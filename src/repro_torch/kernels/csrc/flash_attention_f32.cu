// Causal / sliding-window GQA flash attention in f32 on the CUDA cores
// (sm_90a): the f32 route of the port's `flash_attention`.  bf16 calls take
// the tensor-core kernel in flash_attention.cu; this one keeps f32 products
// and sums throughout, which the f32 tolerance (2e-5 against the reference)
// needs: TF32 tensor-core products would not meet it.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py) for f32 inputs.  For batch b,
// query head h (kv head h / group), query row i at absolute position
// qp = i + q_offset and key j:
//
//   ok(i, j) = (!causal || j <= qp) && (window <= 0 || j > qp - window)
//   s(i, j)  = ok ? (scale * q[i]) . k[j] : -1e30
//   o[i]     = sum_j p(i, j) v[j] / where(l > 0, l, 1),  p = ok ? exp(s - m) : 0
//
// with m and l the running row max and row sum of an online softmax in
// f32, as the TPU kernel keeps them.  A row whose keys are all masked comes
// out as zeros.  When `lse` is not null the kernel also writes each row's
// log-sum-exp, m + log(l) (-inf where l = 0), which the backward
// (flash_attention_bwd.cu) reads to recompute the probabilities.
//
// Design: one block of 256 threads per (tile of 64 query rows, b * H + h).
// The block keeps its scaled query tile in shared memory and walks the key
// tiles that its rows can see (tiles wholly outside the causal or window
// band are skipped: their masked scores change neither m, l nor the sum).
// Each 64-key tile of K and V is staged in shared memory; thread (ty, tx)
// of the 16 x 16 grid owns query rows 4 ty .. 4 ty + 3, scores the keys
// tx + 16 c and accumulates output columns tx + 16 j in registers.  Row
// maxima and sums are reduced across the 16 threads of a row with warp
// shuffles.  Query and K rows are padded by one float so that the threads
// of a row read distinct banks.  Any Sq, Sk and D <= 256 are taken: the
// ragged edges are masked.
//
// What bounds it on the card: operations, at the f32 CUDA-core rate
// (67 TFLOP/s): 4 * B * H * Sq * Sk * D / 2 flops for causal prefill.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 4;       // query rows per thread
constexpr int kCols = kBK / 16;  // scored keys per thread and tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

// element strides of a [B, heads, S, D] operand; the D stride is 1
struct Strides {
  long long b, h, s;
};

template <int NJ>  // NJ * 16 >= D output columns per row
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, Strides qs,
                       Strides ks, Strides vs, Strides os, int H, int group, int Sq,
                       int Sk, int D, float scale, int causal, int window,
                       int q_offset) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;              // [kBQ][ld], already scaled
  float* k_s = q_s + kBQ * ld;    // [kBK][ld]
  float* v_s = k_s + kBK * ld;    // [kBK][D]
  float* p_s = v_s + kBK * D;     // [kBQ][kBK]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / group;
  // heaviest causal tiles (the last rows) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int row = q0 + r;
    q_s[r * ld + d] = row < Sq ? qb[row * qs.s + d] * scale : 0.f;
  }

  // the keys this tile of rows can see
  const int q_lo = q0 + q_offset;
  const int q_hi = min(q0 + kBQ, Sq) - 1 + q_offset;
  int k_begin = 0;
  int k_end = Sk;
  if (causal) k_end = min(Sk, max(q_hi + 1, 0));
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / kBK) * kBK;

  float acc[kRows][NJ];
  float m_i[kRows];
  float l_i[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_i[i] = kMasked;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int d = e - r * D;
      const int key = kt + r;
      const bool live = key < Sk;
      k_s[r * ld + d] = live ? kb[key * ks.s + d] : 0.f;
      v_s[r * D + d] = live ? vb[key * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows];
      float kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty * kRows + i) * ld + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = k_s[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty * kRows + i + q_offset;
      bool ok[kCols];
      float mx = kMasked;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int key = kt + tx + 16 * c;
        bool live = key < Sk;
        if (causal) live = live && key <= qp;
        if (window > 0) live = live && key > qp - window;
        ok[c] = live;
        s[i][c] = live ? s[i][c] : kMasked;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        p_s[(ty * kRows + i) * kBK + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kBK; ++r) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty * kRows + i) * kBK + r];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float vv = col < D ? v_s[r * D + col] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Sq) continue;
    const float denom = l_i[i] > 0.f ? l_i[i] : 1.f;
    if (lse != nullptr && tx == 0) {
      lse[static_cast<long long>(bh) * Sq + row] =
          l_i[i] > 0.f ? m_i[i] + logf(l_i[i]) : neg_inf();
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) ob[row * os.s + col] = acc[i][j] / denom;
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) + static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(kBK) * D + static_cast<size_t>(kBQ) * kBK);
}

template <int NJ>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* st,
           int B, int H, int KVH, int Sq, int Sk, int D, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kernel = flash_attention_kernel<NJ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ), static_cast<unsigned>(B * H));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, qs, ks, vs, os, H, H / KVH,
      Sq,
      Sk, D, scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, Sq, D], k and v [B, KVH, Sk, D], o like q, all f32, each with
// element strides (b, head, seq) in `strides` (q, k, v, o: 12 values, host
// memory) and a unit D stride; lse null or f32 [B, H, Sq], contiguous.
// window <= 0 means no window.  Returns the CUDA error code (0 = ok).
extern "C" int flash_attention_f32_launch(const void* q, const void* k, const void* v,
                                          void* o, void* lse, int B, int H, int KVH, int Sq,
                                          int Sk,
                                          int D, const long long* strides, float scale,
                                          int causal, int window, int q_offset,
                                          void* stream) {
  if (B < 1 || H < 1 || KVH < 1 || H % KVH != 0 || Sq < 1 || Sk < 1 || D < 1 || D > 256 ||
      B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto run = D <= 16 ? launch<1> : D <= 64 ? launch<4> : D <= 128 ? launch<8> : launch<16>;
  return run(q, k, v, o, static_cast<float*>(lse), strides, B, H, KVH, Sq, Sk, D, scale,
             causal, window, q_offset, s);
}
