// The gradient of causal / sliding-window GQA flash attention on the CUDA
// cores (sm_90a): dQ, dK and dV from the forward's output O, its rows'
// log-sum-exp (lse, written by flash_attention.cu or flash_attention_f32.cu)
// and the output's gradient dO.  bf16 or f32 operands; every product and sum
// in f32, the results rounded once to the operands' type.  The route of f32
// operands at every head dim, and of bf16 ones at a head dim above 128; bf16
// at a head dim up to 128 takes the tensor-core kernel in
// flash_attention_bwd.cu (`bwd_plan` in flash_attention.py).
//
// Replaces no TPU kernel: the JAX package has no gradient of its Pallas
// kernel `flash_attention_pallas` (src/repro/kernels/flash_attention.py;
// jax.grad through it raises), and its trainer differentiates the chunked
// jnp path instead.  The port trains through its flash_attention kernel, so
// the gradient is a kernel too.  For batch b, query head h (kv head
// h / group), query row i at position qp = i + q_offset and key j:
//
//   ok(i, j)  = j < Sk && (!causal || j <= qp) && (window <= 0 || j > qp - window)
//   P(i, j)   = ok ? exp(scale * q[i] . k[j] - lse[i]) : 0
//   delta[i]  = sum_d dO[i, d] O[i, d]
//   dS(i, j)  = P(i, j) * (dO[i] . v[j] - delta[i])
//   dV[j]     = sum over the group's heads and rows i of P(i, j) dO[i]
//   dK[j]     = scale * sum over the group's heads and rows i of dS(i, j) q[i]
//   dQ[i]     = scale * sum_j dS(i, j) k[j]
//
// A row that sees no key (lse = -inf) has P = 0 everywhere, so it and its
// keys get zero gradients from it.
//
// Design: three launches, no atomics, so two calls give the same bits.
//   1. delta: one warp a row, its lanes' partial sums folded by a fixed
//      butterfly of shuffles.
//   2. dK / dV: one block of 256 threads (16 x 16) per (key tile, b, kv head).
//      The block stages its K and V tile in shared memory, then walks the
//      group's query heads one after another and, for each, the 64-row query
//      tiles whose rows can see its keys (the causal / window band), staging
//      each tile's Q, dO, lse and delta.  Thread (ty, tx) scores keys
//      R ty .. R ty + R - 1 against query rows tx + 16 c (P and dP = dO V^T
//      in one pass over D), writes P and dS to shared memory, then adds
//      P^T dO and dS^T Q into its dV and dK accumulators (output columns
//      tx + 16 j) in registers.  Summing the group inside one block is what
//      keeps atomics out.
//   3. dQ: one block per (query tile, b, head), walking the key tiles its
//      rows can see (as the forward does), with dS staged in shared memory
//      and dQ accumulated in registers.
// Tiles: R = 4 rows a thread (64-row tiles) up to D = 128, R = 2 (32) above,
// so that two operand tiles of the block's own side, two of the other side
// and the P / dS tiles fit in shared memory (165,888 bytes at D = 128,
// 214,528 at D = 256).  Rows are padded by one float so that the 16 threads
// of a row read distinct banks.
//
// What bounds it on the card: operations.  The gradient needs 5 products of
// 2 D flops per visible (query, key) pair (S and dP recomputed, dV, dK, dQ);
// this kernel does 7 (S and dP twice, once in each of launches 2 and 3), on
// the CUDA cores at the f32 rate (67 TFLOP/s), where the bound is the 5 at
// the bf16 tensor-core rate.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kOther = 64;     // rows of the other side's tile: 4 per thread x 16
constexpr int kOC = kOther / 16;
constexpr int kLdp = kOther + 1;  // P / dS row pitch

// element strides of a [B, heads, S, D] operand; the D stride is 1
struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ bool visible(int key, int qp, int Sk, int causal, int window) {
  return key < Sk && (!causal || key <= qp) && (window <= 0 || key > qp - window);
}

// rows [r0, r0 + n) of a [S, D] operand into a [n][ld] f32 tile, zeros past S
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, long long stride,
                                      int r0, int n, int S, int D, int ld) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int row = r0 + r;
    dst[r * ld + d] = row < S ? to_f32(src[row * stride + d]) : 0.f;
  }
}

// ------------------------------------------------------------------ delta
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dO, float* __restrict__ delta,
             Strides os, Strides dos, int H, int Sq, int D, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(r % Sq);
  const long long bh = r / Sq;
  const int h = static_cast<int>(bh % H);
  const int b = static_cast<int>(bh / H);
  const T* orow = o + b * os.b + h * os.h + i * os.s;
  const T* drow = dO + b * dos.b + h * dos.h + i * dos.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(drow[d]), to_f32(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

// ---------------------------------------------------------------- dK / dV
template <typename T, int NJ, int R>  // NJ * 16 >= D; R keys a thread (BK = 16 R)
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dO, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
            Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, int H,
            int KVH, int Sq, int Sk, int D, float scale, int causal, int window,
            int q_offset) {
  constexpr int BK = 16 * R;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* k_s = smem;                   // [BK][ld]
  float* v_s = k_s + BK * ld;          // [BK][ld]
  float* q_s = v_s + BK * ld;          // [kOther][ld]
  float* do_s = q_s + kOther * ld;     // [kOther][ld]
  float* p_s = do_s + kOther * ld;     // [BK][kLdp]
  float* ds_s = p_s + BK * kLdp;       // [BK][kLdp]
  float* lse_s = ds_s + BK * kLdp;     // [kOther]
  float* dl_s = lse_s + kOther;        // [kOther]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y - b * KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.x * BK;

  stage(k_s, k + b * ks.b + kvh * ks.h, ks.s, k0, BK, Sk, D, ld);
  stage(v_s, v + b * vs.b + kvh * vs.h, vs.s, k0, BK, Sk, D, ld);

  // the query rows that can see this tile's keys
  const int k_hi = min(k0 + BK, Sk) - 1;
  int q_begin = 0;
  int q_end = Sq;
  if (causal) q_begin = max(0, k0 - q_offset);
  if (window > 0) q_end = min(Sq, max(0, k_hi + window - q_offset));
  q_begin = (q_begin / kOther) * kOther;

  float acc_k[R][NJ];
  float acc_v[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dO + b * dos.b + h * dos.h;
    const float* lse_b = lse + (static_cast<long long>(b) * H + h) * Sq;
    const float* dl_b = delta + (static_cast<long long>(b) * H + h) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kOther) {
      __syncthreads();  // the previous tile's readers are done
      stage(q_s, qb, qs.s, q0, kOther, Sq, D, ld);
      stage(do_s, dob, dos.s, q0, kOther, Sq, D, ld);
      if (tid < kOther) {
        const int row = q0 + tid;
        lse_s[tid] = row < Sq ? lse_b[row] : 0.f;
        dl_s[tid] = row < Sq ? dl_b[row] : 0.f;
      }
      __syncthreads();

      float s[R][kOC];
      float dp[R][kOC];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < kOC; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[R], vv[R], qv[kOC], dv_[kOC];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kv[i] = k_s[(ty * R + i) * ld + d];
          vv[i] = v_s[(ty * R + i) * ld + d];
        }
#pragma unroll
        for (int c = 0; c < kOC; ++c) {
          qv[c] = q_s[(tx + 16 * c) * ld + d];
          dv_[c] = do_s[(tx + 16 * c) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < kOC; ++c) {
            s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
            dp[i][c] = fmaf(vv[i], dv_[c], dp[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int key = k0 + ty * R + i;
#pragma unroll
        for (int c = 0; c < kOC; ++c) {
          const int r = tx + 16 * c;
          const int row = q0 + r;
          const bool ok = row < Sq && visible(key, row + q_offset, Sk, causal, window);
          const float p = ok ? expf(s[i][c] * scale - lse_s[r]) : 0.f;
          p_s[(ty * R + i) * kLdp + r] = p;
          ds_s[(ty * R + i) * kLdp + r] = p * (dp[i][c] - dl_s[r]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < kOther; ++r) {
        float pv[R], dsv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = p_s[(ty * R + i) * kLdp + r];
          dsv[i] = ds_s[(ty * R + i) * kLdp + r];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          const float dov = col < D ? do_s[r * ld + col] : 0.f;
          const float qv = col < D ? q_s[r * ld + col] : 0.f;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc_v[i][j] = fmaf(pv[i], dov, acc_v[i][j]);
            acc_k[i][j] = fmaf(dsv[i], qv, acc_k[i][j]);
          }
        }
      }
    }
  }

  T* dkb = dk + b * dks.b + kvh * dks.h;
  T* dvb = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty * R + i;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) {
        store(dkb + key * dks.s + col, acc_k[i][j] * scale);
        store(dvb + key * dvs.s + col, acc_v[i][j]);
      }
    }
  }
}

// --------------------------------------------------------------------- dQ
template <typename T, int NJ, int R>  // NJ * 16 >= D; R query rows a thread (BQ = 16 R)
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dO, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, Strides qs, Strides ks,
          Strides vs, Strides dos, Strides dqs, int H, int KVH, int Sq, int Sk, int D,
          float scale, int causal, int window, int q_offset) {
  constexpr int BQ = 16 * R;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;                // [BQ][ld]
  float* do_s = q_s + BQ * ld;      // [BQ][ld]
  float* k_s = do_s + BQ * ld;      // [kOther][ld]
  float* v_s = k_s + kOther * ld;   // [kOther][ld]
  float* ds_s = v_s + kOther * ld;  // [BQ][kLdp]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KVH);
  // heaviest causal tiles (the last rows) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;

  stage(q_s, q + b * qs.b + h * qs.h, qs.s, q0, BQ, Sq, D, ld);
  stage(do_s, dO + b * dos.b + h * dos.h, dos.s, q0, BQ, Sq, D, ld);
  float lse_r[R], dl_r[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    lse_r[i] = row < Sq ? lse[static_cast<long long>(bh) * Sq + row] : 0.f;
    dl_r[i] = row < Sq ? delta[static_cast<long long>(bh) * Sq + row] : 0.f;
  }
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  // the keys this tile of rows can see
  const int q_lo = q0 + q_offset;
  const int q_hi = min(q0 + BQ, Sq) - 1 + q_offset;
  int k_begin = 0;
  int k_end = Sk;
  if (causal) k_end = min(Sk, max(q_hi + 1, 0));
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / kOther) * kOther;

  float acc[R][NJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += kOther) {
    __syncthreads();
    stage(k_s, kb, ks.s, kt, kOther, Sk, D, ld);
    stage(v_s, vb, vs.s, kt, kOther, Sk, D, ld);
    __syncthreads();

    float s[R][kOC];
    float dp[R][kOC];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kOC; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], dv_[R], kv[kOC], vv[kOC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = q_s[(ty * R + i) * ld + d];
        dv_[i] = do_s[(ty * R + i) * ld + d];
      }
#pragma unroll
      for (int c = 0; c < kOC; ++c) {
        kv[c] = k_s[(tx + 16 * c) * ld + d];
        vv[c] = v_s[(tx + 16 * c) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < kOC; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(dv_[i], vv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty * R + i;
#pragma unroll
      for (int c = 0; c < kOC; ++c) {
        const int key = kt + tx + 16 * c;
        const bool ok = row < Sq && visible(key, row + q_offset, Sk, causal, window);
        const float p = ok ? expf(s[i][c] * scale - lse_r[i]) : 0.f;
        ds_s[(ty * R + i) * kLdp + tx + 16 * c] = p * (dp[i][c] - dl_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kOther; ++r) {
      float dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = ds_s[(ty * R + i) * kLdp + r];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float kv = col < D ? k_s[r * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) store(dqb + row * dqs.s + col, acc[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------- host side
struct Args {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;
  Strides s[8];  // q, k, v, o, dO, dq, dk, dv
  int B, H, KVH, Sq, Sk, D;
  float scale;
  int causal, window, q_offset;
};

template <int R>
size_t dkdv_smem(int D) {
  const size_t ld = D + 1;
  return sizeof(float) * (2 * 16 * R * ld + 2 * kOther * ld + 2 * 16 * R * kLdp + 2 * kOther);
}

template <int R>
size_t dq_smem(int D) {
  const size_t ld = D + 1;
  return sizeof(float) * (2 * 16 * R * ld + 2 * kOther * ld + 16 * R * kLdp);
}

template <typename T, int NJ, int R>
int run(const Args& a, cudaStream_t stream) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dO = static_cast<const T*>(a.dO);
  const long long rows = static_cast<long long>(a.B) * a.H * a.Sq;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<T><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(
      o, dO, a.delta, a.s[3], a.s[4], a.H, a.Sq, a.D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kv_kernel = dkdv_kernel<T, NJ, R>;
  const size_t kv_smem = dkdv_smem<R>(a.D);
  err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 kv_grid(static_cast<unsigned>((a.Sk + 16 * R - 1) / (16 * R)),
               static_cast<unsigned>(a.B * a.KVH));
  kv_kernel<<<kv_grid, kThreads, kv_smem, stream>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.s[0],
      a.s[1], a.s[2], a.s[4], a.s[6], a.s[7], a.H, a.KVH, a.Sq, a.Sk, a.D, a.scale, a.causal,
      a.window, a.q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto q_kernel = dq_kernel<T, NJ, R>;
  const size_t q_smem = dq_smem<R>(a.D);
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 q_grid(static_cast<unsigned>((a.Sq + 16 * R - 1) / (16 * R)),
              static_cast<unsigned>(a.B * a.H));
  q_kernel<<<q_grid, kThreads, q_smem, stream>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<T*>(a.dq), a.s[0], a.s[1], a.s[2], a.s[4],
      a.s[5], a.H, a.KVH, a.Sq, a.Sk, a.D, a.scale, a.causal, a.window, a.q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.D <= 16) return run<T, 1, 4>(a, stream);
  if (a.D <= 64) return run<T, 4, 4>(a, stream);
  if (a.D <= 128) return run<T, 8, 4>(a, stream);
  return run<T, 16, 2>(a, stream);
}

}  // namespace

// q [B, H, Sq, D], k and v [B, KVH, Sk, D], o, dO and dq like q, dk and dv
// like k, all f32 (bf16 = 0) or all bf16 (bf16 = 1), each with element
// strides (b, head, seq) in `strides` (q, k, v, o, dO, dq, dk, dv: 24
// values, host memory) and a unit D stride; lse (the forward's) and delta
// (scratch the launch fills) f32 [B, H, Sq], contiguous.  window <= 0 means
// no window.  Three kernel launches on `stream`.  Returns the CUDA error
// code (0 = ok).
extern "C" int flash_attention_bwd_f32_launch(const void* q, const void* k, const void* v,
                                              const void* o, const void* dO, const void* lse,
                                              void* dq, void* dk, void* dv, void* delta,
                                              int bf16, int B, int H, int KVH, int Sq, int Sk,
                                              int D, const long long* strides, float scale,
                                              int causal, int window, int q_offset,
                                              void* stream) {
  if (B < 1 || H < 1 || KVH < 1 || H % KVH != 0 || Sq < 1 || Sk < 1 || D < 1 || D > 256 ||
      B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, o, dO, static_cast<const float*>(lse), dq, dk, dv,
         static_cast<float*>(delta), {}, B, H, KVH, Sq, Sk, D, scale, causal, window,
         q_offset};
  for (int i = 0; i < 8; ++i) {
    a.s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s);
}
