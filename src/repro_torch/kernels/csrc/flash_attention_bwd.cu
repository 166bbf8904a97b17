// The gradient of causal / sliding-window GQA flash attention for Hopper
// (sm_90a), bf16 at a head dim up to 128: tensor cores (wgmma), TMA copies
// and an mbarrier ring.  dQ, dK and dV from the forward's output O, its
// rows' log-sum-exp (lse, written by flash_attention.cu) and the output's
// gradient dO.  f32 operands, and bf16 ones at a head dim above 128, take
// the CUDA-core kernel in flash_attention_bwd_f32.cu (`bwd_plan` in
// flash_attention.py).
//
// Replaces no TPU kernel: the JAX package has no gradient of its Pallas
// kernel `flash_attention_pallas` (src/repro/kernels/flash_attention.py;
// jax.grad through it raises), and its trainer differentiates the chunked
// jnp path instead.  The port trains through its flash_attention kernel, so
// the gradient is a kernel too.  For batch b, query head h (kv head
// h / group), query row i at position qp = i + q_offset and key j:
//
//   ok(i, j)  = i < Sq && j < Sk && (!causal || j <= qp) && (window <= 0 || j > qp - window)
//   P(i, j)   = ok ? exp2(scale log2(e) q[i] . k[j] - lse[i] log2(e)) : 0
//   delta[i]  = sum_d dO[i, d] O[i, d]
//   dS(i, j)  = P(i, j) * (dO[i] . v[j] - delta[i])
//   dV[j]     = sum over the group's heads and rows i of P(i, j) dO[i]
//   dK[j]     = scale * sum over the group's heads and rows i of dS(i, j) q[i]
//   dQ[i]     = scale * sum_j dS(i, j) k[j]
//
// q . k and dO . v are bf16 x bf16 products summed in f32.  The one rounding
// the plain version (all f32) does not make: P and dS are rounded to bf16
// before the products that take them (dV, dK, dQ), whose sums are f32; the
// forward rounds P so too.  A row that sees no key (lse = -inf) has P = 0:
// the delta launch writes its lse as +inf in the exp2 domain, and the mask
// zeroes P wherever ok is false, so nothing is computed through the -inf.
//
// Design: three launches, no atomics, so two calls give the same bits.
//   1. delta: rowsum(dO O) in f32 (half a warp a row with 16-byte loads, or
//      a warp a row where D or the layout does not allow them; the lanes'
//      partial sums folded by a fixed butterfly of shuffles), and lse
//      log2(e); both written to scratch rows padded to a multiple of 128
//      (padding rows: delta 0, lse +inf), so that the dK / dV producer can
//      copy 64-row slices of them with 16-byte aligned bulk copies.
//   2. dK / dV: one block per (128-key tile, b, kv head); two consumer
//      warpgroups of 64 keys each and one producer warp.  The producer
//      loads the K and V tiles once with TMA, then streams (Q, dO, lse,
//      delta) tiles of 64 query rows through a kStages ring: the group's
//      query heads in turn and, for each, the query tiles of the causal /
//      window band that can see the block's keys.  Per tile a consumer
//      computes S^T = K Q^T and dP^T = V dO^T (wgmma.m64n64k16, both
//      operands K-major, two commit groups), P^T in f32 registers while
//      dP^T's product still runs, dV += P^T dO, then dS^T while dV's product
//      runs, and dK += dS^T Q (wgmma.m64nDPk16 with P^T and dS^T as register
//      A operands in bf16 pairs: the accumulator layout is the A-fragment
//      layout; dO and Q read MN-major through the transpose bit from the
//      same swizzled tiles).  The group's sum stays in registers and is
//      scaled and rounded once.  Blocks run the first key tile of every
//      (b, kv head) pair first (under a causal mask it sees every query
//      tile), then the second, and so on: the heaviest first.
//   3. dQ: one block per (128 query rows, b, head) in the forward's shape
//      and order (heaviest causal tile first, a group's heads adjacent):
//      Q and dO loaded once, K / V tiles of 128 keys of the band through
//      the ring; S = Q K^T and dP = dO V^T (wgmma_ss, two commit groups), P
//      while dP's product runs, dS in registers, dQ += dS K (wgmma_rs, K
//      read MN-major).
//   setmaxnreg hands the producer's registers to the consumers (24 / 240):
//   the dK and dV accumulators of 64 x DP f32 take DP registers a thread,
//   S^T and dP^T another 32 each; dQ's accumulator DP / 2, S and dP 64 each.
//   ptxas: 168 registers at entry, 0 spills.
//
// Shared memory at DP = 128 (64): 133,160 (67,624) bytes for dK / dV (K and
// V tiles, 2 stages of Q and dO tiles of 64 rows and 512 bytes of lse and
// delta), 197,672 (99,368) for dQ (Q and dO of 128 rows, 2 stages of K and
// V tiles of 128 keys).
//
// What bounds it on the card: operations.  The gradient needs 5 products of
// 2 D flops per visible (query, key) pair (S and dP recomputed, dV, dK,
// dQ): 343.6 GFLOP for causal training attention at B 4, H 32, S 2048,
// D 128, 0.347 ms at the 989 TFLOP/s bf16 tensor-core rate, against about
// 337 MB of q, k, v, o, dO, lse and the three gradients (0.100 ms at
// 3.35 TB/s).  This design recomputes S and dP in launch 3 to keep dQ free
// of atomics: 7 products, 481 GFLOP, 0.486 ms at that rate.
#include <cstdint>
#include <cuda_bf16.h>

#include "sm90.cuh"
#include "wgmma.cuh"

namespace {

using namespace sm90;

constexpr int kConsumers = 2;   // warpgroups of 64 rows of the block's own side
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;      // ring depth
constexpr int kRowBytes = 128;  // one swizzled row: 64 bf16
constexpr int kKeys = 128;      // dK / dV: keys a block
constexpr int kRows = 64;       // dK / dV: query rows a tile
constexpr int kQRows = 128;     // dQ: query rows a block
constexpr int kQKeys = 128;     // dQ: keys a tile
constexpr int kPad = 128;       // scratch rows padded to a multiple of this
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000u); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

template <int DP>  // head dim padded to 64 or 128
struct KVTiles {
  static constexpr int kChunks = DP / 64;                 // 64-column chunks of a row
  static constexpr int kKVChunk = kKeys * kRowBytes;      // one chunk of the K or V tile
  static constexpr int kKVBytes = kChunks * kKVChunk;
  static constexpr int kRowChunk = kRows * kRowBytes;     // one chunk of a Q or dO tile
  static constexpr int kTileBytes = kChunks * kRowChunk;
  static constexpr int kStage = 2 * kTileBytes;           // Q and dO
  static constexpr int kVecBytes = kRows * 4;             // a tile's lse or delta
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr int kSmem =
      1024 + 2 * kKVBytes + kStages * (kStage + 2 * kVecBytes) + kBarBytes;
};

template <int DP>
struct QTiles {
  static constexpr int kChunks = DP / 64;
  static constexpr int kQChunk = kQRows * kRowBytes;      // one chunk of the Q or dO tile
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKChunk = kQKeys * kRowBytes;      // one chunk of a K or V tile
  static constexpr int kKBytes = kChunks * kKChunk;
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr int kSmem = 1024 + 2 * kQBytes + kStages * 2 * kKBytes + kBarBytes;
};

// element strides of a [B, heads, S, D] operand; the D stride is 1
struct Strides {
  long long b, h, s;
};

struct Params {
  __nv_bfloat16* out0;       // dK / dV launch: dk; dQ launch: dq
  __nv_bfloat16* out1;       // dK / dV launch: dv
  long long s0[3], s1[3];    // their element strides (b, head, seq); D stride 1
  const float* lse2;         // [B * H, Sqp]: lse log2(e), +inf for no key
  const float* delta;        // [B * H, Sqp]
  int B, KVH, group, Sq, Sk, Sqp, D, n_tiles;
  float scale, scale_log2;
  int causal, window, q_offset;
  int pair0, pair1;          // out0 / out1 rows take aligned bf16 pairs
  MapAxes qa, ka, va, da;
};

__device__ __forceinline__ bool visible(int row, int key, const Params& p) {
  const int qp = row + p.q_offset;
  return row < p.Sq && key < p.Sk && (!p.causal || key <= qp) &&
         (p.window <= 0 || key > qp - p.window);
}

// a thread's accumulator rows r0 and r0 + 8 (columns 8 j + col0, + 1) of a
// 64 x DP f32 tile, times `mul`, rounded to bf16, at rows below `n` and
// columns below D
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride,
                                           const float* acc, float mul, int r0, int n,
                                           int col0, int D, int pair) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* out = base + row * row_stride;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + col0;
      const float v0 = acc[4 * j + 2 * r] * mul;
      const float v1 = acc[4 * j + 2 * r + 1] * mul;
      if (pair && col + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < D) out[col] = __float2bfloat16_rn(v0);
        if (col + 1 < D) out[col + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// ------------------------------------------------------------------ delta
// rowsum(dO o) of each row in f32 and lse log2(e): a warp a row, or
// (kVec: D a multiple of 8, rows on 16-byte boundaries) half a warp a row
// with 16-byte loads; the lanes' partial sums folded by a fixed butterfly
// of shuffles.  Rows from Sq to the padded Sqp get delta 0 and lse +inf.
template <bool kVec>
__global__ void __launch_bounds__(256)
delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dO,
             const float* __restrict__ lse, float* __restrict__ lse2,
             float* __restrict__ delta, Strides os, Strides dos, int H, int Sq, int Sqp, int D,
             long long rows) {
  constexpr int kLanes = kVec ? 16 : 32;  // threads a row
  const long long r = static_cast<long long>(blockIdx.x) * (256 / kLanes) + threadIdx.x / kLanes;
  if (r >= rows) return;  // rows is a multiple of 128: whole warps
  const int lane = threadIdx.x % kLanes;
  const int i = static_cast<int>(r % Sqp);
  const long long bh = r / Sqp;
  if (i >= Sq) {
    if (lane == 0) {
      lse2[r] = pos_inf();
      delta[r] = 0.f;
    }
    return;
  }
  const int h = static_cast<int>(bh % H);
  const int b = static_cast<int>(bh / H);
  const __nv_bfloat16* orow = o + b * os.b + h * os.h + i * os.s;
  const __nv_bfloat16* drow = dO + b * dos.b + h * dos.h + i * dos.s;
  float acc = 0.f;
  if constexpr (kVec) {
    const int d = 8 * lane;
    if (d < D) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + d);
      const uint4 dv = *reinterpret_cast<const uint4*>(drow + d);
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(op[e]);
        const float2 df = __bfloat1622float2(dp[e]);
        acc = fmaf(df.x, of.x, acc);
        acc = fmaf(df.y, of.y, acc);
      }
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      acc = fmaf(__bfloat162float(drow[d]), __bfloat162float(orow[d]), acc);
    }
  }
  // the row's own lanes: a half warp's, or the whole warp's
  const unsigned mask = kVec ? 0xffffu << (threadIdx.x % 32 / 16 * 16) : 0xffffffffu;
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(mask, acc, off);
  if (lane == 0) {
    const float l = lse[bh * Sq + i];
    lse2[r] = l == neg_inf() ? pos_inf() : l * kLog2e;
    delta[r] = acc;
  }
}

// ---------------------------------------------------------------- dK / dV
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
            const Params p) {
  using T = KVTiles<DP>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern repeats every 8 rows of 128 B
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023u) & ~1023u;                  // [chunk][kKeys][64]
  const uint32_t v_s = k_s + T::kKVBytes;                        // [chunk][kKeys][64]
  const uint32_t ring = v_s + T::kKVBytes;                       // [stage]: Q, dO
  auto q_st = [&](int s) { return ring + s * T::kStage; };      // [chunk][kRows][64]
  auto do_st = [&](int s) { return q_st(s) + T::kTileBytes; };  // [chunk][kRows][64]
  const uint32_t vecs = ring + kStages * T::kStage;              // [stage]: lse, delta
  auto lse_st = [&](int s) { return vecs + s * 2 * T::kVecBytes; };
  const uint32_t bars = vecs + kStages * 2 * T::kVecBytes;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStages + s); };

  // block -> (key tile, b, kv head): the first key tile (which a causal mask
  // lets every query tile see) of every pair first, then the next
  int t = blockIdx.x;
  const int kvh = t % p.KVH;
  t /= p.KVH;
  const int b = t % p.B;
  const int k0 = (t / p.B) * kKeys;

  // the query rows that can see the block's keys
  const int k_hi = min(k0 + kKeys, p.Sk) - 1;
  int q_begin = 0;
  int q_end = p.Sq;
  if (p.causal) q_begin = max(0, k0 - p.q_offset);
  if (p.window > 0) q_end = min(p.Sq, max(0, k_hi + p.window - p.q_offset));
  q_begin = (q_begin / kRows) * kRows;
  const int n_q = q_end > q_begin ? (q_end - q_begin + kRows - 1) / kRows : 0;
  const int n_iters = p.group * n_q;  // the group's heads in turn, each over the band

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(kv_full, 2 * T::kKVBytes);
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load_rows(k_s + c * T::kKVChunk, &tk, p.ka, kv_full, 64 * c, k0, kvh, b);
        tma_load_rows(v_s + c * T::kKVChunk, &tv, p.va, kv_full, 64 * c, k0, kvh, b);
      }
      for (int it = 0; it < n_iters; ++it) {
        const int s = it % kStages;
        const int h = kvh * p.group + it / n_q;
        const int q0 = q_begin + (it % n_q) * kRows;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full(s), T::kStage + 2 * T::kVecBytes);
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load_rows(q_st(s) + c * T::kRowChunk, &tq, p.qa, full(s), 64 * c, q0, h, b);
          tma_load_rows(do_st(s) + c * T::kRowChunk, &tdo, p.da, full(s), 64 * c, q0, h, b);
        }
        const long long row = (static_cast<long long>(b) * p.KVH * p.group + h) * p.Sqp + q0;
        bulk_load(lse_st(s), p.lse2 + row, T::kVecBytes, full(s));
        bulk_load(lse_st(s) + T::kVecBytes, p.delta + row, T::kVecBytes, full(s));
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int kw0 = k0 + 64 * wg;                      // this warpgroup's first key
    const int key0 = kw0 + 16 * (tid / 32) + lane / 4;  // this thread's keys: key0, key0 + 8
    const int col0 = 2 * (lane % 4);                    // and query columns 8 j + col0 (+1)
    const bool live = kw0 < p.Sk;
    const int kw_hi = min(kw0 + 64, p.Sk) - 1;
    const uint32_t k_rows = k_s + 64 * wg * kRowBytes;
    const uint32_t v_rows = v_s + 64 * wg * kRowBytes;

    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iters; ++it) {
      const int s = it % kStages;
      const int q0 = q_begin + (it % n_q) * kRows;
      mbar_wait(full(s), (it / kStages) & 1);
      const int r_lo = q0 + p.q_offset;  // positions of the tile's rows
      const int r_hi = min(q0 + kRows, p.Sq) - 1 + p.q_offset;
      const bool seen = live && (!p.causal || kw0 <= r_hi) &&
                        (p.window <= 0 || kw_hi > r_lo - p.window);
      if (seen) {
        // S^T = K Q^T and dP^T = V dO^T over the padded head dim, two
        // groups of products
        float st[kRows / 2], dpt[kRows / 2];
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) st[i] = dpt[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da = smem_desc(k_rows + c * T::kKVChunk + 32 * kk, 16, 1024);
            const uint64_t db = smem_desc(q_st(s) + c * T::kRowChunk + 32 * kk, 16, 1024);
            wgmma_ss<kRows>(st, da, db, (c | kk) != 0);
          }
        }
        wgmma_commit();
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da = smem_desc(v_rows + c * T::kKVChunk + 32 * kk, 16, 1024);
            const uint64_t db = smem_desc(do_st(s) + c * T::kRowChunk + 32 * kk, 16, 1024);
            wgmma_ss<kRows>(dpt, da, db, (c | kk) != 0);
          }
        }
        wgmma_commit();
        reg_fence<kRows / 2>(st);
        reg_fence<kRows / 2>(dpt);
        wgmma_wait<1>();  // S^T is done; dP^T may still run
        reg_fence<kRows / 2>(st);

        // P^T, the element mask only where the band's edge, Sq or Sk cuts
        // the tile
        const bool edge = q0 + kRows > p.Sq || kw0 + 64 > p.Sk ||
                          (p.causal && kw_hi > r_lo) ||
                          (p.window > 0 && kw0 <= r_hi - p.window);
        const float2* lv = reinterpret_cast<const float2*>(smem_raw + (lse_st(s) - raw));
        const float2* dl = lv + kRows / 2;
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
          const float2 l2 = lv[(8 * j + col0) / 2];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pv = exp2_approx(st[4 * j + e] * p.scale_log2 - (e % 2 ? l2.y : l2.x));
            if (edge && !visible(q0 + 8 * j + col0 + e % 2, key0 + 8 * (e / 2), p)) pv = 0.f;
            st[4 * j + e] = pv;
          }
        }
        uint32_t pa[kRows / 4], dsa[kRows / 4];  // the A fragments of P^T dO and dS^T Q
#pragma unroll
        for (int j = 0; j < kRows / 4; ++j) pa[j] = bf16_pair(st[2 * j], st[2 * j + 1]);

        // dV += P^T dO, 16 query rows per wgmma; dO read MN-major: 8-row
        // groups 1024 bytes apart, chunks a chunk apart
        wgmma_fence();
        reg_fence<DP / 2>(dv);
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          const uint64_t dd = smem_desc(do_st(s) + 16 * kRowBytes * kk, T::kRowChunk, 1024);
          wgmma_rs<DP>(dv, &pa[4 * kk], dd);
        }
        wgmma_commit();
        reg_fence<DP / 2>(dv);
        wgmma_wait<1>();  // dP^T is done; dV's product may still run
        reg_fence<kRows / 2>(dpt);

        // dS^T = P^T (dP^T - delta), then dK += dS^T Q (Q read MN-major)
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
          const float2 d2 = dl[(8 * j + col0) / 2];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - (e % 2 ? d2.y : d2.x));
          }
        }
#pragma unroll
        for (int j = 0; j < kRows / 4; ++j) dsa[j] = bf16_pair(dpt[2 * j], dpt[2 * j + 1]);
        wgmma_fence();
        reg_fence<DP / 2>(dk);
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk) {
          const uint64_t dq = smem_desc(q_st(s) + 16 * kRowBytes * kk, T::kRowChunk, 1024);
          wgmma_rs<DP>(dk, &dsa[4 * kk], dq);
        }
        wgmma_commit();
        reg_fence<DP / 2>(dv);
        reg_fence<DP / 2>(dk);
        wgmma_wait_all();
        reg_fence<DP / 2>(dv);
        reg_fence<DP / 2>(dk);
      }
      mbar_arrive(empty(s));
    }

    if (live) {
      store_rows<DP>(p.out0 + b * p.s0[0] + kvh * p.s0[1], p.s0[2], dk, p.scale, key0, p.Sk,
                     col0, p.D, p.pair0);
      store_rows<DP>(p.out1 + b * p.s1[0] + kvh * p.s1[1], p.s1[2], dv, 1.f, key0, p.Sk, col0,
                     p.D, p.pair1);
    }
  }
}

// --------------------------------------------------------------------- dQ
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
          const Params p) {
  using T = QTiles<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [chunk][kQRows][64]
  const uint32_t do_s = q_s + T::kQBytes;                       // [chunk][kQRows][64]
  const uint32_t ring = do_s + T::kQBytes;                      // [stage]: K, V
  auto k_st = [&](int s) { return ring + s * 2 * T::kKBytes; };  // [chunk][kQKeys][64]
  auto v_st = [&](int s) { return k_st(s) + T::kKBytes; };
  const uint32_t bars = ring + kStages * 2 * T::kKBytes;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStages + s); };

  // block -> (q tile, b, kv head, head in group) as the forward orders it:
  // the group's heads neighbours, the heaviest causal tiles first
  int t = blockIdx.x;
  const int g = t % p.group;
  t /= p.group;
  const int kvh = t % p.KVH;
  t /= p.KVH;
  const int b = t % p.B;
  const int q0 = (p.n_tiles - 1 - t / p.B) * kQRows;
  const int h = kvh * p.group + g;

  // the key tiles the block's rows can see
  const int q_lo = q0 + p.q_offset;
  const int q_hi = min(q0 + kQRows, p.Sq) - 1 + p.q_offset;
  int k_begin = 0;
  int k_end = p.Sk;
  if (p.causal) k_end = min(p.Sk, max(q_hi + 1, 0));
  if (p.window > 0) k_begin = max(0, q_lo - p.window + 1);
  k_begin = (k_begin / kQKeys) * kQKeys;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kQKeys - 1) / kQKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, 2 * T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load_rows(q_s + c * T::kQChunk, &tq, p.qa, q_full, 64 * c, q0, h, b);
        tma_load_rows(do_s + c * T::kQChunk, &tdo, p.da, q_full, 64 * c, q0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * T::kKBytes);
        const int kt = k_begin + it * kQKeys;
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load_rows(k_st(s) + c * T::kKChunk, &tk, p.ka, full(s), 64 * c, kt, kvh, b);
          tma_load_rows(v_st(s) + c * T::kKChunk, &tv, p.va, full(s), 64 * c, kt, kvh, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int w0 = q0 + 64 * wg;                      // this warpgroup's first row
    const int row0 = w0 + 16 * (tid / 32) + lane / 4;  // this thread's rows: row0, row0 + 8
    const int col0 = 2 * (lane % 4);                   // and key columns 8 j + col0 (+1)
    const bool live = w0 < p.Sq;
    const int w_lo = w0 + p.q_offset;                  // positions of the warpgroup's rows
    const int w_hi = min(w0 + 64, p.Sq) - 1 + p.q_offset;
    // rows up to q0 + 128 <= Sqp lie in the padded scratch
    const long long at = (static_cast<long long>(b) * p.KVH * p.group + h) * p.Sqp + row0;
    const float l2[2] = {p.lse2[at], p.lse2[at + 8]};
    const float dl[2] = {p.delta[at], p.delta[at + 8]};
    const uint32_t q_rows = q_s + 64 * wg * kRowBytes;
    const uint32_t do_rows = do_s + 64 * wg * kRowBytes;

    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int kt = k_begin + it * kQKeys;
      mbar_wait(full(s), (it / kStages) & 1);
      const bool seen = live && (!p.causal || kt <= w_hi) &&
                        (p.window <= 0 || kt + kQKeys - 1 > w_lo - p.window);
      if (seen) {
        // S = Q K^T and dP = dO V^T over the padded head dim, two groups
        // of products
        float sc[kQKeys / 2], dp[kQKeys / 2];
#pragma unroll
        for (int i = 0; i < kQKeys / 2; ++i) sc[i] = dp[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da = smem_desc(q_rows + c * T::kQChunk + 32 * kk, 16, 1024);
            const uint64_t db = smem_desc(k_st(s) + c * T::kKChunk + 32 * kk, 16, 1024);
            wgmma_ss<kQKeys>(sc, da, db, (c | kk) != 0);
          }
        }
        wgmma_commit();
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da = smem_desc(do_rows + c * T::kQChunk + 32 * kk, 16, 1024);
            const uint64_t db = smem_desc(v_st(s) + c * T::kKChunk + 32 * kk, 16, 1024);
            wgmma_ss<kQKeys>(dp, da, db, (c | kk) != 0);
          }
        }
        wgmma_commit();
        reg_fence<kQKeys / 2>(sc);
        reg_fence<kQKeys / 2>(dp);
        wgmma_wait<1>();  // S is done; dP may still run
        reg_fence<kQKeys / 2>(sc);

        const bool edge = kt + kQKeys > p.Sk || w0 + 64 > p.Sq ||
                          (p.causal && kt + kQKeys - 1 > w_lo) ||
                          (p.window > 0 && kt <= w_hi - p.window);
#pragma unroll
        for (int i = 0; i < kQKeys / 2; ++i) {
          const int r = (i / 2) % 2;
          float pv = exp2_approx(sc[i] * p.scale_log2 - l2[r]);
          if (edge && !visible(row0 + 8 * r, kt + 8 * (i / 4) + col0 + i % 2, p)) pv = 0.f;
          sc[i] = pv;
        }
        wgmma_wait_all();
        reg_fence<kQKeys / 2>(dp);
        uint32_t dsa[kQKeys / 4];  // dS in bf16 pairs: the A fragments of dS K
#pragma unroll
        for (int i = 0; i < kQKeys / 2; ++i) dp[i] = sc[i] * (dp[i] - dl[(i / 2) % 2]);
#pragma unroll
        for (int j = 0; j < kQKeys / 4; ++j) dsa[j] = bf16_pair(dp[2 * j], dp[2 * j + 1]);

        // dQ += dS K, 16 keys per wgmma, K read MN-major as the forward
        // reads V
        wgmma_fence();
        reg_fence<DP / 2>(dq);
#pragma unroll
        for (int kk = 0; kk < kQKeys / 16; ++kk) {
          const uint64_t dkd = smem_desc(k_st(s) + 16 * kRowBytes * kk, T::kKChunk, 1024);
          wgmma_rs<DP>(dq, &dsa[4 * kk], dkd);
        }
        wgmma_commit();
        reg_fence<DP / 2>(dq);
        wgmma_wait_all();
        reg_fence<DP / 2>(dq);
      }
      mbar_arrive(empty(s));
    }

    if (live) {
      store_rows<DP>(p.out0 + b * p.s0[0] + h * p.s0[1], p.s0[2], dq, p.scale, row0, p.Sq,
                     col0, p.D, p.pair0);
    }
  }
}

// ---------------------------------------------------------------- host side
bool pairs_ok(const void* ptr, int D, const long long* st) {
  return D % 2 == 0 && reinterpret_cast<uintptr_t>(ptr) % 4 == 0 && st[0] % 2 == 0 &&
         st[1] % 2 == 0 && st[2] % 2 == 0;
}

// the four tensor maps of a launch: q and dO with boxes of `q_rows` rows,
// k and v with boxes of `k_rows`
int make_maps(CUtensorMap* maps, Params* p, const void* const* ops, const long long* st, int B,
              int H, int KVH, int Sq, int Sk, int D, int q_rows, int k_rows) {
  int err = make_map(&maps[0], &p->qa, ops[0], 2, B, H, Sq, D, st, q_rows);
  if (err == 0) err = make_map(&maps[1], &p->ka, ops[1], 2, B, KVH, Sk, D, st + 3, k_rows);
  if (err == 0) err = make_map(&maps[2], &p->va, ops[2], 2, B, KVH, Sk, D, st + 6, k_rows);
  if (err == 0) err = make_map(&maps[3], &p->da, ops[4], 2, B, H, Sq, D, st + 12, q_rows);
  return err;
}

template <int DP>
int run(const void* const* ops, const float* lse, void* dq, void* dk, void* dv,
        float* scratch, int B, int H, int KVH, int Sq, int Sk, int D, const long long* st,
        float scale, int causal, int window, int q_offset, cudaStream_t stream) {
  Params p{};
  p.B = B;
  p.KVH = KVH;
  p.group = H / KVH;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Sqp = (Sq + kPad - 1) / kPad * kPad;
  p.D = D;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  const long long rows = static_cast<long long>(B) * H * p.Sqp;
  p.lse2 = scratch;
  p.delta = scratch + rows;

  // 1. delta and lse log2(e)
  const Strides os{st[9], st[10], st[11]};
  const Strides dos{st[12], st[13], st[14]};
  const bool vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(ops[3]) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ops[4]) % 16 == 0 && os.b % 8 == 0 &&
                   os.h % 8 == 0 && os.s % 8 == 0 && dos.b % 8 == 0 && dos.h % 8 == 0 &&
                   dos.s % 8 == 0;
  const long long delta_blocks = rows / (vec ? 16 : 8);
  if (delta_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto delta_run = vec ? delta_kernel<true> : delta_kernel<false>;
  delta_run<<<static_cast<unsigned>(delta_blocks), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(ops[3]), static_cast<const __nv_bfloat16*>(ops[4]), lse,
      scratch, scratch + rows, os, dos, H, Sq, p.Sqp, D, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // 2. dK / dV
  CUtensorMap maps[4];
  int err = make_maps(maps, &p, ops, st, B, H, KVH, Sq, Sk, D, kRows, kKeys);
  if (err != 0) return err;
  p.out0 = static_cast<__nv_bfloat16*>(dk);
  p.out1 = static_cast<__nv_bfloat16*>(dv);
  for (int i = 0; i < 3; ++i) {
    p.s0[i] = st[18 + i];
    p.s1[i] = st[21 + i];
  }
  p.pair0 = pairs_ok(dk, D, st + 18);
  p.pair1 = pairs_ok(dv, D, st + 21);
  p.n_tiles = (Sk + kKeys - 1) / kKeys;
  long long blocks = static_cast<long long>(p.n_tiles) * B * KVH;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kv_kernel = dkdv_kernel<DP>;
  e = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           KVTiles<DP>::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kv_kernel<<<static_cast<unsigned>(blocks), kThreads, KVTiles<DP>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // 3. dQ
  err = make_maps(maps, &p, ops, st, B, H, KVH, Sq, Sk, D, kQRows, kQKeys);
  if (err != 0) return err;
  p.out0 = static_cast<__nv_bfloat16*>(dq);
  p.out1 = nullptr;
  for (int i = 0; i < 3; ++i) p.s0[i] = st[15 + i];
  p.pair0 = pairs_ok(dq, D, st + 15);
  p.n_tiles = (Sq + kQRows - 1) / kQRows;
  blocks = static_cast<long long>(p.n_tiles) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto q_kernel = dq_kernel<DP>;
  e = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           QTiles<DP>::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  q_kernel<<<static_cast<unsigned>(blocks), kThreads, QTiles<DP>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, Sq, D], k and v [B, KVH, Sk, D], o, dO and dq like q, dk and dv
// like k, all bf16, D <= 128, each with element strides (b, head, seq) in
// `strides` (q, k, v, o, dO, dq, dk, dv: 24 values, host memory) and a unit
// D stride.  q, k, v and dO start on 16-byte boundaries and their strides
// are multiples of 8 elements (TMA's rule).  lse (the forward's) f32
// [B, H, Sq], contiguous; scratch f32 [2, B, H, Sqp] with Sqp = Sq rounded
// up to a multiple of 128, 16-byte aligned, which the launch fills.  window
// <= 0 means no window.  Three kernel launches on `stream`.  Returns 0, a
// CUDA error code, or 1001 (no driver entry point), 1002 (misaligned
// operand), 1100 + a CUresult (tensor map refused).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dO, const void* lse,
                                          void* dq, void* dk, void* dv, void* scratch, int B,
                                          int H, int KVH, int Sq, int Sk, int D,
                                          const long long* strides, float scale, int causal,
                                          int window, int q_offset, void* stream) {
  if (B < 1 || H < 1 || KVH < 1 || H % KVH != 0 || Sq < 1 || Sk < 1 || D < 1 || D > 128 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ops[5] = {q, k, v, o, dO};
  auto go = D <= 64 ? run<64> : run<128>;
  return go(ops, static_cast<const float*>(lse), dq, dk, dv, static_cast<float*>(scratch), B,
            H, KVH, Sq, Sk, D, strides, scale, causal, window, q_offset,
            static_cast<cudaStream_t>(stream));
}
