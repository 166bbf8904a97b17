// Causal / sliding-window GQA flash attention for Hopper (sm_90a), bf16:
// tensor cores (wgmma), TMA copies and a pipelined K/V ring.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py) for bf16 inputs; f32 inputs take
// the CUDA-core kernel in flash_attention_f32.cu.  For batch b, query head h
// (kv head h / group), query row i at absolute position qp = i + q_offset
// and key j:
//
//   ok(i, j) = j < Sk && (!causal || j <= qp) && (window <= 0 || j > qp - window)
//   s(i, j)  = ok ? scale * (q[i] . k[j]) : -1e30        (f32)
//   o[i]     = sum_j p(i, j) v[j] / where(l > 0, l, 1),  p = ok ? exp(s - m) : 0
//
// with m and l the running row max and row sum of an online softmax in f32,
// and the output rounded to bf16.  A row whose keys are all masked comes out
// as zeros.  When the lse pointer is not null the kernel also writes each
// row's natural log-sum-exp, (m + log2 l) ln 2 in the exp2 domain the kernel
// keeps (-inf where l = 0), which the backward (flash_attention_bwd.cu)
// reads to recompute the probabilities.  q . k is a bf16 x bf16 product summed in f32 (each product is
// exact in f32); `scale` (with log2 e folded in, for exp2) multiplies the
// f32 score.  The one rounding the reference does not make: p is rounded to
// bf16 before the P . V product, whose sum is f32.
//
// Design.  A block takes 128 query rows of one (b, h) and walks the key
// tiles its rows can see; tiles wholly outside the causal / window band are
// never loaded.  Three warpgroups: two consumers of 64 query rows each and
// one producer warp.
//
//   * The producer issues every copy with TMA (cp.async.bulk.tensor through
//     tensor maps built on the host): the Q tile once, then each BK-key tile
//     of K and V into a ring of kStages stages guarded by mbarrier full /
//     empty pairs.  Copies land in 128-byte swizzled rows of 64 bf16, the
//     layout wgmma's descriptors read; out-of-bounds rows and columns come in
//     as zeros, so the ragged Sq / Sk tails and a head dim padded up to 64,
//     128 or 256 need no masked loads.
//   * A consumer computes S = Q K^T with wgmma.m64nBKk16 (Q and K both K-major
//     in shared memory: D is their contiguous axis), scales and masks S in
//     f32 registers (the element mask only on tiles that the band's edge or
//     Sk cuts), updates m and l, rescales its O accumulator, converts P to
//     bf16 pairs in registers and adds P V with wgmma.m64nDPk16, P as the
//     register A operand (S's accumulator layout is the A-fragment layout)
//     and V read MN-major through the transpose bit: no transposing copy.
//   * setmaxnreg hands the producer's registers to the consumers (40 / 232).
//   * Blocks are ordered heaviest causal q tile first and, within a tile,
//     the `group` query heads of one kv head next to each other, so K / V of
//     one (b, kv head) is read from L2 by the group.
//
// Tiles: BQ = 128 rows; BK = 128 keys at a padded head dim of 64 or 128,
// 64 keys at 256 (the 64 x 256 f32 O accumulator alone is 128 registers a
// thread); 2 stages: 82,984, 164,904 and 197,672 bytes of shared memory
// (Tiles::kSmem, with 1 KB of alignment slack).  ptxas: 168 registers at
// entry, 0 spills at every head dim.
//
// What bounds it on the card: operations.  4 * D flops per visible (query,
// key) pair: 137.4 GFLOP for causal prefill at B 4, H 32, S 2048, D 128,
// 0.139 ms at the 989 TFLOP/s bf16 tensor-core rate, against about 168 MB
// of q, k, v and o (0.050 ms at 3.35 TB/s).
#include <cstdint>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 128;                       // query rows per block
constexpr int kConsumers = 2;                  // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;                     // K / V ring depth
constexpr int kRowBytes = 128;                 // one swizzled row: 64 bf16
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

template <int DP>  // head dim padded to 64, 128 or 256
struct Tiles {
  static constexpr int kChunks = DP / 64;                // 64-column chunks of a row
  static constexpr int BK = DP == 256 ? 64 : 128;         // keys per tile
  static constexpr int kQBytes = kChunks * kBQ * kRowBytes;
  static constexpr int kChunkBytes = BK * kRowBytes;      // one chunk of a K or V tile
  static constexpr int kKVBytes = kChunks * kChunkBytes;  // a K (or V) tile
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + kBarBytes;
};

struct Params {
  __nv_bfloat16* o;
  float* lse;               // null, or f32 [B, H, Sq], contiguous
  long long o_b, o_h, o_s;  // element strides of o; its D stride is 1
  int B, KVH, group, Sq, Sk, D, n_qtiles;
  float scale_log2;         // scale * log2(e)
  int causal, window, q_offset;
  int pair_store;           // o's rows take aligned bf16 pairs
  MapAxes qa, ka, va;
};

// ---------------------------------------------------------------- PTX helpers
// A wgmma shared-memory descriptor for 128-byte swizzled rows: start address,
// leading and stride byte offsets (in 16-byte units), layout 1 = 128B swizzle.
// K-major operands (Q, K): 8-row groups 1024 bytes apart, LBO unused.
// MN-major (V): 8-key groups 1024 bytes apart, 64-column chunks LBO apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses to wgmma's registers across an
// asynchronous product
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x in one MUFU instruction: relative error about 2^-22, and a result
// below 2^-126 flushes to zero (such a p is below 2^-126 of its row's
// largest p, which is 1)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------ wgmma (m64nNk16, bf16)
// wgmma_ss_nN: d[0:N/2] (+)= A[64 x 16] . B[16 x N], A and B read from shared
// memory through descriptors, both K-major; `accumulate` 0 overwrites d.
// wgmma_rs_nN: d[0:N/2] += A[64 x 16] . B[16 x N], A from registers (four
// bf16 pairs a thread), B read MN-major (transpose bit set).
// d[i] of thread t of the warpgroup is row 16 (t / 32) + (t % 32) / 4 +
// 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + i % 2.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
      "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
      "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
      "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
      "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
      "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
      "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int accumulate) {
  static_assert(N == 64 || N == 128, "S tiles are 64 or 128 keys");
  if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, accumulate);
  } else {
    wgmma_ss_n128(d, a, b, accumulate);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b) {
  static_assert(N == 64 || N == 128 || N == 256, "head dims pad to 64, 128 or 256");
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, b);
  } else {
    wgmma_rs_n256(d, a, b);
  }
}

// ---------------------------------------------------------------- the kernel
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = Tiles<DP>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern repeats every 8 rows of 128 B
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [chunk][kBQ][64]
  const uint32_t k_s = q_s + T::kQBytes;                       // [stage][chunk][BK][64]
  const uint32_t v_s = k_s + kStages * T::kKVBytes;            // [stage][chunk][BK][64]
  const uint32_t bars = v_s + kStages * T::kKVBytes;
  const uint32_t q_full = bars;
  auto kv_full = [&](int s) { return bars + 8u * (1 + s); };
  auto kv_empty = [&](int s) { return bars + 8u * (1 + kStages + s); };

  // block -> (q tile, b, kv head, head in group): the group's heads are
  // neighbours, the heaviest causal tiles (the last rows) come first
  int t = blockIdx.x;
  const int g = t % p.group;
  t /= p.group;
  const int kvh = t % p.KVH;
  t /= p.KVH;
  const int b = t % p.B;
  const int q0 = (p.n_qtiles - 1 - t / p.B) * kBQ;
  const int h = kvh * p.group + g;

  // the key tiles this block's rows can see
  const int q_lo = q0 + p.q_offset;
  const int q_hi = min(q0 + kBQ, p.Sq) - 1 + p.q_offset;
  int k_begin = 0;
  int k_end = p.Sk;
  if (p.causal) k_end = min(p.Sk, max(q_hi + 1, 0));
  if (p.window > 0) k_begin = max(0, q_lo - p.window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(kv_empty(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load_rows(q_s + c * kBQ * kRowBytes, &tq, p.qa, q_full, 64 * c, q0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(kv_empty(s), ((it / kStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(kv_full(s), 2 * T::kKVBytes);
        const int kt = k_begin + it * BK;
        for (int c = 0; c < T::kChunks; ++c) {
          const uint32_t off = s * T::kKVBytes + c * T::kChunkBytes;
          tma_load_rows(k_s + off, &tk, p.ka, kv_full(s), 64 * c, kt, kvh, b);
          tma_load_rows(v_s + off, &tv, p.va, kv_full(s), 64 * c, kt, kvh, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int w0 = q0 + 64 * wg;                      // this warpgroup's first row
    const int row0 = w0 + 16 * (tid / 32) + lane / 4;  // this thread's rows: row0, row0 + 8
    const int col0 = 2 * (lane % 4);                   // and columns 8 j + col0 (+1)
    const bool live = w0 < p.Sq;
    const int w_lo = w0 + p.q_offset;                  // positions of the warpgroup's rows
    const int w_hi = min(w0 + 64, p.Sq) - 1 + p.q_offset;
    const int pos[2] = {row0 + p.q_offset, row0 + 8 + p.q_offset};

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {kMasked, kMasked};
    float l[2] = {0.f, 0.f};
    const uint32_t q_rows = q_s + 64 * wg * kRowBytes;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int kt = k_begin + it * BK;
      mbar_wait(kv_full(s), (it / kStages) & 1);
      const bool seen = live && (!p.causal || kt <= w_hi) &&
                        (p.window <= 0 || kt + BK - 1 > w_lo - p.window);
      if (seen) {
        // S = Q K^T over the padded head dim, 16 columns per wgmma
        float sc[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
        const uint32_t k_tile = k_s + s * T::kKVBytes;
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da = smem_desc(q_rows + c * kBQ * kRowBytes + 32 * kk, 16, 1024);
            const uint64_t db = smem_desc(k_tile + c * T::kChunkBytes + 32 * kk, 16, 1024);
            wgmma_ss<BK>(sc, da, db, (c | kk) != 0);
          }
        }
        wgmma_commit();
        reg_fence<BK / 2>(sc);
        wgmma_wait_all();
        reg_fence<BK / 2>(sc);

        // the element mask, only where the band's edge or Sk cuts the tile
        const bool edge = kt + BK > p.Sk || (p.causal && kt + BK - 1 > w_lo) ||
                          (p.window > 0 && kt <= w_hi - p.window);
        auto ok = [&](int i) {
          const int key = kt + 8 * (i / 4) + col0 + i % 2;
          const int qp = pos[(i / 2) % 2];
          return key < p.Sk && (!p.causal || key <= qp) && (p.window <= 0 || key > qp - p.window);
        };
        float mx[2] = {kMasked, kMasked};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          float x = sc[i] * p.scale_log2;
          if (edge && !ok(i)) x = kMasked;
          sc[i] = x;
          mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // a row's 4 threads are lanes 4 j .. 4 j + 3
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          alpha[r] = exp2_approx(m[r] - m_new);
          m[r] = m_new;
        }
        // p = ok ? exp(s - m) : 0: a row with no visible key so far has
        // m = -1e30, where exp(s - m) of a masked s would be 1
        float rs[2] = {0.f, 0.f};
        uint32_t pa[BK / 4];  // P in bf16 pairs: the A fragments of P V
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          float e = exp2_approx(sc[i] - m[(i / 2) % 2]);
          if (edge && !ok(i)) e = 0.f;
          sc[i] = e;
          rs[(i / 2) % 2] += e;
        }
#pragma unroll
        for (int j = 0; j < BK / 4; ++j) pa[j] = bf16_pair(sc[2 * j], sc[2 * j + 1]);
        l[0] = l[0] * alpha[0] + rs[0];
        l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i / 2) % 2];

        // O += P V, 16 keys per wgmma; V's 8-key groups are 1024 bytes apart
        // and its 64-column chunks one chunk apart
        const uint32_t v_tile = v_s + s * T::kKVBytes;
        wgmma_fence();
        reg_fence<DP / 2>(o);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = smem_desc(v_tile + 16 * kRowBytes * kk, T::kChunkBytes, 1024);
          wgmma_rs<DP>(o, &pa[4 * kk], dv);
        }
        wgmma_commit();
        reg_fence<DP / 2>(o);
        wgmma_wait_all();
        reg_fence<DP / 2>(o);
      }
      mbar_arrive(kv_empty(s));
    }

    // o = acc / where(l > 0, l, 1), rows below Sq, columns below D
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (p.lse != nullptr && live && lane % 4 == 0 && row < p.Sq) {
        p.lse[(static_cast<long long>(b) * p.KVH * p.group + h) * p.Sq + row] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : neg_inf();
      }
      l[r] = l[r] > 0.f ? l[r] : 1.f;
    }
    if (live) {
      __nv_bfloat16* ob = p.o + b * p.o_b + h * p.o_h;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= p.Sq) continue;
        __nv_bfloat16* orow = ob + row * p.o_s;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = 8 * j + col0;
          const float v0 = o[4 * j + 2 * r] / l[r];
          const float v1 = o[4 * j + 2 * r + 1] / l[r];
          if (p.pair_store && col + 1 < p.D) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (col < p.D) orow[col] = __float2bfloat16_rn(v0);
            if (col + 1 < p.D) orow[col + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- host side
template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* st, int B, int H, int KVH, int Sq, int Sk, int D, float scale,
           int causal, int window, int q_offset, cudaStream_t stream) {
  using T = Tiles<DP>;
  CUtensorMap tq, tk, tv;
  Params p{};
  int err = make_map(&tq, &p.qa, q, 2, B, H, Sq, D, st, kBQ);
  if (err == 0) err = make_map(&tk, &p.ka, k, 2, B, KVH, Sk, D, st + 3, T::BK);
  if (err == 0) err = make_map(&tv, &p.va, v, 2, B, KVH, Sk, D, st + 6, T::BK);
  if (err != 0) return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.o_b = st[9];
  p.o_h = st[10];
  p.o_s = st[11];
  p.B = B;
  p.KVH = KVH;
  p.group = H / KVH;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.n_qtiles = (Sq + kBQ - 1) / kBQ;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.pair_store = D % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 4 == 0 && st[9] % 2 == 0 &&
                 st[10] % 2 == 0 && st[11] % 2 == 0;
  const long long blocks = static_cast<long long>(p.n_qtiles) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_sm90<DP>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(blocks), kThreads, T::kSmem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, Sq, D], k and v [B, KVH, Sk, D], o like q, all bf16, each with
// element strides (b, head, seq) in `strides` (q, k, v, o: 12 values, host
// memory) and a unit D stride.  q, k and v start on 16-byte boundaries and
// their strides are multiples of 8 elements (TMA's rule).  lse is null or
// f32 [B, H, Sq], contiguous.  window <= 0 means no window.  Returns 0, a
// CUDA error code, or 1001 (no driver entry point), 1002 (misaligned
// operand), 1100 + a CUresult (tensor map refused).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int H, int KVH, int Sq, int Sk, int D,
                                      const long long* strides, float scale, int causal,
                                      int window, int q_offset, void* stream) {
  if (B < 1 || H < 1 || KVH < 1 || H % KVH != 0 || Sq < 1 || Sk < 1 || D < 1 || D > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto run = D <= 64 ? launch<64> : D <= 128 ? launch<128> : launch<256>;
  return run(q, k, v, o, static_cast<float*>(lse), strides, B, H, KVH, Sq, Sk, D, scale,
             causal, window, q_offset, s);
}
