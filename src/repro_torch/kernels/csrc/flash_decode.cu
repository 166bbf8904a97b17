// Single-token GQA flash decode over a KV cache for Hopper (sm_90a): a
// persistent TMA ring over the cache, one launch a call.
//
// Replaces the Pallas TPU kernel `flash_decode_pallas`
// (src/repro/kernels/flash_decode.py).  For batch b and query head h (kv
// head h / group), over cache slots j < kv_len[b] (kv_len clamped to
// [0, Sk]):
//
//   s(j) = (scale * q[b, h]) . k[b, j, h / group]
//   m    = max_j s(j)            (-1e30 when no slot is valid)
//   l    = sum_j exp(s(j) - m)
//   o    = sum_j exp(s(j) - m) v[b, j, h / group]      (un-normalised)
//
// all in f32, whatever the cache's type (f32 or bf16): the TPU kernel's
// partials.  Asked for the normalised output instead, the kernel writes
// o / (l > 0 ? l : 1) rounded to q's type, as `ops.flash_decode` does.
//
// What bounds it on the card: bytes.  The valid cache (2 * B * kv_len * KVH
// * D elements) is read once; the flops, 4 * H * D per valid slot, are about
// one per byte of bf16 cache (the card does ~300 bf16 flops per byte).  At
// the main path's shape (B 4, H 32, KVH 8, Sk 2,112, D 128, bf16) that is
// 34.6 MB, 0.0104 ms at 3.35 TB/s.
//
// Design.
//
//   * Balanced persistent grid.  The cache is cut into tiles of 64 slots of
//     one (b, kv head) pair; the pairs' tiles, laid end to end, are a flat
//     range of B * KVH * ceil(Sk / 64) tiles that is cut into `blocks`
//     ranges (one block per SM) whose lengths differ by at most one (the
//     wrapper's `decode_splits`).  A block's range may span the end of one
//     pair and the start of the next: each piece of a pair is a segment.
//     The cut is made on Sk (kv_len lives on the device); a tile wholly past
//     kv_len[b] is neither loaded nor computed.
//   * A TMA ring.  One producer thread loads each tile of K and V with
//     cp.async.bulk.tensor through tensor maps over the strided cache views
//     (boxes of 128 bytes of columns x 64 slots x 1 head x 1 batch, 128-byte
//     swizzle, zero fill past D and Sk) into a ring of kStages stages guarded
//     by full / empty mbarriers.  K and V stay in the cache's type in shared
//     memory.  At bf16, D 128, a stage is 32 KB and the ring 4 stages:
//     128 KB in flight per SM (Little's law asks about 26 KB per SM of
//     3.35 TB/s at ~1 us of latency).
//   * Eight consumer warps and one producer warp (288 threads: the SM's
//     four register files then allow 168 registers a thread), no block-wide
//     barrier per tile.  Warps take the group's query heads kH at a time (4;
//     2 when a lane holds 8 columns, D_pad 256, to stay in the registers)
//     and the tile's slots in equal shares, in batches of 8 slots.  A lane
//     holds D_pad / 32 columns of the warp's scaled query heads in f32
//     registers; it reads those columns of each slot's K and V row (4 to 16
//     bytes, conflict-free through the swizzle), forms partial dots for 8
//     slots x kH heads and folds them across the warp with a transposing
//     shuffle reduction (lane i keeps slot i / kH, head i % kH).  Each warp
//     keeps its own online softmax (m, l, o) over its slots, with expf; p
//     stays f32 and P . V runs on the CUDA cores in f32, which holds
//     (o, m, l) to the 2e-5 of the checks (the scores are f32 products of
//     f32 operands, as in the reference; tensor-core products would round p
//     or need a split of it).  A warp signals the empty barrier when its
//     lanes are done with a stage.
//   * One launch a call.  At a segment's end the warps' states are merged in
//     warp order through shared memory with the algebra of `lse_combine`
//     (M = max m_w, o = sum o_w exp(m_w - M), l likewise; warp 0 turns the
//     m's into weights, a lane per (head, warp)).  A pair that one block
//     holds whole is written out directly.  Otherwise the pair's last block
//     merges its segments: the other blocks write their segment's (o, m, l)
//     to a workspace and add one to the pair's counter (red.release) and
//     are done; the last block, at the end of its range, waits for the
//     count (ld.acquire; it waits only on blocks of lower index, which the
//     card starts first), merges the segments in range order, writes
//     (o, m, l) or the normalised output, and sets the counter back to 0 for
//     the next call or graph replay.  The counters are a per-device buffer
//     that the wrapper zeroes once: calls on two streams at once are not
//     supported.
//
// Shared memory per block: the ring, the warps' merge scratch (8 x (8 + 4
// D_pad) floats) and 8 x 32 floats of p; at bf16 D 128 about 150 KB, so one
// block per SM.  The segment merge at a block's end reuses the ring.
#include <cstdint>
#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kSlots = 64;                  // cache slots per tile
constexpr int kWarps = 8;                   // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kBoxBytes = kSlots * 128;     // one box: 64 slots x 128 bytes
constexpr int kRing = 131072;               // bytes of ring to aim for
constexpr int kMaxBlocks = 256;             // a pair's merge stages 2 x 16 floats a block
constexpr float kMasked = -1e30f;

template <typename T, int NB>  // NB boxes of 128 bytes cover a row of D
struct Tiles {
  static constexpr int kBoxCols = 128 / static_cast<int>(sizeof(T));
  static constexpr int kDPad = NB * kBoxCols;  // head dim padded to whole boxes
  static constexpr int kCols = kDPad / 32;     // columns a lane holds
  static constexpr int kHeads = kCols <= 4 ? 4 : 2;  // query heads a warp holds (registers)
  static constexpr int kStage = 2 * NB * kBoxBytes;  // a tile of K and of V
  static constexpr int kStages = kRing / kStage < 1 ? 1 : kRing / kStage > 4 ? 4 : kRing / kStage;
  static constexpr int kScratch = 8 + 4 * kDPad;  // floats a warp: m[4], l[4], o[4][kDPad]
  // ring, scratch, p of 8 slots x 4 heads a warp, full and empty barriers
  static constexpr int kSmem = 1024 + kStages * kStage + 4 * kWarps * (kScratch + 32) +
                               16 * kStages;
  static_assert(kStages * kStage >= 4 * (2 * kMaxBlocks * 16 + 32), "merge room in the ring");
};

struct Params {
  const void* q;
  long long q_b, q_h, q_d;    // element strides of q [B, H, D]
  const void* kv_len;
  int len64;                  // kv_len is int64 (else int32)
  float *o, *m, *l;           // the partials, or null
  void* out;                  // the normalised output in q's type, or null
  float* work;                // (pairs + blocks) entries of group * (D + 2) floats
  int* count;                 // per-pair arrival counters, zero between calls
  int KVH, G, Sk, D, tiles;   // tiles: per (b, kv head) pair
  int total;                  // tiles of all pairs (total x blocks < 2^31)
  int blocks;
  float scale;
  MapAxes ka, va;
};

__device__ __forceinline__ int seq_len(const Params& p, int b) {
  const long long n = p.len64 ? static_cast<const long long*>(p.kv_len)[b]
                              : static_cast<const int*>(p.kv_len)[b];
  return n < 0 ? 0 : n > p.Sk ? p.Sk : static_cast<int>(n);
}

// the block whose range holds flat tile t: range i is [i T / n, (i + 1) T / n)
__device__ __forceinline__ int block_of(const Params& p, int t) {
  return static_cast<int>((static_cast<unsigned>(t + 1) * p.blocks - 1) / p.total);
}

// the number of blocks whose ranges hold some of the pair's tiles
__device__ __forceinline__ int nseg_of(const Params& p, int pair) {
  return block_of(p, (pair + 1) * p.tiles - 1) - block_of(p, pair * p.tiles) + 1;
}

// add one to a pair's arrival counter, after this block's writes (release)
__device__ __forceinline__ void arrive(int* count) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(count) : "memory");
}

// wait until the other blocks of a pair have arrived (acquire).  It waits
// only on blocks of lower index, which the card starts first, so there is
// no cycle; a count that never comes (a counter left dirty by a failed
// launch) traps after about a second instead of hanging the card.
__device__ __forceinline__ void wait_count(const int* count, int target) {
  const long long t0 = clock64();
  int v;
  for (;;) {
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(count) : "memory");
    if (v >= target) return;
    if (clock64() - t0 > 2000000000LL) __trap();
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__device__ __forceinline__ void unpack(float* out, uint32_t w) {
  if constexpr (sizeof(T) == 2) {
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    out[0] = __uint_as_float(w);
  }
}

// this lane's kCols columns of row `row` of a swizzled tile, as f32: the
// row's 16-byte chunk c of box k sits at chunk c ^ (row % 8) of its 128 bytes
template <typename T, int NB>
__device__ __forceinline__ void load_row(float* out, const uint8_t* tile, int row, int lane) {
  using TL = Tiles<T, NB>;
  constexpr int kBytes = TL::kCols * static_cast<int>(sizeof(T));
  constexpr int kPiece = kBytes < 16 ? kBytes : 16;
  constexpr int kPer = kPiece / static_cast<int>(sizeof(T));
#pragma unroll
  for (int pc = 0; pc < kBytes / kPiece; ++pc) {
    const int ob = lane * kBytes + pc * kPiece;
    const uint8_t* src = tile + (ob >> 7) * kBoxBytes + row * 128 +
                         ((((ob >> 4) & 7) ^ (row & 7)) << 4) + (ob & 15);
    float* dst = out + pc * kPer;
    constexpr int kEach = 4 / static_cast<int>(sizeof(T));  // values per 32-bit word
    if constexpr (kPiece == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(src);
      unpack<T>(dst, u.x);
      unpack<T>(dst + kEach, u.y);
      unpack<T>(dst + 2 * kEach, u.z);
      unpack<T>(dst + 3 * kEach, u.w);
    } else if constexpr (kPiece == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      unpack<T>(dst, u.x);
      unpack<T>(dst + kEach, u.y);
    } else {
      unpack<T>(dst, *reinterpret_cast<const uint32_t*>(src));
    }
  }
}

// one step of the transposing reduction: N values a lane -> N / 2, the lane
// keeping the upper half when its bit N / 2 is set
template <int N>
__device__ __forceinline__ void fold(float* x, int lane) {
  constexpr int H = N / 2;
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? x[i] : x[H + i];
    const float keep = upper ? x[H + i] : x[i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// the final (o, m, l) of row (b, h), column d: the partials or the output
template <typename T>
__device__ __forceinline__ void emit(const Params& p, long long row, int d, float o, float m,
                                     float l) {
  if (p.out != nullptr) {
    store(static_cast<T*>(p.out) + row * p.D + d, o / (l > 0.f ? l : 1.f));
    return;
  }
  p.o[row * p.D + d] = o;
  if (d == 0) {
    p.m[row] = m;
    p.l[row] = l;
  }
}

// The last block of a pair merges the pair's segments (the workspace
// entries pair + first .. pair + last) in range order, with the algebra of
// `lse_combine`: M = max m_k, o = sum o_k exp(m_k - M), l likewise.  The
// segments' m and l go to shared memory (`sm`, the ring, idle by then);
// each thread's first two columns of the first 8 segments are loaded
// before, so that one round trip to L2 serves the usual merge.
template <typename T>
__device__ void merge_pair(const Params& p, int pair, int tid, float* sm) {
  constexpr int kPre = 8;
  const int G = p.G, D = p.D, GD = G * D;
  const int first = block_of(p, pair * p.tiles);
  const int nseg = nseg_of(p, pair);
  const int stride = G * (D + 2);  // floats of one workspace entry
  const float* en0 = p.work + (static_cast<long long>(pair) + first) * stride;
  float* w = sm;                   // [nseg][G]: m, then the weights
  float* ls = w + nseg * G;        // [nseg][G]: l
  float* ml = ls + nseg * G;       // [2][G]: the merged m and l
  const int e0 = tid, e1 = tid + kConsumers;
  float x0[kPre], x1[kPre];
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    x0[k] = k < nseg && e0 < GD ? __ldcg(en0 + k * stride + e0) : 0.f;
    x1[k] = k < nseg && e1 < GD ? __ldcg(en0 + k * stride + e1) : 0.f;
  }
  for (int i = tid; i < nseg * G; i += kConsumers) {
    const int k = i / G;
    const float* en = en0 + k * stride + GD + (i - k * G);
    w[i] = __ldcg(en);
    ls[i] = __ldcg(en + G);
  }
  consumers_sync();
  if (tid < G) {
    float mm = kMasked;
    for (int k = 0; k < nseg; ++k) mm = fmaxf(mm, w[k * G + tid]);
    float ll = 0.f;
    for (int k = 0; k < nseg; ++k) {
      const float a = expf(w[k * G + tid] - mm);
      w[k * G + tid] = a;
      ll += ls[k * G + tid] * a;
    }
    ml[tid] = mm;
    ml[G + tid] = ll;
  }
  consumers_sync();
  auto column = [&](int e, const float* pre) {
    const int g = e / D;
    float o = 0.f;
    int k = 0;
    if (pre != nullptr) {  // segments past nseg were loaded as 0
#pragma unroll
      for (int i = 0; i < kPre; ++i) o += pre[i] * w[min(i, nseg - 1) * G + g];
      k = kPre;
    }
    for (; k < nseg; ++k) o += __ldcg(en0 + k * stride + e) * w[k * G + g];
    emit<T>(p, static_cast<long long>(pair) * G + g, e - g * D, o, ml[g], ml[G + g]);
  };
  if (e0 < GD) column(e0, x0);
  if (e1 < GD) column(e1, x1);
  for (int e = tid + 2 * kConsumers; e < GD; e += kConsumers) column(e, nullptr);
  if (tid == 0) p.count[pair] = 0;  // clean for the next call
}

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_sm90(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const Params p) {
  using TL = Tiles<T, NB>;
  constexpr int kCols = TL::kCols;
  constexpr int kStages = TL::kStages;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern repeats every 8 rows of 128 B
  uint8_t* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* scratch = reinterpret_cast<float*>(ring + kStages * TL::kStage);
  float* pbuf = scratch + kWarps * TL::kScratch;  // [warp][slot * kH + head]
  uint64_t* bar = reinterpret_cast<uint64_t*>(pbuf + kWarps * 32);
  const uint32_t ring_u32 = smem_u32(ring);
  auto full = [&](int s) { return smem_u32(bar + s); };
  auto empty = [&](int s) { return smem_u32(bar + kStages + s); };

  const int blk = blockIdx.x;
  const int t_begin = static_cast<int>(static_cast<unsigned>(blk) * p.total / p.blocks);
  const int t_end = static_cast<int>(static_cast<unsigned>(blk + 1) * p.total / p.blocks);

  // the producer's first kv_len load and descriptors are in flight during
  // the set-up
  const int b_first = t_begin / p.tiles / p.KVH;
  const int len_first = threadIdx.x == kConsumers ? seq_len(p, b_first) : 0;
  if (threadIdx.x == kConsumers) {
    tma_prefetch(&tk);
    tma_prefetch(&tv);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= kWarps) {
    // ---------------------------------------------------------------- producer
    if (threadIdx.x == kConsumers) {
      int it = 0, len_b = b_first, len = len_first;
      for (int t = t_begin; t < t_end; ++t) {
        const int pair = t / p.tiles;
        const int j = t - pair * p.tiles;
        const int b = pair / p.KVH;
        const int kvh = pair - b * p.KVH;
        if (b != len_b) {  // one global load a batch row, not one in front of every copy
          len = seq_len(p, b);
          len_b = b;
        }
        if (j * kSlots >= len) continue;
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full(s), TL::kStage);
        const uint32_t dst = ring_u32 + s * TL::kStage;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load_rows(dst + c * kBoxBytes, &tk, p.ka, full(s), c * TL::kBoxCols, j * kSlots,
                        kvh, b);
          tma_load_rows(dst + (NB + c) * kBoxBytes, &tv, p.va, full(s), c * TL::kBoxCols,
                        j * kSlots, kvh, b);
        }
        ++it;
      }
    }
  } else {
    // ---------------------------------------------------------------- consumers
    const int tid = threadIdx.x;
    constexpr int kH = TL::kHeads;
    int n_hg = 1;  // head groups of kH: warps that share a tile's slots
    while (n_hg * kH < p.G) n_hg *= 2;
    const int hg = warp % n_hg;               // this warp's heads: kH hg .. kH hg + kH - 1
    const int spw = kSlots * n_hg / kWarps;   // slots of a tile this warp takes
    const int r_first = (warp / n_hg) * spw;
    const int h_own = lane % kH;  // after the fold: slot (lane % (8 kH)) / kH, head lane % kH
    float* mine = scratch + warp * TL::kScratch;
    float* pw = pbuf + warp * 32;
    // a segment's q and kv_len are loaded one segment ahead where the
    // registers allow, so that a block whose range spans two pairs does not
    // wait for them at the boundary
    constexpr bool kAhead = kCols * sizeof(T) <= 8;
    T q_raw[kH][kCols];
    int len_next = 0;
    auto fetch = [&](int pair) {
      const int b = pair / p.KVH;
      const int kvh = pair - b * p.KVH;
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const int g = kH * hg + h;
        const T* qh = static_cast<const T*>(p.q) + b * p.q_b + (kvh * p.G + g) * p.q_h;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane * kCols + c;
          q_raw[h][c] = g < p.G && d < p.D ? qh[d * p.q_d] : static_cast<T>(0.f);
        }
      }
      len_next = seq_len(p, b);
    };
    int it = 0;
    int owed = -1;  // the shared pair this block merges at its end
    int t = t_begin;
    fetch(t / p.tiles);
    while (t < t_end) {
      const int pair = t / p.tiles;
      const int seg_end = min(t_end, (pair + 1) * p.tiles);
      // the blocks that hold the pair's tiles: a pair whose tiles are all
      // this block's is written out whole
      const int first = block_of(p, pair * p.tiles);
      const int last = block_of(p, (pair + 1) * p.tiles - 1);
      const bool shared = first != last;
      if (!kAhead && t != t_begin) fetch(pair);
      const int len = len_next;

      // this lane's columns of the warp's query heads, times scale, in f32
      float qr[kH][kCols];
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int c = 0; c < kCols; ++c) qr[h][c] = to_f32(q_raw[h][c]) * p.scale;
      if (kAhead && seg_end < t_end) fetch(pair + 1);
      float m[kH], acc[kH][kCols];
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        m[h] = kMasked;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[h][c] = 0.f;
      }
      float l_lane = 0.f;  // sum of p over this lane's (slot, head) positions

      for (; t < seg_end; ++t) {
        const int s0 = (t - pair * p.tiles) * kSlots;
        if (s0 >= len) continue;  // not loaded
        const int s = it % kStages;
        mbar_wait(full(s), (it / kStages) & 1);
        const uint8_t* kt = ring + s * TL::kStage;
        const uint8_t* vt = kt + NB * kBoxBytes;
        for (int r0 = r_first; r0 < r_first + spw && s0 + r0 < len; r0 += 8) {
          // partial dots of 8 slots x kH heads over this lane's columns
          float x[8 * kH];
#pragma unroll
          for (int sl = 0; sl < 8; ++sl) {
            float kv[kCols];
            load_row<T, NB>(kv, kt, r0 + sl, lane);
#pragma unroll
            for (int h = 0; h < kH; ++h) {
              float dot = 0.f;
#pragma unroll
              for (int c = 0; c < kCols; ++c) dot = __fmaf_rn(qr[h][c], kv[c], dot);
              x[kH * sl + h] = dot;
            }
          }
          if constexpr (kH == 4) fold<32>(x, lane);
          fold<16>(x, lane);
          fold<8>(x, lane);
          fold<4>(x, lane);
          fold<2>(x, lane);
          if constexpr (kH == 2) x[0] += __shfl_xor_sync(0xffffffffu, x[0], 16);
          const bool ok = s0 + r0 + (lane % (8 * kH)) / kH < len;
          const float sc = ok ? x[0] : kMasked;
          float mx = sc;  // the max over the batch's 8 slots of this lane's head
#pragma unroll
          for (int off = kH; off < 8 * kH; off *= 2)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          float alpha[kH], a_own = 1.f, m_own = kMasked;
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            const float m_new = fmaxf(m[h], __shfl_sync(0xffffffffu, mx, h));
            alpha[h] = expf(m[h] - m_new);
            m[h] = m_new;
            if (h == h_own) {
              a_own = alpha[h];
              m_own = m_new;
            }
          }
          // p = ok ? exp(s - m) : 0: a head with no valid slot so far has
          // m = -1e30, where exp(s - m) of a masked s would be 1
          const float pr = ok ? expf(sc - m_own) : 0.f;
          l_lane = l_lane * a_own + pr;
          __syncwarp();  // the previous batch's readers of pw are done
          pw[lane] = pr;
          __syncwarp();
#pragma unroll
          for (int h = 0; h < kH; ++h)
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[h][c] *= alpha[h];
#pragma unroll
          for (int sl = 0; sl < 8; ++sl) {
            float vv[kCols];
            load_row<T, NB>(vv, vt, r0 + sl, lane);
            float pv[kH];
            if constexpr (kH == 4) {
              const float4 ps = reinterpret_cast<const float4*>(pw)[sl];
              pv[0] = ps.x, pv[1] = ps.y, pv[2] = ps.z, pv[3] = ps.w;
            } else {
              const float2 ps = reinterpret_cast<const float2*>(pw)[sl];
              pv[0] = ps.x, pv[1] = ps.y;
            }
#pragma unroll
            for (int h = 0; h < kH; ++h)
#pragma unroll
              for (int c = 0; c < kCols; ++c) acc[h][c] = __fmaf_rn(pv[h], vv[c], acc[h][c]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
        ++it;
      }

      // ------------------------------------------------------------ segment end
      float l_h = l_lane;  // the sum over the 8 slot lanes of this lane's head
#pragma unroll
      for (int off = kH; off < 8 * kH; off *= 2) l_h += __shfl_xor_sync(0xffffffffu, l_h, off);
      if (lane == 0) {
#pragma unroll
        for (int h = 0; h < kH; ++h) mine[h] = m[h];
      }
      if (lane < kH) mine[4 + lane] = l_h;
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int c = 0; c < kCols; ++c) mine[8 + h * TL::kDPad + lane * kCols + c] = acc[h][c];
      consumers_sync();

      // the warps' states merged in warp order.  Warp 0 turns every warp's
      // m into its weight exp(m_w - M) in place, a lane per (head, warp):
      // the head's warps are lanes of one group of n_sg = 8 / n_hg.
      const int G = p.G, D = p.D;
      const int n_sg = kWarps / n_hg;
      float* ml = pbuf;  // [2][16]: the merged m and l (p is not in use here)
      if (warp == 0) {
        const bool act = lane < kH * kWarps;
        const int gp = lane / n_sg;  // head 0 .. kH n_hg - 1
        float* sw = scratch + (act ? gp / kH + (lane % n_sg) * n_hg : 0) * TL::kScratch;
        const float mw = act ? sw[gp % kH] : kMasked;
        float mm = mw;
        for (int off = 1; off < n_sg; off *= 2)
          mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
        const float a = expf(mw - mm);
        const float la = act ? sw[4 + gp % kH] * a : 0.f;
        float ll = 0.f;  // in warp order
        for (int j = 0; j < n_sg; ++j) ll += __shfl_sync(0xffffffffu, la, lane - lane % n_sg + j);
        __syncwarp();
        if (act) sw[gp % kH] = a;
        if (act && lane % n_sg == 0 && gp < G) {
          ml[gp] = mm;
          ml[16 + gp] = ll;
        }
      }
      consumers_sync();
      float* entry = p.work + static_cast<long long>(pair + blk) * G * (D + 2);
      constexpr int kRows = kConsumers / TL::kDPad;  // heads a pass covers
      const int d = tid % TL::kDPad;
      for (int g = tid / TL::kDPad; g < G && d < D; g += kRows) {
        const float* sw = scratch + (g / kH) * TL::kScratch;
        const int hh = g % kH;
        float x[kWarps], wt[kWarps];  // the loads first, no branches: warps past n_sg weigh 0
#pragma unroll
        for (int j = 0; j < kWarps; ++j) {
          const float* sj = sw + min(j, n_sg - 1) * n_hg * TL::kScratch;
          x[j] = sj[8 + hh * TL::kDPad + d];
          wt[j] = j < n_sg ? sj[hh] : 0.f;
        }
        float o = 0.f;
#pragma unroll
        for (int j = 0; j < kWarps; ++j) o += x[j] * wt[j];
        if (!shared) {
          emit<T>(p, static_cast<long long>(pair) * G + g, d, o, ml[g], ml[16 + g]);
        } else {
          entry[g * D + d] = o;
          if (d == 0) {
            entry[G * D + g] = ml[g];
            entry[G * D + G + g] = ml[16 + g];
          }
        }
      }
      consumers_sync();  // entries written; scratch free for the next segment
      // A shared segment's pair is merged by its last block: the others add
      // one to the pair's counter after their entries (the barrier above
      // orders every thread's entry before thread 0's release) and are done.
      // Only a block's first segment can end a shared pair, so a block owes
      // at most one merge; it makes it at its end, the next tiles first.
      if (shared && last != blk && tid == 0) arrive(p.count + pair);
      if (shared && last == blk) owed = pair;
      if (t < t_end) continue;
      if (owed >= 0) {
        if (tid == 0) wait_count(p.count + owed, nseg_of(p, owed) - 1);
        consumers_sync();
        merge_pair<T>(p, owed, tid, reinterpret_cast<float*>(ring));  // every tile is consumed
      }
    }
  }
}

template <typename T, int NB>
int launch(const CUtensorMap& tk, const CUtensorMap& tv, const Params& p, cudaStream_t stream) {
  using TL = Tiles<T, NB>;
  auto kernel = flash_decode_sm90<T, NB>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(p.blocks), kThreads, TL::kSmem, stream>>>(tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, D] with element strides (b, h, d); k and v [B, Sk, KVH, D] with
// element strides (b, head, slot) and a unit D stride, each starting on a
// 16-byte boundary with strides that are multiples of 16 bytes (TMA's rule);
// `strides` holds q's 3 then k's and v's (b, head, slot): 9 values, host
// memory.  f32 (dtype 0) or bf16 (dtype 1).  kv_len int32[B] or, with
// len64, int64[B]; clamped to [0, Sk] here.  With `out` null the kernel
// writes the f32 partials o [B, H, D], m and l [B, H] (contiguous); else the
// normalised output `out` [B, H, D] in q's type.  `work` holds (B * KVH +
// blocks) * (H / KVH) * (D + 2) floats; `count` B * KVH zeroed ints, which
// the kernel leaves zeroed.  `blocks` is the number of ranges the flat tile
// range is cut into (at most one per SM: the kernel's shared memory keeps one
// block on an SM), at most 256; the B * KVH * ceil(Sk / 64) tiles must stay
// below 2^23.  Returns 0, a CUDA error code, or 1001 (no
// cuTensorMapEncodeTiled), 1002 (misaligned cache), 1100 + a CUresult (tensor
// map refused).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* kv_len, int len64, void* o, void* m, void* l,
                                   void* out, void* work, void* count, int dtype, int B, int H,
                                   int KVH, int Sk, int D, const long long* strides, float scale,
                                   int blocks, void* stream) {
  const int group = KVH > 0 ? H / KVH : 0;
  const int tiles = (Sk + kSlots - 1) / kSlots;
  const long long total = static_cast<long long>(B) * KVH * tiles;
  if (B < 1 || H < 1 || KVH < 1 || H % KVH != 0 || group > 16 || Sk < 1 || D < 1 || D > 256 ||
      blocks < 1 || blocks > total || blocks > kMaxBlocks ||
      total * kMaxBlocks >= (1LL << 31) || work == nullptr || count == nullptr ||
      (out == nullptr && (o == nullptr || m == nullptr || l == nullptr)) ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int elem = dtype == 1 ? 2 : 4;
  Params p{};
  CUtensorMap tk, tv;
  int err = make_map(&tk, &p.ka, k, elem, B, KVH, Sk, D, strides + 3, kSlots);
  if (err == 0) err = make_map(&tv, &p.va, v, elem, B, KVH, Sk, D, strides + 6, kSlots);
  if (err != 0) return err;
  p.q = q;
  p.q_b = strides[0];
  p.q_h = strides[1];
  p.q_d = strides[2];
  p.kv_len = kv_len;
  p.len64 = len64;
  p.o = static_cast<float*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.out = out;
  p.work = static_cast<float*>(work);
  p.count = static_cast<int*>(count);
  p.KVH = KVH;
  p.G = group;
  p.Sk = Sk;
  p.D = D;
  p.tiles = tiles;
  p.total = static_cast<int>(total);
  p.blocks = blocks;
  p.scale = scale;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D <= 64) return launch<__nv_bfloat16, 1>(tk, tv, p, s);
    if (D <= 128) return launch<__nv_bfloat16, 2>(tk, tv, p, s);
    return launch<__nv_bfloat16, 4>(tk, tv, p, s);
  }
  if (D <= 32) return launch<float, 1>(tk, tv, p, s);
  if (D <= 64) return launch<float, 2>(tk, tv, p, s);
  if (D <= 128) return launch<float, 4>(tk, tv, p, s);
  return launch<float, 8>(tk, tv, p, s);
}
