// The Hopper attention core of K6 (flash_prefill.cu), K6'
// (flash_prefill_paged.cu), K11 (splash_prefill.cu) and K12's chunks
// (ragged_attention.cu): 128 query rows a work item against tiles of keys,
// bf16 in and out. A configuration (Core) gives the head dim D (128 or
// 256), the keys of a K/V tile (128, or 64 at D = 256), the ring's stages,
// and whether a stage's K and V are freed apart; K6 and K6' run Core<128,
// 128, 3>, K11 and K12's chunks ChunkCore: Core<128, 128, 3, true> and
// Core<256, 64, 2, true>.
//
// The grid is persistent: one block an SM walks work items in the order
// the instantiation gives (the items with the most key tiles first), so
// that a block's next item loads while its last one ends. A block of
// mrt::kRowThreads threads runs the ring of common.cuh without a decode
// step (mrt::Ring<Stage, kStages, false>) over all its items' key tiles:
// - the four producer warps load an item's Q tile once and the K and V
//   tiles of every key step with TMA (cp.async.bulk.tensor) into a ring of
//   kStages stages, a piece each (K or V, half of its 64-column blocks: one
//   at D = 128, two at D = 256): K and Q counted on the stage's `full`
//   mbarrier and V on its `ready` one, so that a Q.K^T starts before its V
//   has landed (a warp issues its lanes' TMA copies one after another, so a
//   stage of one-page boxes needs the four); the instantiation says where a
//   tile comes from (the chunk's own K/V, or pages through a block table);
// - two consumer warpgroups own 64 query rows each. Per key tile:
//   S = Q K^T as D/16 bf16 wgmma m64nKk16 (Q and K from shared memory,
//   K-major), an optional logit transform (K11's and K12's soft cap) in
//   f32, a base-2 online softmax in f32, P rounded to bf16 in registers,
//   and O += P V as
//   K/16 wgmma m64nDk16 with P the A operand from registers and V the B
//   operand, MN-major (transposed). A warp frees a stage once its reads of
//   it are done (with split stages, K once its Q.K^T is done and V once its
//   P.V is), and the Q tile (`q_empty`) once its last Q.K^T of an item is.
//   At an item's end both warpgroups write their normalised rows as bf16
//   into the item's last stage (the V tile at 128-key tiles; at 64-key
//   tiles the K tile for the first warpgroup, V for the second) and the
//   instantiation stores them (K6, K6': with TMA; 4-byte stores straight
//   from the accumulators were the slower epilogue), then the stage is
//   freed.
// Every tile is 64-column blocks of [rows][128 bytes] with the 128-byte
// swizzle, the layout TMA writes and the wgmma descriptors name.
//
// Schedule, FlashAttention-3's: a warpgroup issues tile j's Q.K^T and tile
// j-1's P.V, then runs tile j's softmax while they run (wgmma.wait_group
// 1), and the two warpgroups issue their products in turns (named
// barriers 1 and 2), so that one warpgroup's exps run while the other's
// products do. Running a tile's products and softmax back to back, or
// overlapping within a warpgroup without the turns, was slower for both
// kernels on an H100 (PERF.md §6).
//
// Findings on the card (PERF.md §6): K6''s TMA boxes of one page
// each set its pace while one warp issued them (a warp issues its lanes'
// TMA copies one after another); multicasting each K/V tile to a cluster
// of the 2 or 4 blocks of heads that share it was slower than no cluster;
// K6 at short chunks is held by each block's start and end, which the
// persistent grid overlaps.
//
// Accumulator layout of a 64 x N wgmma tile (S and O alike): warp w of the
// warpgroup holds rows 16w..16w+15; accumulator i of lane (g = lane/4,
// t = lane%4) is row g + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2t +
// (i & 1). Pairs of S accumulators packed to bf16 are then exactly the A
// fragments of P.V: register j of P holds S[2j], S[2j + 1].
#pragma once

#include "common.cuh"

namespace fa3 {

constexpr int kRows = 128;  // query rows of a work item: two consumer warpgroups of 64
constexpr float kLog2e = 1.4426950408889634f;

// A configuration of the core: head dim D, KEYS keys a K/V tile, STAGES
// ring stages, SPLIT to free a stage's K and V apart (a two-stage ring
// then still loads tile j + 1's K while tile j - 1 is in P.V).
template <int D, int KEYS, int STAGES, bool SPLIT = false>
struct Core {
  static_assert((D == 128 || D == 256) && (KEYS == 128 || KEYS == 64), "a shape of the core");
  static constexpr int kD = D, kKeys = KEYS, kStages = STAGES;
  static constexpr int kBlocks = D / 64;           // 64-column blocks of a row
  static constexpr int kQBlock = kRows * 128;      // a 64-column block of the Q tile
  static constexpr int kQBytes = kBlocks * kQBlock;
  static constexpr int kKVBlock = KEYS * 128;      // a 64-column block of a K or V tile
  static constexpr int kKVBytes = kBlocks * kKVBlock;
  static constexpr int kPieceBytes = kKVBytes / 2;  // a producer warp's share of a step
  struct Stage {
    uint8_t k[kKVBytes];
    uint8_t v[kKVBytes];
  };
  using KVRing = mrt::Ring<Stage, STAGES, false, 40, SPLIT>;
  // the ring with the Q tile and its `q_empty` barrier as its extra buffers,
  // and room to align the start to the swizzle's 1024-byte period
  static constexpr int kExtraBytes = kQBytes + 16;
  static constexpr int kSmemBytes = KVRing::smem_bytes(kExtraBytes) + 1024;
  static_assert(kSmemBytes <= 232448, "227 KB a block");
  // where warpgroup wg stages its 64 output rows (kKVBlock bytes between
  // their 64-column blocks) in an item's last stage, once both warpgroups'
  // last P.V is done
  __device__ static uint8_t* out_rows(Stage& S, int wg) {
    if constexpr (KEYS == 128)
      return S.v + wg * 64 * 128;
    else
      return wg ? S.v : S.k;
  }
};

// K6's and K6''s configuration
constexpr int kD = 128;      // head dim
constexpr int kKeys = 128;   // keys of a K/V tile
constexpr int kStages = 3;   // a stage is held from its Q.K^T to its P.V one tile later
using K6Core = Core<kD, kKeys, kStages>;
constexpr int kHalfBytes = K6Core::kKVBlock;  // a 64-column half of a 128-row tile

// K11's and K12's chunk configurations, a stage's K and V freed apart:
// 128-key tiles in three stages at D = 128 (K6's tiles), 64-key tiles in
// two at D = 256 (a stage of K and V is 64 KB beside the 64 KB Q tile)
template <int D>
using ChunkCore = Core<D, D == 128 ? 128 : 64, D == 128 ? 3 : 2, true>;

// ---- PTX pieces ----

// A shared-memory matrix descriptor with the 128-byte swizzle: `lbo` bytes
// between 64-column blocks (MN-major operands; unused for K-major ones),
// `sbo` bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((mrt::smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

#define FA3_F8(i)                                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA3_F32(i) FA3_F8(i), FA3_F8(i + 8), FA3_F8(i + 16), FA3_F8(i + 24)
#define FA3_ACC32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FA3_ACC64                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "    \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define FA3_ACC128                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "       \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "    \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "    \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, "    \
  "%73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "    \
  "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "    \
  "%123, %124, %125, %126, %127}"

// d (+)= A (64x16, smem, K-major) * B (16xN, smem, K-major), f32, N = 128 or
// 64 keys; scale_d 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 128)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA3_ACC64
                 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : FA3_F32(0), FA3_F32(32)
                 : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA3_ACC32
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : FA3_F32(0)
                 : "l"(da), "l"(db), "r"(scale_d));
}

// d += A (64x16 bf16, registers: the A fragments of mma.m16n8k16 per warp)
// * B (16xN, smem, MN-major), f32, N = D = 128 or 256
template <int N>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 2], uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3, uint64_t db) {
  if constexpr (N == 128)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA3_ACC64
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
                 : FA3_F32(0), FA3_F32(32)
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " FA3_ACC128
                 ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
                 : FA3_F32(0), FA3_F32(32), FA3_F32(64), FA3_F32(96)
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
#undef FA3_F8
#undef FA3_F32
#undef FA3_ACC32
#undef FA3_ACC64
#undef FA3_ACC128

// Compiler-level fences on registers a wgmma reads or writes (no
// instruction): placed after the wgmma.wait that completes them, they keep
// the registers' reads after the wait, and keep an A operand's registers
// from being reused while the tensor cores still read them.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barrier `id` over the two consumer warpgroups (256 threads), or
// one (128).
__device__ __forceinline__ void bar_sync(int id, int threads = 256) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- tiles ----

// TMA of 128 rows x 128 bf16 of a [B, T, H, D] tensor (map rows_map): rows
// t0.. of head `head` of batch row b, rows past T zero-filled, counted on
// `full`.
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map, int head, int t0,
                                          int b, uint64_t* full) {
  mrt::tma_load_4d(dst, map, 0, head, t0, b, full);
  mrt::tma_load_4d(dst + kHalfBytes, map, 64, head, t0, b, full);
}

// The map of a contiguous [B, T, H, D] bf16 tensor, dims (D, H, T, B), in
// boxes of 64 columns x `rows` rows (a Q, K or V tile; 64 for an output
// warpgroup's rows) with the 128-byte swizzle.
inline int rows_map(CUtensorMap* map, const void* base, int B, int T, int H, int rows = kRows,
                    int D = kD) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)T, (uint64_t)B};
  const uint64_t str[3] = {(uint64_t)D * 2, (uint64_t)H * D * 2, (uint64_t)T * H * D * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return mrt::tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, str, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---- the consumer warpgroup ----

// Online-softmax state of a thread's two rows (g and g + 8 of its warp).
struct Rows {
  float m[2];      // running max of the logits; -inf before any key
  float l[2];      // this thread's part of the running exp-sum
  float alpha[2];  // the factor O has to take before the last tile's P.V
};

// The logit of a raw score: the score itself (K6, K6' and K12 without a
// cap: the scale is folded into the exponent) ...
struct RawLogit {
  __device__ __forceinline__ float operator()(float s) const { return s; }
};
// ... or K12's soft cap as a base-2 logit, cap * log2(e) * tanh(s * scale /
// cap) (tanhf: the cap of Gemma-2 is 50, so tanh's error is scaled 50-fold
// into the logit); the exponent's factor is then 1
struct CapLogit {
  float pre, cap2;  // scale / cap, cap * log2(e)
  __device__ __forceinline__ float operator()(float s) const { return cap2 * tanhf(s * pre); }
};

// Turn a tile's raw scores (N of a thread) into probabilities in place:
// s = lg(s), then -inf where keep(row, key) says no (row of the block, key
// of the tile) when masked; the running max is taken over these logits
// (mul > 0 keeps their order: scale * log2(e) for raw scores), so a
// probability is one FFMA and one ex2, ex2(s * mul - m * mul). A row that
// has seen no key yet keeps m = -inf and l = 0, and gets alpha 1 and zero
// probabilities.
template <int N, class Keep, class Lg>
__device__ __forceinline__ void softmax(float (&s)[N], Rows& st, float mul, int row0, bool masked,
                                        Keep keep, Lg lg) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = lg(s[i]);
  float mx[2] = {st.m[0], st.m[1]};
  if (masked) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = (i >> 1) & 1;
      if (!keep(row0 + 8 * r, 8 * (i >> 2) + 2 * t + (i & 1))) s[i] = -INFINITY;
      mx[r] = fmaxf(mx[r], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float msub[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the 4 lanes of a quad hold one row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const bool none = mx[r] == -INFINITY;
    st.alpha[r] = none ? 1.f : ex2((st.m[r] - mx[r]) * mul);
    msub[r] = none ? 0.f : mx[r] * mul;
    st.m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = ex2(fmaf(s[i], mul, -msub[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * st.alpha[r] + rs[r];
}

// S = Q K^T of this warpgroup's 64 rows (q: their first row in the Q tile)
// against a K tile: D/16 k-steps of 16 dims, 4 in each 64-column block.
template <class C>
__device__ __forceinline__ void issue_qk(float (&s)[C::kKeys / 2], const uint8_t* q,
                                         const uint8_t* k) {
  mrt::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::kD / 16; ++kk) {
    const int off = (kk & 3) * 32;
    wgmma_ss<C::kKeys>(s, sw128_desc(q + (kk >> 2) * C::kQBlock + off, 16, 1024),
                       sw128_desc(k + (kk >> 2) * C::kKVBlock + off, 16, 1024), kk > 0);
  }
  mrt::wgmma_commit();
}

// O += P V: kKeys/16 k-steps of 16 keys (2048 bytes of a block each); V's
// 64-column blocks are those of the MN-major B operand.
template <class C>
__device__ __forceinline__ void issue_pv(float (&o)[C::kD / 2], const uint32_t (&p)[C::kKeys / 4],
                                         const uint8_t* v) {
  mrt::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::kKeys / 16; ++kk)
    wgmma_rs_t<C::kD>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                      sw128_desc(v + kk * 2048, C::kKVBlock, 1024));
  mrt::wgmma_commit();
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

template <int N>
__device__ __forceinline__ void to_bf16(const float (&s)[N], uint32_t (&p)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
}

// Consumer warpgroup wg's 64 rows against an item's n >= 1 key tiles, ring
// steps s0..s0+n-1: the unnormalised output o and this thread's parts of
// the exp-sums l. prep(), called by every thread of the warpgroup once the
// item's Q tile has landed and before its first Q.K^T, may rewrite the
// warpgroup's 64 rows of it (K11's scale fold). masked(it) says whether
// tile it needs keep(row, key of the tile); lg turns a raw score into a
// logit. clear(v), called by every
// thread once the last tile's V tile v has landed, may zero rows of it
// that lie past the context (and says whether it wrote): only the last
// tile can hold such rows. Each warp arrives on q_empty once its last
// Q.K^T is done (and, with split stages, frees each other tile's K then);
// the last tile's stage is left to the caller. The warpgroups issue their
// products in turns: a warpgroup waits on barrier 1 + wg, which the
// other's arrival completes (the second warpgroup arrives once before the
// first item, run_items).
template <class C, class Prep, class Masked, class Keep, class Clear, class Lg>
__device__ __forceinline__ void attend(const typename C::KVRing& ring, const uint8_t* qtile,
                                       int wg, int s0, int n, float mul, Prep prep, Masked masked,
                                       Keep keep, Clear clear, Lg lg, uint64_t* q_empty,
                                       float (&o)[C::kD / 2], float (&l)[2]) {
  const int row0 = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
  const uint8_t* q = qtile + wg * 64 * 128;
  float s[C::kKeys / 2];
  uint32_t p[C::kKeys / 4];
  Rows st;
#pragma unroll
  for (int i = 0; i < C::kD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < C::kKeys / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.m[r] = -INFINITY;
    st.l[r] = 0.f;
    st.alpha[r] = 1.f;
  }
  auto soft = [&](int it) {
    softmax(
        s, st, mul, row0, masked(it), [&](int r, int c) { return keep(r, it * C::kKeys + c); },
        lg);
  };
  auto qk_done = [&](int it) {  // S of tile it is complete
    if (it == n - 1) {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mrt::mbar_arrive(q_empty);
    } else {
      ring.release_k(s0 + it);
    }
  };
  auto turn = [&] { bar_sync(1 + wg); };
  auto pass = [&] { bar_arrive(2 - wg); };

  ring.acquire(s0);
  prep();
  turn();
  issue_qk<C>(s, q, ring[s0].k);
  pass();
  mrt::wgmma_wait<0>();
  hold(s);
  qk_done(0);
  soft(0);
  to_bf16(s, p);
  for (int it = 1; it < n; ++it) {
    ring.acquire(s0 + it);
    turn();
    issue_qk<C>(s, q, ring[s0 + it].k);
    rescale(o, st.alpha);
    ring.acquire_ready(s0 + it - 1);
    issue_pv<C>(o, p, ring[s0 + it - 1].v);
    pass();
    mrt::wgmma_wait<1>();  // S of tile it; P.V of tile it-1 still runs
    hold(s);
    qk_done(it);
    soft(it);
    mrt::wgmma_wait<0>();
    hold(o);
    hold(p);
    ring.release(s0 + it - 1);
    to_bf16(s, p);
  }
  ring.acquire_ready(s0 + n - 1);
  if (clear(ring[s0 + n - 1].v)) {
    // the zeros, before this warpgroup's P.V reads them (the other
    // warpgroup writes the same zeros for its own)
    mrt::fence_proxy_async();
    bar_sync(3 + wg, 128);
  }
  turn();
  rescale(o, st.alpha);
  issue_pv<C>(o, p, ring[s0 + n - 1].v);
  pass();
  mrt::wgmma_wait<0>();
  hold(o);
  hold(p);
  l[0] = st.l[0];
  l[1] = st.l[1];
}

// Normalise warpgroup wg's 64 rows and write them as bf16 into `rows` (its
// 64 rows of a tile no one else reads now, C::kKVBlock bytes between
// 64-column blocks), in the tiles' swizzled layout (the lanes of a warp hit
// 32 banks), fenced for the async proxy and synced over the warpgroup. A
// row that saw no key is written as zeros.
template <class C>
__device__ __forceinline__ void stage_out(const float (&o)[C::kD / 2], float (&l)[2], int wg,
                                          uint8_t* rows) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // of the warpgroup
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int row = row0 + 8 * r;
#pragma unroll
    for (int j = 0; j < C::kD / 8; ++j)
      *reinterpret_cast<uint32_t*>(rows + (j >> 3) * C::kKVBlock + row * 128 +
                                   (((j & 7) ^ (row & 7)) << 4) + 4 * t) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
  mrt::fence_proxy_async();  // the stores, before a TMA store reads them
  bar_sync(3 + wg, 128);
}

// The epilogue of K6, K6' and K11: warpgroup wg's 64 rows, staged in `rows`
// (stage_out), through omap (the [B, T, Hq, D] output in boxes of 64 rows)
// at rows q0 + 64 wg.. of head h, batch row b, one TMA store per 64-column
// block, which drops rows past T. `rows` is free again on return.
template <class C = K6Core>
__device__ __forceinline__ void store(const float (&o)[C::kD / 2], float (&l)[2], int wg,
                                      uint8_t* rows, const CUtensorMap* omap, int h, int q0,
                                      int b) {
  stage_out<C>(o, l, wg, rows);
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int j = 0; j < C::kBlocks; ++j)
      mrt::tma_store_4d(omap, rows + j * C::kKVBlock, 64 * j, h, q0 + 64 * wg, b);
    mrt::bulk_commit();
    mrt::bulk_wait_read();
  }
  bar_sync(3 + wg, 128);
}

// A work item of K6 and K6': 128 query rows q0.. of head h, batch row b,
// over n key tiles (kv: the row's context length, where the kernel has
// one). Item w of Hq * B * qtiles: the last query tile of every (row, head)
// first, then the one before, ...; the heads that share a kv head side by
// side.
struct Item {
  int h, b, q0, n, kv;
};
__device__ __forceinline__ Item item_at(int w, int Hq, int B, int qtiles) {
  const int per = Hq * B, r = w % per;
  return {r % Hq, r / Hq, (qtiles - 1 - w / per) * kRows, 0, 0};
}

// The block's items w = blockIdx.x, + gridDim.x, ... of `items`:
// item(w) gives an item (any type with the field n, its key tiles);
// copy(item, t, dst, bar, piece, q, lane), by every lane of producer warp
// `piece`, issues that piece of tile t (K for pieces 0-1, V for 2-3; the
// 64-column blocks of the piece's half, piece & 1, dst their first) into
// dst counted on bar, and at t == 0 warp 0 also the item's Q tile into q
// (q is null otherwise), once its lane 0 has announced the bytes;
// prep(item, wg, q) as attend's prep for warpgroup wg (q: the Q tile);
// masked(item, t) and keep(item, row, key) as attend's, clear(item, v) as
// attend's clear(v) for the item's last tile, lg as attend's; zero(item,
// wg) does warpgroup wg's part of an item with no key tile; out(item, wg,
// o, l, rows) writes warpgroup wg's result from its accumulators through
// its staging rows (C::out_rows) and leaves them free.
template <class C, class ItemFn, class Copy, class Prep, class Masked, class Keep, class Clear,
          class Zero, class Lg, class Out>
__device__ __forceinline__ void run_items(uint8_t* smem_raw, int items, float mul, ItemFn item,
                                          Copy copy, Prep prep, Masked masked, Keep keep,
                                          Clear clear, Zero zero, Lg lg, Out out) {
  using ItemT = decltype(item(0));
  uint8_t* smem = smem_raw + ((1024 - (mrt::smem_u32(smem_raw) & 1023)) & 1023);
  const typename C::KVRing ring(smem, C::kExtraBytes);
  uint8_t* qtile = static_cast<uint8_t*>(ring.extra());
  uint64_t* q_empty = reinterpret_cast<uint64_t*>(qtile + C::kQBytes);
  if (threadIdx.x == 0) mrt::mbar_init(q_empty, 8);  // fenced and synced by ring.run
  int steps = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) steps += item(w).n;

  // a producer warp's cursor: item `cur` (from w), its tile t, Q tiles
  // loaded
  int w = (int)blockIdx.x - (int)gridDim.x, t = 0, qloads = 0;
  ItemT cur{};
  ring.run(
      steps, 0,
      [&](typename C::Stage& S, int, uint64_t* kfull, uint64_t* vfull, int piece, int lane) {
        while (t == cur.n) {  // the next item with a key tile
          w += gridDim.x;
          cur = item(w);
          t = 0;
        }
        const bool with_q = t == 0 && piece == 0;
        if (with_q && qloads > 0) mrt::mbar_wait(q_empty, (qloads - 1) & 1);
        uint64_t* bar = piece < 2 ? kfull : vfull;
        if (lane == 0) mrt::mbar_expect_tx(bar, C::kPieceBytes + (with_q ? C::kQBytes : 0));
        __syncwarp();
        copy(cur, t, (piece < 2 ? S.k : S.v) + (piece & 1) * C::kPieceBytes, bar, piece,
             with_q ? qtile : nullptr, lane);
        qloads += t == 0;
        ++t;
      },
      [](typename C::Stage&, int, int) {},
      [&](int wg) {
        if (wg == 1) bar_arrive(1);
        int s0 = 0;
        for (int v = blockIdx.x; v < items; v += gridDim.x) {
          const ItemT it = item(v);
          if (it.n == 0) {
            zero(it, wg);
            continue;
          }
          float o[C::kD / 2], l[2];
          attend<C>(
              ring, qtile, wg, s0, it.n, mul, [&] { prep(it, wg, qtile); },
              [&](int tt) { return masked(it, tt); },
              [&](int r, int key) { return keep(it, r, key); },
              [&](uint8_t* v) { return clear(it, v); }, lg, q_empty, o, l);
          // both warpgroups past their last P.V before either writes into
          // the last stage
          bar_sync(5);
          out(it, wg, o, l, C::out_rows(ring[s0 + it.n - 1], wg));
          ring.release_k(s0 + it.n - 1);
          ring.release(s0 + it.n - 1);
          s0 += it.n;
        }
      });
}

// run_items without a prep step (K6, K6', K12's chunks): Q as it landed
template <class C, class ItemFn, class Copy, class Masked, class Keep, class Clear, class Zero,
          class Lg, class Out>
__device__ __forceinline__ void run_items(uint8_t* smem_raw, int items, float mul, ItemFn item,
                                          Copy copy, Masked masked, Keep keep, Clear clear,
                                          Zero zero, Lg lg, Out out) {
  run_items<C>(
      smem_raw, items, mul, item, copy, [](const auto&, int, uint8_t*) {}, masked, keep, clear,
      zero, lg, out);
}

// The launch of a K6 or K6' call, checked against the Python plan
// (ops/flash_attention.py::flash_plan): this core's rows a work item, keys
// a tile, stages and threads; 1 to Hq * B * query tiles blocks in x; and
// enough shared memory.
inline bool plan_fits(int rows, int keys, int stages, int threads, int gx, int gy, int gz,
                      int smem, int B, int T, int Hq) {
  return rows == kRows && keys == kKeys && stages == kStages && threads == mrt::kRowThreads &&
         gx >= 1 && gx <= Hq * B * ((T + kRows - 1) / kRows) && gy == 1 && gz == 1 &&
         smem >= K6Core::kSmemBytes;
}

// Launch a kernel of this core with the plan's grid and shared memory.
template <typename Kern, typename... Args>
inline int launch(Kern* kern, dim3 grid, int smem, cudaStream_t st, Args... args) {
  const cudaError_t err = mrt::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, mrt::kRowThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace fa3
