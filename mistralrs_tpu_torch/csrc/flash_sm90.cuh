// The Hopper attention core of K6 (flash_prefill.cu) and K6'
// (flash_prefill_paged.cu): causal attention of 128 query rows of one
// (row, head) against 128-key tiles, head dim D = 128, bf16 in and out.
//
// The grid is persistent: one block an SM walks work items (128 query rows
// of one (row, head)) in the order of Item, the rows with the most key
// tiles first, so that a block's next item loads while its last one ends.
// A block of mrt::kRowThreads threads runs the ring of common.cuh without
// a decode step (mrt::Ring<Stage, kStages, false>) over all its items' key
// tiles:
// - the four producer warps load an item's Q tile once and the K and V
//   tiles of every key step with TMA (cp.async.bulk.tensor) into a ring of
//   kStages stages, a piece each (K or V, a 64-column half): K and Q
//   counted on the stage's `full` mbarrier and V on its `ready` one, so
//   that a Q.K^T starts before its V has landed (a warp issues its lanes'
//   TMA copies one after another, so a stage of one-page boxes needs the
//   four); the instantiation says where a tile comes from (the chunk's own
//   K/V, or pages through the block table);
// - two consumer warpgroups own 64 query rows each. Per key tile:
//   S = Q K^T as 8 bf16 wgmma m64n128k16 (Q and K from shared memory,
//   K-major), the scale in f32, a base-2 online softmax in f32, P rounded
//   to bf16 in registers, and O += P V as 8 wgmma m64n128k16 with P the A
//   operand from registers and V the B operand, MN-major (transposed).
//   A warp frees a stage once its reads of it are done, and the Q tile
//   (`q_empty`) once its last Q.K^T of an item is. At an item's end both
//   warpgroups write their normalised rows as bf16 into the V tile of the
//   item's last stage and store them with TMA (4-byte stores straight from
//   the accumulators were the slower epilogue), then free that stage.
// Every tile is two 64-column halves of [rows][128 bytes] with the 128-byte
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
// Accumulator layout of a 64 x 128 wgmma tile (S and O alike): warp w of the
// warpgroup holds rows 16w..16w+15; accumulator i of lane (g = lane/4,
// t = lane%4) is row g + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + 2t +
// (i & 1). Pairs of S accumulators packed to bf16 are then exactly the A
// fragments of P.V: register j of P holds S[2j], S[2j + 1].
#pragma once

#include "common.cuh"

namespace fa3 {

constexpr int kD = 128;      // head dim
constexpr int kRows = 128;   // query rows of a block: two consumer warpgroups of 64
constexpr int kKeys = 128;   // keys of a K/V tile
constexpr int kStages = 3;   // a stage is held from its Q.K^T to its P.V one tile later
constexpr int kHalfBytes = 128 * 128;       // a 64-column half of a 128-row tile
constexpr int kTileBytes = 2 * kHalfBytes;  // 128 rows x 128 bf16
constexpr float kLog2e = 1.4426950408889634f;

struct Stage {
  uint8_t k[kTileBytes];
  uint8_t v[kTileBytes];
};
using KVRing = mrt::Ring<Stage, kStages, false>;
// the ring with the Q tile and its `q_empty` barrier as its extra buffers,
// and room to align the start to the swizzle's 1024-byte period
constexpr int kExtraBytes = kTileBytes + 16;
constexpr int kSmemBytes = KVRing::smem_bytes(kExtraBytes) + 1024;

// ---- PTX pieces ----

// A shared-memory matrix descriptor with the 128-byte swizzle: `lbo` bytes
// between 64-column halves (MN-major operands; unused for K-major ones),
// `sbo` bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((mrt::smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (+)= A (64x16, smem, K-major) * B (16x128, smem, K-major), f32; scale_d
// 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A (64x16 bf16, registers: the A fragments of mma.m16n8k16 per warp)
// * B (16x128, smem, MN-major), f32
__device__ __forceinline__ void wgmma_rs_t(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

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
inline int rows_map(CUtensorMap* map, const void* base, int B, int T, int H, int rows = kRows) {
  const uint64_t dims[4] = {(uint64_t)kD, (uint64_t)H, (uint64_t)T, (uint64_t)B};
  const uint64_t str[3] = {(uint64_t)kD * 2, (uint64_t)H * kD * 2, (uint64_t)T * H * kD * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return mrt::tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, str, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---- the consumer warpgroup ----

// Online-softmax state of a thread's two rows (g and g + 8 of its warp).
struct Rows {
  float m[2];      // running max of the raw scores; -inf before any key
  float l[2];      // this thread's part of the running exp-sum
  float alpha[2];  // the factor O has to take before the last tile's P.V
};

// Turn a tile's raw scores into probabilities in place: -inf where
// keep(row, key) says no (row of the block, key 0..127 of the tile) when
// masked; the running max is taken over raw scores (mul = scale * log2(e)
// > 0 keeps their order), so a probability is one FFMA and one ex2,
// ex2(s * mul - m * mul). A row that has seen no key yet keeps m = -inf and
// l = 0, and gets alpha 1 and zero probabilities.
template <class Keep>
__device__ __forceinline__ void softmax(float (&s)[64], Rows& st, float mul, int row0, bool masked,
                                        Keep keep) {
  const int t = threadIdx.x & 3;
  float mx[2] = {st.m[0], st.m[1]};
  if (masked) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      if (!keep(row0 + 8 * r, 8 * (i >> 2) + 2 * t + (i & 1))) s[i] = -INFINITY;
      mx[r] = fmaxf(mx[r], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
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
  for (int i = 0; i < 64; ++i) {
    s[i] = ex2(fmaf(s[i], mul, -msub[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * st.alpha[r] + rs[r];
}

// S = Q K^T of this warpgroup's 64 rows (q: their first row in the Q tile)
// against a K tile: 8 k-steps of 16 dims, 4 in each 128-byte half.
__device__ __forceinline__ void issue_qk(float (&s)[64], const uint8_t* q, const uint8_t* k) {
  mrt::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int off = (kk >> 2) * kHalfBytes + (kk & 3) * 32;
    wgmma_ss(s, sw128_desc(q + off, 16, 1024), sw128_desc(k + off, 16, 1024), kk > 0);
  }
  mrt::wgmma_commit();
}

// O += P V: 8 k-steps of 16 keys (2048 bytes of a half each); the two
// halves of V are the two 64-column blocks of the MN-major B operand.
__device__ __forceinline__ void issue_pv(float (&o)[64], const uint32_t (&p)[32],
                                         const uint8_t* v) {
  mrt::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_rs_t(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               sw128_desc(v + kk * 2048, kHalfBytes, 1024));
  mrt::wgmma_commit();
}

__device__ __forceinline__ void rescale(float (&o)[64], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
}

__device__ __forceinline__ void to_bf16(const float (&s)[64], uint32_t (&p)[32]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
}

// Consumer warpgroup wg's 64 rows against an item's n >= 1 key tiles, ring
// steps s0..s0+n-1: the unnormalised output o and this thread's parts of
// the exp-sums l. masked(it) says whether tile it needs keep(row, key of
// the tile). clear(v), called by every thread once the last tile's V tile
// v has landed, may zero rows of it that lie past the context (and says
// whether it wrote): only the last tile can hold such rows. Each warp
// arrives on q_empty once its last Q.K^T is done; the last tile's stage is
// left to the caller. The warpgroups issue their products in turns: a
// warpgroup waits on barrier 1 + wg, which the other's arrival completes
// (the second warpgroup arrives once before the first item, run_items).
template <class Masked, class Keep, class Clear>
__device__ __forceinline__ void attend(const KVRing& ring, const uint8_t* qtile, int wg, int s0,
                                       int n, float mul, Masked masked, Keep keep, Clear clear,
                                       uint64_t* q_empty, float (&o)[64], float (&l)[2]) {
  const int row0 = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
  const uint8_t* q = qtile + wg * 64 * 128;
  float s[64];
  uint32_t p[32];
  Rows st;
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = s[i] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.m[r] = -INFINITY;
    st.l[r] = 0.f;
    st.alpha[r] = 1.f;
  }
  auto soft = [&](int it) {
    softmax(s, st, mul, row0, masked(it), [&](int r, int c) { return keep(r, it * kKeys + c); });
  };
  auto qk_done = [&](int it) {  // S of tile it is complete
    if (it == n - 1) {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mrt::mbar_arrive(q_empty);
    }
  };
  auto turn = [&] { bar_sync(1 + wg); };
  auto pass = [&] { bar_arrive(2 - wg); };

  ring.acquire(s0);
  turn();
  issue_qk(s, q, ring[s0].k);
  pass();
  mrt::wgmma_wait<0>();
  hold(s);
  qk_done(0);
  soft(0);
  to_bf16(s, p);
  for (int it = 1; it < n; ++it) {
    ring.acquire(s0 + it);
    turn();
    issue_qk(s, q, ring[s0 + it].k);
    rescale(o, st.alpha);
    ring.acquire_ready(s0 + it - 1);
    issue_pv(o, p, ring[s0 + it - 1].v);
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
  issue_pv(o, p, ring[s0 + n - 1].v);
  pass();
  mrt::wgmma_wait<0>();
  hold(o);
  hold(p);
  l[0] = st.l[0];
  l[1] = st.l[1];
}

// Normalise warpgroup wg's 64 rows and write them as bf16 through omap (the
// [B, T, Hq, D] output in boxes of 64 rows) at rows q0 + 64 wg.. of head h,
// batch row b: staged in the warpgroup's rows of buf (a 128-row tile no
// one else reads now), in the tiles' swizzled layout (the lanes of a warp
// hit 32 banks), then one TMA store per half, which drops rows past T. A
// row that saw no key is written as zeros. buf is free again on return.
__device__ __forceinline__ void store(const float (&o)[64], float (&l)[2], int wg, uint8_t* buf,
                                      const CUtensorMap* omap, int h, int q0, int b) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // of the warpgroup
  uint8_t* rows = buf + wg * 64 * 128;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int row = row0 + 8 * r;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(rows + (j >> 3) * kHalfBytes + row * 128 +
                                   (((j & 7) ^ (row & 7)) << 4) + 4 * t) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
  mrt::fence_proxy_async();  // the stores, before the TMA store reads them
  bar_sync(3 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
    mrt::tma_store_4d(omap, rows, 0, h, q0 + 64 * wg, b);
    mrt::tma_store_4d(omap, rows + kHalfBytes, 64, h, q0 + 64 * wg, b);
    mrt::bulk_commit();
    mrt::bulk_wait_read();
  }
  bar_sync(3 + wg, 128);
}

// A work item: 128 query rows q0.. of head h, batch row b, over n key
// tiles (kv: the row's context length, where the kernel has one). Item w
// of Hq * B * qtiles: the last query tile of every (row, head) first, then
// the one before, ...; the heads that share a kv head side by side.
struct Item {
  int h, b, q0, n, kv;
};
__device__ __forceinline__ Item item_at(int w, int Hq, int B, int qtiles) {
  const int per = Hq * B, r = w % per;
  return {r % Hq, r / Hq, (qtiles - 1 - w / per) * kRows, 0, 0};
}

// The block's items w = blockIdx.x, + gridDim.x, ... of `items`:
// item(w) gives an Item with its n; copy(item, t, dst, bar, piece, q,
// lane), by every lane of producer warp `piece`, issues that piece of tile
// t (K for pieces 0-1, V for 2-3; the 64-column half piece & 1) into dst
// counted on bar, and at t == 0 warp 0 also the item's Q tile into q (q is
// null otherwise), once its lane 0 has announced the bytes;
// masked(item, t) and keep(item, row, key) as attend's, clear(item, v) as
// attend's clear(v) for the item's last tile; zero(item, wg)
// writes warpgroup wg's rows of an item with no key tile as zeros. The
// output goes through omap (store).
template <class ItemFn, class Copy, class Masked, class Keep, class Clear, class Zero>
__device__ __forceinline__ void run_items(uint8_t* smem_raw, int items, float mul, ItemFn item,
                                          Copy copy, Masked masked, Keep keep, Clear clear,
                                          Zero zero, const CUtensorMap* omap) {
  uint8_t* smem = smem_raw + ((1024 - (mrt::smem_u32(smem_raw) & 1023)) & 1023);
  const KVRing ring(smem, kExtraBytes);
  uint8_t* qtile = static_cast<uint8_t*>(ring.extra());
  uint64_t* q_empty = reinterpret_cast<uint64_t*>(qtile + kTileBytes);
  if (threadIdx.x == 0) mrt::mbar_init(q_empty, 8);  // fenced and synced by ring.run
  int steps = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) steps += item(w).n;

  // a producer warp's cursor: item `cur` (from w), its tile t, Q tiles
  // loaded
  int w = (int)blockIdx.x - (int)gridDim.x, t = 0, qloads = 0;
  Item cur{0, 0, 0, 0, 0};
  ring.run(
      steps, 0,
      [&](Stage& S, int, uint64_t* kfull, uint64_t* vfull, int piece, int lane) {
        while (t == cur.n) {  // the next item with a key tile
          w += gridDim.x;
          cur = item(w);
          t = 0;
        }
        const bool with_q = t == 0 && piece == 0;
        if (with_q && qloads > 0) mrt::mbar_wait(q_empty, (qloads - 1) & 1);
        uint64_t* bar = piece < 2 ? kfull : vfull;
        if (lane == 0) mrt::mbar_expect_tx(bar, kHalfBytes + (with_q ? kTileBytes : 0));
        __syncwarp();
        copy(cur, t, (piece < 2 ? S.k : S.v) + (piece & 1) * kHalfBytes, bar, piece,
             with_q ? qtile : nullptr, lane);
        qloads += t == 0;
        ++t;
      },
      [](Stage&, int, int) {},
      [&](int wg) {
        if (wg == 1) bar_arrive(1);
        int s0 = 0;
        for (int v = blockIdx.x; v < items; v += gridDim.x) {
          const Item it = item(v);
          if (it.n == 0) {
            zero(it, wg);
            continue;
          }
          float o[64], l[2];
          attend(
              ring, qtile, wg, s0, it.n, mul, [&](int tt) { return masked(it, tt); },
              [&](int r, int key) { return keep(it, r, key); },
              [&](uint8_t* v) { return clear(it, v); }, q_empty, o, l);
          // both warpgroups past their last P.V before either writes into
          // the last stage's V tile
          bar_sync(5);
          store(o, l, wg, ring[s0 + it.n - 1].v, omap, it.h, it.q0, it.b);
          ring.release(s0 + it.n - 1);
          s0 += it.n;
        }
      });
}

// The launch of a call, checked against the Python plan
// (ops/flash_attention.py::flash_plan): this core's rows a work item, keys
// a tile, stages and threads; 1 to Hq * B * query tiles blocks in x; and
// enough shared memory.
inline bool plan_fits(int rows, int keys, int stages, int threads, int gx, int gy, int gz,
                      int smem, int B, int T, int Hq) {
  return rows == kRows && keys == kKeys && stages == kStages && threads == mrt::kRowThreads &&
         gx >= 1 && gx <= Hq * B * ((T + kRows - 1) / kRows) && gy == 1 && gz == 1 &&
         smem >= kSmemBytes;
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
