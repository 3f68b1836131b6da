// K13: grouped GEMM over expert-sorted rows (the dropless MoE dispatch).
//
// Replaces the TPU library kernel jax.experimental.pallas.ops.tpu.megablox
// .gmm, called at mistralrs_tpu/ops/grouped_gemm.py:73 by _gmm (:60), from
// grouped_matmul in mistralrs_tpu/models/decoder.py::_moe_mlp_grouped.
//
// lhs [M, K] bf16, rows sorted by group; rhs [G, K, N] bf16 (N contiguous);
// group_sizes [G] int32 on the device (negative sizes count as 0, rows past
// M are dropped); out [M, N] bf16 with out[m] = lhs[m] @ rhs[g(m)], the
// products on bf16 tensor cores summed in f32 and rounded to bf16 once.
// The host never reads the sizes, so a decode step never waits for the card:
// both kernels find their tiles on the device.
//
// What bounds it on an H100: at decode and up to ~64 rows a group the
// weight bytes (every group with rows reads its [K, N] matrix once: a
// Mixtral gate call at M = 32 or 512 moves 940 MB, 0.28 ms at 3.35 TB/s);
// from ~2,048 (token, expert) pairs on the operations (2 M K N: 0.24 ms at M
// = 2,048, 0.49 at 4,096).
//
// Two kernels, chosen by the host from the average rows a group
// (ops/grouped_gemm.py::grouped_gemm_plan):
//
// - "decode" (at most 32 rows a group on average), grouped_gemm_decode_kernel:
//   one block for each possible 16-row tile, ceil(M / 16) + G - 1, times N /
//   128 column tiles; a block walks the sizes to find its group and exits if
//   it has none, so an empty group reads none of its weights. A 4-stage
//   cp.async ring of [16, 32] lhs and [32, 128] rhs tiles, mma.sync with rhs
//   fragments through ldmatrix.trans. Bound by the weight bytes, which it
//   reads once (1.2x its bound at M = 32).
//
// - "tiles" (above 32 rows a group), grouped_gemm_tiles_kernel: bound by
//   operations from ~2,048 pairs, so it is built for the tensor cores' full
//   rate, and reads each weight tile once from memory at M = 512, where the
//   bytes bound it. Tiles of 128 rows x 256 columns:
//   - a persistent grid, one block an SM. Each block reads the sizes into
//     shared memory and forms the prefix of each group's tiles (ceil(n_g /
//     128) row tiles times ceil(N / 256) column tiles); tile t is group g's
//     local tile l = t - first(g), column tile l / rt_g and row tile l % rt_g
//     (rt_g: the group's row tiles). So the row tiles of one (group, column
//     tile) are neighbours: the blocks that run together read a weight tile
//     once from memory and again from L2, and a group's rows stay in L2
//     while its column tiles go by. Block b takes t = b, b + grid, ...;
//   - the ring of common.cuh without a decode step (mrt::Ring<Stage,
//     kStages, false>): producer warp 0 loads a stage's lhs box [128 rows,
//     64 K] through a 2-D tensor map of lhs, warp 1 its four rhs boxes [64
//     K, 64 N] through a 3-D map of rhs [G, K, N], all with the 128-byte
//     swizzle, counted on the stage's `full` barrier (two arrivals). The lhs
//     box starts at the tile's first row, whatever it is: rows of the next
//     group in it are computed and not stored; rows past M and K past K land
//     as zeros, and so do the rhs box's K and N past the group's own (the
//     3-D map never reads the next expert's rows). A stage is 64 deep in K
//     (48 KB): four fit in ~200 KB. The producers run ahead into the next
//     tile while the consumers store the last one;
//   - two consumer warpgroups of 64 rows run bf16 wgmma m64n256k16 with f32
//     accumulators (128 a thread), lhs K-major and the weight MN-major
//     (transposed), both from shared memory, one k-step's products kept in
//     flight (wgmma.wait_group 1). A warpgroup whose 64 rows hold none of
//     the tile's skips the products. The loop bounds and that test are
//     broadcast from lane 0, so ptxas sees the wgmmas on a uniform path (it
//     serializes them otherwise: 5-14% slower on the card);
//   - the epilogue rounds to bf16 once and stages each warp's 16 rows x 64
//     columns in shared memory (XOR-swizzled, no bank conflicts), then
//     writes 16-byte row pieces of the tile's own group and columns < N (4-
//     byte stores straight from the accumulators were 4-16% slower);
//   - no split-K and no atomics: a result is bit-equal from call to call.
//   On an H100 (PERF.md §6) 128-column tiles (six 32 KB stages) were
//   24-32% slower at most shapes from M = 2,048 and no faster at M = 512.
//   The loads alone (no products) take 70-88% of a call at M >= 2,048 and
//   the products alone 78-82%: both the bytes the SMs draw from L2 (a
//   stage's 48 KB per 4.2 MFLOP) and the tensor cores are near their
//   limits, and a tile whose group ends early costs its whole weight
//   stream. Two-block clusters multicasting the weight boxes were 1.6-1.8x
//   slower.
#include "common.cuh"

namespace {

constexpr int MAX_GROUPS = 256;

// ---- the decode kernel: 16-row tiles, mma.sync ----

constexpr int DEC_ROWS = 16;   // rows a block
constexpr int DEC_COLS = 128;  // columns a block: 4 warps of 32 across
constexpr int DEC_BK = 32;     // K a stage
constexpr int DEC_STAGES = 4;
constexpr int DEC_THREADS = 128;
constexpr int DEC_A_BYTES = DEC_ROWS * DEC_BK * 2;  // [16, 32] bf16, 64-byte rows
constexpr int DEC_B_BYTES = DEC_BK * DEC_COLS * 2;  // [32, 128] bf16, 256-byte rows
constexpr int DEC_STAGE_BYTES = DEC_A_BYTES + DEC_B_BYTES;
constexpr int DEC_SMEM = DEC_STAGES * DEC_STAGE_BYTES;

// byte offset of 16-byte chunk c of row r in an lhs tile (4 chunks a row)
__device__ __forceinline__ uint32_t a_off(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}
// byte offset of 16-byte chunk c of row k in an rhs tile (16 chunks a row)
__device__ __forceinline__ uint32_t b_off(int k, int c) { return k * 256 + ((c ^ (k & 7)) << 4); }

__device__ __forceinline__ void dec_load_stage(uint8_t* sa, uint8_t* sb,
                                               const __nv_bfloat16* __restrict__ lhs,
                                               const __nv_bfloat16* __restrict__ w, int row0,
                                               int rows, int k0, int col0, int K, int N) {
  for (int i = threadIdx.x; i < DEC_ROWS * 4; i += DEC_THREADS) {
    const int r = i >> 2, c = i & 3;
    const bool ok = r < rows;
    mrt::cp_async16(sa + a_off(r, c), ok ? lhs + (size_t)(row0 + r) * K + k0 + 8 * c : lhs, ok);
  }
  for (int i = threadIdx.x; i < DEC_BK * 16; i += DEC_THREADS) {
    const int k = i >> 4, c = i & 15;
    const bool ok = col0 + 8 * c < N;
    mrt::cp_async16(sb + b_off(k, c), ok ? w + (size_t)(k0 + k) * N + col0 + 8 * c : w, ok);
  }
}

__global__ void __launch_bounds__(DEC_THREADS)
    grouped_gemm_decode_kernel(const __nv_bfloat16* __restrict__ lhs,
                               const __nv_bfloat16* __restrict__ rhs,
                               const int* __restrict__ group_sizes,
                               __nv_bfloat16* __restrict__ out, int M, int K, int N, int G) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_sizes[MAX_GROUPS];
  __shared__ int s_group, s_row0, s_rows;
  for (int g = threadIdx.x; g < G; g += DEC_THREADS) s_sizes[g] = max(group_sizes[g], 0);
  __syncthreads();
  if (threadIdx.x == 0) {
    // group g owns tiles tile .. tile + ceil(n_g / 16) - 1, in group order
    int start = 0, tile = 0, rows = 0, group = 0, row0 = 0;
    for (int g = 0; g < G; ++g) {
      const int n = s_sizes[g];
      const int t = (n + DEC_ROWS - 1) / DEC_ROWS;
      if ((int)blockIdx.y < tile + t) {
        const int j = blockIdx.y - tile;
        group = g;
        row0 = start + j * DEC_ROWS;
        rows = min(DEC_ROWS, n - j * DEC_ROWS);
        break;
      }
      tile += t;
      start += n;
    }
    s_group = group;
    s_row0 = row0;
    s_rows = max(0, min(rows, M - row0));  // rows past M (sizes summing above M) are dropped
  }
  __syncthreads();
  const int rows = s_rows;
  if (rows == 0) return;
  const int row0 = s_row0;
  const int col0 = blockIdx.x * DEC_COLS;
  const __nv_bfloat16* w = rhs + (size_t)s_group * K * N;

  const int wn = threadIdx.x >> 5, lane = threadIdx.x & 31;  // warp's 32-column block
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int nk = K / DEC_BK;
  auto stage_a = [&](int s) { return smem + s * DEC_STAGE_BYTES; };
  auto stage_b = [&](int s) { return smem + s * DEC_STAGE_BYTES + DEC_A_BYTES; };
#pragma unroll
  for (int s = 0; s < DEC_STAGES - 1; ++s) {
    if (s < nk) dec_load_stage(stage_a(s), stage_b(s), lhs, w, row0, rows, s * DEC_BK, col0, K, N);
    mrt::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    mrt::cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();  // stage kt has landed, and every warp is done with stage kt - 1
    const int pf = kt + DEC_STAGES - 1;
    if (pf < nk)
      dec_load_stage(stage_a(pf % DEC_STAGES), stage_b(pf % DEC_STAGES), lhs, w, row0, rows,
                     pf * DEC_BK, col0, K, N);
    mrt::cp_async_commit();
    const uint32_t sa = mrt::smem_u32(stage_a(kt % DEC_STAGES));
    const uint32_t sb = mrt::smem_u32(stage_b(kt % DEC_STAGES));
#pragma unroll
    for (int kk = 0; kk < DEC_BK; kk += 16) {
      // matrices 0..3: rows +0/+8 (lane bit 3) x k +0/+8 (lane bit 4)
      uint32_t a[4];
      mrt::ldsm_x4(sa + a_off(lane & 15, (kk >> 3) + (lane >> 4)), a);
      uint32_t b[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        // matrices 0..3: k +0/+8 (lane bit 3) x n-tiles 2p / 2p + 1 (lane bit 4)
        const int k = kk + (lane & 7) + (lane & 8);
        uint32_t t[4];
        mrt::ldsm_x4_trans(sb + b_off(k, wn * 4 + 2 * p + (lane >> 4)), t);
        b[2 * p][0] = t[0];
        b[2 * p][1] = t[1];
        b[2 * p + 1][0] = t[2];
        b[2 * p + 1][1] = t[3];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) mrt::mma_bf16(acc[j], a, b[j][0], b[j][1]);
    }
  }
  mrt::cp_async_wait<0>();

  // C fragment of n-tile j: e = 0, 1 at row g, e = 2, 3 at row g + 8;
  // columns 2t, 2t + 1 of the n-tile
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + wn * 32 + j * 8 + 2 * t;
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (r >= rows) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + r) * N + col) =
          __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

// ---- the tiles kernel: a persistent grid, TMA-fed ring, bf16 wgmma ----

constexpr int kBM = 128;        // rows a tile: two consumer warpgroups of 64
constexpr int kBN = 256;        // columns a tile
constexpr int kBK = 64;         // K a stage: one 128-byte swizzled row of bf16
constexpr int kBoxCols = 64;    // columns of an rhs box
constexpr int kBoxes = kBN / kBoxCols;
constexpr int kRowBytes = 128;  // a box row: 64 bf16
constexpr int kABytes = kBM * kRowBytes;      // lhs box [128 rows, 64 K]
constexpr int kBoxBytes = kBK * kRowBytes;    // rhs box [64 K, 64 N]
constexpr int kEpiWarpBytes = 16 * kRowBytes;  // a consumer warp's 16 rows x 64 columns
constexpr int kEpiBytes = 8 * kEpiWarpBytes;
// the group tables: first row, rows in [0, M), first tile (G + 1 entries)
constexpr int kTableBytes = 4 * (3 * MAX_GROUPS + 4);

struct TileStage {
  uint8_t a[kABytes];
  uint8_t b[kBoxes * kBoxBytes];
};
// as many stages as ~200 KB hold: 4 of 48 KB
constexpr int kStages = mrt::kRingBudget / (int)sizeof(TileStage);
using TileRing = mrt::Ring<TileStage, kStages, false>;
constexpr int kExtra = kEpiBytes + kTableBytes;
// and room to align the start to the swizzle's 1024-byte period
constexpr int kTilesSmem = TileRing::smem_bytes(kExtra) + 1024;
static_assert(kTilesSmem <= 232448, "the card's 227 KB of shared memory a block");

// The group tables of a call, by warp 0 (G <= 256: lane l takes groups
// 8l .. 8l + 7): start[g] = the group's first row, rows[g] = its rows that
// lie in [0, M), tile0[g] = its first tile (ceil(rows / 128) row tiles
// times `ctiles` column tiles each), tile0[G] = the call's tiles.
__device__ __forceinline__ void group_tables(const int* __restrict__ sizes, int G, int M,
                                             int ctiles, int* start, int* rows, int* tile0) {
  const int lane = threadIdx.x & 31;
  int n[8], sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int g = 8 * lane + i;
    n[i] = g < G ? min(max(sizes[g], 0), M) : 0;  // at most M: the sums stay small
    sum += n[i];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  int s = incl - sum, nt[8], tsum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = max(0, min(n[i], M - s));
    nt[i] = (r + kBM - 1) / kBM * ctiles;
    tsum += nt[i];
    if (8 * lane + i < G) {
      start[8 * lane + i] = s;
      rows[8 * lane + i] = r;
    }
    s += n[i];
  }
  int tincl = tsum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, tincl, d);
    if (lane >= d) tincl += v;
  }
  int t = tincl - tsum;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (8 * lane + i < G) tile0[8 * lane + i] = t;
    t += nt[i];
  }
  if (lane == 31) tile0[G] = tincl;
}

struct Tile {
  int group, row0, rows, col0;
};

// Tile t (< tile0[G]): the group g with tile0[g] <= t < tile0[g + 1] (a
// binary search; an empty group owns no tile), then column tile l / rt and
// row tile l % rt of its local tile l, rt its row tiles.
__device__ __forceinline__ Tile tile_at(int t, const int* start, const int* rows,
                                        const int* tile0, int G) {
  int lo = 0, hi = G;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile0[mid] <= t)
      lo = mid;
    else
      hi = mid;
  }
  const int rt = (rows[lo] + kBM - 1) / kBM, l = t - tile0[lo];
  const int c = l / rt, j = l - c * rt;
  return {lo, start[lo] + j * kBM, min(kBM, rows[lo] - j * kBM), c * kBN};
}

// Warp w of the consumers (16 rows of the tile from 16w) writes its rows of
// the tile that lie in `rows`, columns < N: per 64 columns, its accumulators
// rounded to bf16 into its 16 x 128-byte buffer (16-byte chunk j of row r
// at chunk j ^ (r & 7): the 8 rows a store instruction touches hit 32
// banks), then 16-byte row pieces to out (a quarter-warp reads one row).
__device__ __forceinline__ void store_tile(const float (&acc)[kBN / 2], uint8_t* buf,
                                           __nv_bfloat16* __restrict__ out, int N,
                                           const Tile& tl, int w) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * w;
  if (r0 >= tl.rows) return;
#pragma unroll
  for (int q = 0; q < kBoxes; ++q) {
    const int c0 = tl.col0 + kBoxCols * q;
    if (c0 < N) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * q + jj;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(buf + (g + 8 * h) * kRowBytes + ((jj ^ g) << 4) +
                                             4 * t) = v;
        }
      }
      __syncwarp();
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int i = lane + 32 * p, r = i >> 3, c = i & 7;
        const uint4 v =
            *reinterpret_cast<const uint4*>(buf + r * kRowBytes + ((c ^ (r & 7)) << 4));
        const int col = c0 + 8 * c;
        if (r0 + r < tl.rows && col < N)
          *reinterpret_cast<uint4*>(out + (size_t)(tl.row0 + r0 + r) * N + col) = v;
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(mrt::kRowThreads, 1)
    grouped_gemm_tiles_kernel(const __grid_constant__ CUtensorMap amap,
                              const __grid_constant__ CUtensorMap bmap,
                              const int* __restrict__ group_sizes,
                              __nv_bfloat16* __restrict__ out, int M, int K, int N, int G) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (mrt::smem_u32(smem_raw) & 1023)) & 1023);
  const TileRing ring(smem, kExtra);
  uint8_t* epi = static_cast<uint8_t*>(ring.extra());
  int* start = reinterpret_cast<int*>(epi + kEpiBytes);
  int* rows = start + MAX_GROUPS;
  int* tile0 = rows + MAX_GROUPS;
  const int ctiles = (N + kBN - 1) / kBN;
  if (threadIdx.x < 32) group_tables(group_sizes, G, M, ctiles, start, rows, tile0);
  __syncthreads();
  // broadcast from lane 0, so that the compiler sees the consumers' tile
  // loop, and the wgmmas in it, as uniform across each warp
  const int total = __shfl_sync(0xffffffffu, tile0[G], 0);
  const int nk = (K + kBK - 1) / kBK;
  const int blk = blockIdx.x, mine = blk < total ? (total - 1 - blk) / (int)gridDim.x + 1 : 0;

  Tile cur{0, 0, 0, 0};  // a producer warp's tile
  ring.run(
      mine * nk, 0,
      [&](TileStage& S, int i, uint64_t* full, uint64_t*, int pw, int lane) {
        if (pw > 1) return;  // warps 0 (lhs) and 1 (rhs) load; 2 and 3 idle
        const int kt = i % nk;
        if (kt == 0) cur = tile_at(blockIdx.x + i / nk * gridDim.x, start, rows, tile0, G);
        if (lane != 0) return;
        if (pw == 0) {
          mrt::mbar_expect_tx(full, kABytes);
          mrt::tma_load_2d(S.a, &amap, kt * kBK, cur.row0, full);
        } else {
          mrt::mbar_expect_tx(full, kBoxes * kBoxBytes);
#pragma unroll
          for (int b = 0; b < kBoxes; ++b)
            mrt::tma_load_3d(S.b + b * kBoxBytes, &bmap, cur.col0 + kBoxCols * b, kt * kBK,
                             cur.group, full);
        }
      },
      [](TileStage&, int, int) {},
      [&](int wg) {
        const int w = 4 * wg + ((threadIdx.x >> 5) & 3);  // consumer warp 0..7
        uint8_t* buf = epi + w * kEpiWarpBytes;
        int s = 0;
        for (int t = blockIdx.x; t < total; t += gridDim.x) {
          const Tile tl = tile_at(t, start, rows, tile0, G);
          // this warpgroup's rows hold some of the tile's (uniform, as total)
          const bool live = __shfl_sync(0xffffffffu, tl.rows > 64 * wg, 0);
          float acc[kBN / 2];
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
          for (int kt = 0; kt < nk; ++kt, ++s) {
            ring.acquire(s);
            if (live) {
              const uint8_t* a = ring[s].a + wg * 64 * kRowBytes;
              const uint8_t* b = ring[s].b;
              mrt::wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < kBK / 16; ++kk)
                // lhs: 16 K (32 bytes) of the swizzled rows, 8-row groups 1024
                // bytes apart; rhs: 16 K rows (2048 bytes) of each box, boxes
                // (64 columns) kBoxBytes apart
                mrt::wgmma_bf16_ss_t(acc, mrt::swizzled_desc(a + kk * 32, 16, 1024, 1),
                                     mrt::swizzled_desc(b + kk * 2048, kBoxBytes, 1024, 1));
              mrt::wgmma_commit();
              mrt::wgmma_wait<1>();  // the k-step before this one is done
            }
            if (kt > 0) ring.release(s - 1);
          }
          if (live) {
            mrt::wgmma_wait<0>();
            mrt::fence_operand(acc);
          }
          ring.release(s - 1);
          if (live) store_tile(acc, buf, out, N, tl, w);
        }
      });
}

// The launch of a tiles call, checked against the plan: 128 rows, 256
// columns and 64 of K a tile, the ring's stages, kRowThreads threads, 1 to
// min(ceil(M / 128) + G - 1, M) row tiles times ceil(N / 256) column tiles
// blocks in x, and the kernel's shared memory.
bool tiles_fit(int bm, int bn, int bk, int stages, int threads, int gx, int gy, int gz, int smem,
               int M, int N, int G) {
  const long long rtiles = (M + kBM - 1) / kBM + G - 1 < M ? (M + kBM - 1) / kBM + G - 1 : M;
  return bm == kBM && bn == kBN && bk == kBK && stages == kStages &&
         threads == mrt::kRowThreads && gx >= 1 && gx <= rtiles * ((N + kBN - 1) / kBN) &&
         gy == 1 && gz == 1 && smem == kTilesSmem;
}

int launch_tiles(const void* lhs, const void* rhs, const void* group_sizes, void* out, int M,
                 int K, int N, int G, int gx, cudaStream_t st) {
  CUtensorMap amap, bmap;
  // lhs [M, K]: boxes of 128 rows x 64 K
  const uint64_t adims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t astr[1] = {(uint64_t)K * 2};
  const uint32_t abox[2] = {kBK, kBM};
  int err = mrt::tile_map(&amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lhs, adims, astr, abox,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  // rhs [G, K, N]: boxes of 64 K x 64 N inside one group
  const uint64_t bdims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)G};
  const uint64_t bstr[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
  const uint32_t bbox[3] = {kBoxCols, kBK, 1};
  err = mrt::tile_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, rhs, bdims, bstr, bbox,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const cudaError_t e = mrt::allow_smem(grouped_gemm_tiles_kernel, kTilesSmem);
  if (e != cudaSuccess) return (int)e;
  grouped_gemm_tiles_kernel<<<gx, mrt::kRowThreads, kTilesSmem, st>>>(
      amap, bmap, static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(out), M, K, N,
      G);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/grouped_gemm.py): bf16
// contiguous 16-byte aligned lhs, rhs and out, int32 group_sizes on the same
// device, K % 32 == 0, N % 8 == 0, 1 <= G <= 256, M >= 1. The launch comes
// from its plan (grouped_gemm_plan): kind 0 is the decode kernel (16 rows,
// 128 columns, 32 of K a stage, 4 stages, 128 threads, grid (N / 128 column
// tiles, ceil(M / 16) + G - 1, 1)), kind 1 the tiles kernel (tiles_fit);
// any other plan is refused with cudaErrorInvalidValue. Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int grouped_gemm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                            int M, int K, int N, int G, int kind, int bm, int bn, int bk,
                            int stages, int threads, int gx, int gy, int gz, int smem,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (bm != DEC_ROWS || bn != DEC_COLS || bk != DEC_BK || stages != DEC_STAGES ||
        threads != DEC_THREADS || gx != (N + DEC_COLS - 1) / DEC_COLS ||
        gy != (M + DEC_ROWS - 1) / DEC_ROWS + G - 1 || gz != 1 || smem != DEC_SMEM)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = mrt::allow_smem(grouped_gemm_decode_kernel, DEC_SMEM);
    if (err != cudaSuccess) return (int)err;
    grouped_gemm_decode_kernel<<<dim3(gx, gy), DEC_THREADS, DEC_SMEM, st>>>(
        static_cast<const __nv_bfloat16*>(lhs), static_cast<const __nv_bfloat16*>(rhs),
        static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(out), M, K, N, G);
    return (int)cudaGetLastError();
  }
  if (kind == 1 && tiles_fit(bm, bn, bk, stages, threads, gx, gy, gz, smem, M, N, G))
    return launch_tiles(lhs, rhs, group_sizes, out, M, K, N, G, gx, st);
  return (int)cudaErrorInvalidValue;
}
