// The rows instantiation (17 <= B <= 256) of K1 (Q4_K x int8,
// csrc/q4k_q8_gemv.cu) and of K9 (Q5_K x int8, csrc/q5k_q8_gemv.cu): one
// body, rows_body<BM, Q5>, where Q5 adds the high-bit plane qh, run by the
// kernels q4k_q8_rows_kernel<BM> and q5k_q8_rows_kernel<BM>.
//
// K2's design (q8_0_q8_gemv.cu) on the ring of common.cuh (mrt::Ring): a
// block owns 128 columns and BM = 64 or 128 rows, with two consumer
// warpgroups (at BM 128 one per 64 rows, wgmma N = 128; at BM 64 one per 64
// columns, N = 64) and a producer warpgroup; the grid is (row tiles, column
// tiles, ksplit), row tiles fastest. One K step is one sub-block pair p:
// - the copies: TMA boxes of the pair's 32 byte rows of qs and of its four
//   scale rows (scale and minv of sub-blocks p and K/64 + p), bulk copies
//   of x's codes of the two sub-blocks for the BM rows (A slices,
//   common.cuh tiled_off) and their xs and xsum; with Q5 also the 32 rows
//   of qh that hold the pair's high bits (below);
// - the decode: low and high nibbles into two K-major B tiles (0..15 are
//   valid int8 codes; with Q5 each plane's bit ORed into bit 4, 0..31), the
//   scale rows into f32 at mrt::scale_pos, and the pair's xsum (three bf16
//   parts) and minv into the slice's min tiles (Q4MinTiles);
// - each consumer warpgroup issues wgmma.m64nNk32.s32.s8.s8 for the low
//   sub-block into one int32 accumulator and for the high one into
//   another, scales the low one while the high one runs, issues the next
//   pair's low sub-block, and scales the high one while that runs (the
//   conversion, exact below 2^24, xs * scale, an fma). After every 8th
//   pair, three bf16 wgmma.m64nNk16 put the slice's min term into the
//   high accumulator's registers, and 64 adds move it into the f32 sums.
//   The two warpgroups share each SM sub-partition.
//
// Q5_K's high bits (qh [K/8, O], plane-major: bit j of row r is element
// j*K/8 + r): the pair p's low sub-block (elements 32p..) has its bits in
// plane j = 32p / (K/8) of qh rows 32p mod K/8 .., its high sub-block (K/2
// + 32p..) in plane j + 4 of the same rows. So the 4 pairs p, p + K/256, p +
// 2K/256, p + 3K/256 (a "group") share one box of 32 qh rows; the K steps
// run group by group (step s is pair (s % 4) * K/256 + s / 4, plane s % 4),
// and a K split takes whole groups. The box is read by TMA at each of the
// group's four steps: the three after the first find it in L2, so the
// weight's bytes come from memory once per column tile.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace q4rows {

template <int BM>
struct __align__(128) Q4RowStage {
  uint8_t q[32 * mrt::kGemvCols];        // the pair's byte rows as stored, row r at r*128
  uint8_t lo[32 * mrt::kGemvCols];       // decoded B tile of sub-block p (low nibbles)
  uint8_t hi[32 * mrt::kGemvCols];       // and of sub-block K/64 + p (high nibbles)
  int8_t x[2][BM * 32];                  // x's codes of the two sub-blocks: A slices
  __nv_bfloat16 sc[4][mrt::kGemvCols];   // scale lo, scale hi, minv lo, minv hi as stored
  float scf[2][mrt::kScaleRow];          // the scales in f32, at scale_pos
  float xv[4][BM];                       // xs lo, xs hi, xsum lo, xsum hi of the BM rows
};
// K9's stage: K1's and the 32 rows of qh that hold the pair's high bits
template <int BM>
struct __align__(128) Q5RowStage : Q4RowStage<BM> {
  uint8_t qh[32 * mrt::kGemvCols];
};
template <int BM, bool Q5>
using RowStage = std::conditional_t<Q5, Q5RowStage<BM>, Q4RowStage<BM>>;

// The min term sum_sub xsum[b,sub] * minv[sub,o] on the tensor cores: every
// 8 pairs (16 sub-blocks, slots 2j and 2j+1 for the j-th pair's two) one
// bf16 wgmma.m64nNk16 per part subtracts it into the f32 accumulators. xsum
// is split exactly into three bf16 parts (hi + mid + lo); minv is bf16.
// Both are K-major tiles in the int8 tiles' layout, double-buffered by
// slice, written by the decode warps from each stage.
template <int BM>
struct __align__(128) Q4MinTiles {
  __nv_bfloat16 a[2][3][BM * 16];  // xsum parts: (r, k) at (r/64)*2048 + (k/8)*1024 + (r%64)*16 + (k%8)*2 bytes
  __nv_bfloat16 b[2][128 * 16];    // minv: (c, k) at (k/8)*2048 + c*16 + (k%8)*2 bytes
};

// K1's ring in ~200 KB; K9's larger stage in the card's whole 226 KB (six
// stages at both row tiles, as K1 has)
template <int BM, bool Q5>
constexpr int kStages =
    mrt::ring_stages<RowStage<BM, Q5>, sizeof(Q4MinTiles<BM>), 8,
                     Q5 ? mrt::kRingBudgetMax : mrt::kRingBudget>();
template <int BM, bool Q5>
using RowRing = mrt::Ring<RowStage<BM, Q5>, kStages<BM, Q5>>;

// the pairs of K a K split takes: whole groups of 4 with Q5 (every split
// but the last the same count; ops/quant_matmul.q5k_rows_pairs_per_split)
template <bool Q5>
__host__ __device__ constexpr int pairs_per_split(int K, int ksplit) {
  return Q5 ? 4 * ((K / 256 + ksplit - 1) / ksplit) : (K / 64 + ksplit - 1) / ksplit;
}

// The kernel's body; each source wraps it in a kernel of its own name
// (q4k_q8_rows_kernel, q5k_q8_rows_kernel), which passes its
// __grid_constant__ tensor maps by reference.
template <int BM, bool Q5>
__device__ __forceinline__ void rows_body(const CUtensorMap& qmap, const CUtensorMap& smap,
                                          const CUtensorMap& mmap, const CUtensorMap& hmap,
                                          const int8_t* __restrict__ xq,
                                          const float* __restrict__ xs,
                                          const float* __restrict__ xsum, void* out, int out_mode,
                                          int B, int bpad, int K, int O, int pairs_per_split) {
  constexpr int N = BM == 128 ? 128 : 64;  // wgmma width of a consumer warpgroup
  using Stage = RowStage<BM, Q5>;
  static_assert(kStages<BM, Q5> <= 8, "a slice's min tiles are rewritten 16 pairs later");
  extern __shared__ __align__(128) uint8_t smem[];
  const RowRing<BM, Q5> ring(smem, sizeof(Q4MinTiles<BM>));
  Q4MinTiles<BM>& mt = *static_cast<Q4MinTiles<BM>*>(ring.extra());
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * mrt::kGemvCols;
  const int npairs = K / 64;
  const int p_begin = blockIdx.z * pairs_per_split;
  const int n = max(0, min(pairs_per_split, npairs - p_begin));
  // the pair of step i (Q5: group by group) and, with Q5, its qh plane
  auto pair_of = [&](int i) {
    const int s = p_begin + i;
    return Q5 ? (s & 3) * (K / 256) + (s >> 2) : s;
  };

  auto copy = [&](Stage& S, int i, uint64_t* full) {
    const int pr = pair_of(i);
    mrt::tma_load_2d(S.q, &qmap, col0, 32 * pr, full);
    mrt::tma_load_3d(S.sc[0], &smap, col0, pr, 0, full);  // rows pr, npairs + pr
    mrt::tma_load_3d(S.sc[2], &mmap, col0, pr, 0, full);
    if constexpr (Q5) mrt::tma_load_2d(S.qh, &hmap, col0, 32 * ((p_begin + i) >> 2), full);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t sub = (size_t)(h ? npairs + pr : pr);
      mrt::bulk_g2s(S.x[h], xq + sub * bpad * 32 + (size_t)row0 * 32, BM * 32, full);
      mrt::bulk_g2s(S.xv[h], xs + sub * bpad + row0, BM * 4, full);
      mrt::bulk_g2s(S.xv[2 + h], xsum + sub * bpad + row0, BM * 4, full);
    }
  };
  auto decode = [&](Stage& S, int i, int lane) {
    const uint32_t sel = mrt::rot_sel(lane >> 1);
    const int plane = (p_begin + i) & 3;  // Q5: the low sub-block's plane; the high one's is + 4
    // the 4 byte-row octets of the lane's column quad
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      uint32_t w[8], hb[8];
      mrt::load_quad8(S.q, 8 * o, lane, sel, w);
      if constexpr (Q5) mrt::load_quad8(S.qh, 8 * o, lane, sel, hb);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * lane + ((j + (lane >> 1)) & 3);
        uint32_t lo[2], hi[2];  // K rows 8o..8o+3 and 8o+4..8o+7 of column c
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          lo[e] = w[j + 4 * e] & 0x0F0F0F0Fu;
          hi[e] = (w[j + 4 * e] >> 4) & 0x0F0F0F0Fu;
          if constexpr (Q5) {
            lo[e] |= (hb[j + 4 * e] << (4 - plane)) & 0x10101010u;  // bit `plane` to bit 4
            hi[e] |= (hb[j + 4 * e] >> plane) & 0x10101010u;        // bit plane + 4 to bit 4
          }
        }
        mrt::store_b8(S.lo, c, 8 * o, lo[0], lo[1]);
        mrt::store_b8(S.hi, c, 8 * o, hi[0], hi[1]);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const uint2 u = *reinterpret_cast<const uint2*>(&S.sc[a][4 * lane]);
      S.scf[a][mrt::scale_pos(4 * lane)] = mrt::bf16_lo(u.x);
      S.scf[a][mrt::scale_pos(4 * lane + 1)] = mrt::bf16_hi(u.x);
      S.scf[a][mrt::scale_pos(4 * lane + 2)] = mrt::bf16_lo(u.y);
      S.scf[a][mrt::scale_pos(4 * lane + 3)] = mrt::bf16_hi(u.y);
    }
    // this pair's slots 2j, 2j+1 of the slice's min tiles (and zeros in the
    // slots past the last pair)
    const int buf = (i >> 3) & 1, j = i & 7;
    uint8_t* ma = reinterpret_cast<uint8_t*>(mt.a[buf][0]);
    uint8_t* mb = reinterpret_cast<uint8_t*>(mt.b[buf]);
    for (int r = lane; r < BM; r += 32) {
      __nv_bfloat16 pl[3], ph[3];
      mrt::split3(S.xv[2][r], pl);
      mrt::split3(S.xv[3][r], ph);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        *reinterpret_cast<uint32_t*>(ma + t * BM * 32 + (r >> 6) * 2048 + (j >> 2) * 1024 +
                                     (r & 63) * 16 + 4 * (j & 3)) = mrt::bf16_pair(pl[t], ph[t]);
    }
#pragma unroll
    for (int c = lane; c < mrt::kGemvCols; c += 32)
      *reinterpret_cast<uint32_t*>(mb + (j >> 2) * 2048 + c * 16 + 4 * (j & 3)) =
          mrt::bf16_pair(S.sc[2][c], S.sc[3][c]);
    if (i == n - 1)
      for (int jz = j + 1; jz < 8; ++jz) {
        for (int r = lane; r < BM; r += 32)
#pragma unroll
          for (int t = 0; t < 3; ++t)
            *reinterpret_cast<uint32_t*>(ma + t * BM * 32 + (r >> 6) * 2048 + (jz >> 2) * 1024 +
                                         (r & 63) * 16 + 4 * (jz & 3)) = 0u;
        for (int c = lane; c < mrt::kGemvCols; c += 32)
          *reinterpret_cast<uint32_t*>(mb + (jz >> 2) * 2048 + c * 16 + 4 * (jz & 3)) = 0u;
      }
  };
  // consumer warpgroup wg: rows 64*wr.., columns 64*wc.. of the tile
  auto consume = [&](int wg) {
    const int wr = BM == 128 ? wg : 0, wc = BM == 128 ? 0 : wg;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int t = lane & 3;
    const int rl = wr * 64 + warp * 16 + (lane >> 2);  // rows rl and rl + 8 of the tile
    const int sp = t * 36 + wc * 16;                   // the thread's columns in scf rows
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    int dl[N / 2], dh[N / 2];
    // wgmma of the low (h = 0) or high (h = 1) sub-block of pair i into d
    auto mma = [&](int (&d)[N / 2], int i, int h) {
      const Stage& S = ring[i];
      if (h == 0) ring.acquire(i);
      mrt::fence_operand(d);
      mrt::wgmma_fence();
      mrt::wgmma_s8<N>(d, mrt::kmajor_desc(S.x[h] + wr * 2048, mrt::kALbo, mrt::kTileSbo),
                       mrt::kmajor_desc((h ? S.hi : S.lo) + wc * 1024, mrt::kBLbo, mrt::kTileSbo),
                       0);
      mrt::wgmma_commit();
    };
    // acc += d * xs * scale of sub-block h of a stage
    auto scale_into = [&](const int (&d)[N / 2], const Stage& S, int h) {
      const float x0 = S.xv[h][rl], x1 = S.xv[h][rl + 8];
#pragma unroll
      for (int jj = 0; jj < N / 8; jj += 2) {
        const float4 a4 = *reinterpret_cast<const float4*>(&S.scf[h][sp + 2 * jj]);
        const float sc[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {  // n-tiles jj, jj + 1; bit 0 column, bit 1 row
          const int idx = 4 * jj + e;
          acc[idx] = fmaf((float)d[idx], ((e & 2) ? x1 : x0) * sc[(e >> 2) * 2 + (e & 1)],
                          acc[idx]);
        }
      }
    };
    if (n > 0) {
      mma(dl, 0, 0);
      mma(dh, 0, 1);
    }
    // the low sub-block's epilogue runs while the high one's wgmma does, the
    // high one's while the next pair's low one's does
    for (int i = 0; i < n; ++i) {
      const Stage& S = ring[i];
      mrt::wgmma_wait<1>();  // the low sub-block of pair i is done
      mrt::fence_operand(dl);
      scale_into(dl, S, 0);
      if (i + 1 < n) {
        mma(dl, i + 1, 0);
        mrt::wgmma_wait<1>();  // the high sub-block of pair i is done
      } else {
        mrt::wgmma_wait<0>();
      }
      mrt::fence_operand(dh);
      scale_into(dh, S, 1);
      ring.release(i);
      if ((i & 7) == 7 || i == n - 1) {
        // the slice's last pair: its min term, in dh's registers (free until
        // the next pair's high sub-block), added into acc
        const int buf = (i >> 3) & 1;
        mrt::fence_operand(dh);
        mrt::wgmma_fence();
#pragma unroll
        for (int t = 0; t < 3; ++t)
          mrt::wgmma_bf16_neg<N>(
              dh, mrt::kmajor_desc(mt.a[buf][t] + wr * 64 * 16, mrt::kALbo, mrt::kTileSbo),
              mrt::kmajor_desc(mt.b[buf] + wc * 64 * 8, mrt::kBLbo, mrt::kTileSbo), t);
        mrt::wgmma_commit();
        mrt::wgmma_wait<0>();
        mrt::fence_operand(dh);
#pragma unroll
        for (int k = 0; k < N / 2; ++k) acc[k] += __int_as_float(dh[k]);
      }
      if (i + 1 < n) mma(dh, i + 1, 1);
    }
    mrt::store_rows(out, out_mode, acc, B, O, row0 + rl, col0 + wc * 64 + 2 * t);
  };
  ring.run(n,
           32 * mrt::kGemvCols + 4 * 2 * mrt::kGemvCols + 64 * BM + 16 * BM +
               (Q5 ? 32 * mrt::kGemvCols : 0),
           copy, decode, consume);
}

#define Q4ROWS_KERNEL(name, Q5)                                                                \
  template <int BM>                                                                            \
  __global__ void __launch_bounds__(mrt::kRowThreads, 1)                                       \
      name(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap smap, \
           const __grid_constant__ CUtensorMap mmap, const __grid_constant__ CUtensorMap hmap, \
           const int8_t* __restrict__ xq, const float* __restrict__ xs,                        \
           const float* __restrict__ xsum, void* out, int out_mode, int B, int bpad, int K,    \
           int O, int pairs_per_split) {                                                       \
    q4rows::rows_body<BM, Q5>(qmap, smap, mmap, hmap, xq, xs, xsum, out, out_mode, B, bpad, K, \
                              O, pairs_per_split);                                             \
  }

// Launch the rows kernel `kern` (q4k_q8_rows_kernel<BM> or
// q5k_q8_rows_kernel<BM>) on qs [K/2, O] (and, with Q5, qh [K/8, O]) in boxes
// of 32 byte rows x 128 columns, and scale and minv [K/32, O] seen as [2,
// K/64, O], so one box holds rows p and K/64 + p. Returns the CUDA error.
template <int BM, bool Q5, typename Kern>
int launch_rows(Kern* kern, const mrt::Workspace& w, const void* qs, const void* qh, const void* scale,
                const void* minv, void* out, int out_is_bf16, int B, int K, int O, dim3 grid,
                cudaStream_t st) {
  const int npairs = K / 64;
  CUtensorMap qmap, smap, mmap, hmap;
  const uint64_t qdims[2] = {(uint64_t)O, (uint64_t)(K / 2)}, qstr[1] = {(uint64_t)O};
  const uint64_t hdims[2] = {(uint64_t)O, (uint64_t)(K / 8)};
  const uint32_t qbox[2] = {mrt::kGemvCols, 32};
  const uint64_t sdims[3] = {(uint64_t)O, (uint64_t)npairs, 2};
  const uint64_t sstr[2] = {(uint64_t)O * 2, (uint64_t)npairs * O * 2};
  const uint32_t sbox[3] = {mrt::kGemvCols, 1, 2};
  int err = mrt::tile_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qs, qdims, qstr, qbox);
  if (!err) err = mrt::tile_map(&smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, scale, sdims, sstr, sbox);
  if (!err) err = mrt::tile_map(&mmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, minv, sdims, sstr, sbox);
  if constexpr (Q5) {
    if (!err) err = mrt::tile_map(&hmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qh, hdims, qstr, qbox);
  } else {
    hmap = qmap;  // unused
  }
  if (err) return err;
  const int smem = RowRing<BM, Q5>::smem_bytes(sizeof(Q4MinTiles<BM>));
  const int ksplit = (int)grid.z;
  return mrt::launch_ring(kern, smem, w, out, out_is_bf16, ksplit, B * O, st,
                          [&](void* dst, int mode) {
                            kern<<<grid, mrt::kRowThreads, smem, st>>>(
                                qmap, smap, mmap, hmap, w.xq, w.xs, w.xsum, dst, mode, B, w.bpad,
                                K, O, pairs_per_split<Q5>(K, ksplit));
                          });
}

}  // namespace q4rows
