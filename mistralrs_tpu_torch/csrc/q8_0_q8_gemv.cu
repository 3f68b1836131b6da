// K2: int8 weights with a scale per `gs` rows x int8 activations (wire Q8_0,
// gs 32 with bf16 scales, and the Q6_K -> int8 requant "rq8" layout, f32
// scales, gs 32 or 64), for decode-sized row counts.
//
// Replaces the TPU kernel mistralrs_tpu/ops/quant_matmul.py::_q8_0_q8_kernel
// (launched by _q8_0_q8_matmul_padded and _q8_0_q8_matmul_stacked).
//
// Computes, for x quantized per gs-element block (xq int8, scale xs; the
// first of the two kernels of a call does that quantization, see
// common.cuh):
//   y[b,o] = sum_g xs[b,g] * s[g,o] * (sum_{k in g} xq[b,k] q[k,o])
//
// Layouts (row-major): x [B,K] bf16 or f32, q [K,O] int8, s [K/gs,O] f32 or
// bf16, out [B,O] bf16 or f32; in the workspace xq and xs as common.cuh's
// carve lays them out for the instantiation.
//
// What bounds it on an H100: at decode the weight stream, 1 + 4/gs bytes per
// weight for f32 scales (1 + 2/gs for bf16), against 3.35 TB/s.
// Design for that (B <= 16, q8_0_q8_dec_kernel): K1's decode design
// (q4k_q8_gemv.cu; common.cuh's decode section) without the nibbles and
// the min term. Two launches a call (quantize, then the GEMV by
// programmatic dependent launch); a block owns C = 128 or 64 columns and
// one K split, the splits of a column tile one cluster that adds its f32
// tiles in distributed shared memory (no partials in global memory); a
// ring stage holds 64 rows (64/gs groups): a producer warp brings their
// rows of q (the 128-byte swizzle at C = 128) and their scale rows in two
// TMA boxes, at most half the ring ahead of what has landed, another x's
// codes and scales in two bulk copies; dec_stages(64 * C + (64/gs) * C *
// sizeof(scale)) stages; each consumer warp owns 32 columns, the weight
// the mma's A operand and x its B operand (one n-tile up to 8 rows), gs/32
// mma.m16n8k32 an n-tile and m-tile into one exact int32 group dot,
// scaled by exact_f32(dot) * (xs * s) into an f32 sum: per (row, column,
// group) IADD, FADD, FMUL, FFMA, where the earlier 16-row kernel spent an
// I2F conversion (a quarter of the FMA rate) and three FP ops.
//
// At 17-256 rows (the rows instantiation below) the scaling epilogue bounds
// it: a conversion, an f32 scale product and an accumulate per (row,
// column, group), bound by issue slots. Design for that: a block owns 128
// columns and 64 or 128 rows, so each weight tile is read once per call
// (twice at 129-256 rows, by blocks that are grid neighbours and meet in
// L2); int8 wgmma does the dots, and the epilogue of one group runs while
// the next group's wgmma does; see q8_0_q8_rows_kernel.
#include "common.cuh"

namespace {

// a ring stage of the decode kernel: kDecSub * 32 rows of C columns, G =
// kDecSub * 32 / GS scale groups
template <int C, int GS, typename ST>
struct alignas(C == 128 ? 1024 : 128) Q8DecStage {
  static constexpr int G = mrt::kDecSub * 32 / GS;
  uint8_t q[mrt::kDecSub * 32 * C];                // the rows (TMA, swizzled at C = 128)
  ST sc[G][C];                                     // their scale rows
  int8_t x[mrt::kDecSub][mrt::kDecRows * 32];      // x's codes, a slice per 32 rows
  float xs[G][mrt::kDecRows];                      // x's scales of the groups
};
template <int C, int GS, typename ST>
constexpr int kQ8DecWeightBytes = mrt::kDecSub * 32 * C + (mrt::kDecSub * 32 / GS) * C * (int)sizeof(ST);
template <int C, int GS, typename ST>
constexpr int kQ8DecStages = mrt::dec_stages(kQ8DecWeightBytes<C, GS, ST>);
template <int C, int GS, typename ST>
using Q8DecRing = mrt::DecRing<Q8DecStage<C, GS, ST>, kQ8DecStages<C, GS, ST>, C / 32>;

// A consumer warp's n groups: y[nt][m][e] = the f32 sums of x row 8nt + 2t +
// e%2 and column 32 * warp + 4g + 2m + e/2 (NT n-tiles: 1 up to 8 rows).
template <int C, int GS, typename ST, int NT>
__device__ __forceinline__ void q8_dec_consume(const Q8DecRing<C, GS, ST>& ring, int n, int warp,
                                               int lane, float (&y)[2][2][4]) {
  constexpr int G = Q8DecStage<C, GS, ST>::G;
  const int g = lane >> 2, t = lane & 3, c = 32 * warp + 4 * g;
  float acc[NT * 8];  // index (nt * 2 + m) * 4 + e
#pragma unroll
  for (int i = 0; i < NT * 8; ++i) acc[i] = 0.f;
  for (int i = 0; i * G < n; ++i) {
    const Q8DecStage<C, GS, ST>& S = ring[i];
    const int nv = min(G, n - i * G);
    ring.acquire(i);
    for (int j = 0; j < nv; ++j) {
      int d[NT * 2][4];
#pragma unroll
      for (int k = 0; k < NT * 2; ++k) d[k][0] = d[k][1] = d[k][2] = d[k][3] = 0;
#pragma unroll
      for (int sl = 0; sl < GS / 32; ++sl) {  // the group's 32-row slices: one int32 dot
        const int r = j * GS + 32 * sl;
        uint32_t w0[4], w1[4];
        mrt::w_frags<C>(S.q + r * C, 0, c, t, w0, w1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t xb[2];
          mrt::x_frag(S.x[r / 32], 8 * nt + g, t, xb);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const uint32_t a[4] = {w0[2 * m], w0[2 * m + 1], w1[2 * m], w1[2 * m + 1]};
            mrt::mma_s8(d[nt * 2 + m], a, xb[0], xb[1]);
          }
        }
      }
      float sc[4];
      mrt::lds4(&S.sc[j][c], sc);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 xs = *reinterpret_cast<const float2*>(&S.xs[j][8 * nt + 2 * t]);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = (nt * 2 + m) * 4 + e;
            acc[k] = fmaf(mrt::exact_f32(d[nt * 2 + m][e]),
                          ((e & 1) ? xs.y : xs.x) * sc[2 * m + (e >> 1)], acc[k]);
          }
      }
    }
    mrt::fence_values(acc);  // every read of the stage has landed in a register
    ring.release(i);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[nt][m][e] = acc[(nt * 2 + m) * 4 + e];
}

template <int C, int GS, typename ST>
__global__ void __launch_bounds__(mrt::dec_threads(C), 3)
    q8_0_q8_dec_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap smap, const int8_t* __restrict__ xq,
                       const float* __restrict__ xs, void* out, int out_is_bf16, int B, int K,
                       int O, int groups_per_split) {
  constexpr int NW = C / 32;  // consumer warps; the producers are warps NW and NW + 1
  using Stage = Q8DecStage<C, GS, ST>;
  constexpr int G = Stage::G;
  extern __shared__ uint8_t smem[];
  const Q8DecRing<C, GS, ST> ring(smem);
  const int splits = (int)gridDim.x, rank = (int)mrt::cluster_rank();
  const int col0 = blockIdx.y * C;
  const int g_begin = rank * groups_per_split;
  const int n = max(0, min(groups_per_split, K / GS - g_begin));
  const int stages = (n + G - 1) / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  float y[2][2][4] = {};
  if (warp == NW) {  // the weights: TMA boxes of G groups
    if (lane == 0) {
      mrt::prefetch_tensormap(&qmap);
      mrt::prefetch_tensormap(&smap);
      ring.produce(
          stages, true, [](int) { return (uint32_t)kQ8DecWeightBytes<C, GS, ST>; },
          [&](Stage& S, int i, uint64_t* full) {
            const int grp = g_begin + i * G;
            mrt::tma_load_2d(S.q, &qmap, col0, GS * grp, full);
            mrt::tma_load_2d(S.sc, &smap, col0, grp, full);
          });
    }
    __syncwarp();
  } else if (warp == NW + 1) {  // x's codes and scales, from the quantize kernel
    if (lane == 0) {
      mrt::grid_dep_wait();  // the quantize kernel's codes are written
      auto nv = [&](int i) { return min(G, n - i * G); };
      ring.produce(
          stages, false, [&](int i) { return (uint32_t)(nv(i) * (GS * mrt::kDecRows + 64)); },
          [&](Stage& S, int i, uint64_t* full) {
            const size_t grp = (size_t)(g_begin + i * G);
            mrt::bulk_g2s(S.x[0], xq + grp * GS * mrt::kDecRows, nv(i) * GS * mrt::kDecRows,
                          full);
            mrt::bulk_g2s(S.xs[0], xs + grp * mrt::kDecRows, nv(i) * 64, full);
          });
    }
    __syncwarp();
  } else if (B > 8) {
    q8_dec_consume<C, GS, ST, 2>(ring, n, warp, lane, y);
  } else {
    q8_dec_consume<C, GS, ST, 1>(ring, n, warp, lane, y);
  }
  if (splits == 1) {  // no cluster to add up
    if (warp < NW) mrt::dec_store_out(y, B > 8 ? 2 : 1, out, out_is_bf16, B, O, col0, warp, lane);
    return;
  }
  __syncthreads();  // every stage consumed: the ring's memory holds the tile now
  float* red = static_cast<float*>(ring.base());
  if (warp < NW) mrt::dec_store_tile<C>(red, y, B > 8 ? 2 : 1, warp, lane);
  mrt::cluster_sync();
  mrt::dec_reduce<C>(red, out, out_is_bf16, B, O, col0, splits, rank);
  mrt::cluster_sync();  // no block leaves while another reads its tile
}

// q [K, O] bytes in boxes of `groups` * GS rows x C columns (the 128-byte
// swizzle at C = 128, none for the rows instantiation); s [K/GS, O] in
// boxes of `groups` rows
template <typename ST>
int q8_maps(CUtensorMap* qmap, CUtensorMap* smap, const void* q, const void* s, int K, int O,
            int GS, int C, int groups, bool swizzle) {
  const uint64_t qdims[2] = {(uint64_t)O, (uint64_t)K}, qstr[1] = {(uint64_t)O};
  const uint32_t qbox[2] = {(uint32_t)C, (uint32_t)(GS * groups)};
  const uint64_t sdims[2] = {(uint64_t)O, (uint64_t)(K / GS)}, sstr[1] = {O * sizeof(ST)};
  const uint32_t sbox[2] = {(uint32_t)C, (uint32_t)groups};
  const int err = mrt::tile_map(qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, qdims, qstr, qbox,
                                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  return mrt::tile_map(smap, sizeof(ST) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       2, s, sdims, sstr, sbox);
}

template <int C, int GS, typename ST>
int launch_dec(const mrt::Workspace& w, const void* q, const void* s, void* out, int out_is_bf16,
               int B, int K, int O, int splits, cudaStream_t st) {
  CUtensorMap qmap, smap;
  const int G = Q8DecStage<C, GS, ST>::G;
  const int err = q8_maps<ST>(&qmap, &smap, q, s, K, O, GS, C, G, C == 128);
  if (err) return err;
  // the groups a split takes: whole stages (dec_per_split counts 32-row
  // slices, kDecSub a stage)
  const int per = mrt::dec_per_split(K / 32, splits) / (GS / 32);
  return mrt::launch_dec(q8_0_q8_dec_kernel<C, GS, ST>, splits, (O + C - 1) / C,
                         mrt::dec_threads(C), Q8DecRing<C, GS, ST>::smem_bytes(), st, qmap, smap,
                         static_cast<const int8_t*>(w.xq), static_cast<const float*>(w.xs), out,
                         out_is_bf16, B, K, O, per);
}

// the stages of the decode instantiation for (cols, gs, scale type), 0 for another
int q8_dec_stages(int cols, int gs, bool bf16) {
  if (cols == 128 && gs == 32) return bf16 ? kQ8DecStages<128, 32, __nv_bfloat16> : kQ8DecStages<128, 32, float>;
  if (cols == 128 && gs == 64) return bf16 ? kQ8DecStages<128, 64, __nv_bfloat16> : kQ8DecStages<128, 64, float>;
  if (cols == 64 && gs == 32) return bf16 ? kQ8DecStages<64, 32, __nv_bfloat16> : kQ8DecStages<64, 32, float>;
  if (cols == 64 && gs == 64) return bf16 ? kQ8DecStages<64, 64, __nv_bfloat16> : kQ8DecStages<64, 64, float>;
  return 0;
}

template <int GS, typename ST>
int launch_dec_cols(int cols, const mrt::Workspace& w, const void* q, const void* s, void* out,
                    int out_is_bf16, int B, int K, int O, int splits, cudaStream_t st) {
  if (cols == 128) return launch_dec<128, GS, ST>(w, q, s, out, out_is_bf16, B, K, O, splits, st);
  return launch_dec<64, GS, ST>(w, q, s, out, out_is_bf16, B, K, O, splits, st);
}

}  // namespace

// ---- rows instantiation: 17 <= B <= 256 ----
//
// A block owns 128 columns and BM = 64 or 128 rows, with two consumer
// warpgroups (at BM 128 one per 64 rows, wgmma N = 128; at BM 64 one per 64
// columns, N = 64) and one producer warpgroup. The grid is (row tiles,
// column tiles, ksplit), row tiles fastest, so the two row tiles of a
// column tile run side by side and the second finds the weight tile in L2.
// One K step is one group, on the ring of common.cuh (mrt::Ring):
// - the copies: TMA boxes of the group's gs rows x 128 columns of q and its
//   scale row (tensor maps, zero-filled past O), and bulk copies
//   (cp.async.bulk) of x's int8 codes of the BM rows (laid out by the
//   quantize kernel as the wgmma A operand wants them, common.cuh
//   tiled_off) and their scales;
// - the decode: the byte transpose of q into K-major tiles (int8 wgmma
//   reads B K-major only; the packed layout stays N-major), and the scale
//   row into f32 at mrt::scale_pos;
// - each consumer warpgroup runs gs/32 wgmma.m64nNk32.s32.s8.s8 per group
//   into one of two int32 accumulators, alternating by group, so the f32
//   epilogue of group i (the conversion, exact below 2^24, xs * s, one
//   fma) runs while the tensor cores work on group i + 1. The two
//   warpgroups share each SM sub-partition.
// - With one split the block writes out; with more, f32 partials for the
//   fixed-order second pass.
namespace {

template <int GS, int BM, typename ST>
struct __align__(128) RowStage {
  uint8_t q[GS * mrt::kGemvCols];  // the group's rows as stored, row r at r*128
  uint8_t b[GS * mrt::kGemvCols];  // GS/32 decoded K-major B tiles of 4 KB
  int8_t x[GS / 32][BM * 32];      // x's codes: GS/32 A slices
  ST sc[mrt::kGemvCols];           // the scale row as stored
  float scf[mrt::kScaleRow];       // the same in f32, at scale_pos
  float xs[BM];                    // x's scales of the BM rows
};

template <int GS, int BM, typename ST>
using RowRing = mrt::Ring<RowStage<GS, BM, ST>, mrt::ring_stages<RowStage<GS, BM, ST>>()>;

template <int GS, int BM, typename ST>
__global__ void __launch_bounds__(mrt::kRowThreads, 1)
    q8_0_q8_rows_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap smap, const int8_t* __restrict__ xq,
                        const float* __restrict__ xs, void* out, int out_mode, int B, int bpad,
                        int K, int O, int groups_per_split) {
  constexpr int N = BM == 128 ? 128 : 64;  // wgmma width of a consumer warpgroup
  using Stage = RowStage<GS, BM, ST>;
  extern __shared__ __align__(128) uint8_t smem[];
  const RowRing<GS, BM, ST> ring(smem, 0);
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * mrt::kGemvCols;
  const int g_begin = blockIdx.z * groups_per_split;
  const int n = max(0, min(groups_per_split, K / GS - g_begin));

  auto copy = [&](Stage& S, int i, uint64_t* full) {
    const int grp = g_begin + i;
    mrt::tma_load_2d(S.q, &qmap, col0, GS * grp, full);
    mrt::tma_load_2d(S.sc, &smap, col0, grp, full);
#pragma unroll
    for (int sl = 0; sl < GS / 32; ++sl)
      mrt::bulk_g2s(S.x[sl], xq + ((size_t)grp * (GS / 32) + sl) * bpad * 32 + (size_t)row0 * 32,
                    BM * 32, full);
    mrt::bulk_g2s(S.xs, xs + (size_t)grp * bpad + row0, BM * 4, full);
  };
  auto decode = [&](Stage& S, int, int lane) {
    const uint32_t sel = mrt::rot_sel(lane >> 1);
    // GS/8 row octets of the lane's column quad
#pragma unroll
    for (int o = 0; o < GS / 8; ++o) {
      uint32_t w[8];
      mrt::load_quad8(S.q, 8 * o, lane, sel, w);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mrt::store_b8(S.b + (o >> 2) * 4096, 4 * lane + ((j + (lane >> 1)) & 3), (8 * o) & 31,
                      w[j], w[4 + j]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) S.scf[mrt::scale_pos(4 * lane + k)] = mrt::to_f32(S.sc[4 * lane + k]);
  };
  // consumer warpgroup wg: rows 64*wr.., columns 64*wc.. of the tile
  auto consume = [&](int wg) {
    const int wr = BM == 128 ? wg : 0, wc = BM == 128 ? 0 : wg;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int t = lane & 3;
    const int rl = wr * 64 + warp * 16 + (lane >> 2);  // rows rl and rl + 8 of the tile
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    int d0[N / 2], d1[N / 2];
    // wgmma of group i into d (its stage decoded first)
    auto mma = [&](int (&d)[N / 2], int i) {
      const Stage& S = ring[i];
      ring.acquire(i);
      mrt::fence_operand(d);
      mrt::wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < GS / 32; ++sl)
        mrt::wgmma_s8<N>(d, mrt::kmajor_desc(S.x[sl] + wr * 2048, mrt::kALbo, mrt::kTileSbo),
                         mrt::kmajor_desc(S.b + sl * 4096 + wc * 1024, mrt::kBLbo,
                                          mrt::kTileSbo),
                         sl);
      mrt::wgmma_commit();
    };
    // scale the finished dots of group i into acc, then free its stage
    auto epilogue = [&](int (&d)[N / 2], int i) {
      mrt::fence_operand(d);
      const Stage& S = ring[i];
      const float x0 = S.xs[rl], x1 = S.xs[rl + 8];
#pragma unroll
      for (int jj = 0; jj < N / 8; jj += 2) {
        const float4 c4 = *reinterpret_cast<const float4*>(&S.scf[t * 36 + wc * 16 + 2 * jj]);
        const float cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {  // n-tiles jj, jj + 1; bit 0 column, bit 1 row
          const int idx = 4 * jj + e;
          acc[idx] = fmaf((float)d[idx], ((e & 2) ? x1 : x0) * cs[(e >> 2) * 2 + (e & 1)],
                          acc[idx]);
        }
      }
      ring.release(i);
    };
    // two groups in flight: the epilogue of one overlaps the wgmma of the
    // next, in pairs of groups as K1's sub-block pairs. An odd last group is
    // issued twice and scaled once, so the loop stays one shape (a group
    // issued after it makes ptxas serialize every wgmma).
    auto second = [&](int i) { return i + 1 < n ? i + 1 : i; };
    if (n > 0) {
      mma(d0, 0);
      mma(d1, second(0));
    }
    for (int i = 0; i < n; i += 2) {
      mrt::wgmma_wait<1>();  // group i is done
      epilogue(d0, i);
      if (i + 2 < n) {
        mma(d0, i + 2);
        mrt::wgmma_wait<1>();  // group i + 1 is done
      } else {
        mrt::wgmma_wait<0>();
      }
      if (i + 1 < n) epilogue(d1, i + 1);
      if (i + 2 < n) mma(d1, second(i + 2));
    }
    mrt::store_rows(out, out_mode, acc, B, O, row0 + rl, col0 + wc * 64 + 2 * t);
  };
  ring.run(n, GS * mrt::kGemvCols + mrt::kGemvCols * (int)sizeof(ST) + GS * BM + BM * 4, copy,
           decode, consume);
}

template <int GS, int BM, typename ST>
int launch_rows(const mrt::Workspace& w, const void* q, const void* s, void* out, int out_is_bf16,
                int B, int K, int O, dim3 grid, cudaStream_t st) {
  CUtensorMap qmap, smap;
  const int err = q8_maps<ST>(&qmap, &smap, q, s, K, O, GS, mrt::kGemvCols, 1, false);
  if (err) return err;
  auto* kern = q8_0_q8_rows_kernel<GS, BM, ST>;
  const int smem = RowRing<GS, BM, ST>::smem_bytes(0);
  const int ksplit = (int)grid.z, ngroups = K / GS;
  return mrt::launch_ring(kern, smem, w, out, out_is_bf16, ksplit, B * O, st,
                          [&](void* dst, int mode) {
                            kern<<<grid, mrt::kRowThreads, smem, st>>>(
                                qmap, smap, w.xq, w.xs, dst, mode, B, w.bpad, K, O,
                                (ngroups + ksplit - 1) / ksplit);
                          });
}

template <int GS, typename ST>
int launch_rows_bm(int rows, const mrt::Workspace& w, const void* q, const void* s, void* out,
                   int out_is_bf16, int B, int K, int O, dim3 grid, cudaStream_t st) {
  if (rows == 64) return launch_rows<GS, 64, ST>(w, q, s, out, out_is_bf16, B, K, O, grid, st);
  return launch_rows<GS, 128, ST>(w, q, s, out, out_is_bf16, B, K, O, grid, st);
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): gs in
// {32, 64}, K % gs == 0, O % 16 == 0, 16-byte aligned pointers, and a
// workspace of ws_bytes (see mrt::carve). The launch is the plan of
// ops/quant_matmul.int8_gemv_plan, every field of it checked here, as in
// q4k_q8_gemv: rows 16 (B <= 16) the decode instantiation, grid (K splits
// <= K/gs, column tiles of `cols` = 128 or 64, 1), a cluster of the splits
// (at most 8), its stages (kQ8DecStages), two launches; rows 64 or 128 the
// rows instantiation, grid (row tiles, column tiles, K splits), cluster 1,
// cols 128, stages 0, and the split-K pass after more than one split.
// Quantizes x (bf16 or f32 [B,K]) per gs first. Returns the CUDA error
// code of the launches (0 = launched).
extern "C" int q8_0_q8_gemv(const void* x, int x_is_bf16, const void* q, const void* s,
                            int scale_is_bf16, int gs, void* ws, long long ws_bytes, void* out,
                            int out_is_bf16, int B, int K, int O, int rows, int gx, int gy, int gz,
                            int cluster, int cols, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((gs != 32 && gs != 64) || (rows != 16 && rows != 64 && rows != 128))
    return (int)cudaErrorInvalidValue;
  const bool dec = rows == 16;
  const int ksplit = dec ? gx : gz;
  const mrt::Workspace w =
      mrt::carve(ws, B, K, O, gs, 0, ksplit, dec ? mrt::kDecode : mrt::kTiled, rows);
  const bool plan_ok =
      dec ? cluster == gx && gx <= 8 && stages != 0 &&
                stages == q8_dec_stages(cols, gs, scale_is_bf16 != 0)
          : cluster == 1 && cols == mrt::kGemvCols && stages == 0;
  if (!plan_ok || w.bytes > (size_t)ws_bytes || ksplit < 1 || ksplit > K / gs ||
      !mrt::grid_covers(w, rows, cols, B, O, gx, gy, gz))
    return (int)cudaErrorInvalidValue;
  const mrt::XLayout layout = dec ? mrt::kDecode : mrt::kTiled;
  if (gs == 32)
    mrt::launch_quantize<32>(x, x_is_bf16 != 0, w.xq, w.xs, nullptr, nullptr, B, K, w.bpad, st,
                             layout);
  else
    mrt::launch_quantize<64>(x, x_is_bf16 != 0, w.xq, w.xs, nullptr, nullptr, B, K, w.bpad, st,
                             layout);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dec) {
    if (gs == 32)
      return scale_is_bf16
                 ? launch_dec_cols<32, __nv_bfloat16>(cols, w, q, s, out, out_is_bf16, B, K, O, gx, st)
                 : launch_dec_cols<32, float>(cols, w, q, s, out, out_is_bf16, B, K, O, gx, st);
    return scale_is_bf16
               ? launch_dec_cols<64, __nv_bfloat16>(cols, w, q, s, out, out_is_bf16, B, K, O, gx, st)
               : launch_dec_cols<64, float>(cols, w, q, s, out, out_is_bf16, B, K, O, gx, st);
  }
  const dim3 grid(gx, gy, gz);
  if (gs == 32)
    return scale_is_bf16
               ? launch_rows_bm<32, __nv_bfloat16>(rows, w, q, s, out, out_is_bf16, B, K, O, grid, st)
               : launch_rows_bm<32, float>(rows, w, q, s, out, out_is_bf16, B, K, O, grid, st);
  return scale_is_bf16
             ? launch_rows_bm<64, __nv_bfloat16>(rows, w, q, s, out, out_is_bf16, B, K, O, grid, st)
             : launch_rows_bm<64, float>(rows, w, q, s, out, out_is_bf16, B, K, O, grid, st);
}

// ---- dequantization for prefill-sized calls ----
//
// The pass XLA fuses in the JAX package's dequant_q8_0_gs_weights for the
// prefill route: w[k, o] = bf16(q * bf16(s[k/gs, o])), K-major [K, O] bf16,
// rounded as the plain version's bf16 ops round. Bound: bytes (1 + 4/gs
// read + 2 written per weight). A thread owns 8 neighbouring columns of one
// row.
namespace {

template <typename ST>
__global__ void q8_0_dequant_kernel(const int8_t* __restrict__ q, const ST* __restrict__ s,
                                    __nv_bfloat16* __restrict__ w, int K, int O, int gs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per_row = O / 8;
  if (i >= (long long)K * per_row) return;
  const int k = (int)(i / per_row), c = (int)(i % per_row) * 8;
  const uint2 qv = __ldg(reinterpret_cast<const uint2*>(q + (size_t)k * O + c));
  const int8_t* qb = reinterpret_cast<const int8_t*>(&qv);
  const ST* sp = s + (size_t)(k / gs) * O + c;
  uint32_t out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sb = __bfloat162float(__float2bfloat16_rn(mrt::to_f32(sp[2 * j + h])));
      v[h] = (float)qb[2 * j + h] * sb;
    }
    const __nv_bfloat16 a = __float2bfloat16_rn(v[0]), b = __float2bfloat16_rn(v[1]);
    out[j] = (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
  }
  *reinterpret_cast<uint4*>(w + (size_t)k * O + c) = make_uint4(out[0], out[1], out[2], out[3]);
}

}  // namespace

// q [K, O] int8, s [K/gs, O] f32 or bf16 -> w [K, O] bf16. O % 8 == 0,
// K % gs == 0, 16-byte aligned pointers (checked by ops/quant_matmul.py).
extern "C" int q8_0_dequant(const void* q, const void* s, int scale_is_bf16, int gs, void* w,
                            int K, int O, void* stream) {
  const long long n = (long long)K * (O / 8);
  const unsigned grid = (unsigned)((n + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale_is_bf16)
    q8_0_dequant_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const __nv_bfloat16*>(s),
        static_cast<__nv_bfloat16*>(w), K, O, gs);
  else
    q8_0_dequant_kernel<float><<<grid, 256, 0, st>>>(static_cast<const int8_t*>(q),
                                                     static_cast<const float*>(s),
                                                     static_cast<__nv_bfloat16*>(w), K, O, gs);
  return (int)cudaGetLastError();
}
