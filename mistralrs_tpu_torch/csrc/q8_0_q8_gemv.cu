// K2: int8 weights with a scale per `gs` rows x int8 activations (wire Q8_0,
// gs 32 with bf16 scales, and the Q6_K -> int8 requant "rq8" layout, f32
// scales, gs 32 or 64), for decode-sized row counts.
//
// Replaces the TPU kernel mistralrs_tpu/ops/quant_matmul.py::_q8_0_q8_kernel
// (launched by _q8_0_q8_matmul_padded and _q8_0_q8_matmul_stacked).
//
// Computes, for x quantized per gs-element block (xq int8, scale xs; the
// first of the three kernels of a call does that quantization, see
// common.cuh):
//   y[b,o] = sum_g xs[b,g] * s[g,o] * (sum_{k in g} xq[b,k] q[k,o])
//
// Layouts (row-major): x [B,K] bf16 or f32, q [K,O] int8, s [K/gs,O] f32 or
// bf16, out [B,O] bf16 or f32; in the workspace xq [B,K] int8, xs [B,K/gs]
// f32, part [ksplit,B,O] f32.
//
// What bounds it on an H100: at decode the weight stream, 1 + 4/gs bytes per
// weight for f32 scales (1 + 2/gs for bf16), against 3.35 TB/s.
// Design for that (B <= 16): the structure of K1 (q4k_q8_gemv.cu) without
// the nibble unpack. A block owns 128 output columns and a 16-row tile of x;
// one K step is one scale group (gs rows x 128 columns of q, gs*128 bytes,
// plus its scale row and x's codes and scales over the group) staged with
// 16-byte cp.async loads in a 4-deep ring; each warp
// runs gs/32 int8 mma.m16n8k32 per n-tile into exact int32 group dots and
// scales them into f32 accumulators; K is split over blockIdx.y with a
// fixed-order second pass.
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

constexpr int kStages = 4;

template <int GS, typename ST>
struct Stage {
  static constexpr int kXStride = GS + 16;  // bytes per staged x row (+16 spreads the banks)
  uint8_t q[GS * mrt::kGemvCols];           // one group's rows, swizzled
  ST sc[mrt::kGemvCols];
  int8_t x[16 * kXStride];                  // x's 16 rows over the group
  float xv[16];                             // xs of the 16 rows
};

template <int GS, typename ST>
__global__ void __launch_bounds__(mrt::kGemvThreads)
    q8_0_q8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                       const int8_t* __restrict__ q, const ST* __restrict__ s,
                       float* __restrict__ part, int B, int bpad, int K, int O,
                       int groups_per_split) {
  __shared__ __align__(16) Stage<GS, ST> st[kStages];
  constexpr int kScaleChunks = mrt::kGemvCols * (int)sizeof(ST) / 16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * mrt::kGemvCols;
  const int row0 = blockIdx.z * 16;
  const int ngroups = K / GS;
  const int g_begin = blockIdx.y * groups_per_split;
  const int n = max(0, min(groups_per_split, ngroups - g_begin));

  auto load = [&](int stage, int grp) {
    mrt::stage_bytes(st[stage].q, reinterpret_cast<const uint8_t*>(q), GS * grp, GS, col0, O);
    if (threadIdx.x < kScaleChunks) {
      const int c = threadIdx.x, per = 16 / (int)sizeof(ST);
      const bool ok = col0 + per * c < O;
      mrt::cp_async16(&st[stage].sc[per * c], ok ? s + (size_t)grp * O + col0 + per * c : s, ok);
    }
    // x: GS/16 chunks per row with threads 32.., its scales with threads 0..3
    mrt::stage_x(st[stage].x, Stage<GS, ST>::kXStride, xq, B, K, row0, GS / 16, 32,
                 [&](int c) { return GS * grp + 16 * c; });
    mrt::stage_rows16(st[stage].xv, xs + (size_t)grp * bpad + row0, 0);
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) load(i, g_begin + i);
    mrt::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    mrt::cp_async_wait<kStages - 2>();
    __syncthreads();
    const Stage<GS, ST>& S = st[i % kStages];
    int d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][e] = 0;
#pragma unroll
    for (int ks = 0; ks < GS / 32; ++ks) {
      uint32_t a[4], b0[4], b1[4];
      mrt::a_frag(S.x, Stage<GS, ST>::kXStride, 32 * ks, lane, a);
      mrt::b_frags(S.q, 32 * ks, warp, lane, b0, b1);
#pragma unroll
      for (int j = 0; j < 4; ++j) mrt::mma_s8(d[j], a, b0[j], b1[j]);
    }
    const float x0 = S.xv[g], x1 = S.xv[g + 8];  // rows past B: zero codes, never stored
    const int cb = warp * 32 + 8 * t;
    float s0[4], s1[4];
    mrt::lds4(&S.sc[cb], s0);
    mrt::lds4(&S.sc[cb + 4], s1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j][0] += (float)d[j][0] * x0 * s0[j];
      acc[j][1] += (float)d[j][1] * x0 * s1[j];
      acc[j][2] += (float)d[j][2] * x1 * s0[j];
      acc[j][3] += (float)d[j][3] * x1 * s1[j];
    }
    const int next = i + kStages - 1;  // refill the stage read in the previous step
    if (next < n) load(next % kStages, g_begin + next);
    mrt::cp_async_commit();
  }
  mrt::cp_async_wait<0>();
  mrt::store_part(part + (size_t)blockIdx.y * B * O, acc, B, O, row0, col0, warp, lane);
}

// grid (column tiles, ksplit, 16-row tiles)
template <int GS, typename ST>
void launch_gs(const void* xq, const void* xs, const void* q, const void* s, float* part, int B,
               int bpad, int K, int O, dim3 grid, cudaStream_t st) {
  const int ngroups = K / GS, ksplit = (int)grid.y;
  q8_0_q8_mma_kernel<GS, ST><<<grid, mrt::kGemvThreads, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(q), static_cast<const ST*>(s), part, B, bpad, K, O,
      (ngroups + ksplit - 1) / ksplit);
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
  // q [K, O] bytes in boxes of GS rows x 128 columns; s [K/GS, O] one row at a time
  CUtensorMap qmap, smap;
  const uint64_t qdims[2] = {(uint64_t)O, (uint64_t)K}, qstr[1] = {(uint64_t)O};
  const uint32_t qbox[2] = {mrt::kGemvCols, GS};
  const uint64_t sdims[2] = {(uint64_t)O, (uint64_t)(K / GS)}, sstr[1] = {O * sizeof(ST)};
  const uint32_t sbox[2] = {mrt::kGemvCols, 1};
  int err = mrt::tile_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, qdims, qstr, qbox);
  if (err) return err;
  err = mrt::tile_map(&smap, sizeof(ST) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      2, s, sdims, sstr, sbox);
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
// workspace of ws_bytes (see mrt::carve). `rows` is the row tile of a block
// (16: the decode kernel; 64 or 128: the rows instantiation) and (gx, gy,
// gz) the grid of the launch plan (ops/quant_matmul.int8_gemv_plan), which
// also gives the K split (gy for the decode kernel, gz for the rows
// instantiation; at most K/gs). Quantizes x (bf16 or f32 [B,K]) per gs,
// then runs the GEMV and, unless a rows call has one split, the split-K
// pass. Returns the CUDA error code of the launches (0 = launched).
extern "C" int q8_0_q8_gemv(const void* x, int x_is_bf16, const void* q, const void* s,
                            int scale_is_bf16, int gs, void* ws, long long ws_bytes, void* out,
                            int out_is_bf16, int B, int K, int O, int rows, int gx, int gy, int gz,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((gs != 32 && gs != 64) || (rows != 16 && rows != 64 && rows != 128))
    return (int)cudaErrorInvalidValue;
  const bool tiled = rows != 16;
  const int ksplit = tiled ? gz : gy;
  const mrt::Workspace w = mrt::carve(ws, B, K, O, gs, 0, ksplit, rows);
  if (w.bytes > (size_t)ws_bytes || ksplit < 1 || ksplit > K / gs ||
      !mrt::grid_covers(w, rows, B, O, gx, gy, gz))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gx, gy, gz);
  if (gs == 32)
    mrt::launch_quantize<32>(x, x_is_bf16 != 0, w.xq, w.xs, nullptr, nullptr, B, K, w.bpad, st,
                             tiled);
  else
    mrt::launch_quantize<64>(x, x_is_bf16 != 0, w.xq, w.xs, nullptr, nullptr, B, K, w.bpad, st,
                             tiled);
  if (tiled) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (gs == 32)
      return scale_is_bf16
                 ? launch_rows_bm<32, __nv_bfloat16>(rows, w, q, s, out, out_is_bf16, B, K, O, grid, st)
                 : launch_rows_bm<32, float>(rows, w, q, s, out, out_is_bf16, B, K, O, grid, st);
    return scale_is_bf16
               ? launch_rows_bm<64, __nv_bfloat16>(rows, w, q, s, out, out_is_bf16, B, K, O, grid, st)
               : launch_rows_bm<64, float>(rows, w, q, s, out, out_is_bf16, B, K, O, grid, st);
  }
  if (gs == 32) {
    if (scale_is_bf16)
      launch_gs<32, __nv_bfloat16>(w.xq, w.xs, q, s, w.part, B, w.bpad, K, O, grid, st);
    else
      launch_gs<32, float>(w.xq, w.xs, q, s, w.part, B, w.bpad, K, O, grid, st);
  } else {
    if (scale_is_bf16)
      launch_gs<64, __nv_bfloat16>(w.xq, w.xs, q, s, w.part, B, w.bpad, K, O, grid, st);
    else
      launch_gs<64, float>(w.xq, w.xs, q, s, w.part, B, w.bpad, K, O, grid, st);
  }
  return mrt::finish_gemv(w, out, out_is_bf16, ksplit, B * O, st);
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
