// K9: Q5_K weights x int8 activations, for decode- and prefill-chunk-sized
// row counts; and the Q5_K dequantization of the prefill route.
//
// Replaces the TPU kernel mistralrs_tpu/ops/quant_matmul.py::_q5k_hbit_q8_kernel
// together with the K1 call (_q4k_q8_kernel) that _q5k_q8_matmul_padded
// makes before it: the whole Q5_K product is one kernel here.
//
// Computes, for x quantized per 32-element block (xq, xs, and xsum = the
// block sums of the ORIGINAL x; common.cuh's quantize kernel makes them):
//   y[b,o] = sum_sub xs[b,sub] * scale[sub,o] * (sum_{k in sub} xq[b,k] v[k,o])
//          - sum_sub xsum[b,sub] * minv[sub,o]
// with the 5-bit code v = nib | hbit << 4 (0..31): nib is K1's paired nibble
// (qs row k, low, for k < K/2; row k - K/2, high, otherwise) and hbit is bit
// k / (K/8) of qh row k % (K/8) (plane-major). The per-32 integer dot over v
// is JAX's K1 dot plus 16 x its high-bit dot, exactly (|sum| <= 32*127*31).
//
// Layouts (row-major): x [B,K] bf16 or f32, qs [K/2,O] u8, qh [K/8,O] u8,
// scale/minv [K/32,O] bf16, out [B,O] bf16 or f32; in the workspace x's
// codes, scales and sums as common.cuh's carve lays them out for the
// instantiation.
//
// What bounds it on an H100: at decode the weight stream, 0.75 bytes per
// weight (qs 0.5, qh 0.125, two bf16 planes per 32), against 3.35 TB/s.
// Design for that (q5k_q8_dec_kernel, 1-16 rows): K1's decode kernel
// (csrc/q4k_q8_gemv.cu) with a fifth bit, on common.cuh's decode section:
// - a call is two launches: the quantize kernel (the decode layout), then
//   the GEMV by programmatic dependent launch;
// - a block owns C = 128 (or 64) columns and one K split; the K splits of
//   a column tile form a cluster and add their f32 tiles in distributed
//   shared memory in rank order (no partials in global memory);
// - a K step must read qh once: qh rows [32r, 32r+32) hold the high bits
//   of the 8 sub-blocks j*K/256 + r (j = 0..7), whose nibbles are the low
//   (j < 4) and high (j >= 4) halves of the 4 qs row blocks m*K/8 + 32r
//   (m = j mod 4). So a step (a ring stage) is those 32 rows: qs seen as
//   [4][K/8][O] in one 3-D box of 4 x 32 rows, qh's 32 rows, scale and
//   minv seen as [8][K/256][O] in one box each (24 KB of weights at C =
//   128), brought by one producer warp at most half the ring ahead of what
//   has landed; x's codes, scales and sums of the 8 sub-blocks, strided in
//   the decode layout, come by three boxes of those arrays seen as
//   [8][K/256][...] from the other producer warp;
// - the weight is the mma's A operand and x the B operand (one n-tile up
//   to 8 rows, two up to 16): a consumer warp's 32 columns of each staged
//   32-row block are transposed into A fragments (w_frags), each plane's
//   bit ORed into bit 4 of the nibble bytes (the 5-bit codes, 0..31), and
//   u8 x s8 mma.m16n8k32 gives exact int32 dots per (row, column,
//   sub-block); K1's epilogue: exact_f32, xs * scale and the min term
//   xsum * minv as FFMAs, no I2F.
//
// At 17-256 rows the bound is K1's rows instantiation's, the scaling
// epilogue (issue slots: per row, column and sub-block a conversion, the
// xs * scale product and an fma); Q5_K adds the qh stage and a shift, mask
// and OR a decoded word. Design: K1's rows kernel with the high-bit plane
// (q5k_q8_rows_kernel, csrc/q4k_rows.cuh): one weight read per call (a
// weight tile read by at most two blocks, grid neighbours that meet in L2),
// each stage decoded once by a producer warp into 5-bit codes that are
// valid int8, int8 wgmma, K1's epilogue and min term unchanged.
#include "common.cuh"
#include "q4k_rows.cuh"

namespace {

// a ring stage of the decode kernel: the K step of qh rows 32r.. for C columns
template <int C>
struct alignas(C == 128 ? 1024 : 128) Q5DecStage {
  uint8_t qs[4][32 * C];                       // qs rows m*K/8 + 32r.. (swizzled at C = 128)
  uint8_t qh[32 * C];                          // qh rows 32r..
  __nv_bfloat16 sc[8][C];                      // scale of sub-block j*K/256 + r
  __nv_bfloat16 mn[8][C];                      // minv of the same
  int8_t x[8][mrt::kDecRows * 32];             // x's codes of the same (decode layout)
  float xs[8][mrt::kDecRows];                  // x's scales
  float xsum[8][mrt::kDecRows];                // x's block sums
};
template <int C>
constexpr int kQ5DecWeightBytes = 32 * C * 5 + 16 * C * 2;
template <int C>
constexpr int kQ5DecStages = mrt::dec_stages(kQ5DecWeightBytes<C>);
template <int C>
using Q5DecRing = mrt::DecRing<Q5DecStage<C>, kQ5DecStages<C>, C / 32>;
constexpr uint32_t kQ5DecXBytes = 8 * (512 + 2 * 64);

// the high bit of plane J moved to bit 4 of each byte
template <int J>
__device__ __forceinline__ uint32_t hbit4(uint32_t h) {
  if constexpr (J <= 4)
    return (h << (4 - J)) & 0x10101010u;
  else
    return (h >> (J - 4)) & 0x10101010u;
}

// Sub-block J of a step for a consumer warp: its 5-bit codes from the
// transposed qs words w0/w1 (low nibbles for J < 4, high ones above) and qh
// words h0/h1, u8 x s8 mma per n-tile, K1's epilogue into acc.
template <int C, int NT, int J>
__device__ __forceinline__ void q5_dec_sub(const Q5DecStage<C>& S, int c, int g, int t,
                                           const uint32_t (&w0)[4], const uint32_t (&w1)[4],
                                           const uint32_t (&h0)[4], const uint32_t (&h1)[4],
                                           float (&acc)[NT * 8]) {
  auto code = [](uint32_t w, uint32_t h) {
    return (J < 4 ? w & 0x0F0F0F0Fu : (w >> 4) & 0x0F0F0F0Fu) | hbit4<J>(h);
  };
  float sc[4], mn[4];
  mrt::lds4(&S.sc[J][c], sc);
  mrt::lds4(&S.mn[J][c], mn);
  uint32_t xb[NT][2];
  float2 xs[NT], xm[NT];  // rows 8nt + 2t and + 1
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    mrt::x_frag(S.x[J], 8 * nt + g, t, xb[nt]);
    xs[nt] = *reinterpret_cast<const float2*>(&S.xs[J][8 * nt + 2 * t]);
    xm[nt] = *reinterpret_cast<const float2*>(&S.xsum[J][8 * nt + 2 * t]);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const uint32_t a[4] = {code(w0[2 * m], h0[2 * m]), code(w0[2 * m + 1], h0[2 * m + 1]),
                           code(w1[2 * m], h1[2 * m]), code(w1[2 * m + 1], h1[2 * m + 1])};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      int d[4] = {0, 0, 0, 0};
      mrt::mma_u8s8(d, a, xb[nt][0], xb[nt][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = (nt * 2 + m) * 4 + e, col = 2 * m + (e >> 1);
        acc[k] = fmaf(mrt::exact_f32(d[e]), ((e & 1) ? xs[nt].y : xs[nt].x) * sc[col], acc[k]);
        acc[k] = fmaf(-((e & 1) ? xm[nt].y : xm[nt].x), mn[col], acc[k]);
      }
    }
  }
}

// A consumer warp over its n steps: y[nt][m][e] = the f32 sums of x row 8nt
// + 2t + e%2 and column 32 * warp + 4g + 2m + e/2 (NT n-tiles: 1 up to 8 rows).
template <int C, int NT>
__device__ __forceinline__ void q5_dec_consume(const Q5DecRing<C>& ring, int n, int warp, int lane,
                                               float (&y)[2][2][4]) {
  const int g = lane >> 2, t = lane & 3, c = 32 * warp + 4 * g;
  float acc[NT * 8];  // index (nt * 2 + m) * 4 + e
#pragma unroll
  for (int i = 0; i < NT * 8; ++i) acc[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    const Q5DecStage<C>& S = ring[i];
    ring.acquire(i);
    uint32_t h0[4], h1[4], w0[4], w1[4];
    mrt::w_frags<C>(S.qh, 0, c, t, h0, h1);
    mrt::w_frags<C>(S.qs[0], 0, c, t, w0, w1);
    q5_dec_sub<C, NT, 0>(S, c, g, t, w0, w1, h0, h1, acc);
    q5_dec_sub<C, NT, 4>(S, c, g, t, w0, w1, h0, h1, acc);
    mrt::w_frags<C>(S.qs[1], 0, c, t, w0, w1);
    q5_dec_sub<C, NT, 1>(S, c, g, t, w0, w1, h0, h1, acc);
    q5_dec_sub<C, NT, 5>(S, c, g, t, w0, w1, h0, h1, acc);
    mrt::w_frags<C>(S.qs[2], 0, c, t, w0, w1);
    q5_dec_sub<C, NT, 2>(S, c, g, t, w0, w1, h0, h1, acc);
    q5_dec_sub<C, NT, 6>(S, c, g, t, w0, w1, h0, h1, acc);
    mrt::w_frags<C>(S.qs[3], 0, c, t, w0, w1);
    q5_dec_sub<C, NT, 3>(S, c, g, t, w0, w1, h0, h1, acc);
    q5_dec_sub<C, NT, 7>(S, c, g, t, w0, w1, h0, h1, acc);
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

// A block of dec_threads(C) threads: the consumer warps 0..C/32-1, the
// producers the last two; steps_per_split = dec_per_split(K/256, splits, 1).
template <int C>
__global__ void __launch_bounds__(mrt::dec_threads(C), 3)
    q5k_q8_dec_kernel(const __grid_constant__ CUtensorMap qsmap,
                      const __grid_constant__ CUtensorMap qhmap,
                      const __grid_constant__ CUtensorMap smap,
                      const __grid_constant__ CUtensorMap mmap,
                      const __grid_constant__ CUtensorMap xqmap,
                      const __grid_constant__ CUtensorMap xsmap,
                      const __grid_constant__ CUtensorMap xmmap, void* out, int out_is_bf16,
                      int B, int K, int O, int steps_per_split) {
  constexpr int NW = C / 32;  // consumer warps; the producers are warps NW and NW + 1
  using Stage = Q5DecStage<C>;
  extern __shared__ uint8_t smem[];
  const Q5DecRing<C> ring(smem);
  const int splits = (int)gridDim.x, rank = (int)mrt::cluster_rank();
  const int col0 = blockIdx.y * C;
  const int s_begin = rank * steps_per_split;
  const int n = max(0, min(steps_per_split, K / 256 - s_begin));  // a stage a step
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  float y[2][2][4] = {};
  if (warp == NW) {  // the weights: a TMA box an array a step
    if (lane == 0) {
      mrt::prefetch_tensormap(&qsmap);
      mrt::prefetch_tensormap(&qhmap);
      mrt::prefetch_tensormap(&smap);
      mrt::prefetch_tensormap(&mmap);
      ring.produce(
          n, true, [](int) { return (uint32_t)kQ5DecWeightBytes<C>; },
          [&](Stage& S, int i, uint64_t* full) {
            const int r = s_begin + i;
            mrt::tma_load_3d(S.qs, &qsmap, col0, 32 * r, 0, full);  // [4] blocks of 32 rows
            mrt::tma_load_2d(S.qh, &qhmap, col0, 32 * r, full);
            mrt::tma_load_3d(S.sc, &smap, col0, r, 0, full);  // [8] sub-blocks' rows
            mrt::tma_load_3d(S.mn, &mmap, col0, r, 0, full);
          });
    }
    __syncwarp();
  } else if (warp == NW + 1) {  // x's codes, scales and sums, from the quantize kernel
    if (lane == 0) {
      mrt::grid_dep_wait();  // the quantize kernel's codes are written
      mrt::prefetch_tensormap(&xqmap);
      mrt::prefetch_tensormap(&xsmap);
      mrt::prefetch_tensormap(&xmmap);
      ring.produce(
          n, false, [](int) { return kQ5DecXBytes; },
          [&](Stage& S, int i, uint64_t* full) {
            const int r = s_begin + i;
            mrt::tma_load_3d(S.x, &xqmap, 0, r, 0, full);
            mrt::tma_load_3d(S.xs, &xsmap, 0, r, 0, full);
            mrt::tma_load_3d(S.xsum, &xmmap, 0, r, 0, full);
          });
    }
    __syncwarp();
  } else if (B > 8) {
    q5_dec_consume<C, 2>(ring, n, warp, lane, y);
  } else {
    q5_dec_consume<C, 1>(ring, n, warp, lane, y);
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

// The tensor maps of a decode call at C columns a box: qs [K/2, O] seen as
// [4][K/8][O] in boxes of 4 x 32 rows and qh [K/8, O] in boxes of 32 rows
// (both with the 128-byte swizzle at C = 128); scale and minv [K/32, O]
// seen as [8][K/256][O] in boxes of 8 rows; x's codes (the decode layout,
// 512 bytes a sub-block) seen as [8][K/256][128] u32, its scales and sums
// [K/32][16] seen as [8][K/256][16], each in boxes of the step's 8
// sub-blocks. Returns the CUDA error.
template <int C>
int launch_dec(const mrt::Workspace& w, const void* qs, const void* qh, const void* scale,
               const void* minv, void* out, int out_is_bf16, int B, int K, int O, int splits,
               cudaStream_t st) {
  const uint64_t n8 = (uint64_t)(K / 256), k8 = (uint64_t)(K / 8);
  const CUtensorMapSwizzle sw = C == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
  const uint64_t qdims[3] = {(uint64_t)O, k8, 4}, qstr[2] = {(uint64_t)O, k8 * O};
  const uint32_t qbox[3] = {(uint32_t)C, 32, 4};
  const uint64_t hdims[2] = {(uint64_t)O, k8}, hstr[1] = {(uint64_t)O};
  const uint32_t hbox[2] = {(uint32_t)C, 32};
  const uint64_t sdims[3] = {(uint64_t)O, n8, 8}, sstr[2] = {(uint64_t)O * 2, n8 * O * 2};
  const uint32_t sbox[3] = {(uint32_t)C, 1, 8};
  const uint64_t xdims[3] = {128, n8, 8}, xstr[2] = {512, n8 * 512};
  const uint32_t xbox[3] = {128, 1, 8};
  const uint64_t vdims[3] = {16, n8, 8}, vstr[2] = {64, n8 * 64};
  const uint32_t vbox[3] = {16, 1, 8};
  CUtensorMap qsmap, qhmap, smap, mmap, xqmap, xsmap, xmmap;
  int err = mrt::tile_map(&qsmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, qs, qdims, qstr, qbox, sw);
  if (!err) err = mrt::tile_map(&qhmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qh, hdims, hstr, hbox, sw);
  if (!err) err = mrt::tile_map(&smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, scale, sdims, sstr, sbox);
  if (!err) err = mrt::tile_map(&mmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, minv, sdims, sstr, sbox);
  if (!err) err = mrt::tile_map(&xqmap, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, w.xq, xdims, xstr, xbox);
  if (!err) err = mrt::tile_map(&xsmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, w.xs, vdims, vstr, vbox);
  if (!err)
    err = mrt::tile_map(&xmmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, w.xsum, vdims, vstr, vbox);
  if (err) return err;
  return mrt::launch_dec(q5k_q8_dec_kernel<C>, splits, (O + C - 1) / C, mrt::dec_threads(C),
                         Q5DecRing<C>::smem_bytes(), st, qsmap, qhmap, smap, mmap, xqmap, xsmap,
                         xmmap, out, out_is_bf16, B, K, O, mrt::dec_per_split(K / 256, splits, 1));
}

}  // namespace

// ---- rows instantiation: 17 <= B <= 256 (csrc/q4k_rows.cuh) ----
Q4ROWS_KERNEL(q5k_q8_rows_kernel, true)

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): K % 256 ==
// 0, O % 16 == 0, 16-byte aligned pointers, and a workspace of ws_bytes (see
// mrt::carve). The launch is the plan of ops/quant_matmul.q5k_q8_plan, every
// field of it checked here:
// - rows 16 (B <= 16): q5k_q8_dec_kernel, grid (K splits, column tiles of
//   `cols` = 128 or 64, 1), a cluster of the gx splits (at most 8, at most
//   K/256, none empty), stages = kQ5DecStages<cols>. Quantizes x into the
//   decode layout, then launches the GEMV behind it (programmatic
//   dependent launch): two launches.
// - rows 64 or 128: the rows instantiation on K1's plan (int8_gemv_plan):
//   grid (row tiles, column tiles, K splits), cluster 1, cols 128, stages 0,
//   at most K/256 splits (a split takes whole groups of 4 pairs).
//   Quantizes x (tiled), runs the GEMV and, with more than one split, the
//   split-K pass.
// Returns the CUDA error code of the launches (0 = launched).
extern "C" int q5k_q8_gemv(const void* x, int x_is_bf16, const void* qs, const void* qh,
                           const void* scale, const void* minv, void* ws, long long ws_bytes,
                           void* out, int out_is_bf16, int B, int K, int O, int rows, int gx,
                           int gy, int gz, int cluster, int cols, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows != 16 && rows != 64 && rows != 128) return (int)cudaErrorInvalidValue;
  const bool dec = rows == 16;
  const int ksplit = dec ? gx : gz, steps = K / 256;
  const mrt::Workspace w =
      mrt::carve(ws, B, K, O, 32, 32, ksplit, dec ? mrt::kDecode : mrt::kTiled, rows);
  const bool plan_ok =
      dec ? (cols == 128 || cols == 64) && cluster == gx && gx <= 8 &&
                (gx - 1) * mrt::dec_per_split(steps, gx, 1) < steps &&
                stages == (cols == 128 ? kQ5DecStages<128> : kQ5DecStages<64>)
          : cluster == 1 && cols == mrt::kGemvCols && stages == 0;
  if (!plan_ok || w.bytes > (size_t)ws_bytes || ksplit < 1 || ksplit > steps ||
      !mrt::grid_covers(w, rows, cols, B, O, gx, gy, gz))
    return (int)cudaErrorInvalidValue;
  mrt::launch_quantize<32>(x, x_is_bf16 != 0, w.xq, w.xs, w.xsum, nullptr, B, K, w.bpad, st,
                           dec ? mrt::kDecode : mrt::kTiled);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dec)
    return cols == 128 ? launch_dec<128>(w, qs, qh, scale, minv, out, out_is_bf16, B, K, O, gx, st)
                       : launch_dec<64>(w, qs, qh, scale, minv, out, out_is_bf16, B, K, O, gx, st);
  const dim3 grid(gx, gy, gz);
  if (rows == 64)
    return q4rows::launch_rows<64, true>(q5k_q8_rows_kernel<64>, w, qs, qh, scale, minv, out,
                                         out_is_bf16, B, K, O, grid, st);
  return q4rows::launch_rows<128, true>(q5k_q8_rows_kernel<128>, w, qs, qh, scale, minv, out,
                                        out_is_bf16, B, K, O, grid, st);
}

// ---- dequantization for prefill-sized calls ----
//
// The pass XLA fuses in the JAX package's dequant_q5k_weights: w[k, o] =
// bf16(bf16(v * scale) - minv), K-major [K, O] bf16, with the same two
// roundings as the plain version's bf16 ops. Bound: bytes (0.75 read + 2
// written per weight). A thread owns 8 neighbouring columns of one qs byte
// row r and writes element rows r and r + K/2, whose high bits share qh row
// r mod K/8 (planes r / (K/8) and that + 4).
namespace {

__global__ void q5k_dequant_kernel(const uint8_t* __restrict__ qs, const uint8_t* __restrict__ qh,
                                   const __nv_bfloat16* __restrict__ scale,
                                   const __nv_bfloat16* __restrict__ minv,
                                   __nv_bfloat16* __restrict__ w, int K, int O) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per_row = O / 8;
  if (i >= (long long)(K / 2) * per_row) return;
  const int r = (int)(i / per_row), c = (int)(i % per_row) * 8;
  const int K8 = K / 8;
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(qs + (size_t)r * O + c));
  const uint2 h = __ldg(reinterpret_cast<const uint2*>(qh + (size_t)(r % K8) * O + c));
  const uint8_t* qb = reinterpret_cast<const uint8_t*>(&q);
  const uint8_t* hb = reinterpret_cast<const uint8_t*>(&h);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int k = r + half * (K / 2);
    const int plane = k / K8;
    const uint4 s = __ldg(reinterpret_cast<const uint4*>(scale + (size_t)(k / 32) * O + c));
    const uint4 m = __ldg(reinterpret_cast<const uint4*>(minv + (size_t)(k / 32) * O + c));
    const uint32_t sw[4] = {s.x, s.y, s.z, s.w}, mw[4] = {m.x, m.y, m.z, m.w};
    uint32_t out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = qb[2 * j + e];
        const int code = (half ? b >> 4 : b & 0xF) | (((hb[2 * j + e] >> plane) & 1) << 4);
        const float sc = e ? mrt::bf16_hi(sw[j]) : mrt::bf16_lo(sw[j]);
        const float mn = e ? mrt::bf16_hi(mw[j]) : mrt::bf16_lo(mw[j]);
        v[e] = __bfloat162float(__float2bfloat16_rn((float)code * sc)) - mn;
      }
      const __nv_bfloat162 p = __floats2bfloat162_rn(v[0], v[1]);
      out[j] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(w + (size_t)k * O + c) = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

}  // namespace

// qs [K/2, O], qh [K/8, O] u8, scale/minv [K/32, O] bf16 -> w [K, O] bf16.
// K % 256 == 0, O % 8 == 0, 16-byte aligned pointers (checked by
// ops/quant_matmul.py).
extern "C" int q5k_dequant(const void* qs, const void* qh, const void* scale, const void* minv,
                           void* w, int K, int O, void* stream) {
  const long long n = (long long)(K / 2) * (O / 8);
  q5k_dequant_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(qh),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(minv),
      static_cast<__nv_bfloat16*>(w), K, O);
  return (int)cudaGetLastError();
}
