// K1: Q4_K weights x int8 activations, for decode-sized row counts.
//
// Replaces the TPU kernel mistralrs_tpu/ops/quant_matmul.py::_q4k_q8_kernel
// (launched by _q4k_q8_matmul_padded and _q4k_q8_matmul_stacked).
//
// Computes, for x quantized per 32-element block (xq int8, scale xs, and
// xsum = the block sums of the ORIGINAL x; the first of the two kernels of
// a call does that quantization, see common.cuh):
//   y[b,o] = sum_sub xs[b,sub] * scale[sub,o] * (sum_{k in sub} xq[b,k] q[k,o])
//          - sum_sub xsum[b,sub] * minv[sub,o]
// where q[k,o] is the low nibble of qs[k,o] for k < K/2 and the high nibble
// of qs[k-K/2,o] otherwise (the paired layout of quant/gguf_linear.pack_q4k).
//
// Layouts (row-major): x [B,K] bf16 or f32, qs [K/2,O] u8, scale/minv
// [K/32,O] bf16, out [B,O] bf16 or f32; in the workspace xq, xs, xsum as
// common.cuh's carve lays them out for the instantiation.
//
// What bounds it on an H100 at decode (B <= 16): the weight stream, 0.625
// bytes per weight (qs + two bf16 scale planes), against 3.35 TB/s; and,
// close behind at 16 rows, the issue slots of the scaling epilogue.
// Design for that (q4k_q8_dec_kernel; the shared pieces are common.cuh's
// decode section):
// - a call is two launches: the quantize kernel, then the GEMV by
//   programmatic dependent launch (its launch and first weight stages
//   overlap the quantize kernel's end);
// - a block owns C = 128 (or, where the column tiles are too few to fill
//   the card, 64) columns and one K split; the K splits of a column tile
//   form a cluster (at most 8) and add their f32 tiles in distributed
//   shared memory in the order of their ranks, so no partial sums go
//   through global memory and a result does not depend on timing;
// - a ring stage holds 2 sub-block pairs p, p + 1: one producer warp
//   brings their 64 byte rows of qs (the 128-byte swizzle at C = 128) and
//   their scale and minv rows (sub-blocks p.. and K/64 + p..) in three TMA
//   boxes, at most half the ring ahead of what has landed, so every
//   block's first stages land first and its consumers start while the
//   rest streams; a second producer warp brings x's codes, scales and
//   sums of the four sub-blocks (the decode layout of the quantize kernel)
//   in six bulk copies; dec_stages(160 * C) stages, 4 at C = 128;
// - the weight is the mma's A operand (an output column an A row), x its
//   B operand, so up to 8 rows take one n-tile of mma.m16n8k32 and half
//   the epilogue of 16; each consumer warp owns 32 columns: 8 shared
//   loads and two 4x4 byte transposes give a pair's fragments, the low
//   nibbles masked out (0..15) and the high ones masked in place (u8 x s8
//   MMA: 16x their value, exactly undone by xs / 16), 4 MMAs a pair an
//   n-tile give exact int32 dots per (row, column, sub-block);
// - the epilogue per (row, column, pair), a thread's instructions: the
//   earlier 16-row kernel converted both dots with I2F (a quarter of the
//   FMA rate, so each held its unit 4x as long) and spent ~8 more FP ops;
//   now 2 IADD + 2 FADD (exact_f32), 2 FMUL (xs * scale), 2 FFMA, and the
//   min term xsum * minv as 2 FFMA into the same sums: 10 full-rate slots.
//   A pair a thread: 16 such elements before at any B; now 8 up to 8 rows,
//   16 at 9-16 (the min term as a tensor-core product, as the rows kernel
//   does it, would save 32 of those 160 slots at the price of staging
//   minv across 8 pairs; not done).
//
// At 17-256 rows (the rows instantiation below) the bound is the scaling
// epilogue: per (row, column, sub-block) a conversion, the xs * scale
// product and an fma, which the tensor cores cannot take since xs and
// scale change every 32 elements; it is bound by issue slots. Design for
// that: each weight tile is read once per call (twice at 129-256 rows, by
// grid neighbours that meet in L2) and decoded once per block; int8 wgmma
// does the dots; the epilogue of one sub-block overlaps the tensor cores'
// work on the next; the min term, a plain product of xsum and minv, goes
// to the tensor cores in bf16 (xsum split exactly into three parts); see
// q4k_q8_rows_kernel (its body in csrc/q4k_rows.cuh, shared with K9).
#include "common.cuh"
#include "q4k_rows.cuh"

namespace {

// a ring stage of the decode kernel: kDecSub sub-block pairs p.. of C columns
template <int C>
struct alignas(C == 128 ? 1024 : 128) Q4DecStage {
  uint8_t q[mrt::kDecSub * 32 * C];                   // the pairs' byte rows (swizzled at C = 128)
  __nv_bfloat16 sc[2][mrt::kDecSub][C];               // scale of sub-blocks p.. and K/64 + p..
  __nv_bfloat16 mn[2][mrt::kDecSub][C];               // minv of the same
  int8_t x[2][mrt::kDecSub][mrt::kDecRows * 32];      // x's codes of the same
  float xs[2][mrt::kDecSub][mrt::kDecRows];           // x's scales
  float xsum[2][mrt::kDecSub][mrt::kDecRows];         // x's block sums
};
template <int C>
constexpr int kQ4DecWeightBytes = mrt::kDecSub * (32 * C + 4 * C * 2);
template <int C>
constexpr int kQ4DecStages = mrt::dec_stages(kQ4DecWeightBytes<C>);
template <int C>
using Q4DecRing = mrt::DecRing<Q4DecStage<C>, kQ4DecStages<C>, C / 32>;

// A consumer warp's n pairs: y[nt][m][e] = the f32 sums of x row 8nt + 2t +
// e%2 and column 32 * warp + 4g + 2m + e/2 (NT n-tiles: 1 up to 8 rows).
// The low nibbles go to the tensor cores masked, the high ones masked in
// place as unsigned bytes (16x their value; xs / 16 scales that back,
// exactly), and the min term xsum * minv goes into the same sums.
template <int C, int NT>
__device__ __forceinline__ void q4_dec_consume(const Q4DecRing<C>& ring, int n, int warp, int lane,
                                               float (&y)[2][2][4]) {
  const int g = lane >> 2, t = lane & 3, c = 32 * warp + 4 * g;
  float acc[NT * 8];  // index (nt * 2 + m) * 4 + e
#pragma unroll
  for (int i = 0; i < NT * 8; ++i) acc[i] = 0.f;
  for (int i = 0; i * mrt::kDecSub < n; ++i) {
    const Q4DecStage<C>& S = ring[i];
    const int nv = min(mrt::kDecSub, n - i * mrt::kDecSub);
    ring.acquire(i);
    for (int j = 0; j < nv; ++j) {
      uint32_t w0[4], w1[4];
      mrt::w_frags<C>(S.q + j * 32 * C, 0, c, t, w0, w1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the low nibbles are sub-block p + j, the high K/64 + p + j
        const uint32_t mask = h ? 0xF0F0F0F0u : 0x0F0F0F0Fu;
        float sc[4], mn[4];
        mrt::lds4(&S.sc[h][j][c], sc);
        mrt::lds4(&S.mn[h][j][c], mn);
        uint32_t xb[NT][2];
        float2 xs[NT], xm[NT];  // rows 8nt + 2t and + 1
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mrt::x_frag(S.x[h][j], 8 * nt + g, t, xb[nt]);
          xs[nt] = *reinterpret_cast<const float2*>(&S.xs[h][j][8 * nt + 2 * t]);
          xm[nt] = *reinterpret_cast<const float2*>(&S.xsum[h][j][8 * nt + 2 * t]);
          if (h) xs[nt] = make_float2(xs[nt].x * 0.0625f, xs[nt].y * 0.0625f);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const uint32_t a[4] = {w0[2 * m] & mask, w0[2 * m + 1] & mask, w1[2 * m] & mask,
                                 w1[2 * m + 1] & mask};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            int d[4] = {0, 0, 0, 0};
            mrt::mma_u8s8(d, a, xb[nt][0], xb[nt][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int k = (nt * 2 + m) * 4 + e, col = 2 * m + (e >> 1);
              acc[k] = fmaf(mrt::exact_f32(d[e]), ((e & 1) ? xs[nt].y : xs[nt].x) * sc[col],
                            acc[k]);
              acc[k] = fmaf(-((e & 1) ? xm[nt].y : xm[nt].x), mn[col], acc[k]);
            }
          }
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

template <int C>
__global__ void __launch_bounds__(mrt::dec_threads(C), 3)
    q4k_q8_dec_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap smap,
                      const __grid_constant__ CUtensorMap mmap, const int8_t* __restrict__ xq,
                      const float* __restrict__ xs, const float* __restrict__ xsum, void* out,
                      int out_is_bf16, int B, int K, int O, int pairs_per_split) {
  constexpr int NW = C / 32;  // consumer warps; the producers are warps NW and NW + 1
  using Stage = Q4DecStage<C>;
  extern __shared__ uint8_t smem[];
  const Q4DecRing<C> ring(smem);
  const int splits = (int)gridDim.x, rank = (int)mrt::cluster_rank();
  const int col0 = blockIdx.y * C;
  const int npairs = K / 64;
  const int p_begin = rank * pairs_per_split;
  const int n = max(0, min(pairs_per_split, npairs - p_begin));
  const int stages = (n + mrt::kDecSub - 1) / mrt::kDecSub;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  float y[2][2][4] = {};
  if (warp == NW) {  // the weights: TMA boxes of kDecSub pairs
    if (lane == 0) {
      mrt::prefetch_tensormap(&qmap);
      mrt::prefetch_tensormap(&smap);
      mrt::prefetch_tensormap(&mmap);
      ring.produce(
          stages, true, [](int) { return (uint32_t)kQ4DecWeightBytes<C>; },
          [&](Stage& S, int i, uint64_t* full) {
            const int pr = p_begin + i * mrt::kDecSub;
            mrt::tma_load_2d(S.q, &qmap, col0, 32 * pr, full);
            mrt::tma_load_3d(S.sc, &smap, col0, pr, 0, full);  // [2][kDecSub] rows
            mrt::tma_load_3d(S.mn, &mmap, col0, pr, 0, full);
          });
    }
    __syncwarp();
  } else if (warp == NW + 1) {  // x's codes, scales and sums, from the quantize kernel
    if (lane == 0) {
      mrt::grid_dep_wait();  // the quantize kernel's codes are written
      auto nv = [&](int i) { return min(mrt::kDecSub, n - i * mrt::kDecSub); };
      ring.produce(
          stages, false, [&](int i) { return (uint32_t)(2 * nv(i) * (512 + 2 * 64)); },
          [&](Stage& S, int i, uint64_t* full) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const size_t sub = (size_t)(p_begin + i * mrt::kDecSub + h * npairs);
              mrt::bulk_g2s(S.x[h], xq + sub * 512, nv(i) * 512, full);
              mrt::bulk_g2s(S.xs[h], xs + sub * mrt::kDecRows, nv(i) * 64, full);
              mrt::bulk_g2s(S.xsum[h], xsum + sub * mrt::kDecRows, nv(i) * 64, full);
            }
          });
    }
    __syncwarp();
  } else if (B > 8) {
    q4_dec_consume<C, 2>(ring, n, warp, lane, y);
  } else {
    q4_dec_consume<C, 1>(ring, n, warp, lane, y);
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

// The tensor maps of a Q4_K weight for C columns a box: qs [K/2, O] in boxes
// of 32 * `pairs` byte rows (the 128-byte swizzle at C = 128); scale and
// minv [K/32, O] seen as [2, K/64, O], so one box holds rows p.. and
// K/64 + p.. of `pairs` pairs.
int q4k_maps(CUtensorMap* qmap, CUtensorMap* smap, CUtensorMap* mmap, const void* qs,
             const void* scale, const void* minv, int K, int O, int C, int pairs) {
  const int npairs = K / 64;
  const uint64_t qdims[2] = {(uint64_t)O, (uint64_t)(K / 2)}, qstr[1] = {(uint64_t)O};
  const uint32_t qbox[2] = {(uint32_t)C, (uint32_t)(32 * pairs)};
  const uint64_t sdims[3] = {(uint64_t)O, (uint64_t)npairs, 2};
  const uint64_t sstr[2] = {(uint64_t)O * 2, (uint64_t)npairs * O * 2};
  const uint32_t sbox[3] = {(uint32_t)C, (uint32_t)pairs, 2};
  int err = mrt::tile_map(qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qs, qdims, qstr, qbox,
                          C == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!err) err = mrt::tile_map(smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, scale, sdims, sstr, sbox);
  if (!err) err = mrt::tile_map(mmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, minv, sdims, sstr, sbox);
  return err;
}

template <int C>
int launch_dec(const mrt::Workspace& w, const void* qs, const void* scale, const void* minv,
               void* out, int out_is_bf16, int B, int K, int O, int splits, cudaStream_t st) {
  CUtensorMap qmap, smap, mmap;
  const int err = q4k_maps(&qmap, &smap, &mmap, qs, scale, minv, K, O, C, mrt::kDecSub);
  if (err) return err;
  return mrt::launch_dec(q4k_q8_dec_kernel<C>, splits, (O + C - 1) / C, mrt::dec_threads(C),
                         Q4DecRing<C>::smem_bytes(), st, qmap, smap, mmap,
                         static_cast<const int8_t*>(w.xq), static_cast<const float*>(w.xs),
                         static_cast<const float*>(w.xsum), out, out_is_bf16, B, K, O,
                         mrt::dec_per_split(K / 64, splits));
}

}  // namespace


// ---- rows instantiation: 17 <= B <= 256 ----
//
// csrc/q4k_rows.cuh (shared with K9, which adds Q5_K's high-bit plane).
Q4ROWS_KERNEL(q4k_q8_rows_kernel, false)

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): K % 64 == 0,
// O % 16 == 0, 16-byte aligned pointers, and a workspace of ws_bytes (see
// mrt::carve). The launch is the plan of ops/quant_matmul.int8_gemv_plan,
// every field of it checked here: `rows` (16: the decode instantiation; 64
// or 128: the rows instantiation), the grid (gx, gy, gz), the blocks of a
// cluster, the columns of a block and the ring's stages.
// - rows 16 (B <= 16): grid (K splits, column tiles of `cols` = 128 or 64,
//   1), a cluster of the gx splits (at most 8, at most K/64), stages =
//   kQ4DecStages<cols>. Quantizes x into the decode layout, then launches
//   the GEMV behind it (programmatic dependent launch): two launches.
// - rows 64 or 128: grid (row tiles, column tiles, K splits), cluster 1,
//   cols 128, stages 0 (the rows kernels size their ring from shared
//   memory). Quantizes x (tiled), runs the GEMV and, with more than one
//   split, the split-K pass.
// Returns the CUDA error code of the launches (0 = launched).
extern "C" int q4k_q8_gemv(const void* x, int x_is_bf16, const void* qs, const void* scale,
                           const void* minv, void* ws, long long ws_bytes, void* out,
                           int out_is_bf16, int B, int K, int O, int rows, int gx, int gy, int gz,
                           int cluster, int cols, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows != 16 && rows != 64 && rows != 128) return (int)cudaErrorInvalidValue;
  const bool dec = rows == 16;
  const int ksplit = dec ? gx : gz;
  const mrt::Workspace w =
      mrt::carve(ws, B, K, O, 32, 32, ksplit, dec ? mrt::kDecode : mrt::kTiled, rows);
  const bool plan_ok =
      dec ? (cols == 128 || cols == 64) && cluster == gx && gx <= 8 &&
                stages == (cols == 128 ? kQ4DecStages<128> : kQ4DecStages<64>)
          : cluster == 1 && cols == mrt::kGemvCols && stages == 0;
  if (!plan_ok || w.bytes > (size_t)ws_bytes || ksplit < 1 || ksplit > K / 64 ||
      !mrt::grid_covers(w, rows, cols, B, O, gx, gy, gz))
    return (int)cudaErrorInvalidValue;
  mrt::launch_quantize<32>(x, x_is_bf16 != 0, w.xq, w.xs, w.xsum, nullptr, B, K, w.bpad, st,
                           dec ? mrt::kDecode : mrt::kTiled);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dec)
    return cols == 128 ? launch_dec<128>(w, qs, scale, minv, out, out_is_bf16, B, K, O, gx, st)
                       : launch_dec<64>(w, qs, scale, minv, out, out_is_bf16, B, K, O, gx, st);
  const dim3 grid(gx, gy, gz);
  if (rows == 64)
    return q4rows::launch_rows<64, false>(q4k_q8_rows_kernel<64>, w, qs, nullptr, scale, minv, out,
                                          out_is_bf16, B, K, O, grid, st);
  return q4rows::launch_rows<128, false>(q4k_q8_rows_kernel<128>, w, qs, nullptr, scale, minv, out,
                                         out_is_bf16, B, K, O, grid, st);
}

// ---- dequantization for prefill-sized calls ----
//
// Above 256 rows the dispatcher dequantizes the weight and calls
// torch.matmul, as the JAX package leaves prefill to XLA (gguf_linear.py
// _ref_forward / dequant_q4k_weights, which XLA fuses into one pass). This
// kernel is that pass: w[k, o] = bf16(bf16(q * scale) - minv), K-major
// [K, O] bf16, with the same two roundings as the plain version's bf16 ops.
// Bound: bytes (0.625 read + 2 written per weight). A thread owns 8
// neighbouring columns of one byte row r and writes rows r and r + K/2.
namespace {

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat16 a = __float2bfloat16_rn(lo), b = __float2bfloat16_rn(hi);
  return (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

__global__ void q4k_dequant_kernel(const uint8_t* __restrict__ qs,
                                   const __nv_bfloat16* __restrict__ scale,
                                   const __nv_bfloat16* __restrict__ minv,
                                   __nv_bfloat16* __restrict__ w, int K, int O) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per_row = O / 8;
  if (i >= (long long)(K / 2) * per_row) return;
  const int r = (int)(i / per_row), c = (int)(i % per_row) * 8;
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(qs + (size_t)r * O + c));
  const uint8_t* qb = reinterpret_cast<const uint8_t*>(&q);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int k = r + half * (K / 2);
    const uint4 s = __ldg(reinterpret_cast<const uint4*>(scale + (size_t)(k / 32) * O + c));
    const uint4 m = __ldg(reinterpret_cast<const uint4*>(minv + (size_t)(k / 32) * O + c));
    const uint32_t sw[4] = {s.x, s.y, s.z, s.w}, mw[4] = {m.x, m.y, m.z, m.w};
    uint32_t out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = qb[2 * j + h];
        const float nib = (float)(half ? b >> 4 : b & 0xF);
        const float sc = h ? mrt::bf16_hi(sw[j]) : mrt::bf16_lo(sw[j]);
        const float mn = h ? mrt::bf16_hi(mw[j]) : mrt::bf16_lo(mw[j]);
        const float qs_b = __bfloat162float(__float2bfloat16_rn(nib * sc));
        v[h] = qs_b - mn;
      }
      out[j] = pack_bf16x2(v[0], v[1]);
    }
    *reinterpret_cast<uint4*>(w + (size_t)k * O + c) = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

}  // namespace

// qs [K/2, O] u8, scale/minv [K/32, O] bf16 -> w [K, O] bf16. K % 64 == 0,
// O % 8 == 0, 16-byte aligned pointers (checked by ops/quant_matmul.py).
extern "C" int q4k_dequant(const void* qs, const void* scale, const void* minv, void* w, int K,
                           int O, void* stream) {
  const long long n = (long long)(K / 2) * (O / 8);
  q4k_dequant_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qs), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(minv), static_cast<__nv_bfloat16*>(w), K, O);
  return (int)cudaGetLastError();
}
