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
// scale/minv [K/32,O] bf16, out [B,O] bf16 or f32; in the workspace xq
// [B,K] int8, xs/xsum [K/32][bpad] f32, part [ksplit,B,O] f32.
//
// What bounds it on an H100: at decode the weight stream, 0.75 bytes per
// weight (qs 0.5, qh 0.125, two bf16 planes per 32), against 3.35 TB/s.
// Design for that (q5k_q8_mma_kernel, up to 16 rows):
// - the K loop runs over blocks of 32 qh rows: rows [32r, 32r+32) of qh hold
//   the high bits of the 8 sub-blocks j*K/256 + r (j = 0..7), whose nibbles
//   are the low (j < 4) and high (j >= 4) halves of the 4 qs row blocks
//   m*K/8 + 32r (m = j mod 4). One step stages those 4 + 1 row blocks (20
//   KB for 128 columns), the 8 sub-blocks' scale and minv rows and x's codes,
//   scales and sums for them, so every weight byte is read once; a 3-deep
//   ring of steps in dynamic shared memory, filled by 16-byte cp.async;
// - a warp transposes its 32 columns into mma B fragments as K1 does, ORs
//   each plane's bit into bit 4 of the nibble bytes (a shift and a mask a
//   register), and runs one int8 mma.m16n8k32 per sub-block and n-tile:
//   exact int32 dots, scaled into f32 accumulators with xs*scale and the
//   min term xsum*minv;
// - the K axis is split over blockIdx.y (a split keeps a step's four qs
//   blocks together); common.cuh's pass adds the partials in a fixed order.
// Not done yet at 1-16 rows (later work): TMA/wgmma, fusing the split-K
// pass.
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

constexpr int kStages = 3;
constexpr int kXStride = 272;  // bytes per staged x row (256 used; 272 spreads the banks)

struct Stage {
  uint8_t qh[32 * mrt::kGemvCols];     // qh rows 32r.., swizzled
  uint8_t qs[4][32 * mrt::kGemvCols];  // qs rows m*K/8 + 32r.., swizzled
  __nv_bfloat16 sc[8][mrt::kGemvCols];  // scale of sub-block j*K/256 + r
  __nv_bfloat16 mn[8][mrt::kGemvCols];  // minv of the same
  int8_t x[16 * kXStride];              // x's 16 rows: 32 codes of each sub-block
  float xv[16][16];                     // xs of sub-blocks 0..7, then their xsum
};

// the high bit of plane J moved to bit 4 of each byte
template <int J>
__device__ __forceinline__ uint32_t hbit4(uint32_t h) {
  if constexpr (J <= 4)
    return (h << (4 - J)) & 0x10101010u;
  else
    return (h >> (J - 4)) & 0x10101010u;
}

template <int J>
__device__ __forceinline__ void sub_block(const Stage& S, int warp, int lane, const uint32_t (&q0)[4],
                                          const uint32_t (&q1)[4], const uint32_t (&h0)[4],
                                          const uint32_t (&h1)[4], float (&acc)[4][4]) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[4];
  mrt::a_frag(S.x, kXStride, 32 * J, lane, a);
  const int cb = warp * 32 + 8 * t;  // C columns of n-tile jj: cb + jj and cb + 4 + jj
  float s0[4], s1[4], m0[4], m1[4];
  mrt::lds4(&S.sc[J][cb], s0);
  mrt::lds4(&S.sc[J][cb + 4], s1);
  mrt::lds4(&S.mn[J][cb], m0);
  mrt::lds4(&S.mn[J][cb + 4], m1);
  // rows past B have zero codes and are never stored
  const float x0 = S.xv[J][g], x1 = S.xv[J][g + 8];
  const float xm0 = S.xv[8 + J][g], xm1 = S.xv[8 + J][g + 8];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const uint32_t n0 = J < 4 ? q0[jj] & 0x0F0F0F0Fu : (q0[jj] >> 4) & 0x0F0F0F0Fu;
    const uint32_t n1 = J < 4 ? q1[jj] & 0x0F0F0F0Fu : (q1[jj] >> 4) & 0x0F0F0F0Fu;
    int d[4] = {0, 0, 0, 0};
    mrt::mma_s8(d, a, n0 | hbit4<J>(h0[jj]), n1 | hbit4<J>(h1[jj]));
    acc[jj][0] += (float)d[0] * x0 * s0[jj] - xm0 * m0[jj];
    acc[jj][1] += (float)d[1] * x0 * s1[jj] - xm0 * m1[jj];
    acc[jj][2] += (float)d[2] * x1 * s0[jj] - xm1 * m0[jj];
    acc[jj][3] += (float)d[3] * x1 * s1[jj] - xm1 * m1[jj];
  }
}

__global__ void __launch_bounds__(mrt::kGemvThreads)
    q5k_q8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                      const float* __restrict__ xsum, const uint8_t* __restrict__ qs,
                      const uint8_t* __restrict__ qh, const __nv_bfloat16* __restrict__ scale,
                      const __nv_bfloat16* __restrict__ minv, float* __restrict__ part, int B,
                      int bpad, int K, int O, int steps_per_split) {
  extern __shared__ __align__(16) uint8_t smem[];
  Stage* st = reinterpret_cast<Stage*>(smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * mrt::kGemvCols;
  const int row0 = blockIdx.z * 16;
  const int K8 = K / 8, nsub8 = K / 256;  // sub-blocks per plane
  const int nsteps = K / 256;
  const int r_begin = blockIdx.y * steps_per_split;
  const int n = max(0, min(steps_per_split, nsteps - r_begin));

  auto load = [&](int s, int r) {
    mrt::stage_bytes(st[s].qh, qh, 32 * r, 32, col0, O);
#pragma unroll
    for (int m = 0; m < 4; ++m) mrt::stage_bytes(st[s].qs[m], qs, m * K8 + 32 * r, 32, col0, O);
    // 16 rows (scale, minv of 8 sub-blocks) of 128 bf16 = 256 chunks, two a thread
    for (int q = threadIdx.x; q < 256; q += mrt::kGemvThreads) {
      const int a = q >> 4, ch = q & 15, j = a & 7;
      const __nv_bfloat16* base = a < 8 ? scale : minv;
      __nv_bfloat16* dst = a < 8 ? &st[s].sc[j][8 * ch] : &st[s].mn[j][8 * ch];
      const bool ok = col0 + 8 * ch < O;
      mrt::cp_async16(dst, ok ? base + (size_t)(j * nsub8 + r) * O + col0 + 8 * ch : base, ok);
    }
    // x: 2 chunks of 16 codes per sub-block and row, 256 copies, two a thread
    mrt::stage_x(st[s].x, kXStride, xq, B, K, row0, 8, 0,
                 [&](int ch) { return (ch >> 1) * K8 + 32 * r + 16 * (ch & 1); });
    mrt::stage_x(st[s].x + 128, kXStride, xq, B, K, row0, 8, 0,
                 [&](int ch) { return (4 + (ch >> 1)) * K8 + 32 * r + 16 * (ch & 1); });
    // xs and xsum of the 8 sub-blocks: 16 x 4 chunks (threads 0..63)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mrt::stage_rows16(st[s].xv[j], xs + (size_t)(j * nsub8 + r) * bpad + row0, 4 * j);
      mrt::stage_rows16(st[s].xv[8 + j], xsum + (size_t)(j * nsub8 + r) * bpad + row0,
                        32 + 4 * j);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s, r_begin + s);
    mrt::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    mrt::cp_async_wait<kStages - 2>();
    __syncthreads();
    const Stage& S = st[i % kStages];
    uint32_t h0[4], h1[4], q0[4], q1[4];
    mrt::b_frags(S.qh, 0, warp, lane, h0, h1);
    mrt::b_frags(S.qs[0], 0, warp, lane, q0, q1);
    sub_block<0>(S, warp, lane, q0, q1, h0, h1, acc);
    sub_block<4>(S, warp, lane, q0, q1, h0, h1, acc);
    mrt::b_frags(S.qs[1], 0, warp, lane, q0, q1);
    sub_block<1>(S, warp, lane, q0, q1, h0, h1, acc);
    sub_block<5>(S, warp, lane, q0, q1, h0, h1, acc);
    mrt::b_frags(S.qs[2], 0, warp, lane, q0, q1);
    sub_block<2>(S, warp, lane, q0, q1, h0, h1, acc);
    sub_block<6>(S, warp, lane, q0, q1, h0, h1, acc);
    mrt::b_frags(S.qs[3], 0, warp, lane, q0, q1);
    sub_block<3>(S, warp, lane, q0, q1, h0, h1, acc);
    sub_block<7>(S, warp, lane, q0, q1, h0, h1, acc);
    const int next = i + kStages - 1;  // refill the stage read in the previous step
    if (next < n) load(next % kStages, r_begin + next);
    mrt::cp_async_commit();
  }
  mrt::cp_async_wait<0>();
  mrt::store_part(part + (size_t)blockIdx.y * B * O, acc, B, O, row0, col0, warp, lane);
}

}  // namespace

// ---- rows instantiation: 17 <= B <= 256 (csrc/q4k_rows.cuh) ----
Q4ROWS_KERNEL(q5k_q8_rows_kernel, true)

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): K % 256 ==
// 0, O % 16 == 0, 16-byte aligned pointers, and a workspace of ws_bytes (see
// mrt::carve). The launch is the plan of ops/quant_matmul.q5k_q8_plan, every
// field of it checked here:
// - rows 16 (B <= 16): q5k_q8_mma_kernel, grid (column tiles, K splits, 1),
//   cluster 1, cols 128, stages 0, at most K/256 splits. Quantizes x (row
//   major) per 32, runs the GEMV and the split-K pass.
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
  const int ksplit = dec ? gy : gz;
  const mrt::Workspace w =
      mrt::carve(ws, B, K, O, 32, 32, ksplit, dec ? mrt::kRowMajor : mrt::kTiled, rows);
  const bool grid_ok = dec ? B <= 16 && gx == (O + mrt::kGemvCols - 1) / mrt::kGemvCols && gz == 1
                           : mrt::grid_covers(w, rows, cols, B, O, gx, gy, gz);
  if (!grid_ok || cluster != 1 || cols != mrt::kGemvCols || stages != 0 ||
      w.bytes > (size_t)ws_bytes || ksplit < 1 || ksplit > K / 256)
    return (int)cudaErrorInvalidValue;
  mrt::launch_quantize<32>(x, x_is_bf16 != 0, w.xq, w.xs, w.xsum, nullptr, B, K, w.bpad, st,
                           dec ? mrt::kRowMajor : mrt::kTiled);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!dec) {
    const dim3 grid(gx, gy, gz);
    if (rows == 64)
      return q4rows::launch_rows<64, true>(q5k_q8_rows_kernel<64>, w, qs, qh, scale, minv, out,
                                           out_is_bf16, B, K, O, grid, st);
    return q4rows::launch_rows<128, true>(q5k_q8_rows_kernel<128>, w, qs, qh, scale, minv, out,
                                          out_is_bf16, B, K, O, grid, st);
  }
  const int smem = kStages * (int)sizeof(Stage);
  err = mrt::allow_smem(q5k_q8_mma_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  q5k_q8_mma_kernel<<<dim3(gx, gy, 1), mrt::kGemvThreads, smem, st>>>(
      w.xq, w.xs, w.xsum, static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(qh),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(minv), w.part,
      B, w.bpad, K, O, (K / 256 + ksplit - 1) / ksplit);
  return mrt::finish_gemv(w, out, out_is_bf16, ksplit, B * O, st);
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
