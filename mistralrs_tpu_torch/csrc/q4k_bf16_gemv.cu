// K5: Q4_K weights x activations kept in bf16, for decode- and
// prefill-chunk-sized row counts: the Q4_K route of
// PipelineConfig.int8_activations=False, and the nibble and min terms of its
// Q5_K route (with K9b, csrc/q5k_hbit_bf16_gemv.cu, for the high bits).
//
// Replaces the TPU kernel mistralrs_tpu/ops/quant_matmul.py::_q4k_kernel
// (launched by _q4k_matmul_padded, and by the first pallas_call of
// _q5k_matmul_padded, when the int8 gates MISTRALRS_Q4K_INT8 /
// MISTRALRS_Q5K_INT8 are off).
//
// Computes, for bf16 x [B, K] and xsum = the f32 sums of every 32 x (taken
// from x before any rounding, as JAX's _xsum32_t does):
//   y[b,o] = sum_sub scale[sub,o] * (sum_{k in sub} x[b,k] q[k,o])   (f32 dot per sub-block)
//          - sum_sub xsum[b,sub] * minv[sub,o]
// where q[k,o] is the low nibble of qs[k,o] for k < K/2 and the high nibble
// of qs[k-K/2,o] otherwise (the paired layout of quant/gguf_linear.pack_q4k).
// The JAX kernel multiplies each 32-element sub-block's f32 dot by the
// scale (:107-116); a nibble is exact in bf16, so the tensor cores see x
// and q unrounded; the weight q * s is never rounded either.
//
// Layouts (row-major): x [B,K] bf16, qs [K/2,O] u8, scale/minv [K/32,O] bf16,
// out [B,O] bf16 or f32; in the workspace (common.cuh carve) xsum
// [K/32][bpad] f32, part [ksplit,B,O] f32 (at 17-256 rows only with more
// than one K split) and, at 17-256 rows, x's step-ordered copy xc [bpad,K].
//
// What bounds it on an H100: at decode the weight stream, 0.625 bytes a
// weight (qs + two bf16 planes per 32), against 3.35 TB/s; at 256 rows, the
// bf16 tensor-core operations (twice the product's at 17-256 rows, whose
// weight goes in as two exact bf16 parts).
// Design for that at 1-16 rows (K1's earlier cp.async staging with bf16
// mma.sync):
// - a block owns 128 output columns and one 16-row tile of x; one K step is
//   one "sub-block pair": byte rows 32p..32p+31 of qs, whose low nibbles are
//   sub-block p and high nibbles sub-block K/64+p, 4 KB for 128 columns,
//   with the pair's scale and minv rows, both sub-blocks' 32 x values of
//   each row and their sums, staged with 16-byte cp.async loads in a 3-deep
//   ring in dynamic shared memory;
// - each warp turns its 32 columns of the staged bytes into mma B fragments
//   with K1's 4x4 byte transposes, masks the low or high nibbles out of the
//   same words and converts them to bf16 (exact), and runs two bf16
//   mma.m16n8k16 per sub-block and n-tile into fresh f32 fragments, which
//   the sub-block's scale multiplies onto the accumulators; the min term
//   is two f32 FMAs a pair on the accumulators;
// - the K axis is split over blockIdx.y; common.cuh's pass adds the
//   partials in a fixed order. The sums come from common.cuh's quantize
//   kernel in its sums-only mode, in the same C call.
// At 17-256 rows: plane_rows_kernel with Q4kFmt (csrc/plane_gemv.cuh): the
// paired layout is the 4-bit planes, a producer warpgroup decodes each
// TMA-fed stage once into the two exact bf16 parts of q * s, bf16 wgmma
// runs over both, and the min term is the zs term on the tensor cores.
// Not done yet (later work): TMA/wgmma and fusing the split-K pass at 1-16
// rows.
#include "plane_gemv.cuh"

namespace {

constexpr int kStages = 3;
// elements of a main step of the rows kernel (ops/quant_matmul.Q4K_ROW_ELEMS):
// 32, so six 27 KB stages fit at 128 rows (nine at 64); 64-element steps
// (53 KB: three) measured 11-15% slower on an H100 (PERF.md §6)
constexpr int kQ4kRowElems = 32;
using RowsFmt = mrt::Q4kFmt<kQ4kRowElems>;

struct Q4kStage {
  static constexpr int kXStride = 128 + 32;  // bytes per staged x row (128 used)
  uint8_t q[32 * mrt::kGemvCols];            // one pair's byte rows, swizzled
  __nv_bfloat16 sc[4][mrt::kGemvCols];       // scale lo, scale hi, minv lo, minv hi
  float xm[2][16];                           // xsum of sub-blocks lo and hi for the rows
  uint8_t x[16 * kXStride];                  // each row: 32 bf16 of sub-block p, 32 of K/64+p
};

__global__ void __launch_bounds__(mrt::kGemvThreads)
    q4k_bf16_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ xsum,
                        const uint8_t* __restrict__ qs, const __nv_bfloat16* __restrict__ scale,
                        const __nv_bfloat16* __restrict__ minv, float* __restrict__ part, int B,
                        int bpad, int K, int O, int pairs_per_split) {
  constexpr int kXS = Q4kStage::kXStride;
  extern __shared__ __align__(16) uint8_t smem_q4k[];
  Q4kStage* st = reinterpret_cast<Q4kStage*>(smem_q4k);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * mrt::kGemvCols;
  const int npairs = K / 64;
  const int p_begin = blockIdx.y * pairs_per_split;
  const int n = max(0, min(pairs_per_split, npairs - p_begin));

  auto load = [&](int s, int p) {
    Q4kStage& S = st[s];
    mrt::stage_bytes(S.q, qs, 32 * p, 32, col0, O);
    // scale lo/hi, minv lo/hi: 4 rows of 128 bf16 = 64 chunks of 16 bytes
    for (int c = threadIdx.x; c < 64; c += mrt::kGemvThreads) {
      const int a = c >> 4, ch = c & 15;
      const __nv_bfloat16* base = a < 2 ? scale : minv;
      const int row = (a & 1) ? npairs + p : p;
      const bool ok = col0 + 8 * ch < O;
      mrt::cp_async16(&S.sc[a][8 * ch], ok ? base + (size_t)row * O + col0 + 8 * ch : base, ok);
    }
    // x: 16 rows x 8 chunks of 8 bf16 (4 of sub-block p, 4 of K/64+p),
    // zero past B
    for (int c = threadIdx.x; c < 16 * 8; c += mrt::kGemvThreads) {
      const int r = c >> 3, ch = c & 7;
      const bool ok = r < B;
      const int col = (ch < 4 ? 32 * p : K / 2 + 32 * p) + 8 * (ch & 3);
      mrt::cp_async16(S.x + r * kXS + 16 * ch, ok ? x + (size_t)r * K + col : x, ok);
    }
    // xsum of the two sub-blocks: 2 x 4 chunks of the 16 rows (bpad is 16)
    for (int c = threadIdx.x; c < 2 * 4; c += mrt::kGemvThreads) {
      const int a = c >> 2, ch = c & 3;
      mrt::cp_async16(&S.xm[a][4 * ch], xsum + (size_t)(a ? npairs + p : p) * bpad + 4 * ch,
                      true);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s, p_begin + s);
    mrt::cp_async_commit();
  }
  const int cb = warp * 32 + 8 * t;  // C columns of n-tile jj: cb + jj and cb + 4 + jj
  for (int i = 0; i < n; ++i) {
    mrt::cp_async_wait<kStages - 2>();
    __syncthreads();
    const Q4kStage& S = st[i % kStages];
    uint32_t p0[4], p1[4];  // byte rows 4t.. and 16+4t.. of the pair, 4 n-tiles
    mrt::b_frags(S.q, 0, warp, lane, p0, p1);
#pragma unroll
    for (int sb = 0; sb < 2; ++sb) {  // sub-block p (low nibbles), K/64+p (high)
      uint32_t b[4][2][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        mrt::code_b((p0[jj] >> (4 * sb)) & 0x0F0F0F0Fu, 1.f, b[jj][0][0], b[jj][0][1]);
        mrt::code_b((p1[jj] >> (4 * sb)) & 0x0F0F0F0Fu, 1.f, b[jj][1][0], b[jj][1][1]);
      }
      float s0[4], s1[4];  // the sub-block's scale at the C columns
      mrt::lds4(&S.sc[sb][cb], s0);
      mrt::lds4(&S.sc[sb][cb + 4], s1);
      float d[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[jj][e] = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        // A: rows g and g+8 of the tile, x elements 4t..4t+3 of the half
        const uint8_t* xr = S.x + g * kXS + 64 * sb + 32 * hf + 8 * t;
        const uint2 u0 = *reinterpret_cast<const uint2*>(xr);
        const uint2 u1 = *reinterpret_cast<const uint2*>(xr + 8 * kXS);
        const uint32_t a[4] = {u0.x, u1.x, u0.y, u1.y};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) mrt::mma_bf16(d[jj], a, b[jj][hf][0], b[jj][hf][1]);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        acc[jj][0] += d[jj][0] * s0[jj];
        acc[jj][1] += d[jj][1] * s1[jj];
        acc[jj][2] += d[jj][2] * s0[jj];
        acc[jj][3] += d[jj][3] * s1[jj];
      }
    }
    // the min term over the original x's sums
    float ml0[4], ml1[4], mh0[4], mh1[4];
    mrt::lds4(&S.sc[2][cb], ml0);
    mrt::lds4(&S.sc[2][cb + 4], ml1);
    mrt::lds4(&S.sc[3][cb], mh0);
    mrt::lds4(&S.sc[3][cb + 4], mh1);
    const float xl0 = S.xm[0][g], xl1 = S.xm[0][g + 8];
    const float xh0 = S.xm[1][g], xh1 = S.xm[1][g + 8];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      acc[jj][0] -= xl0 * ml0[jj] + xh0 * mh0[jj];
      acc[jj][1] -= xl0 * ml1[jj] + xh0 * mh1[jj];
      acc[jj][2] -= xl1 * ml0[jj] + xh1 * mh0[jj];
      acc[jj][3] -= xl1 * ml1[jj] + xh1 * mh1[jj];
    }
    const int next = i + kStages - 1;  // refill the stage read in the previous step
    if (next < n) load(next % kStages, p_begin + next);
    mrt::cp_async_commit();
  }
  mrt::cp_async_wait<0>();
  mrt::store_part(part + (size_t)blockIdx.y * B * O, acc, B, O, 0, col0, warp, lane);
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): K % 64 ==
// 0, O % 16 == 0, 16-byte aligned pointers. The launch is the plan of
// ops/quant_matmul.q4k_bf16_plan, every field of it checked here:
// - rows 16 (B <= 16): q4k_bf16_mma_kernel, grid (column tiles, K splits,
//   1), cluster 1, cols 128, stages 0, at most K/64 splits; the quantize
//   kernel's per-32 sums (its sums-only mode), the GEMV and the split-K
//   pass (the workspace holds the sums and the partials);
// - rows 64 or 128: plane_rows_kernel with Q4kFmt, grid (row tiles, column
//   tiles, K splits), cluster 1, cols 128, its ring's stages, at most one
//   split per zs slice; plane_prep_kernel (the per-32 sums and x in step
//   order; the workspace tiled to the row tile), the GEMV and, with more
//   than one split, the split-K pass.
// Returns the CUDA error code of the launches (0 = launched).
extern "C" int q4k_bf16_gemv(const void* x, const void* qs, const void* scale, const void* minv,
                             void* ws, long long ws_bytes, void* out, int out_is_bf16, int B,
                             int K, int O, int rows, int gx, int gy, int gz, int cluster, int cols,
                             int stages, void* stream) {
  using G = RowsFmt::G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows != 16 && rows != 64 && rows != 128) return (int)cudaErrorInvalidValue;
  const bool dec = rows == 16;
  const int ksplit = dec ? gy : gz;
  const mrt::Workspace w = dec ? mrt::carve(ws, B, K, O, 0, 32, ksplit)
                               : mrt::carve(ws, B, K, O, 0, 32, ksplit, mrt::kTiled, rows, true);
  const int Z = mrt::plane_slice_steps<G, true>(32);
  const int units = dec ? K / 64 : (K / 2 / G::kR + Z - 1) / Z;  // the K split's units
  const bool grid_ok = dec ? B <= 16 && gx == (O + mrt::kGemvCols - 1) / mrt::kGemvCols &&
                                 gz == 1 && stages == 0
                           : mrt::grid_covers(w, rows, cols, B, O, gx, gy, gz);
  if (!grid_ok || cluster != 1 || cols != mrt::kGemvCols || w.bytes > (size_t)ws_bytes ||
      ksplit < 1 || ksplit > units)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const uint8_t*>(qs);
  const auto* sb = static_cast<const __nv_bfloat16*>(scale);
  const auto* mb = static_cast<const __nv_bfloat16*>(minv);
  if (!dec)  // the paired nibbles as 4-bit planes, group 32, zs = minv
    return mrt::plane_rows_call<RowsFmt>(xb, w, out, out_is_bf16, B, K, O, 32, rows,
                                         dim3(gx, gy, gz), stages, st, qb, sb, mb);
  const int smem = kStages * (int)sizeof(Q4kStage);
  const cudaError_t err = mrt::allow_smem(q4k_bf16_mma_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  mrt::launch_quantize<32>(x, true, nullptr, nullptr, w.xsum, nullptr, B, K, w.bpad, st);
  q4k_bf16_mma_kernel<<<dim3(gx, ksplit, 1), mrt::kGemvThreads, smem, st>>>(
      xb, w.xsum, qb, sb, mb, w.part, B, w.bpad, K, O, (K / 64 + ksplit - 1) / ksplit);
  return mrt::finish_gemv(w, out, out_is_bf16, ksplit, B * O, st);
}
