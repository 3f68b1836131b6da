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
// Computes, for bf16 x [B, K]:
//   y[b,o] = sum_sub scale[sub,o] * (sum_{k in sub} x[b,k] q[k,o])   (f32 dot per sub-block)
//          - sum_sub xsum[b,sub] * minv[sub,o]
// with xsum the f32 sums of every 32 x, where q[k,o] is the low nibble of
// qs[k,o] for k < K/2 and the high nibble of qs[k-K/2,o] otherwise (the
// paired layout of quant/gguf_linear.pack_q4k). The JAX kernel multiplies
// each 32-element sub-block's f32 dot by the scale (:107-116); a nibble is
// exact in bf16, so the tensor cores see x and q unrounded; the weight
// q * s is never rounded either.
//
// Layouts (row-major): x [B,K] bf16, qs [K/2,O] u8, scale/minv [K/32,O] bf16,
// out [B,O] bf16 or f32; at 17-256 rows in the workspace (common.cuh carve)
// the per-32 sums xsum [K/32][bpad] f32, x's step-ordered copy xc [bpad,K]
// and, with more than one K split, the partials [ksplit,B,O] f32.
//
// What bounds it on an H100: at decode the weight stream, 0.625 bytes a
// weight (qs + two bf16 planes per 32), against 3.35 TB/s; at 256 rows, the
// bf16 tensor-core operations (twice the product's at 17-256 rows, whose
// weight goes in as two exact bf16 parts).
// Q4_K's paired layout is the 4-bit plane layout (plane 0: the low nibbles,
// elements 0..K/2-1; plane 1: the high ones), so both instantiations are
// csrc/plane_gemv.cuh's, with the format Q4kFmt (group 32, zs = minv):
// - 1-16 rows: plane_dec_kernel, K8's and K10's decode design: one launch a
//   call (no quantize or sums kernel, no workspace, no split-K pass); a K
//   step is 32 byte rows of qs, one sub-block of each plane, brought with
//   its scale and minv rows (both seen as [2][K/64][O]) in one TMA box an
//   array, and x's 32 elements of each plane in one box of x seen as
//   [B][2][K/2]; the K splits of a column tile add their tiles in a
//   cluster. The scale stays on the accumulator (Q4kFmt::kScaleOnAcc): the
//   weight is the A operand of bf16 mma.m16n8k16 as the raw nibble (K4's
//   0x43cc pair less 128, exact), the two 16-element halves of a sub-block
//   run into a fresh f32 fragment and one FFMA a (row, column, sub-block)
//   adds it times the column's scale; the min term is a second FFMA, x's
//   per-32 sums times -minv, the sums taken on the tensor cores by a bf16
//   mma with an all-ones A over the same x fragments (no sums kernel).
// - 17-256 rows: plane_rows_kernel: a producer warpgroup decodes each
//   TMA-fed stage once into the two exact bf16 parts of q * s, bf16 wgmma
//   runs over both, and the min term is the zs term on the tensor cores.
#include "plane_gemv.cuh"

namespace {

// elements of a main step of the rows kernel (ops/quant_matmul.Q4K_ROW_ELEMS):
// 32, so six 27 KB stages fit at 128 rows (nine at 64); 64-element steps
// (53 KB: three) measured 11-15% slower on an H100 (PERF.md §6)
constexpr int kQ4kRowElems = 32;
using Fmt = mrt::Q4kFmt<kQ4kRowElems>;

}  // namespace

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): K % 64 ==
// 0, O % 16 == 0, 16-byte aligned pointers. The launch is the plan of
// ops/quant_matmul.q4k_bf16_plan, every field of it checked here:
// - rows 16 (B <= 16): plane_dec_kernel with Q4kFmt, K10's 4-bit decode
//   plan at group 32 (plane_dec_plan_ok): grid (K splits, column tiles of
//   `cols` = 128 or 64, 1), a cluster of the splits, the ring's stages; no
//   workspace; one launch;
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
  using G = Fmt::G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 16)  // the paired nibbles as 4-bit planes, group 32, zs = minv
    return mrt::plane_dec_call<Fmt>(x, qs, scale, minv, out, out_is_bf16, B, K, O, 32, rows, gx,
                                    gy, gz, cluster, cols, stages, st);
  if (rows != 64 && rows != 128) return (int)cudaErrorInvalidValue;
  const int ksplit = gz;
  const mrt::Workspace w = mrt::carve(ws, B, K, O, 0, 32, ksplit, mrt::kTiled, rows, true);
  const int Z = mrt::plane_slice_steps<G, true>(32);
  const int units = (K / 2 / G::kR + Z - 1) / Z;  // the K split's units
  if (!mrt::grid_covers(w, rows, cols, B, O, gx, gy, gz) || cluster != 1 ||
      cols != mrt::kGemvCols || w.bytes > (size_t)ws_bytes || ksplit < 1 || ksplit > units)
    return (int)cudaErrorInvalidValue;
  return mrt::plane_rows_call<Fmt>(static_cast<const __nv_bfloat16*>(x), w, out, out_is_bf16, B,
                                   K, O, 32, rows, dim3(gx, gy, gz), stages, st,
                                   static_cast<const uint8_t*>(qs),
                                   static_cast<const __nv_bfloat16*>(scale),
                                   static_cast<const __nv_bfloat16*>(minv));
}
