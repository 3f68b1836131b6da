// K9b at 17-256 rows: the high-bit term of Q5_K with activations kept in
// bf16, for prefill-chunk-sized row counts: with K5's rows instantiation
// (csrc/q4k_bf16_gemv.cu) on the same layer's nibbles, the Q5_K product of
// PipelineConfig.int8_activations=False above 16 rows
// (ops/quant_matmul.q5k_matmul adds y + 16 * yh in x's dtype). At 1-16 rows
// the whole Q5_K product is one kernel, csrc/q5k_bf16_gemv.cu.
//
// Replaces the TPU kernel mistralrs_tpu/ops/quant_matmul.py::_q5k_hbit_kernel
// (the second pallas_call of _q5k_matmul_padded, taken by q5k_matmul when
// the int8 gate MISTRALRS_Q5K_INT8 is off).
//
// Computes, for bf16 x [B, K] in element order,
//   yh[b, o] = sum_i x[b, i] * bf16(scale[i/32, o]) * hbit[i, o]   (bf16 MMA, f32 sums)
// rounded once to the output's dtype, where hbit[i, o] is bit i / (K/8) of
// qh row i % (K/8) (plane-major, quant/gguf_linear.pack_q5k: the eight
// planes of a qh byte row contract against eight x slices K/8 apart). The
// weight hbit * s is s or 0, exact in bf16, as the JAX kernel forms
// bits * srep in x's dtype (:687).
//
// Layouts (row-major): x [B,K] bf16, qh [K/8,O] u8, scale [K/32,O] bf16, out
// [B,O] bf16 or f32; in the workspace (common.cuh carve) x's step-ordered
// copy xc [bpad,K] bf16 and, with more than one K split, the partials
// [ksplit,B,O] f32.
//
// What bounds it on an H100: at 256 rows, the bf16 tensor-core operations
// (as many as the full product's: every bit is a multiply). Design for
// that: csrc/plane_gemv.cuh's plane_rows_kernel (K10's) at one bit a code,
// with no zero term, so no activation sums are taken (TMA, a producer
// warpgroup that decodes each stage once, bf16 wgmma).
#include "plane_gemv.cuh"

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): K % 256 ==
// 0, O % 16 == 0, 16-byte aligned pointers. The launch is the plan of
// ops/quant_matmul.q5k_hbit_bf16_plan, every field of it checked here: rows
// 64 or 128, plane_rows_kernel without the zs term, grid (row tiles, column
// tiles, K splits), cluster 1, cols 128, its ring's stages, at most K/256
// splits (4 main steps each); plane_prep_kernel (x in step order, no sums;
// the workspace tiled to the row tile), the GEMV and, with more than one
// split, the split-K pass. Any other plan, and any call of 1-16 rows, is
// refused.
// Returns the CUDA error code of the launches (0 = launched).
extern "C" int q5k_hbit_bf16_gemv(const void* x, const void* qh, const void* scale, void* ws,
                                  long long ws_bytes, void* out, int out_is_bf16, int B, int K,
                                  int O, int rows, int gx, int gy, int gz, int cluster, int cols,
                                  int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((rows != 64 && rows != 128) || B <= 16) return (int)cudaErrorInvalidValue;
  const int ksplit = gz;
  const mrt::Workspace w = mrt::carve(ws, B, K, O, 0, 0, ksplit, mrt::kTiled, rows, true);
  if (!mrt::grid_covers(w, rows, cols, B, O, gx, gy, gz) || cluster != 1 ||
      cols != mrt::kGemvCols || w.bytes > (size_t)ws_bytes || ksplit < 1 || ksplit > K / 256)
    return (int)cudaErrorInvalidValue;
  // no zs term: the pre-pass takes no sums (w.xsum is null)
  return mrt::plane_rows_call<mrt::PlaneFmt<1, false, __nv_bfloat16, false>>(
      static_cast<const __nv_bfloat16*>(x), w, out, out_is_bf16, B, K, O, 32, rows,
      dim3(gx, gy, gz), stages, st, static_cast<const uint8_t*>(qh),
      static_cast<const __nv_bfloat16*>(scale), nullptr);
}
