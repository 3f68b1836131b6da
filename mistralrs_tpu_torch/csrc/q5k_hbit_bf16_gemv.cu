// K9b: the high-bit term of Q5_K with activations kept in bf16, for decode-
// and prefill-chunk-sized row counts: with K5 (csrc/q4k_bf16_gemv.cu) on the
// same layer's nibbles, the Q5_K product of PipelineConfig.int8_activations=
// False (ops/quant_matmul.q5k_matmul adds y + 16 * yh in x's dtype).
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
// [B,O] bf16 or f32; in the workspace (common.cuh carve) part [ksplit,B,O]
// f32 and, at 17-256 rows, x's step-ordered copy xc [bpad,K] bf16.
//
// What bounds it on an H100: at decode the stream of bits (1/8 byte a
// weight) and scales (2/32), against 3.35 TB/s; at 256 rows, the bf16
// tensor-core operations (as many as the full product's: every bit is a
// multiply). Design for that: the kernels of csrc/plane_gemv.cuh (K10's) at
// one bit a code, with no zero term, so no activation sums are taken: up to
// 16 rows plane_bf16_mma_kernel (cp.async, the split-K pass; K9b is its
// last user, next in line for plane_dec_kernel), at 17-256 rows
// plane_rows_kernel (TMA, a producer warpgroup that decodes each stage
// once, bf16 wgmma).
// Not done yet (later work): fusing it into K5, one Q5_K kernel over qs and
// qh that reads x once (K9 does so on the int8 route).
#include "plane_gemv.cuh"

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): K % 256 ==
// 0, O % 16 == 0, 16-byte aligned pointers. The launch is the plan of
// ops/quant_matmul.q5k_hbit_bf16_plan, every field of it checked here:
// - rows 16 (B <= 16): plane_bf16_mma_kernel, grid (column tiles, K splits,
//   1), cluster 1, cols 128, stages 0, at most K/256 splits; the GEMV and
//   the split-K pass (the workspace holds the partials);
// - rows 64 or 128: plane_rows_kernel without the zs term, grid (row tiles,
//   column tiles, K splits), cluster 1, cols 128, its ring's stages, at
//   most K/256 splits (4 main steps each); plane_prep_kernel (x in step
//   order, no sums; the workspace tiled to the row tile), the GEMV and,
//   with more than one split, the split-K pass.
// Returns the CUDA error code of the launches (0 = launched).
extern "C" int q5k_hbit_bf16_gemv(const void* x, const void* qh, const void* scale, void* ws,
                                  long long ws_bytes, void* out, int out_is_bf16, int B, int K,
                                  int O, int rows, int gx, int gy, int gz, int cluster, int cols,
                                  int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows != 16 && rows != 64 && rows != 128) return (int)cudaErrorInvalidValue;
  const bool dec = rows == 16;
  const int ksplit = dec ? gy : gz;
  const mrt::Workspace w = dec ? mrt::carve(ws, B, K, O, 0, 0, ksplit)
                               : mrt::carve(ws, B, K, O, 0, 0, ksplit, mrt::kTiled, rows, true);
  const bool grid_ok = dec ? B <= 16 && gx == (O + mrt::kGemvCols - 1) / mrt::kGemvCols &&
                                 gz == 1 && stages == 0
                           : mrt::grid_covers(w, rows, cols, B, O, gx, gy, gz);
  if (!grid_ok || cluster != 1 || cols != mrt::kGemvCols || w.bytes > (size_t)ws_bytes ||
      ksplit < 1 || ksplit > K / 256)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const uint8_t*>(qh);
  const auto* sb = static_cast<const __nv_bfloat16*>(scale);
  if (!dec)  // no zs term: the pre-pass takes no sums (w.xsum is null)
    return mrt::plane_rows_call<mrt::PlaneFmt<1, false, __nv_bfloat16, false>>(
        xb, w, out, out_is_bf16, B, K, O, 32, rows, dim3(gx, gy, gz), stages, st, qb, sb, nullptr);
  const int err = mrt::launch_plane_16<1>(xb, w, qb, sb, B, K, O, 32, ksplit, st);
  if (err != 0) return err;
  return mrt::finish_gemv(w, out, out_is_bf16, ksplit, B * O, st);
}
