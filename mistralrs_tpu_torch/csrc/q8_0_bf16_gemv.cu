// K8: int8 weights with a scale per 32 rows x activations kept in bf16 (wire
// Q8_0 with bf16 scales, and the Q6_K -> int8 requant "rq8" layout at group 32
// with f32 scales), for decode- and prefill-chunk-sized row counts: the route
// of PipelineConfig.int8_activations=False.
//
// Replaces the TPU kernel mistralrs_tpu/ops/quant_matmul.py::_q8_0_kernel
// (launched by _q8_0_matmul_padded via q8_0_matmul when the int8 gate
// MISTRALRS_Q8_0_INT8 is off).
//
// Computes, for bf16 x [B, K] in element order,
//   y[b, o] = sum_k x[b, k] * bf16(q[k, o] * bf16(s[k/32, o]))   (bf16 MMA, f32 sums)
// as the JAX kernel casts q and the scale to x's dtype and forms their
// product there (:1201-1207) before the dot: the weight is rounded to bf16
// once, at every element, and an f32 weight would differ from JAX's in its
// last bits.
//
// Layouts (row-major): x [B,K] bf16, q [K,O] int8, s [K/32,O] bf16 or f32,
// out [B,O] bf16 or f32; at 17-256 rows in the workspace (common.cuh carve)
// part [ksplit,B,O] f32 only with more than one K split; none at 1-16 rows.
//
// What bounds it on an H100: at decode the weight stream, 1 + 2/32 bytes a
// weight with bf16 scales (1 + 4/32 with f32), against 3.35 TB/s; at 256
// rows, the bf16 tensor-core operations. Design for that: the kernels of
// csrc/plane_gemv.cuh (K10's), at 8 bits a code with signed codes, the
// scale rounded to bf16 as it is read, and no zero term, so no activation
// sums are taken: up to 16 rows plane_dec_kernel (one launch a call:
// 64-row steps of codes and their two scale rows by TMA, x by TMA, the K
// splits of a column tile summed in a cluster; bf16(q * s) from the low 7
// bits under 0x43 and an fma whose exact addend carries the sign bit); at
// 17-256 rows plane_rows_kernel (TMA, a producer warpgroup that decodes
// each stage once, bf16 wgmma), whose 32-element steps are x's own order,
// so it reads x in place with no pre-pass.
#include "plane_gemv.cuh"

namespace {

// 32-element main steps of the rows kernel (PlaneRowGeom's at 8 bits): nine
// 21 KB stages at 128 rows; 64-element steps (42 KB: three) measured 25%
// slower at the lm_head, 256 rows, on an H100 (PERF.md §6)
template <typename ST>
using Q8Fmt = mrt::PlaneFmt<8, true, ST, false>;

template <typename ST>
int q8_bf16(const void* x, void* ws, long long ws_bytes, const void* q, const void* s, void* out,
            int out_is_bf16, int B, int K, int O, int rows, int gx, int gy, int gz, int cluster,
            int cols, int stages, cudaStream_t st) {
  if (rows == 16)
    return mrt::plane_dec_call<Q8Fmt<ST>>(x, q, s, nullptr, out, out_is_bf16, B, K, O, 32, rows,
                                          gx, gy, gz, cluster, cols, stages, st);
  const mrt::Workspace w = mrt::carve(ws, B, K, O, 0, 0, gz, mrt::kTiled, rows);
  if ((rows != 64 && rows != 128) || !mrt::grid_covers(w, rows, cols, B, O, gx, gy, gz) ||
      cluster != 1 || cols != mrt::kGemvCols || w.bytes > (size_t)ws_bytes || gz < 1 ||
      gz > (K / 32 + 3) / 4)
    return (int)cudaErrorInvalidValue;
  return mrt::plane_rows_call<Q8Fmt<ST>>(static_cast<const __nv_bfloat16*>(x), w, out,
                                         out_is_bf16, B, K, O, 32, rows, dim3(gx, gy, gz), stages,
                                         st, static_cast<const uint8_t*>(q),
                                         static_cast<const ST*>(s), nullptr);
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): K % 32 ==
// 0, O % 16 == 0, 16-byte aligned pointers. The launch is the plan of
// ops/quant_matmul.q8_0_bf16_plan, every field of it checked here (any
// other plan is refused):
// - rows 16 (B <= 16): plane_dec_kernel on the decode plan
//   (quant_matmul.plane_dec_plan at 8 bits, group 32: grid (K splits,
//   column tiles of `cols` = 128 or 64, 1), a cluster of the splits, at
//   most 8, none empty, the ring's stages at the scale's width), no
//   workspace: one launch;
// - rows 64 or 128: plane_rows_kernel at 8 bits without the zs term, grid
//   (row tiles, column tiles, K splits), cluster 1, cols 128, its ring's
//   stages (of the scale's width), at most one split per 4 main steps; no
//   pre-pass (x read in place), the GEMV and, with more than one split,
//   the split-K pass (the tiled workspace holds only the partials).
// Returns the CUDA error code of the launches (0 = launched).
extern "C" int q8_0_bf16_gemv(const void* x, const void* q, const void* s, int s_is_bf16,
                              void* ws, long long ws_bytes, void* out, int out_is_bf16, int B,
                              int K, int O, int rows, int gx, int gy, int gz, int cluster,
                              int cols, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return s_is_bf16 ? q8_bf16<__nv_bfloat16>(x, ws, ws_bytes, q, s, out, out_is_bf16, B, K, O,
                                            rows, gx, gy, gz, cluster, cols, stages, st)
                   : q8_bf16<float>(x, ws, ws_bytes, q, s, out, out_is_bf16, B, K, O, rows, gx,
                                    gy, gz, cluster, cols, stages, st);
}
