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
// out [B,O] bf16 or f32; in the workspace (common.cuh carve) part
// [ksplit,B,O] f32.
//
// What bounds it on an H100: at decode the weight stream, 1 + 2/32 bytes a
// weight with bf16 scales (1 + 4/32 with f32), against 3.35 TB/s; at 256
// rows, the bf16 tensor-core operations. Design for that: the kernel of
// csrc/plane_gemv.cuh (K10's), at 8 bits a code with signed codes, the scale
// rounded to bf16 as it is read, and no zero term, so no activation sums
// are taken: one GEMV launch and the split-K pass.
#include "plane_gemv.cuh"

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): K % 32 ==
// 0, O % 16 == 0, 16-byte aligned pointers, ksplit <= K / 32, and a
// workspace of ws_bytes (see mrt::carve). Returns the CUDA error code of the
// launches (0 = launched).
extern "C" int q8_0_bf16_gemv(const void* x, const void* q, const void* s, int s_is_bf16,
                              void* ws, long long ws_bytes, void* out, int out_is_bf16, int B,
                              int K, int O, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mrt::Workspace w = mrt::carve(ws, B, K, O, 0, 0, ksplit);
  if (w.bytes > (size_t)ws_bytes) return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const uint8_t*>(q);
  const int err =
      s_is_bf16
          ? mrt::launch_plane<8, true, __nv_bfloat16, false>(
                xb, w, qb, static_cast<const __nv_bfloat16*>(s), nullptr, B, K, O, 32, ksplit, st)
          : mrt::launch_plane<8, true, float, false>(xb, w, qb, static_cast<const float*>(s),
                                                     nullptr, B, K, O, 32, ksplit, st);
  if (err != 0) return err;
  return mrt::finish_gemv(w, out, out_is_bf16, ksplit, B * O, st);
}
