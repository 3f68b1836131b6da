// K10: the plane-major affine GEMV (w = q * scale[g] - zs[g]) that serves
// GGUF Q2_K, GPTQ 2/3/4/8-bit and HQQ 1/2/3/4/8-bit weights at decode- and
// prefill-chunk-sized row counts; and the same weights' dequantization for
// the prefill route.
//
// Replaces the TPU kernel mistralrs_tpu/ops/quant_matmul.py::_affine_kernel
// (launched by _affine_matmul_padded via affine_qmatmul).
//
// The layout (quant/gguf_linear.pack_q2k, quant/gptq._pack_bytes_rows), with
// PER = 8 / BITS codes a byte and Kp = K / PER byte rows: bits BITS*j of q
// row r hold element j*Kp + r ("plane" j is the contiguous element chunk
// [j*Kp, (j+1)*Kp)); at BITS = 8 q holds one code a byte in element order.
// scale and zs are [K/group, O] bf16, group a multiple of 16.
//
// K10 computes, for bf16 x [B, K] in element order,
//   y[b, o] = sum_k x[b, k] * bf16(q[k, o] * scale[g(k), o])     (bf16 MMA, f32 sums)
//           - sum_g xsum_g[b] * zs[g, o]                         (f32)
// where xsum_g sums x over group g: zs is constant over a group, so the
// kernels sum it over 16-element halves (1-16 rows: a second bf16 mma
// with A = -zs; 17-256 rows: per-group sums of x on the tensor cores), the
// JAX kernel's xsum_g @ zs up to the f32 order. bf16(q * s) is one
// rounding of the exact product (q < 256 and a bf16 s make an exact f32),
// as the JAX kernel forms `vals * srep` in x's dtype.
//
// Layouts (row-major): x [B,K] bf16, q [Kp,O] u8, scale/zs [K/group,O] bf16,
// out [B,O] bf16 or f32; at 17-256 rows in the workspace (common.cuh
// carve, tiled to the row tile) xsum [K/group][bpad], x's step-ordered copy
// xc and, with more than one split, part [ksplit,B,O] f32; none at 1-16
// rows.
//
// What bounds it on an H100: at decode the weight stream. Q2_K moves 0.25
// bytes of codes and 0.25 bytes of bf16 scale and min a weight (group 16),
// against 3.35 TB/s; at 256 rows, the bf16 tensor-core operations.
// Design for that: csrc/plane_gemv.cuh, whose kernels this file launches
// with unsigned codes, bf16 scale and zs, and the zs term on: up to 16 rows
// plane_dec_kernel (K8's too; one launch a call, the K splits summed in a
// cluster, the zs term a second bf16 mma), at 17-256 rows plane_rows_kernel
// (TMA, bf16 wgmma, the zs term on the tensor cores).
#include "plane_gemv.cuh"

namespace {

template <int BITS>
using AffineFmt = mrt::PlaneFmt<BITS, false, __nv_bfloat16, true>;

template <int BITS>
int affine_bits(const void* x, void* ws, long long ws_bytes, const uint8_t* q,
                const __nv_bfloat16* scale, const __nv_bfloat16* zs, void* out, int out_is_bf16,
                int B, int K, int O, int group, int rows, int gx, int gy, int gz, int cluster,
                int cols, int stages, cudaStream_t st) {
  using F = AffineFmt<BITS>;
  if (rows == 16)
    return mrt::plane_dec_call<F>(x, q, scale, zs, out, out_is_bf16, B, K, O, group, rows, gx, gy,
                                  gz, cluster, cols, stages, st);
  // the rows kernel: a group inside a plane and a power of two, and no
  // empty K split
  using G = typename F::G;
  const mrt::Workspace w = mrt::carve(ws, B, K, O, 0, group, gz, mrt::kTiled, rows, true);
  const int Kp = K / G::kPer;
  const int Z = mrt::plane_slice_steps<G, true>(group);
  const int nslices = (Kp / G::kR + Z - 1) / Z;
  if ((rows != 64 && rows != 128) || !mrt::grid_covers(w, rows, cols, B, O, gx, gy, gz) ||
      cluster != 1 || cols != mrt::kGemvCols || w.bytes > (size_t)ws_bytes || gz < 1 ||
      Kp % group != 0 || (group & (group - 1)) != 0 || gz > nslices)
    return (int)cudaErrorInvalidValue;
  return mrt::plane_rows_call<F>(static_cast<const __nv_bfloat16*>(x), w, out, out_is_bf16, B, K,
                                 O, group, rows, dim3(gx, gy, gz), stages, st, q, scale, zs);
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): bits in
// {1, 2, 4, 8}, group % 16 == 0, K % group == 0, (K / (8/bits)) % 32 == 0,
// O % 16 == 0, 16-byte aligned pointers, and a workspace of ws_bytes (see
// mrt::carve). The launch is the plan of ops/quant_matmul.plane_gemv_plan,
// every field of it checked here (any other plan is refused):
// - rows 16 (B <= 16): plane_dec_kernel on the decode plan
//   (quant_matmul.plane_dec_plan: grid (K splits, column tiles of `cols` =
//   128 or 64, 1), a cluster of the splits, at most 8, none empty, the
//   ring's stages), a group inside one plane ((K/(8/bits)) % group == 0: a
//   group that straddles two planes is refused), no workspace: one launch;
// - rows 64 or 128: plane_rows_kernel, grid (row tiles, column tiles, K
//   splits), cluster 1, cols 128, its ring's stages, (K/(8/bits)) % group
//   == 0 and a power-of-two group, at most one split per zs slice. The
//   per-group sums and x's step-ordered copy (plane_prep_kernel; the
//   workspace tiled to the row tile), the GEMV and, with more than one
//   split, the split-K pass.
// Returns the CUDA error code of the launches (0 = launched).
extern "C" int affine_gemv(const void* x, const void* q, const void* scale, const void* zs,
                           int bits, int group, void* ws, long long ws_bytes, void* out,
                           int out_is_bf16, int B, int K, int O, int rows, int gx, int gy, int gz,
                           int cluster, int cols, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* sb = static_cast<const __nv_bfloat16*>(scale);
  const auto* zb = static_cast<const __nv_bfloat16*>(zs);
  switch (bits) {
    case 1: return affine_bits<1>(x, ws, ws_bytes, qb, sb, zb, out, out_is_bf16, B, K, O, group, rows, gx, gy, gz, cluster, cols, stages, st);
    case 2: return affine_bits<2>(x, ws, ws_bytes, qb, sb, zb, out, out_is_bf16, B, K, O, group, rows, gx, gy, gz, cluster, cols, stages, st);
    case 4: return affine_bits<4>(x, ws, ws_bytes, qb, sb, zb, out, out_is_bf16, B, K, O, group, rows, gx, gy, gz, cluster, cols, stages, st);
    case 8: return affine_bits<8>(x, ws, ws_bytes, qb, sb, zb, out, out_is_bf16, B, K, O, group, rows, gx, gy, gz, cluster, cols, stages, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- dequantization for prefill-sized calls ----
//
// The pass XLA fuses in the JAX package's dequant_q2k_weights (and the GPTQ
// and HQQ dequants): w[k, o] = bf16(bf16(q * scale) - zs) in element order,
// with the same two roundings as the plain version's bf16 ops. Bound: bytes
// (BITS/8 + 4/group read and 2 written per weight). A thread owns 8
// neighbouring columns of one element row k.
namespace {

__global__ void affine_dequant_kernel(const uint8_t* __restrict__ q,
                                      const __nv_bfloat16* __restrict__ scale,
                                      const __nv_bfloat16* __restrict__ zs,
                                      __nv_bfloat16* __restrict__ w, int bits, int group, int K,
                                      int O) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per_row = O / 8;
  if (i >= (long long)K * per_row) return;
  const int k = (int)(i / per_row), c8 = (int)(i % per_row) * 8;
  const int Kp = K / (8 / bits), j = k / Kp, r = k % Kp;
  const uint32_t mask = (1u << bits) - 1u;
  const uint2 qv = __ldg(reinterpret_cast<const uint2*>(q + (size_t)r * O + c8));
  const uint4 sv = __ldg(reinterpret_cast<const uint4*>(scale + (size_t)(k / group) * O + c8));
  const uint4 zv = __ldg(reinterpret_cast<const uint4*>(zs + (size_t)(k / group) * O + c8));
  const uint8_t* qb = reinterpret_cast<const uint8_t*>(&qv);
  const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w}, zw[4] = {zv.x, zv.y, zv.z, zv.w};
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float code = (float)((qb[e] >> (bits * j)) & mask);
    const float s = (e & 1) ? mrt::bf16_hi(sw[e >> 1]) : mrt::bf16_lo(sw[e >> 1]);
    const float z = (e & 1) ? mrt::bf16_hi(zw[e >> 1]) : mrt::bf16_lo(zw[e >> 1]);
    v[e] = __bfloat162float(__float2bfloat16_rn(code * s)) - z;
  }
  uint32_t o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = mrt::bf16x2(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(w + (size_t)k * O + c8) = make_uint4(o[0], o[1], o[2], o[3]);
}

}  // namespace

// q [K/(8/bits), O] u8 plane-major (bytes at bits 8), scale/zs [K/group, O]
// bf16 -> w [K, O] bf16 in element order. bits in {1, 2, 4, 8}, K % group ==
// 0, O % 8 == 0, 16-byte aligned pointers (checked by ops/quant_matmul.py).
extern "C" int affine_dequant(const void* q, const void* scale, const void* zs, void* w, int bits,
                              int group, int K, int O, void* stream) {
  const long long n = (long long)K * (O / 8);
  affine_dequant_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(zs), static_cast<__nv_bfloat16*>(w), bits, group, K, O);
  return (int)cudaGetLastError();
}
