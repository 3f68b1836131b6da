// K2: int8 weights with a scale per `gs` rows x int8 activations (wire Q8_0,
// gs 32 with bf16 scales, and the Q6_K -> int8 requant "rq8" layout, f32
// scales, gs 32 or 64), for decode-sized row counts.
//
// Replaces the TPU kernel mistralrs_tpu/ops/quant_matmul.py::_q8_0_q8_kernel
// (launched by _q8_0_q8_matmul_padded and _q8_0_q8_matmul_stacked).
//
// Computes, for x quantized per gs-element block (xq int8, scale xs; the
// first of the three kernels of a call does that quantization, see
// common.cuh):
//   y[b,o] = sum_g xs[b,g] * s[g,o] * (sum_{k in g} xq[b,k] q[k,o])
//
// Layouts (row-major): x [B,K] bf16 or f32, q [K,O] int8, s [K/gs,O] f32 or
// bf16, out [B,O] bf16 or f32; in the workspace xq [B,K] int8, xs [B,K/gs]
// f32, part [ksplit,B,O] f32.
//
// What bounds it on an H100: at decode the weight stream, 1 + 4/gs bytes per
// weight for f32 scales (1 + 2/gs for bf16), against 3.35 TB/s.
// Design for that: the structure of K1 (q4k_q8_gemv.cu) without the nibble
// unpack. A block owns 128 output columns and a 16-row tile of x; one K step
// is one scale group (gs rows x 128 columns of q, gs*128 bytes, plus its
// scale row and x's codes and scales over the group) staged with 16-byte
// cp.async loads in a 4-deep ring; each warp
// runs gs/32 int8 mma.m16n8k32 per n-tile into exact int32 group dots and
// scales them into f32 accumulators; K is split over blockIdx.y with a
// fixed-order second pass.
#include "common.cuh"

namespace {

constexpr int kStages = 4;

template <int GS, typename ST>
struct Stage {
  static constexpr int kXStride = GS + 16;  // bytes per staged x row (+16 spreads the banks)
  uint8_t q[GS * mrt::kGemvCols];           // one group's rows, swizzled
  ST sc[mrt::kGemvCols];
  int8_t x[16 * kXStride];                  // x's 16 rows over the group
  float xv[16];                             // xs of the 16 rows
};

template <int GS, typename ST>
__global__ void __launch_bounds__(mrt::kGemvThreads)
    q8_0_q8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                       const int8_t* __restrict__ q, const ST* __restrict__ s,
                       float* __restrict__ part, int B, int bpad, int K, int O,
                       int groups_per_split) {
  __shared__ __align__(16) Stage<GS, ST> st[kStages];
  constexpr int kScaleChunks = mrt::kGemvCols * (int)sizeof(ST) / 16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * mrt::kGemvCols;
  const int row0 = blockIdx.z * 16;
  const int ngroups = K / GS;
  const int g_begin = blockIdx.y * groups_per_split;
  const int n = max(0, min(groups_per_split, ngroups - g_begin));

  auto load = [&](int stage, int grp) {
    mrt::stage_bytes(st[stage].q, reinterpret_cast<const uint8_t*>(q), GS * grp, GS, col0, O);
    if (threadIdx.x < kScaleChunks) {
      const int c = threadIdx.x, per = 16 / (int)sizeof(ST);
      const bool ok = col0 + per * c < O;
      mrt::cp_async16(&st[stage].sc[per * c], ok ? s + (size_t)grp * O + col0 + per * c : s, ok);
    }
    // x: GS/16 chunks per row with threads 32.., its scales with threads 0..3
    mrt::stage_x(st[stage].x, Stage<GS, ST>::kXStride, xq, B, K, row0, GS / 16, 32,
                 [&](int c) { return GS * grp + 16 * c; });
    mrt::stage_rows16(st[stage].xv, xs + (size_t)grp * bpad + row0, 0);
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) load(i, g_begin + i);
    mrt::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    mrt::cp_async_wait<kStages - 2>();
    __syncthreads();
    const Stage<GS, ST>& S = st[i % kStages];
    int d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][e] = 0;
#pragma unroll
    for (int ks = 0; ks < GS / 32; ++ks) {
      uint32_t a[4], b0[4], b1[4];
      mrt::a_frag(S.x, Stage<GS, ST>::kXStride, 32 * ks, lane, a);
      mrt::b_frags(S.q, 32 * ks, warp, lane, b0, b1);
#pragma unroll
      for (int j = 0; j < 4; ++j) mrt::mma_s8(d[j], a, b0[j], b1[j]);
    }
    const float x0 = S.xv[g], x1 = S.xv[g + 8];  // rows past B: zero codes, never stored
    const int cb = warp * 32 + 8 * t;
    float s0[4], s1[4];
    mrt::lds4(&S.sc[cb], s0);
    mrt::lds4(&S.sc[cb + 4], s1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j][0] += (float)d[j][0] * x0 * s0[j];
      acc[j][1] += (float)d[j][1] * x0 * s1[j];
      acc[j][2] += (float)d[j][2] * x1 * s0[j];
      acc[j][3] += (float)d[j][3] * x1 * s1[j];
    }
    const int next = i + kStages - 1;  // refill the stage read in the previous step
    if (next < n) load(next % kStages, g_begin + next);
    mrt::cp_async_commit();
  }
  mrt::cp_async_wait<0>();
  mrt::store_part(part + (size_t)blockIdx.y * B * O, acc, B, O, row0, col0, warp, lane);
}

template <int GS, typename ST>
void launch_gs(const void* xq, const void* xs, const void* q, const void* s, float* part, int B,
               int bpad, int K, int O, int ksplit, cudaStream_t st) {
  const int ngroups = K / GS;
  const dim3 grid((O + mrt::kGemvCols - 1) / mrt::kGemvCols, ksplit, (B + 15) / 16);
  q8_0_q8_mma_kernel<GS, ST><<<grid, mrt::kGemvThreads, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(q), static_cast<const ST*>(s), part, B, bpad, K, O,
      (ngroups + ksplit - 1) / ksplit);
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): gs in
// {32, 64}, K % gs == 0, O % 16 == 0, 16-byte aligned pointers,
// ksplit <= K/gs, and a workspace of ws_bytes (see mrt::carve). Quantizes x
// (bf16 or f32 [B,K]) per gs, then runs the GEMV and the split-K pass.
// Returns the CUDA error code of the launches (0 = launched).
extern "C" int q8_0_q8_gemv(const void* x, int x_is_bf16, const void* q, const void* s,
                            int scale_is_bf16, int gs, void* ws, long long ws_bytes, void* out,
                            int out_is_bf16, int B, int K, int O, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gs != 32 && gs != 64) return (int)cudaErrorInvalidValue;
  const mrt::Workspace w = mrt::carve(ws, B, K, O, gs, 0, ksplit);
  if (w.bytes > (size_t)ws_bytes) return (int)cudaErrorInvalidValue;
  if (gs == 32) {
    mrt::launch_quantize<32>(x, x_is_bf16 != 0, w.xq, w.xs, nullptr, nullptr, B, K, w.bpad, st);
    if (scale_is_bf16)
      launch_gs<32, __nv_bfloat16>(w.xq, w.xs, q, s, w.part, B, w.bpad, K, O, ksplit, st);
    else
      launch_gs<32, float>(w.xq, w.xs, q, s, w.part, B, w.bpad, K, O, ksplit, st);
  } else {
    mrt::launch_quantize<64>(x, x_is_bf16 != 0, w.xq, w.xs, nullptr, nullptr, B, K, w.bpad, st);
    if (scale_is_bf16)
      launch_gs<64, __nv_bfloat16>(w.xq, w.xs, q, s, w.part, B, w.bpad, K, O, ksplit, st);
    else
      launch_gs<64, float>(w.xq, w.xs, q, s, w.part, B, w.bpad, K, O, ksplit, st);
  }
  return mrt::finish_gemv(w, out, out_is_bf16, ksplit, B * O, st);
}

// ---- dequantization for prefill-sized calls ----
//
// The pass XLA fuses in the JAX package's dequant_q8_0_gs_weights for the
// prefill route: w[k, o] = bf16(q * bf16(s[k/gs, o])), K-major [K, O] bf16,
// rounded as the plain version's bf16 ops round. Bound: bytes (1 + 4/gs
// read + 2 written per weight). A thread owns 8 neighbouring columns of one
// row.
namespace {

template <typename ST>
__global__ void q8_0_dequant_kernel(const int8_t* __restrict__ q, const ST* __restrict__ s,
                                    __nv_bfloat16* __restrict__ w, int K, int O, int gs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per_row = O / 8;
  if (i >= (long long)K * per_row) return;
  const int k = (int)(i / per_row), c = (int)(i % per_row) * 8;
  const uint2 qv = __ldg(reinterpret_cast<const uint2*>(q + (size_t)k * O + c));
  const int8_t* qb = reinterpret_cast<const int8_t*>(&qv);
  const ST* sp = s + (size_t)(k / gs) * O + c;
  uint32_t out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sb = __bfloat162float(__float2bfloat16_rn(mrt::to_f32(sp[2 * j + h])));
      v[h] = (float)qb[2 * j + h] * sb;
    }
    const __nv_bfloat16 a = __float2bfloat16_rn(v[0]), b = __float2bfloat16_rn(v[1]);
    out[j] = (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
  }
  *reinterpret_cast<uint4*>(w + (size_t)k * O + c) = make_uint4(out[0], out[1], out[2], out[3]);
}

}  // namespace

// q [K, O] int8, s [K/gs, O] f32 or bf16 -> w [K, O] bf16. O % 8 == 0,
// K % gs == 0, 16-byte aligned pointers (checked by ops/quant_matmul.py).
extern "C" int q8_0_dequant(const void* q, const void* s, int scale_is_bf16, int gs, void* w,
                            int K, int O, void* stream) {
  const long long n = (long long)K * (O / 8);
  const unsigned grid = (unsigned)((n + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale_is_bf16)
    q8_0_dequant_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const __nv_bfloat16*>(s),
        static_cast<__nv_bfloat16*>(w), K, O, gs);
  else
    q8_0_dequant_kernel<float><<<grid, 256, 0, st>>>(static_cast<const int8_t*>(q),
                                                     static_cast<const float*>(s),
                                                     static_cast<__nv_bfloat16*>(w), K, O, gs);
  return (int)cudaGetLastError();
}
