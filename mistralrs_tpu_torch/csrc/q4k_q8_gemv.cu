// K1: Q4_K weights x int8 activations, for decode-sized row counts.
//
// Replaces the TPU kernel mistralrs_tpu/ops/quant_matmul.py::_q4k_q8_kernel
// (launched by _q4k_q8_matmul_padded and _q4k_q8_matmul_stacked).
//
// Computes, for x quantized per 32-element block (xq int8, scale xs, and
// xsum = the block sums of the ORIGINAL x; the first of the three kernels
// of a call does that quantization, see common.cuh):
//   y[b,o] = sum_sub xs[b,sub] * scale[sub,o] * (sum_{k in sub} xq[b,k] q[k,o])
//          - sum_sub xsum[b,sub] * minv[sub,o]
// where q[k,o] is the low nibble of qs[k,o] for k < K/2 and the high nibble
// of qs[k-K/2,o] otherwise (the paired layout of quant/gguf_linear.pack_q4k).
//
// Layouts (row-major): x [B,K] bf16 or f32, qs [K/2,O] u8, scale/minv
// [K/32,O] bf16, out [B,O] bf16 or f32; in the workspace xq [B,K] int8,
// xs/xsum [B,K/32] f32, part [ksplit,B,O] f32.
//
// What bounds it on an H100: at decode (B <= 16) the weight stream, 0.625
// bytes per weight (qs + two bf16 scale planes), against 3.35 TB/s.
// Design for that:
// - a block owns 128 output columns and a 16-row tile of x; one K step is
//   one "sub-block pair": byte rows 32p..32p+31 of qs, whose low nibbles are
//   sub-block p and high nibbles sub-block K/64+p, 4 KB for 128 columns,
//   staged with 16-byte cp.async loads (coalesced) in a 4-deep ring together
//   with the pair's four scale rows (1 KB) and x's int8 codes, scales and
//   block sums for those two sub-blocks, so no step waits on a global load;
// - each warp turns its 32 columns of the staged bytes into mma.m16n8k32
//   B fragments (one 4x4 byte transpose per 4 rows, low and high nibbles
//   masked out of the same word) and runs 8 int8 tensor-core MMAs per pair
//   against x's int8 rows: exact int32 dots per (row, column, sub-block),
//   scaled into f32 accumulators with xs*scale and the min term xsum*minv;
// - the K axis is split over blockIdx.y so that enough loads are in flight
//   to fill the card; partial sums go to part[] and a second small kernel
//   adds them in a fixed order.
// Not done yet (later work): TMA/wgmma, fusing the split-K pass.
#include "common.cuh"

namespace {

constexpr int kStages = 4;

constexpr int kXStride = 80;  // bytes per staged x row (64 used; 80 spreads the banks)

struct Stage {
  uint8_t q[32 * mrt::kGemvCols];       // one pair's byte rows, swizzled
  __nv_bfloat16 sc[4][mrt::kGemvCols];  // scale lo, scale hi, minv lo, minv hi
  int8_t x[16 * kXStride];              // x's 16 rows: 32 bytes of sub-block p, 32 of K/64+p
  float xv[4][16];                      // xs lo, xs hi, xsum lo, xsum hi of the 16 rows
};

__global__ void __launch_bounds__(mrt::kGemvThreads)
    q4k_q8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                      const float* __restrict__ xsum, const uint8_t* __restrict__ qs,
                      const __nv_bfloat16* __restrict__ scale,
                      const __nv_bfloat16* __restrict__ minv, float* __restrict__ part, int B,
                      int bpad, int K, int O, int pairs_per_split) {
  __shared__ __align__(16) Stage st[kStages];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * mrt::kGemvCols;
  const int row0 = blockIdx.z * 16;
  const int npairs = K / 64;
  const int p_begin = blockIdx.y * pairs_per_split;
  const int n = max(0, min(pairs_per_split, npairs - p_begin));

  auto load = [&](int s, int p) {
    mrt::stage_bytes(st[s].q, qs, 32 * p, 32, col0, O);
    if (threadIdx.x < 64) {  // 4 rows of 128 bf16 = 64 chunks of 16 bytes
      const int a = threadIdx.x >> 4, c = threadIdx.x & 15;
      const __nv_bfloat16* base = a < 2 ? scale : minv;
      const int row = (a & 1) ? npairs + p : p;
      const bool ok = col0 + 8 * c < O;
      mrt::cp_async16(&st[s].sc[a][8 * c], ok ? base + (size_t)row * O + col0 + 8 * c : base, ok);
    }
    // x: 2 chunks of sub-block p and 2 of sub-block K/64+p per row (threads 64..127)
    mrt::stage_x(st[s].x, kXStride, xq, B, K, row0, 4, 64,
                 [&](int c) { return (c < 2 ? 32 * p : K / 2 + 32 * p - 32) + 16 * c; });
    mrt::stage_rows16(st[s].xv[0], xs + (size_t)p * bpad + row0, 0);
    mrt::stage_rows16(st[s].xv[1], xs + (size_t)(npairs + p) * bpad + row0, 4);
    mrt::stage_rows16(st[s].xv[2], xsum + (size_t)p * bpad + row0, 8);
    mrt::stage_rows16(st[s].xv[3], xsum + (size_t)(npairs + p) * bpad + row0, 12);
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
  for (int i = 0; i < n; ++i) {
    mrt::cp_async_wait<kStages - 2>();
    __syncthreads();
    const Stage& S = st[i % kStages];
    uint32_t alo[4], ahi[4], b0[4], b1[4];
    mrt::a_frag(S.x, kXStride, 0, lane, alo);
    mrt::a_frag(S.x, kXStride, 32, lane, ahi);
    mrt::b_frags(S.q, 0, warp, lane, b0, b1);
    // x's scales and block sums for the rows g and g+8 of the tile (rows
    // past B have zero codes, so whatever these hold never reaches part)
    const float xsl0 = S.xv[0][g], xsl1 = S.xv[0][g + 8];
    const float xsh0 = S.xv[1][g], xsh1 = S.xv[1][g + 8];
    const float xml0 = S.xv[2][g], xml1 = S.xv[2][g + 8];
    const float xmh0 = S.xv[3][g], xmh1 = S.xv[3][g + 8];
    // column scales: C columns of n-tile j are cb + j and cb + 4 + j
    const int cb = warp * 32 + 8 * t;
    float sl0[4], sl1[4], sh0[4], sh1[4], ml0[4], ml1[4], mh0[4], mh1[4];
    mrt::lds4(&S.sc[0][cb], sl0);
    mrt::lds4(&S.sc[0][cb + 4], sl1);
    mrt::lds4(&S.sc[1][cb], sh0);
    mrt::lds4(&S.sc[1][cb + 4], sh1);
    mrt::lds4(&S.sc[2][cb], ml0);
    mrt::lds4(&S.sc[2][cb + 4], ml1);
    mrt::lds4(&S.sc[3][cb], mh0);
    mrt::lds4(&S.sc[3][cb + 4], mh1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int dl[4] = {0, 0, 0, 0}, dh[4] = {0, 0, 0, 0};
      mrt::mma_s8(dl, alo, b0[j] & 0x0F0F0F0Fu, b1[j] & 0x0F0F0F0Fu);
      mrt::mma_s8(dh, ahi, (b0[j] >> 4) & 0x0F0F0F0Fu, (b1[j] >> 4) & 0x0F0F0F0Fu);
      acc[j][0] += (float)dl[0] * xsl0 * sl0[j] + (float)dh[0] * xsh0 * sh0[j] - xml0 * ml0[j] -
                   xmh0 * mh0[j];
      acc[j][1] += (float)dl[1] * xsl0 * sl1[j] + (float)dh[1] * xsh0 * sh1[j] - xml0 * ml1[j] -
                   xmh0 * mh1[j];
      acc[j][2] += (float)dl[2] * xsl1 * sl0[j] + (float)dh[2] * xsh1 * sh0[j] - xml1 * ml0[j] -
                   xmh1 * mh0[j];
      acc[j][3] += (float)dl[3] * xsl1 * sl1[j] + (float)dh[3] * xsh1 * sh1[j] - xml1 * ml1[j] -
                   xmh1 * mh1[j];
    }
    const int next = i + kStages - 1;  // refill the stage read in the previous step
    if (next < n) load(next % kStages, p_begin + next);
    mrt::cp_async_commit();
  }
  mrt::cp_async_wait<0>();
  mrt::store_part(part + (size_t)blockIdx.y * B * O, acc, B, O, row0, col0, warp, lane);
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): K % 64 == 0,
// O % 16 == 0, 16-byte aligned pointers, ksplit <= K/64, and a workspace of
// ws_bytes (see mrt::carve). Quantizes x (bf16 or f32 [B,K]) per 32, then
// runs the GEMV and the split-K pass. Returns the CUDA error code of the
// launches (0 = launched).
extern "C" int q4k_q8_gemv(const void* x, int x_is_bf16, const void* qs, const void* scale,
                           const void* minv, void* ws, long long ws_bytes, void* out,
                           int out_is_bf16, int B, int K, int O, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mrt::Workspace w = mrt::carve(ws, B, K, O, 32, 32, ksplit);
  if (w.bytes > (size_t)ws_bytes) return (int)cudaErrorInvalidValue;
  mrt::launch_quantize<32>(x, x_is_bf16 != 0, w.xq, w.xs, w.xsum, nullptr, B, K, w.bpad, st);
  const int npairs = K / 64;
  const dim3 grid((O + mrt::kGemvCols - 1) / mrt::kGemvCols, ksplit, (B + 15) / 16);
  q4k_q8_mma_kernel<<<grid, mrt::kGemvThreads, 0, st>>>(
      w.xq, w.xs, w.xsum, static_cast<const uint8_t*>(qs),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(minv), w.part,
      B, w.bpad, K, O, (npairs + ksplit - 1) / ksplit);
  return mrt::finish_gemv(w, out, out_is_bf16, ksplit, B * O, st);
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
