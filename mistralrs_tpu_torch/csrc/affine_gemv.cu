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
//           - sum_16 xsum16[b, .] * zs[g(.), o]                    (f32)
// where xsum16 holds the f32 sums of every 16 consecutive x (the quantize
// kernel of common.cuh makes them). zs is constant over a group, so the sum
// over 16-element halves equals the JAX kernel's sum over whole groups
// (xsum_g @ zs) up to the f32 order. bf16(q * s) is one rounding of the
// exact product (q < 256 and a bf16 s make an exact f32), as the JAX kernel
// forms `vals * srep` in x's dtype.
//
// Layouts (row-major): x [B,K] bf16, q [Kp,O] u8, scale/zs [K/group,O] bf16,
// out [B,O] bf16 or f32; in the workspace (common.cuh carve) xsum16
// [K/16][bpad], part [ksplit,B,O] f32.
//
// What bounds it on an H100: at decode the weight stream. Q2_K moves 0.25
// bytes of codes and 0.25 bytes of bf16 scale and min a weight (group 16),
// against 3.35 TB/s; at 256 rows, the bf16 tensor-core operations.
// Design for that (K4's structure, csrc/q6k_gemv.cu):
// - one K step is 32 byte rows of q for 128 columns (4 KB) and, for each of
//   the PER planes, the two 16-element halves' scale and zs rows, the
//   32-element x slice of the plane at j*Kp + r0 and its two xsum16 values:
//   every code byte is read once, the scales at the codes' rate (at group
//   16 one scale and one zs row a half); a 3-deep cp.async ring in dynamic
//   shared memory;
// - a warp turns its 32 columns of the staged bytes into mma B fragments
//   with K1's 4x4 byte transposes; plane j's codes are a shift and a mask of
//   the same registers, four codes a register, then bf16(q * s) per element;
// - bf16 mma.m16n8k16 with f32 accumulators for the row tiles of x that
//   share each staged weight tile: one (16 rows) up to B = 16, so that a
//   decode step's blocks keep little shared memory and many fit an SM, else
//   four (64 rows); the zs term is two f32 FMAs a half on the accumulators;
// - the K axis is split over blockIdx.y; the partials are added in a fixed
//   order by common.cuh's split-K pass.
// Not done yet (later work): TMA/wgmma, fusing the split-K pass, the zs term
// on the tensor cores.
#include "common.cuh"

namespace {

constexpr int kStages = 3;

// one K step of RT 16-row tiles of x
template <int BITS, int RT>
struct AffineStage {
  static constexpr int kPer = 8 / BITS;
  static constexpr int kXStride = 64 * kPer + 32;  // bytes per staged x row (64 * kPer used)
  uint8_t q[32 * mrt::kGemvCols];                   // swizzled as common.cuh's tiles
  __nv_bfloat16 sc[2 * kPer][mrt::kGemvCols];       // (plane j, half h) at row 2j + h
  __nv_bfloat16 zs[2 * kPer][mrt::kGemvCols];
  float xm[2 * kPer][16 * RT];                      // xsum16 of (plane, half) for the rows
  uint8_t x[16 * RT * kXStride];                    // 16 RT rows x kPer planes x 32 bf16
};

// bf16 pair (lo, hi) from two floats, round to nearest even
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// an unsigned byte as an exact f32 (0x4B000000 is 2^23)
__device__ __forceinline__ float byte_f32(uint32_t w, int i) {
  return __uint_as_float(0x4B000000u | __byte_perm(w, 0, 0x4440 + i)) - 8388608.f;
}

// B fragments of one bf16 m16n8k16 from 4 codes of a column (K rows 4t..4t+3
// of the 16): the MMA's k = 2t, 2t+1 take rows 4t, 4t+1 and k = 2t+8, 2t+9
// take 4t+2, 4t+3; the A fragments below follow the same order (as K4).
__device__ __forceinline__ void bf16_b(uint32_t codes, float s, uint32_t& b0, uint32_t& b1) {
  b0 = bf16x2(byte_f32(codes, 0) * s, byte_f32(codes, 1) * s);
  b1 = bf16x2(byte_f32(codes, 2) * s, byte_f32(codes, 3) * s);
}

template <int BITS, int RT>
__global__ void __launch_bounds__(mrt::kGemvThreads)
    affine_bf16_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ xsum16,
                           const uint8_t* __restrict__ q, const __nv_bfloat16* __restrict__ scale,
                           const __nv_bfloat16* __restrict__ zs, float* __restrict__ part, int B,
                           int bpad, int K, int O, int group, int steps_per_split) {
  using Stage = AffineStage<BITS, RT>;
  constexpr int kPer = Stage::kPer;
  constexpr int kXS = Stage::kXStride;
  constexpr uint32_t kMask = ((1u << BITS) - 1u) * 0x01010101u;  // BITS low bits of each byte
  extern __shared__ __align__(16) uint8_t smem10[];
  Stage* st = reinterpret_cast<Stage*>(smem10);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * mrt::kGemvCols;
  const int row0 = blockIdx.z * 16 * RT;
  const int Kp = K / kPer;
  const int nsteps = Kp / 32;
  const int i_begin = blockIdx.y * steps_per_split;
  const int n = max(0, min(steps_per_split, nsteps - i_begin));

  auto load = [&](int s, int i) {
    Stage& S = st[s];
    const int r0 = 32 * i;  // byte row of q; plane j's elements j*Kp + r0 ..
    mrt::stage_bytes(S.q, q, r0, 32, col0, O);
    // scale, then zs: 2*kPer rows of 128 bf16 each, 16 chunks a row
    for (int c = threadIdx.x; c < 2 * 2 * kPer * 16; c += mrt::kGemvThreads) {
      const int arr = c / (2 * kPer * 16), rem = c % (2 * kPer * 16);
      const int a = rem >> 4, ch = rem & 15;  // a = 2j + h
      const int row = ((a >> 1) * Kp + r0 + 16 * (a & 1)) / group;
      const bool ok = col0 + 8 * ch < O;
      const __nv_bfloat16* src = arr ? zs : scale;
      __nv_bfloat16* dst = arr ? &S.zs[a][8 * ch] : &S.sc[a][8 * ch];
      mrt::cp_async16(dst, ok ? src + (size_t)row * O + col0 + 8 * ch : src, ok);
    }
    // x: 16 RT rows x kPer planes x 4 chunks of 8 bf16, zero past B
    for (int c = threadIdx.x; c < 16 * RT * 4 * kPer; c += mrt::kGemvThreads) {
      const int r = c / (4 * kPer), ch = c % (4 * kPer);
      const bool ok = row0 + r < B;
      const __nv_bfloat16* src = x + (size_t)(row0 + r) * K + (ch >> 2) * Kp + r0 + 8 * (ch & 3);
      mrt::cp_async16(S.x + r * kXS + 16 * ch, ok ? src : x, ok);
    }
    // xsum16: 2*kPer (plane, half) x RT row tiles x 4 chunks; row tiles
    // past bpad are zero-filled
    for (int c = threadIdx.x; c < 2 * kPer * RT * 4; c += mrt::kGemvThreads) {
      const int a = c / (4 * RT), rt = (c >> 2) % RT, ch = c & 3;
      const int r = row0 + 16 * rt;
      const bool ok = r < bpad;
      const float* src = xsum16 + (size_t)(((a >> 1) * Kp + r0) / 16 + (a & 1)) * bpad + r + 4 * ch;
      mrt::cp_async16(&S.xm[a][16 * rt + 4 * ch], ok ? src : xsum16, ok);
    }
  };

  float acc[RT][4][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s, i_begin + s);
    mrt::cp_async_commit();
  }
  const int cb = warp * 32 + 8 * t;  // C columns of n-tile jj: cb + jj and cb + 4 + jj
  const int bc = warp * 32 + 4 * g;  // B columns of n-tile jj: bc + jj
  for (int i = 0; i < n; ++i) {
    mrt::cp_async_wait<kStages - 2>();
    __syncthreads();
    const Stage& S = st[i % kStages];
    uint32_t p0[4], p1[4];  // K rows 4t.. and 16+4t.. of the step, 4 n-tiles
    mrt::b_frags(S.q, 0, warp, lane, p0, p1);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      // the weight fragments of plane j: bf16(q * s) for 4 n-tiles x 2 halves
      float bs0[4], bs1[4];
      mrt::lds4(&S.sc[2 * j][bc], bs0);
      mrt::lds4(&S.sc[2 * j + 1][bc], bs1);
      uint32_t b[4][2][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        bf16_b((p0[jj] >> (BITS * j)) & kMask, bs0[jj], b[jj][0][0], b[jj][0][1]);
        bf16_b((p1[jj] >> (BITS * j)) & kMask, bs1[jj], b[jj][1][0], b[jj][1][1]);
      }
      // zs at the C columns
      float za0[4], za1[4], zb0[4], zb1[4];
      mrt::lds4(&S.zs[2 * j][cb], za0);
      mrt::lds4(&S.zs[2 * j][cb + 4], za1);
      mrt::lds4(&S.zs[2 * j + 1][cb], zb0);
      mrt::lds4(&S.zs[2 * j + 1][cb + 4], zb1);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        if (row0 + 16 * rt >= B) break;  // the same for the whole block
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          // A: rows g and g+8 of the tile, x elements 4t..4t+3 of the half
          const uint8_t* xr = S.x + (16 * rt + g) * kXS + 64 * j + 32 * hf + 8 * t;
          const uint2 u0 = *reinterpret_cast<const uint2*>(xr);
          const uint2 u1 = *reinterpret_cast<const uint2*>(xr + 8 * kXS);
          const uint32_t a[4] = {u0.x, u1.x, u0.y, u1.y};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mrt::mma_bf16(acc[rt][jj], a, b[jj][hf][0], b[jj][hf][1]);
        }
        const float ma0 = S.xm[2 * j][16 * rt + g], ma1 = S.xm[2 * j][16 * rt + g + 8];
        const float mb0 = S.xm[2 * j + 1][16 * rt + g], mb1 = S.xm[2 * j + 1][16 * rt + g + 8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[rt][jj][0] -= ma0 * za0[jj] + mb0 * zb0[jj];
          acc[rt][jj][1] -= ma0 * za1[jj] + mb0 * zb1[jj];
          acc[rt][jj][2] -= ma1 * za0[jj] + mb1 * zb0[jj];
          acc[rt][jj][3] -= ma1 * za1[jj] + mb1 * zb1[jj];
        }
      }
    }
    const int next = i + kStages - 1;  // refill the stage read in the previous step
    if (next < n) load(next % kStages, i_begin + next);
    mrt::cp_async_commit();
  }
  mrt::cp_async_wait<0>();
  float* p = part + (size_t)blockIdx.y * B * O;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
    mrt::store_part(p, acc[rt], B, O, row0 + 16 * rt, col0, warp, lane);
}

template <int BITS, int RT>
int launch_affine_rt(const __nv_bfloat16* x, const mrt::Workspace& w, const uint8_t* q,
                     const __nv_bfloat16* scale, const __nv_bfloat16* zs, int B, int K, int O,
                     int group, int ksplit, cudaStream_t st) {
  const int smem = kStages * (int)sizeof(AffineStage<BITS, RT>);
  const cudaError_t err = mrt::allow_smem(affine_bf16_mma_kernel<BITS, RT>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = 16 * RT;
  const int nsteps = K / (8 / BITS) / 32;
  const dim3 grid((O + mrt::kGemvCols - 1) / mrt::kGemvCols, ksplit, (B + rows - 1) / rows);
  affine_bf16_mma_kernel<BITS, RT><<<grid, mrt::kGemvThreads, smem, st>>>(
      x, w.xsum, q, scale, zs, w.part, B, w.bpad, K, O, group, (nsteps + ksplit - 1) / ksplit);
  return 0;
}

// one 16-row tile a block up to B = 16, four above
template <int BITS>
int launch_affine(const __nv_bfloat16* x, const mrt::Workspace& w, const uint8_t* q,
                  const __nv_bfloat16* scale, const __nv_bfloat16* zs, int B, int K, int O,
                  int group, int ksplit, cudaStream_t st) {
  return B <= 16 ? launch_affine_rt<BITS, 1>(x, w, q, scale, zs, B, K, O, group, ksplit, st)
                 : launch_affine_rt<BITS, 4>(x, w, q, scale, zs, B, K, O, group, ksplit, st);
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): bits in
// {1, 2, 4, 8}, group % 16 == 0, K % group == 0, (K / (8/bits)) % 32 == 0,
// O % 16 == 0, 16-byte aligned pointers, ksplit <= K / (8/bits) / 32, and a
// workspace of ws_bytes (see mrt::carve). Returns the CUDA error code of the
// launches (0 = launched).
extern "C" int affine_gemv(const void* x, const void* q, const void* scale, const void* zs,
                           int bits, int group, void* ws, long long ws_bytes, void* out,
                           int out_is_bf16, int B, int K, int O, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mrt::Workspace w = mrt::carve(ws, B, K, O, 0, 16, ksplit);
  if (w.bytes > (size_t)ws_bytes) return (int)cudaErrorInvalidValue;
  mrt::launch_quantize<32>(x, true, nullptr, nullptr, nullptr, w.xsum, B, K, w.bpad, st);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* sb = static_cast<const __nv_bfloat16*>(scale);
  const auto* zb = static_cast<const __nv_bfloat16*>(zs);
  int err;
  switch (bits) {
    case 1: err = launch_affine<1>(xb, w, qb, sb, zb, B, K, O, group, ksplit, st); break;
    case 2: err = launch_affine<2>(xb, w, qb, sb, zb, B, K, O, group, ksplit, st); break;
    case 4: err = launch_affine<4>(xb, w, qb, sb, zb, B, K, O, group, ksplit, st); break;
    case 8: err = launch_affine<8>(xb, w, qb, sb, zb, B, K, O, group, ksplit, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return mrt::finish_gemv(w, out, out_is_bf16, ksplit, B * O, st);
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
  for (int e = 0; e < 4; ++e) o[e] = bf16x2(v[2 * e], v[2 * e + 1]);
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
