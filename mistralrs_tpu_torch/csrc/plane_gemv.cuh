// The plane-major GEMV with the weight rounded to bf16 before the product,
//   y[b, o] = sum_k x[b, k] * bf16(code[k, o] * s[g(k), o])      (bf16 MMA, f32 sums)
//           - sum_16 xsum16[b, .] * zs[g(.), o]                   (f32, when ZS)
// shared by three kernels: K10 (csrc/affine_gemv.cu: unsigned codes of 1, 2,
// 4 or 8 bits, bf16 scale and zs), K8 (csrc/q8_0_bf16_gemv.cu: signed 8-bit
// codes, a bf16 or f32 scale per 32, no zs) and K9b
// (csrc/q5k_hbit_bf16_gemv.cu: the 1-bit high-bit planes of Q5_K, a bf16
// scale per 32, no zs).
//
// The layout, with PER = 8 / BITS codes a byte and Kp = K / PER byte rows:
// bits BITS*j of q row r hold element j*Kp + r ("plane" j is the contiguous
// element chunk [j*Kp, (j+1)*Kp)); at BITS = 8 q holds one code a byte in
// element order. s and zs are [K/group, O], group a multiple of 16. An f32 s
// is rounded to bf16 first (as the JAX kernels cast the scale to x's dtype);
// bf16(code * s) is then one rounding of the exact product (|code| < 256 and
// a bf16 s make an exact f32). xsum16 holds the f32 sums of every 16
// consecutive x (the quantize kernel of common.cuh makes them).
//
// Layouts (row-major): x [B,K] bf16, q [Kp,O] u8 (int8 when SIGNED), s
// [K/group,O] bf16 or f32, zs [K/group,O] bf16, out [B,O] bf16 or f32; in the
// workspace (common.cuh carve) xsum16 [K/16][bpad] (when ZS), part
// [ksplit,B,O] f32.
//
// What bounds it on an H100: at decode the weight stream (codes at BITS/8
// bytes a weight, s and zs at 2 or 4 bytes a group), against 3.35 TB/s; at
// 256 rows, the bf16 tensor-core operations.
// Design for that (K4's structure, csrc/q6k_gemv.cu):
// - one K step is 32 byte rows of q for 128 columns (4 KB) and, for each of
//   the PER planes, the two 16-element halves' s (and zs) rows, the
//   32-element x slice of the plane at j*Kp + r0 (and its two xsum16
//   values): every code byte is read once; a 3-deep cp.async ring in
//   dynamic shared memory;
// - a warp turns its 32 columns of the staged bytes into mma B fragments
//   with K1's 4x4 byte transposes; plane j's codes are a shift and a mask of
//   the same registers, four codes a register, then bf16(code * s) per
//   element;
// - bf16 mma.m16n8k16 with f32 accumulators for the row tiles of x that
//   share each staged weight tile: one (16 rows) up to B = 16, so that a
//   decode step's blocks keep little shared memory and many fit an SM, else
//   four (64 rows); the zs term is two f32 FMAs a half on the accumulators;
// - the K axis is split over blockIdx.y; the partials are added in a fixed
//   order by common.cuh's split-K pass.
// Not done yet (later work): TMA/wgmma, fusing the split-K pass, the zs term
// on the tensor cores, reading a group-32 scale row once for both halves.
#pragma once

#include "common.cuh"

namespace mrt {

constexpr int kPlaneStages = 3;

// one K step of RT 16-row tiles of x
template <int BITS, int RT, typename ST, bool ZS>
struct PlaneStage {
  static constexpr int kPer = 8 / BITS;
  static constexpr int kXStride = 64 * kPer + 32;  // bytes per staged x row (64 * kPer used)
  static constexpr int kZ = ZS ? 2 * kPer : 1;      // zs and xsum16 rows (one unused without zs)
  uint8_t q[32 * kGemvCols];                        // swizzled as common.cuh's tiles
  ST sc[2 * kPer][kGemvCols];                       // (plane j, half h) at row 2j + h
  __nv_bfloat16 zs[kZ][kGemvCols];
  float xm[kZ][16 * RT];                            // xsum16 of (plane, half) for the rows
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

// byte i of w as a code: unsigned, or a two's complement int8 (flipping the
// sign bit maps -128..127 onto 0..255, then 2^23 + 128 comes off)
template <bool SIGNED>
__device__ __forceinline__ float code_f32(uint32_t w, int i) {
  if constexpr (SIGNED)
    return __uint_as_float(0x4B000000u | __byte_perm(w ^ 0x80808080u, 0, 0x4440 + i)) -
           8388736.f;
  else
    return byte_f32(w, i);
}

// B fragments of one bf16 m16n8k16 from 4 codes of a column (K rows 4t..4t+3
// of the 16): the MMA's k = 2t, 2t+1 take rows 4t, 4t+1 and k = 2t+8, 2t+9
// take 4t+2, 4t+3; the A fragments below follow the same order (as K4).
template <bool SIGNED>
__device__ __forceinline__ void code_b(uint32_t codes, float s, uint32_t& b0, uint32_t& b1) {
  b0 = bf16x2(code_f32<SIGNED>(codes, 0) * s, code_f32<SIGNED>(codes, 1) * s);
  b1 = bf16x2(code_f32<SIGNED>(codes, 2) * s, code_f32<SIGNED>(codes, 3) * s);
}

// 4 scales from shared memory as the bf16 values the product uses
template <typename ST>
__device__ __forceinline__ void scales4(const ST* p, float o[4]) {
  lds4(p, o);
  if constexpr (sizeof(ST) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = __bfloat162float(__float2bfloat16_rn(o[i]));
  }
}

template <int BITS, int RT, bool SIGNED, typename ST, bool ZS>
__global__ void __launch_bounds__(kGemvThreads)
    plane_bf16_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ xsum16,
                          const uint8_t* __restrict__ q, const ST* __restrict__ scale,
                          const __nv_bfloat16* __restrict__ zs, float* __restrict__ part, int B,
                          int bpad, int K, int O, int group, int steps_per_split) {
  static_assert(!ZS || sizeof(ST) == 2, "the zs term comes with bf16 scales (K10)");
  using Stage = PlaneStage<BITS, RT, ST, ZS>;
  constexpr int kPer = Stage::kPer;
  constexpr int kXS = Stage::kXStride;
  constexpr int kScaleChunks = kGemvCols * (int)sizeof(ST) / 16;  // 16-byte chunks of a row
  constexpr uint32_t kMask = ((1u << BITS) - 1u) * 0x01010101u;   // BITS low bits of each byte
  extern __shared__ __align__(16) uint8_t smem_plane[];
  Stage* st = reinterpret_cast<Stage*>(smem_plane);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * kGemvCols;
  const int row0 = blockIdx.z * 16 * RT;
  const int Kp = K / kPer;
  const int nsteps = Kp / 32;
  const int i_begin = blockIdx.y * steps_per_split;
  const int n = max(0, min(steps_per_split, nsteps - i_begin));

  auto load = [&](int s, int i) {
    Stage& S = st[s];
    const int r0 = 32 * i;  // byte row of q; plane j's elements j*Kp + r0 ..
    stage_bytes(S.q, q, r0, 32, col0, O);
    if constexpr (ZS) {
      // scale, then zs: 2*kPer rows of 128 bf16 each, 16 chunks a row, in
      // one loop (two loops measured 6-10% slower at K10's shapes on an
      // H100, scripts/torch_affine_ab.py)
      for (int c = threadIdx.x; c < 2 * 2 * kPer * 16; c += kGemvThreads) {
        const int arr = c / (2 * kPer * 16), rem = c % (2 * kPer * 16);
        const int a = rem >> 4, ch = rem & 15;  // a = 2j + h
        const int row = ((a >> 1) * Kp + r0 + 16 * (a & 1)) / group;
        const bool ok = col0 + 8 * ch < O;
        const __nv_bfloat16* src = arr ? zs : scale;
        __nv_bfloat16* dst = arr ? &S.zs[a][8 * ch] : &S.sc[a][8 * ch];
        cp_async16(dst, ok ? src + (size_t)row * O + col0 + 8 * ch : src, ok);
      }
    } else {
      // s: 2*kPer rows of 128 values, kScaleChunks chunks a row
      for (int c = threadIdx.x; c < 2 * kPer * kScaleChunks; c += kGemvThreads) {
        const int a = c / kScaleChunks, ch = c % kScaleChunks;  // a = 2j + h
        const int row = ((a >> 1) * Kp + r0 + 16 * (a & 1)) / group;
        constexpr int kPerChunk = 16 / (int)sizeof(ST);
        const bool ok = col0 + kPerChunk * ch < O;
        cp_async16(&S.sc[a][kPerChunk * ch],
                   ok ? scale + (size_t)row * O + col0 + kPerChunk * ch : scale, ok);
      }
    }
    // x: 16 RT rows x kPer planes x 4 chunks of 8 bf16, zero past B
    for (int c = threadIdx.x; c < 16 * RT * 4 * kPer; c += kGemvThreads) {
      const int r = c / (4 * kPer), ch = c % (4 * kPer);
      const bool ok = row0 + r < B;
      const __nv_bfloat16* src = x + (size_t)(row0 + r) * K + (ch >> 2) * Kp + r0 + 8 * (ch & 3);
      cp_async16(S.x + r * kXS + 16 * ch, ok ? src : x, ok);
    }
    if constexpr (ZS) {
      // xsum16: 2*kPer (plane, half) x RT row tiles x 4 chunks; row tiles
      // past bpad are zero-filled
      for (int c = threadIdx.x; c < 2 * kPer * RT * 4; c += kGemvThreads) {
        const int a = c / (4 * RT), rt = (c >> 2) % RT, ch = c & 3;
        const int r = row0 + 16 * rt;
        const bool ok = r < bpad;
        const float* src =
            xsum16 + (size_t)(((a >> 1) * Kp + r0) / 16 + (a & 1)) * bpad + r + 4 * ch;
        cp_async16(&S.xm[a][16 * rt + 4 * ch], ok ? src : xsum16, ok);
      }
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
  for (int s = 0; s < kPlaneStages - 1; ++s) {
    if (s < n) load(s, i_begin + s);
    cp_async_commit();
  }
  const int cb = warp * 32 + 8 * t;  // C columns of n-tile jj: cb + jj and cb + 4 + jj
  const int bc = warp * 32 + 4 * g;  // B columns of n-tile jj: bc + jj
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kPlaneStages - 2>();
    __syncthreads();
    const Stage& S = st[i % kPlaneStages];
    uint32_t p0[4], p1[4];  // K rows 4t.. and 16+4t.. of the step, 4 n-tiles
    b_frags(S.q, 0, warp, lane, p0, p1);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      // the weight fragments of plane j: bf16(code * s) for 4 n-tiles x 2 halves
      float bs0[4], bs1[4];
      scales4(&S.sc[2 * j][bc], bs0);
      scales4(&S.sc[2 * j + 1][bc], bs1);
      uint32_t b[4][2][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        code_b<SIGNED>((p0[jj] >> (BITS * j)) & kMask, bs0[jj], b[jj][0][0], b[jj][0][1]);
        code_b<SIGNED>((p1[jj] >> (BITS * j)) & kMask, bs1[jj], b[jj][1][0], b[jj][1][1]);
      }
      // zs at the C columns
      float za0[4], za1[4], zb0[4], zb1[4];
      if constexpr (ZS) {
        lds4(&S.zs[2 * j][cb], za0);
        lds4(&S.zs[2 * j][cb + 4], za1);
        lds4(&S.zs[2 * j + 1][cb], zb0);
        lds4(&S.zs[2 * j + 1][cb + 4], zb1);
      }
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
          for (int jj = 0; jj < 4; ++jj) mma_bf16(acc[rt][jj], a, b[jj][hf][0], b[jj][hf][1]);
        }
        if constexpr (ZS) {
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
    }
    const int next = i + kPlaneStages - 1;  // refill the stage read in the previous step
    if (next < n) load(next % kPlaneStages, i_begin + next);
    cp_async_commit();
  }
  cp_async_wait<0>();
  float* p = part + (size_t)blockIdx.y * B * O;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) store_part(p, acc[rt], B, O, row0 + 16 * rt, col0, warp, lane);
}

template <int BITS, int RT, bool SIGNED, typename ST, bool ZS>
int launch_plane_rt(const __nv_bfloat16* x, const Workspace& w, const uint8_t* q,
                    const ST* scale, const __nv_bfloat16* zs, int B, int K, int O, int group,
                    int ksplit, cudaStream_t st) {
  auto* kernel = plane_bf16_mma_kernel<BITS, RT, SIGNED, ST, ZS>;
  const int smem = kPlaneStages * (int)sizeof(PlaneStage<BITS, RT, ST, ZS>);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = 16 * RT;
  const int nsteps = K / (8 / BITS) / 32;
  const dim3 grid((O + kGemvCols - 1) / kGemvCols, ksplit, (B + rows - 1) / rows);
  kernel<<<grid, kGemvThreads, smem, st>>>(x, w.xsum, q, scale, zs, w.part, B, w.bpad, K, O,
                                           group, (nsteps + ksplit - 1) / ksplit);
  return 0;
}

// one 16-row tile a block up to B = 16, four above (ops/quant_matmul.py sizes
// ksplit by the same rule)
template <int BITS, bool SIGNED, typename ST, bool ZS>
int launch_plane(const __nv_bfloat16* x, const Workspace& w, const uint8_t* q, const ST* scale,
                 const __nv_bfloat16* zs, int B, int K, int O, int group, int ksplit,
                 cudaStream_t st) {
  return B <= 16
             ? launch_plane_rt<BITS, 1, SIGNED, ST, ZS>(x, w, q, scale, zs, B, K, O, group,
                                                         ksplit, st)
             : launch_plane_rt<BITS, 4, SIGNED, ST, ZS>(x, w, q, scale, zs, B, K, O, group,
                                                         ksplit, st);
}

}  // namespace mrt
