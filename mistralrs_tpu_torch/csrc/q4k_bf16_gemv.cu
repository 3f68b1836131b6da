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
// Computes, for bf16 x [B, K] and xsum = the f32 sums of every 32 x (taken
// from x before any rounding, as JAX's _xsum32_t does):
//   y[b,o] = sum_sub scale[sub,o] * (sum_{k in sub} x[b,k] q[k,o])   (f32 dot per sub-block)
//          - sum_sub xsum[b,sub] * minv[sub,o]
// where q[k,o] is the low nibble of qs[k,o] for k < K/2 and the high nibble
// of qs[k-K/2,o] otherwise (the paired layout of quant/gguf_linear.pack_q4k).
// The scale multiplies each 32-element sub-block's f32 dot on the
// accumulator, as the JAX kernel does (:107-116); a nibble is exact in bf16,
// so the tensor cores see x and q unrounded.
//
// Layouts (row-major): x [B,K] bf16, qs [K/2,O] u8, scale/minv [K/32,O] bf16,
// out [B,O] bf16 or f32; in the workspace (common.cuh carve) xsum
// [K/32][bpad] f32, part [ksplit,B,O] f32.
//
// What bounds it on an H100: at decode the weight stream, 0.625 bytes a
// weight (qs + two bf16 planes per 32), against 3.35 TB/s; at 256 rows, the
// bf16 tensor-core operations.
// Design for that (K1's staging, csrc/q4k_q8_gemv.cu, with K4's bf16 MMA):
// - a block owns 128 output columns and one (B <= 16) or four 16-row tiles
//   of x; one K step is one "sub-block pair": byte rows 32p..32p+31 of qs,
//   whose low nibbles are sub-block p and high nibbles sub-block K/64+p, 4
//   KB for 128 columns, with the pair's scale and minv rows, both
//   sub-blocks' 32 x values of each row and their sums, staged with 16-byte
//   cp.async loads in a 3-deep ring in dynamic shared memory;
// - each warp turns its 32 columns of the staged bytes into mma B fragments
//   with K1's 4x4 byte transposes, masks the low or high nibbles out of the
//   same words and converts them to bf16 (exact), and runs two bf16
//   mma.m16n8k16 per sub-block and n-tile into fresh f32 fragments, which
//   the sub-block's scale multiplies onto the accumulators; the min term
//   is two f32 FMAs a pair on the accumulators;
// - the K axis is split over blockIdx.y; common.cuh's pass adds the
//   partials in a fixed order. The sums come from common.cuh's quantize
//   kernel in its sums-only mode, in the same C call.
// Not done yet (later work): TMA/wgmma, fusing the split-K pass, nibble to
// bf16 without the f32 detour.
#include "plane_gemv.cuh"

namespace {

constexpr int kStages = 3;

template <int RT>
struct Q4kStage {
  static constexpr int kXStride = 128 + 32;  // bytes per staged x row (128 used)
  uint8_t q[32 * mrt::kGemvCols];            // one pair's byte rows, swizzled
  __nv_bfloat16 sc[4][mrt::kGemvCols];       // scale lo, scale hi, minv lo, minv hi
  float xm[2][16 * RT];                      // xsum of sub-blocks lo and hi for the rows
  uint8_t x[16 * RT * kXStride];             // each row: 32 bf16 of sub-block p, 32 of K/64+p
};

template <int RT>
__global__ void __launch_bounds__(mrt::kGemvThreads)
    q4k_bf16_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ xsum,
                        const uint8_t* __restrict__ qs, const __nv_bfloat16* __restrict__ scale,
                        const __nv_bfloat16* __restrict__ minv, float* __restrict__ part, int B,
                        int bpad, int K, int O, int pairs_per_split) {
  using Stage = Q4kStage<RT>;
  constexpr int kXS = Stage::kXStride;
  extern __shared__ __align__(16) uint8_t smem_q4k[];
  Stage* st = reinterpret_cast<Stage*>(smem_q4k);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * mrt::kGemvCols;
  const int row0 = blockIdx.z * 16 * RT;
  const int npairs = K / 64;
  const int p_begin = blockIdx.y * pairs_per_split;
  const int n = max(0, min(pairs_per_split, npairs - p_begin));

  auto load = [&](int s, int p) {
    Stage& S = st[s];
    mrt::stage_bytes(S.q, qs, 32 * p, 32, col0, O);
    // scale lo/hi, minv lo/hi: 4 rows of 128 bf16 = 64 chunks of 16 bytes
    for (int c = threadIdx.x; c < 64; c += mrt::kGemvThreads) {
      const int a = c >> 4, ch = c & 15;
      const __nv_bfloat16* base = a < 2 ? scale : minv;
      const int row = (a & 1) ? npairs + p : p;
      const bool ok = col0 + 8 * ch < O;
      mrt::cp_async16(&S.sc[a][8 * ch], ok ? base + (size_t)row * O + col0 + 8 * ch : base, ok);
    }
    // x: 16 RT rows x 8 chunks of 8 bf16 (4 of sub-block p, 4 of K/64+p),
    // zero past B
    for (int c = threadIdx.x; c < 16 * RT * 8; c += mrt::kGemvThreads) {
      const int r = c >> 3, ch = c & 7;
      const bool ok = row0 + r < B;
      const int col = (ch < 4 ? 32 * p : K / 2 + 32 * p) + 8 * (ch & 3);
      mrt::cp_async16(S.x + r * kXS + 16 * ch, ok ? x + (size_t)(row0 + r) * K + col : x, ok);
    }
    // xsum of the two sub-blocks: 2 x RT row tiles x 4 chunks; row tiles
    // past bpad are zero-filled
    for (int c = threadIdx.x; c < 2 * RT * 4; c += mrt::kGemvThreads) {
      const int a = c / (4 * RT), rt = (c >> 2) % RT, ch = c & 3;
      const int r = row0 + 16 * rt;
      const bool ok = r < bpad;
      const float* src = xsum + (size_t)(a ? npairs + p : p) * bpad + r + 4 * ch;
      mrt::cp_async16(&S.xm[a][16 * rt + 4 * ch], ok ? src : xsum, ok);
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
    if (s < n) load(s, p_begin + s);
    mrt::cp_async_commit();
  }
  const int cb = warp * 32 + 8 * t;  // C columns of n-tile jj: cb + jj and cb + 4 + jj
  for (int i = 0; i < n; ++i) {
    mrt::cp_async_wait<kStages - 2>();
    __syncthreads();
    const Stage& S = st[i % kStages];
    uint32_t p0[4], p1[4];  // byte rows 4t.. and 16+4t.. of the pair, 4 n-tiles
    mrt::b_frags(S.q, 0, warp, lane, p0, p1);
#pragma unroll
    for (int sb = 0; sb < 2; ++sb) {  // sub-block p (low nibbles), K/64+p (high)
      uint32_t b[4][2][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        mrt::code_b<false>((p0[jj] >> (4 * sb)) & 0x0F0F0F0Fu, 1.f, b[jj][0][0], b[jj][0][1]);
        mrt::code_b<false>((p1[jj] >> (4 * sb)) & 0x0F0F0F0Fu, 1.f, b[jj][1][0], b[jj][1][1]);
      }
      float s0[4], s1[4];  // the sub-block's scale at the C columns
      mrt::lds4(&S.sc[sb][cb], s0);
      mrt::lds4(&S.sc[sb][cb + 4], s1);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        if (row0 + 16 * rt >= B) break;  // the same for the whole block
        float d[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[jj][e] = 0.f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          // A: rows g and g+8 of the tile, x elements 4t..4t+3 of the half
          const uint8_t* xr = S.x + (16 * rt + g) * kXS + 64 * sb + 32 * hf + 8 * t;
          const uint2 u0 = *reinterpret_cast<const uint2*>(xr);
          const uint2 u1 = *reinterpret_cast<const uint2*>(xr + 8 * kXS);
          const uint32_t a[4] = {u0.x, u1.x, u0.y, u1.y};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mrt::mma_bf16(d[jj], a, b[jj][hf][0], b[jj][hf][1]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[rt][jj][0] += d[jj][0] * s0[jj];
          acc[rt][jj][1] += d[jj][1] * s1[jj];
          acc[rt][jj][2] += d[jj][2] * s0[jj];
          acc[rt][jj][3] += d[jj][3] * s1[jj];
        }
      }
    }
    // the min term over the original x's sums
    float ml0[4], ml1[4], mh0[4], mh1[4];
    mrt::lds4(&S.sc[2][cb], ml0);
    mrt::lds4(&S.sc[2][cb + 4], ml1);
    mrt::lds4(&S.sc[3][cb], mh0);
    mrt::lds4(&S.sc[3][cb + 4], mh1);
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      if (row0 + 16 * rt >= B) break;
      const float xl0 = S.xm[0][16 * rt + g], xl1 = S.xm[0][16 * rt + g + 8];
      const float xh0 = S.xm[1][16 * rt + g], xh1 = S.xm[1][16 * rt + g + 8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        acc[rt][jj][0] -= xl0 * ml0[jj] + xh0 * mh0[jj];
        acc[rt][jj][1] -= xl0 * ml1[jj] + xh0 * mh1[jj];
        acc[rt][jj][2] -= xl1 * ml0[jj] + xh1 * mh0[jj];
        acc[rt][jj][3] -= xl1 * ml1[jj] + xh1 * mh1[jj];
      }
    }
    const int next = i + kStages - 1;  // refill the stage read in the previous step
    if (next < n) load(next % kStages, p_begin + next);
    mrt::cp_async_commit();
  }
  mrt::cp_async_wait<0>();
  float* out = part + (size_t)blockIdx.y * B * O;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
    mrt::store_part(out, acc[rt], B, O, row0 + 16 * rt, col0, warp, lane);
}

template <int RT>
int launch_q4k_bf16(const __nv_bfloat16* x, const mrt::Workspace& w, const uint8_t* qs,
                    const __nv_bfloat16* scale, const __nv_bfloat16* minv, int B, int K, int O,
                    int ksplit, cudaStream_t st) {
  const int smem = kStages * (int)sizeof(Q4kStage<RT>);
  const cudaError_t err = mrt::allow_smem(q4k_bf16_mma_kernel<RT>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = 16 * RT;
  const int npairs = K / 64;
  const dim3 grid((O + mrt::kGemvCols - 1) / mrt::kGemvCols, ksplit, (B + rows - 1) / rows);
  q4k_bf16_mma_kernel<RT><<<grid, mrt::kGemvThreads, smem, st>>>(
      x, w.xsum, qs, scale, minv, w.part, B, w.bpad, K, O, (npairs + ksplit - 1) / ksplit);
  return 0;
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): K % 64 ==
// 0, O % 16 == 0, 16-byte aligned pointers, ksplit <= K / 64, and a
// workspace of ws_bytes (see mrt::carve). Takes x's per-32 sums (the
// quantize kernel's sums-only mode), then runs the GEMV (one 16-row tile a
// block up to B = 16, four above; ops/quant_matmul.py sizes ksplit by the
// same rule) and the split-K pass. Returns the CUDA error code of the
// launches (0 = launched).
extern "C" int q4k_bf16_gemv(const void* x, const void* qs, const void* scale, const void* minv,
                             void* ws, long long ws_bytes, void* out, int out_is_bf16, int B,
                             int K, int O, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mrt::Workspace w = mrt::carve(ws, B, K, O, 0, 32, ksplit);
  if (w.bytes > (size_t)ws_bytes) return (int)cudaErrorInvalidValue;
  mrt::launch_quantize<32>(x, true, nullptr, nullptr, w.xsum, nullptr, B, K, w.bpad, st);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const uint8_t*>(qs);
  const auto* sb = static_cast<const __nv_bfloat16*>(scale);
  const auto* mb = static_cast<const __nv_bfloat16*>(minv);
  const int err = B <= 16 ? launch_q4k_bf16<1>(xb, w, qb, sb, mb, B, K, O, ksplit, st)
                          : launch_q4k_bf16<4>(xb, w, qb, sb, mb, B, K, O, ksplit, st);
  if (err != 0) return err;
  return mrt::finish_gemv(w, out, out_is_bf16, ksplit, B * O, st);
}
