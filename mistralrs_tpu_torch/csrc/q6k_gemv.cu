// K3 and K4: Q6_K weights in the chunked layout, for decode- and
// prefill-chunk-sized row counts; and the Q6_K dequantization of the
// prefill route.
//
// Replaces the TPU kernels mistralrs_tpu/ops/quant_matmul.py::_q6k_q8_kernel
// (K3, launched by _q6k_q8_matmul_padded / _q6k_q8_matmul_stacked) and
// ::_q6k_kernel (K4, launched by _q6k_matmul_padded / _q6k_matmul_stacked).
//
// The layout (quant/gguf_linear.pack_q6k), with chunk span G and K/4 = Kq:
// element j*Kq + c*G + t (span j of 4, chunk c, 0 <= t < G) has its low
// nibble in ql row 2Gc + (j&1)*G + t (low half for j < 2, high half for j
// >= 2), its two high bits at bits 2j of qh row Gc + t, and its per-16
// scale in scale row c*G/4 + j*G/16 + t/16. w = s16 * (q - 32), q in 0..63.
//
// K3 computes, for x quantized per 32 (xq, xs) and the per-16 sums of the
// ORIGINAL x (xsum16; the quantize kernel of common.cuh makes all three):
//   y[b,o] = sum_blk xs[b,blk] * sum_{16 in blk} s16[o] * (sum xq[b,k] q[k,o])
//          - 32 * sum_16 xsum16[b,.] * s16[.,o]
// (the -32 term over the unquantized x, as the JAX kernel computes it).
// K4 computes y = x @ bf16(q * s16) with f32 accumulation, minus the same
// -32 term in f32, as `_q6k_kernel` does for bf16 activations; up to 16
// rows in its 16-row instantiation (below), at 17-256 rows in its rows
// instantiation, csrc/plane_gemv.cuh's plane_rows_kernel with Q6kFmt (TMA, a
// producer warpgroup that decodes each stage once, bf16 wgmma, the -32 term
// on the tensor cores; its design is written there).
//
// Layouts (row-major): x [B,K] in element order (K3: bf16 or f32; K4:
// bf16), ql [K/2,O] u8, qh [K/4,O] u8, scale [K/16,O] bf16, out [B,O] bf16
// or f32; in the workspace (common.cuh carve) xq [B,K] int8, xs
// [K/32][bpad], xsum16 [K/16][bpad], part [ksplit,B,O] f32 (K4's rows
// instantiation: xsum16 and x's step-ordered copy xc [bpad,K] bf16, tiled
// to the row tile, and the partials only with more than one split).
//
// What bounds them on an H100: at decode the weight stream, 0.875 bytes per
// weight (ql 0.5, qh 0.25, a bf16 scale per 16), against 3.35 TB/s; K4 at
// 256 rows is bound by its bf16 tensor-core operations.
// Design of K3 and K4's 16-row instantiation:
// - one K step is 32 consecutive t of one chunk for all four spans: 32 rows
//   of each ql half, 32 rows of qh, 8 scale rows and four 32-element slices
//   of x at j*Kq + c*G + t0, so every weight byte is read once, in 16-byte
//   cp.async copies, and x is read in element order (no permutation
//   gather); a 3-deep ring of steps in dynamic shared memory;
// - a warp turns its 32 columns of the staged bytes into mma B fragments
//   with K1's 4x4 byte transposes; each span's 6-bit codes are built from
//   the ql and qh words with masks and shifts, four codes a register;
// - K3 runs mma.m16n8k16 on int8 (exact int32 per-16 dots, so the per-16
//   scales apply to exact integers), 8 per n-tile a step; K4 rounds q*s16
//   to bf16 per element and runs mma.m16n8k16 on bf16 for up to 4 row tiles
//   of x (64 rows) that share each staged weight tile;
// - the K axis is split over blockIdx.y; the partials are added in a fixed
//   order by common.cuh's split-K pass.
// Not done yet in them (later work): TMA/wgmma, fusing the split-K pass.
#include "plane_gemv.cuh"

namespace {

constexpr int kStages = 3;

// one K step's weights: 32 rows of ql (spans 0|2), 32 of ql (spans 1|3), 32
// of qh, swizzled as common.cuh's tiles; 8 scale rows (span j, half h at
// row 2j + h)
struct WeightStage {
  uint8_t ql02[32 * mrt::kGemvCols];
  uint8_t ql13[32 * mrt::kGemvCols];
  uint8_t qh[32 * mrt::kGemvCols];
  __nv_bfloat16 sc[8][mrt::kGemvCols];
};

// Stage step i (chunk c = i / (G/32), t0 = 32 * (i % (G/32))) of the weights.
__device__ __forceinline__ void load_weights(WeightStage& W, const uint8_t* ql, const uint8_t* qh,
                                             const __nv_bfloat16* scale, int i, int G, int col0,
                                             int O) {
  const int c = i / (G / 32), t0 = 32 * (i % (G / 32));
  mrt::stage_bytes(W.ql02, ql, 2 * G * c + t0, 32, col0, O);
  mrt::stage_bytes(W.ql13, ql, 2 * G * c + G + t0, 32, col0, O);
  mrt::stage_bytes(W.qh, qh, G * c + t0, 32, col0, O);
  // 8 rows of 128 bf16 = 128 chunks of 16 bytes, one a thread
  const int a = threadIdx.x >> 4, ch = threadIdx.x & 15;
  const int row = c * (G / 4) + (a >> 1) * (G / 16) + t0 / 16 + (a & 1);
  const bool ok = col0 + 8 * ch < O;
  mrt::cp_async16(&W.sc[a][8 * ch], ok ? scale + (size_t)row * O + col0 + 8 * ch : scale, ok);
}

// ------------------------------------------------------------------ K3

constexpr int kXStride3 = 144;  // bytes per staged x row (128 used; 144 spreads the banks)

struct Stage3 {
  WeightStage w;
  int8_t x[16 * kXStride3];  // x's 16 rows: 32 codes of each span
  float xv[12][16];          // xs of spans 0..3, then xsum16 of (span, half) 0..7
};

__global__ void __launch_bounds__(mrt::kGemvThreads)
    q6k_q8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                      const float* __restrict__ xsum16, const uint8_t* __restrict__ ql,
                      const uint8_t* __restrict__ qh, const __nv_bfloat16* __restrict__ scale,
                      float* __restrict__ part, int B, int bpad, int K, int O, int G,
                      int steps_per_split) {
  extern __shared__ __align__(16) uint8_t smem3[];
  Stage3* st = reinterpret_cast<Stage3*>(smem3);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * mrt::kGemvCols;
  const int row0 = blockIdx.z * 16;
  const int Kq = K / 4;
  const int nsteps = K / 128;
  const int i_begin = blockIdx.y * steps_per_split;
  const int n = max(0, min(steps_per_split, nsteps - i_begin));

  auto load = [&](int s, int i) {
    load_weights(st[s].w, ql, qh, scale, i, G, col0, O);
    const int e0 = (i / (G / 32)) * G + 32 * (i % (G / 32));  // element offset in a span
    // x: 2 chunks of 16 codes per span and row (all 128 threads)
    mrt::stage_x(st[s].x, kXStride3, xq, B, K, row0, 8, 0,
                 [&](int ch) { return (ch >> 1) * Kq + e0 + 16 * (ch & 1); });
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mrt::stage_rows16(st[s].xv[j], xs + (size_t)((j * Kq + e0) / 32) * bpad + row0, 4 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mrt::stage_rows16(st[s].xv[4 + 2 * j + h],
                          xsum16 + (size_t)((j * Kq + e0) / 16 + h) * bpad + row0,
                          16 + 8 * j + 4 * h);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s, i_begin + s);
    mrt::cp_async_commit();
  }
  const int cb = warp * 32 + 8 * t;  // C columns of n-tile jj: cb + jj and cb + 4 + jj
  for (int i = 0; i < n; ++i) {
    mrt::cp_async_wait<kStages - 2>();
    __syncthreads();
    const Stage3& S = st[i % kStages];
    uint32_t p0[4], p1[4], r0[4], r1[4], h0[4], h1[4];
    mrt::b_frags(S.w.ql02, 0, warp, lane, p0, p1);
    mrt::b_frags(S.w.ql13, 0, warp, lane, r0, r1);
    mrt::b_frags(S.w.qh, 0, warp, lane, h0, h1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t a[4];
      mrt::a_frag(S.x, kXStride3, 32 * j, lane, a);
      // scales of (span j, half 0 / 1) at the C columns of each n-tile
      float sa0[4], sa1[4], sb0[4], sb1[4];
      mrt::lds4(&S.w.sc[2 * j][cb], sa0);
      mrt::lds4(&S.w.sc[2 * j][cb + 4], sa1);
      mrt::lds4(&S.w.sc[2 * j + 1][cb], sb0);
      mrt::lds4(&S.w.sc[2 * j + 1][cb + 4], sb1);
      // rows past B have zero codes and are never stored
      const float x0 = S.xv[j][g], x1 = S.xv[j][g + 8];
      const float ma0 = S.xv[4 + 2 * j][g], ma1 = S.xv[4 + 2 * j][g + 8];
      const float mb0 = S.xv[5 + 2 * j][g], mb1 = S.xv[5 + 2 * j][g + 8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const uint32_t w0 = mrt::q6_codes(j, p0[jj], r0[jj], h0[jj]);  // K rows 4t.. of the step
        const uint32_t w1 = mrt::q6_codes(j, p1[jj], r1[jj], h1[jj]);  // K rows 16+4t..
        int dl[4] = {0, 0, 0, 0}, dh[4] = {0, 0, 0, 0};
        mrt::mma_s8_k16(dl, a[0], a[1], w0);  // elements t0..t0+15 of span j
        mrt::mma_s8_k16(dh, a[2], a[3], w1);  // t0+16..t0+31
        acc[jj][0] += x0 * ((float)dl[0] * sa0[jj] + (float)dh[0] * sb0[jj]) -
                      32.f * (ma0 * sa0[jj] + mb0 * sb0[jj]);
        acc[jj][1] += x0 * ((float)dl[1] * sa1[jj] + (float)dh[1] * sb1[jj]) -
                      32.f * (ma0 * sa1[jj] + mb0 * sb1[jj]);
        acc[jj][2] += x1 * ((float)dl[2] * sa0[jj] + (float)dh[2] * sb0[jj]) -
                      32.f * (ma1 * sa0[jj] + mb1 * sb0[jj]);
        acc[jj][3] += x1 * ((float)dl[3] * sa1[jj] + (float)dh[3] * sb1[jj]) -
                      32.f * (ma1 * sa1[jj] + mb1 * sb1[jj]);
      }
    }
    const int next = i + kStages - 1;  // refill the stage read in the previous step
    if (next < n) load(next % kStages, i_begin + next);
    mrt::cp_async_commit();
  }
  mrt::cp_async_wait<0>();
  mrt::store_part(part + (size_t)blockIdx.y * B * O, acc, B, O, row0, col0, warp, lane);
}

// ------------------------------------------------------------------ K4

constexpr int kRowTiles = 4;            // 64 rows of x share a staged weight tile
constexpr int kXStride4 = 256 + 32;     // bytes per staged bf16 x row (256 used)

struct Stage4 {
  WeightStage w;
  uint8_t x[16 * kRowTiles * kXStride4];  // 64 rows x 4 spans x 32 bf16
  float xm[8][16 * kRowTiles];            // xsum16 of (span, half) for the 64 rows
};

__global__ void __launch_bounds__(mrt::kGemvThreads)
    q6k_bf16_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ xsum16,
                        const uint8_t* __restrict__ ql, const uint8_t* __restrict__ qh,
                        const __nv_bfloat16* __restrict__ scale, float* __restrict__ part,
                        int B, int bpad, int K, int O, int G, int steps_per_split) {
  extern __shared__ __align__(16) uint8_t smem4[];
  Stage4* st = reinterpret_cast<Stage4*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * mrt::kGemvCols;
  const int row0 = blockIdx.z * 16 * kRowTiles;
  const int Kq = K / 4;
  const int nsteps = K / 128;
  const int i_begin = blockIdx.y * steps_per_split;
  const int n = max(0, min(steps_per_split, nsteps - i_begin));

  auto load = [&](int s, int i) {
    load_weights(st[s].w, ql, qh, scale, i, G, col0, O);
    const int e0 = (i / (G / 32)) * G + 32 * (i % (G / 32));
    // x: 64 rows x 16 chunks (4 spans x 64 bytes), zero past B
    for (int q = threadIdx.x; q < 16 * kRowTiles * 16; q += mrt::kGemvThreads) {
      const int r = q >> 4, ch = q & 15;
      const bool ok = row0 + r < B;
      const __nv_bfloat16* src = x + (size_t)(row0 + r) * K + (ch >> 2) * Kq + e0 + 8 * (ch & 3);
      mrt::cp_async16(st[s].x + r * kXStride4 + 16 * ch, ok ? src : x, ok);
    }
    // xsum16: 8 (span, half) x 4 row tiles x 4 chunks = 128, one a thread;
    // row tiles past bpad are zero-filled
    const int a = threadIdx.x >> 4, rt = (threadIdx.x >> 2) & 3, ch = threadIdx.x & 3;
    const int r = row0 + 16 * rt;
    const bool ok = r < bpad;
    const float* src = xsum16 + (size_t)((( a >> 1) * Kq + e0) / 16 + (a & 1)) * bpad + r + 4 * ch;
    mrt::cp_async16(&st[s].xm[a][16 * rt + 4 * ch], ok ? src : xsum16, ok);
  };

  float acc[kRowTiles][4][4];
#pragma unroll
  for (int rt = 0; rt < kRowTiles; ++rt)
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
    const Stage4& S = st[i % kStages];
    uint32_t p0[4], p1[4], r0[4], r1[4], h0[4], h1[4];
    mrt::b_frags(S.w.ql02, 0, warp, lane, p0, p1);
    mrt::b_frags(S.w.ql13, 0, warp, lane, r0, r1);
    mrt::b_frags(S.w.qh, 0, warp, lane, h0, h1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // the weight fragments of span j: bf16(q * s16) for 4 n-tiles x 2 halves
      float bs0[4], bs1[4];
      mrt::lds4(&S.w.sc[2 * j][bc], bs0);
      mrt::lds4(&S.w.sc[2 * j + 1][bc], bs1);
      uint32_t b[4][2][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const uint32_t w0 = mrt::q6_codes(j, p0[jj], r0[jj], h0[jj]);  // K rows 4t.. of the step
        const uint32_t w1 = mrt::q6_codes(j, p1[jj], r1[jj], h1[jj]);  // K rows 16+4t..
        mrt::code_b<false>(w0, bs0[jj], b[jj][0][0], b[jj][0][1]);
        mrt::code_b<false>(w1, bs1[jj], b[jj][1][0], b[jj][1][1]);
      }
      // the -32 term's scales at the C columns
      float sa0[4], sa1[4], sb0[4], sb1[4];
      mrt::lds4(&S.w.sc[2 * j][cb], sa0);
      mrt::lds4(&S.w.sc[2 * j][cb + 4], sa1);
      mrt::lds4(&S.w.sc[2 * j + 1][cb], sb0);
      mrt::lds4(&S.w.sc[2 * j + 1][cb + 4], sb1);
#pragma unroll
      for (int rt = 0; rt < kRowTiles; ++rt) {
        if (row0 + 16 * rt >= B) break;  // the same for the whole block
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          // A: rows g and g+8 of the tile, x elements 4t..4t+3 of the half
          const uint8_t* xr = S.x + (16 * rt + g) * kXStride4 + 64 * j + 32 * hf + 8 * t;
          const uint2 u0 = *reinterpret_cast<const uint2*>(xr);
          const uint2 u1 = *reinterpret_cast<const uint2*>(xr + 8 * kXStride4);
          const uint32_t a[4] = {u0.x, u1.x, u0.y, u1.y};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mrt::mma_bf16(acc[rt][jj], a, b[jj][hf][0], b[jj][hf][1]);
        }
        const float ma0 = S.xm[2 * j][16 * rt + g], ma1 = S.xm[2 * j][16 * rt + g + 8];
        const float mb0 = S.xm[2 * j + 1][16 * rt + g], mb1 = S.xm[2 * j + 1][16 * rt + g + 8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[rt][jj][0] -= 32.f * (ma0 * sa0[jj] + mb0 * sb0[jj]);
          acc[rt][jj][1] -= 32.f * (ma0 * sa1[jj] + mb0 * sb1[jj]);
          acc[rt][jj][2] -= 32.f * (ma1 * sa0[jj] + mb1 * sb0[jj]);
          acc[rt][jj][3] -= 32.f * (ma1 * sa1[jj] + mb1 * sb1[jj]);
        }
      }
    }
    const int next = i + kStages - 1;
    if (next < n) load(next % kStages, i_begin + next);
    mrt::cp_async_commit();
  }
  mrt::cp_async_wait<0>();
  float* p = part + (size_t)blockIdx.y * B * O;
#pragma unroll
  for (int rt = 0; rt < kRowTiles; ++rt)
    mrt::store_part(p, acc[rt], B, O, row0 + 16 * rt, col0, warp, lane);
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): G % 32 ==
// 0, K % 4G == 0, O % 16 == 0, 16-byte aligned pointers, ksplit <= K/128,
// and a workspace of ws_bytes (see mrt::carve). Returns the CUDA error code
// of the launches (0 = launched).
extern "C" int q6k_q8_gemv(const void* x, int x_is_bf16, const void* ql, const void* qh,
                           const void* scale, int G, void* ws, long long ws_bytes, void* out,
                           int out_is_bf16, int B, int K, int O, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mrt::Workspace w = mrt::carve(ws, B, K, O, 32, 16, ksplit);
  if (w.bytes > (size_t)ws_bytes) return (int)cudaErrorInvalidValue;
  const int smem = kStages * (int)sizeof(Stage3);
  const cudaError_t err = mrt::allow_smem(q6k_q8_mma_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  mrt::launch_quantize<32>(x, x_is_bf16 != 0, w.xq, w.xs, nullptr, w.xsum, B, K, w.bpad, st);
  const dim3 grid((O + mrt::kGemvCols - 1) / mrt::kGemvCols, ksplit, (B + 15) / 16);
  q6k_q8_mma_kernel<<<grid, mrt::kGemvThreads, smem, st>>>(
      w.xq, w.xs, w.xsum, static_cast<const uint8_t*>(ql), static_cast<const uint8_t*>(qh),
      static_cast<const __nv_bfloat16*>(scale), w.part, B, w.bpad, K, O, G,
      (K / 128 + ksplit - 1) / ksplit);
  return mrt::finish_gemv(w, out, out_is_bf16, ksplit, B * O, st);
}

// As q6k_q8_gemv, for bf16 x kept in bf16 (K4). The launch is the plan of
// ops/quant_matmul.q6k_bf16_plan, every field of it checked here:
// - rows 16 (B <= 16): q6k_bf16_mma_kernel, grid (column tiles, K splits,
//   1), cluster 1, cols 128, stages 0, at most K/128 splits; the quantize
//   kernel's per-16 sums, the GEMV, the split-K pass (the workspace holds
//   xsum16 and the partials);
// - rows 64 or 128: plane_rows_kernel with Q6kFmt, grid (row tiles, column
//   tiles, K splits), cluster 1, cols 128, its ring's stages, a span G that
//   is a power of two and a multiple of 128, at most one split per slice
//   of 128 r; plane_prep_kernel (per-16 sums and x in step order; the
//   workspace tiled to the row tile), the GEMV and, with more than one
//   split, the split-K pass.
extern "C" int q6k_bf16_gemv(const void* x, const void* ql, const void* qh, const void* scale,
                             int G, void* ws, long long ws_bytes, void* out, int out_is_bf16,
                             int B, int K, int O, int rows, int gx, int gy, int gz, int cluster,
                             int cols, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows != 16 && rows != 64 && rows != 128) return (int)cudaErrorInvalidValue;
  const bool dec = rows == 16;
  const int ksplit = dec ? gy : gz;
  const mrt::Workspace w = dec ? mrt::carve(ws, B, K, O, 0, 16, ksplit)
                               : mrt::carve(ws, B, K, O, 0, 16, ksplit, mrt::kTiled, rows, true);
  const bool grid_ok =
      dec ? B <= 16 && gx == (O + mrt::kGemvCols - 1) / mrt::kGemvCols && gz == 1 &&
                stages == 0 && ksplit <= K / 128
          : mrt::grid_covers(w, rows, cols, B, O, gx, gy, gz) && G >= 128 && G % 128 == 0 &&
                (G & (G - 1)) == 0 && K % (4 * G) == 0 && gz <= K / 512;
  if (!grid_ok || cluster != 1 || cols != mrt::kGemvCols || w.bytes > (size_t)ws_bytes ||
      ksplit < 1)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* lb = static_cast<const uint8_t*>(ql);
  const auto* hb = static_cast<const uint8_t*>(qh);
  const auto* sb = static_cast<const __nv_bfloat16*>(scale);
  if (!dec)  // qh as the 2-bit planes, group 16, zs = the scale itself
    return mrt::plane_rows_call<mrt::Q6kFmt>(xb, w, out, out_is_bf16, B, K, O, 16, rows,
                                             dim3(gx, gy, gz), stages, st, hb, lb, sb, G);
  const int smem = kStages * (int)sizeof(Stage4);
  const cudaError_t err = mrt::allow_smem(q6k_bf16_mma_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  mrt::launch_quantize<32>(x, true, nullptr, nullptr, nullptr, w.xsum, B, K, w.bpad, st);
  q6k_bf16_mma_kernel<<<dim3(gx, ksplit, 1), mrt::kGemvThreads, smem, st>>>(
      xb, w.xsum, lb, hb, sb, w.part, B, w.bpad, K, O, G, (K / 128 + ksplit - 1) / ksplit);
  return mrt::finish_gemv(w, out, out_is_bf16, ksplit, B * O, st);
}

// ---- dequantization for prefill-sized calls ----
//
// The pass XLA fuses in the JAX package's dequant_q6k_weights, written in
// element order (no inverse-permutation gather): w[k, o] = (q - 32) * s16,
// one f32 multiply, rounded to bf16 (the prefill route) or kept in f32 (the
// load-time requant to int8), as the plain version's ops round. Bound: bytes
// (0.875 read + 2 or 4 written per weight). A thread owns 8 neighbouring
// columns of one element row k.
namespace {

template <typename OutT>
__global__ void q6k_dequant_kernel(const uint8_t* __restrict__ ql, const uint8_t* __restrict__ qh,
                                   const __nv_bfloat16* __restrict__ scale, OutT* __restrict__ w,
                                   int G, int K, int O) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per_row = O / 8;
  if (i >= (long long)K * per_row) return;
  const int k = (int)(i / per_row), c8 = (int)(i % per_row) * 8;
  const int Kq = K / 4, j = k / Kq, rem = k % Kq, c = rem / G, t = rem % G;
  const uint2 lv = __ldg(reinterpret_cast<const uint2*>(ql + (size_t)(2 * G * c + (j & 1) * G + t) * O + c8));
  const uint2 hv = __ldg(reinterpret_cast<const uint2*>(qh + (size_t)(G * c + t) * O + c8));
  const uint4 sv = __ldg(reinterpret_cast<const uint4*>(
      scale + (size_t)(c * (G / 4) + j * (G / 16) + t / 16) * O + c8));
  const uint8_t* lb = reinterpret_cast<const uint8_t*>(&lv);
  const uint8_t* hb = reinterpret_cast<const uint8_t*>(&hv);
  const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int q = ((lb[e] >> (4 * (j >> 1))) & 0xF) | (((hb[e] >> (2 * j)) & 3) << 4);
    const float s = (e & 1) ? mrt::bf16_hi(sw[e >> 1]) : mrt::bf16_lo(sw[e >> 1]);
    v[e] = (float)(q - 32) * s;
  }
  OutT* dst = w + (size_t)k * O + c8;
  if constexpr (sizeof(OutT) == 2) {
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = mrt::bf16x2(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

}  // namespace

// ql [K/2, O], qh [K/4, O] u8, scale [K/16, O] bf16 -> w [K, O] bf16 or f32
// in element order. G % 16 == 0, K % 4G == 0, O % 8 == 0, 16-byte aligned
// pointers (checked by ops/quant_matmul.py).
extern "C" int q6k_dequant(const void* ql, const void* qh, const void* scale, void* w,
                           int out_is_bf16, int G, int K, int O, void* stream) {
  const long long n = (long long)K * (O / 8);
  const unsigned grid = (unsigned)((n + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* l = static_cast<const uint8_t*>(ql);
  const uint8_t* h = static_cast<const uint8_t*>(qh);
  const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(scale);
  if (out_is_bf16)
    q6k_dequant_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        l, h, s, static_cast<__nv_bfloat16*>(w), G, K, O);
  else
    q6k_dequant_kernel<float><<<grid, 256, 0, st>>>(l, h, s, static_cast<float*>(w), G, K, O);
  return (int)cudaGetLastError();
}
