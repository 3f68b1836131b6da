// K3 and K4: Q6_K weights in the chunked layout, for decode- and
// prefill-chunk-sized row counts; and the Q6_K dequantization of the
// prefill route.
//
// Replaces the TPU kernels mistralrs_tpu/ops/quant_matmul.py::_q6k_q8_kernel
// (K3, launched by _q6k_q8_matmul_padded / _q6k_q8_matmul_stacked; the JAX
// package routes it at up to 16 rows only) and ::_q6k_kernel (K4, launched
// by _q6k_matmul_padded / _q6k_matmul_stacked).
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
// (the -32 term over the unquantized x, as the JAX kernel computes it; the
// codes stay q, not q - 32, so the term never sees the quantized x).
// K4 computes y = x @ bf16(q * s16) with f32 accumulation, minus the same
// -32 term in f32, as `_q6k_kernel` does for bf16 activations.
//
// Layouts (row-major): x [B,K] in element order (K3: bf16 or f32; K4:
// bf16), ql [K/2,O] u8, qh [K/4,O] u8, scale [K/16,O] bf16, out [B,O] bf16
// or f32; K3's workspace (common.cuh carve, the decode layout) xq [16][K]
// in 512-byte slices of 32 elements, xs [K/32][16], xsum16 [K/16][16]; K4
// at 1-16 rows has none (at 17-256 rows: xsum16 and x's step-ordered copy
// xc [bpad,K] bf16, tiled to the row tile, and the partials only with more
// than one split).
//
// What bounds them on an H100: at decode (1-16 rows) the weight stream,
// 0.875 bytes a weight (ql 0.5, qh 0.25, a bf16 scale per 16), against
// 3.35 TB/s, and at 16 rows close behind it K3's scaling epilogue (issue
// slots); K4 at 256 rows its bf16 tensor-core operations.
//
// Design at 1-16 rows (q6k_q8_dec_kernel, q6k_bf16_dec_kernel), K1's and
// K2's decode design (common.cuh's decode section, whose pieces it uses):
// - a K step is 32 t of one chunk for all four spans (128 elements): 64
//   rows of ql (both halves), 32 of qh and 8 scale rows, 14 KB at C = 128
//   columns, already more than a K1 or K2 stage, so a ring stage is one
//   step and the ring holds dec_stages(14 KB) = 3 (5 of 7 KB at C = 64);
// - a block owns C = 128 or 64 columns and one K split; the splits of a
//   column tile are one cluster (<= 8) that adds its f32 tiles in
//   distributed shared memory in rank order (dec_store_tile, dec_reduce):
//   no partials in global memory and no split-K pass; one split writes out
//   itself (dec_store_out);
// - one producer warp brings a step's weights in three TMA boxes: ql seen
//   as [chunks][2][G][O] (both halves' 32 rows in one box), qh as [K/4][O],
//   the scale as [chunks][4][G/16][O] (the four spans' two rows in one box);
//   the 128-byte swizzle on the byte tiles at C = 128; at most half the
//   ring ahead of what has landed;
// - the other producer warp brings x after griddepcontrol.wait (both GEMVs
//   are launched by programmatic dependent launch, mrt::launch_dec): K3's
//   codes, scales and per-16 sums of the four span slices from the quantize
//   kernel's decode layout (12 bulk copies), so a K3 call is 2 launches;
//   K4's bf16 x by one TMA box of x seen as [B][4][Kq] (32 elements of the
//   four spans for 16 rows, rows past B zero-filled), no quantize kernel
//   and no workspace, so a K4 call is 1 launch;
// - C/32 consumer warps, each 32 columns; the weight is the mma's A operand
//   (an output column an A row, mrt::w_frags) and x the B operand (one
//   n-tile up to 8 rows, two up to 16); each span's 6-bit codes come from
//   the ql and qh words in registers (mrt::q6_codes), four a register;
// - K3: mma.m16n8k16 on s8 gives exact int32 per-16 dots, converted by
//   exact_f32 (|dot| <= 16*127*63 < 2^22); each 32-block's two dots times
//   their s16 are summed before the xs multiply (JAX's order), and the -32
//   term is two FMAs of -32 * xsum16 and s16 into the same sums;
// - K4: mma.m16n8k16 on bf16 with A = bf16(q * s16): a byte_perm makes the
//   codes' bf16 pairs 128 + q (bits 0x43qq), and one fma.rn.bf16x2
//   (128 + q) * s - 128 * s rounds the exact q * s once, the bits of the
//   plain version's bf16 product, two instructions a pair; the k order
//   inside an mma is free as long as A and B agree, so a lane's four K
//   rows 4t.. (one transposed word) are mma k 2t, 2t+1, 2t+8, 2t+9 and x's
//   B fragments are one 8-byte load; the -32 term is a second bf16 mma
//   into the same accumulators with A = -32 * s16 (exact in bf16) and the
//   x fragments already in registers (kept over per-16 sums of the staged
//   x and an FMA per row, column and group: those sums would cost every
//   consumer warp the adds over its 16 rows x 128 elements a step, and K4
//   has no quantize kernel to make them);
// - no per-call state: each block sets up its own barriers and nothing in
//   global memory needs zeroing, so a call replays in a CUDA graph.
//
// At 17-256 rows K4 runs csrc/plane_gemv.cuh's plane_rows_kernel with
// Q6kFmt (TMA, a producer warpgroup that decodes each stage once, bf16
// wgmma, the -32 term on the tensor cores; its design is written there).
#include "plane_gemv.cuh"

namespace {

// weight bytes of a K step at C columns: ql 64 rows, qh 32 rows, 8 scale
// rows of bf16
template <int C>
constexpr int kQ6DecWeightBytes = 112 * C;
template <int C>
constexpr int kQ6DecStages = mrt::dec_stages(kQ6DecWeightBytes<C>);
constexpr int kQ6DecSub = 1;  // K steps a ring stage holds

// x of a K step: K3's codes (span j's decode-layout slice), scales and
// per-16 sums of the 16 rows; K4's bf16 values [row][span][32]
template <bool BF16X>
struct Q6DecX {
  int8_t x[4][mrt::kDecRows * 32];
  float xs[4][mrt::kDecRows];
  float xm[4][2][mrt::kDecRows];
};
template <>
struct Q6DecX<true> {
  __nv_bfloat16 x[mrt::kDecRows][4][32];
};

template <int C, bool BF16X>
struct alignas(C == 128 ? 1024 : 128) Q6DecStage {
  uint8_t ql[2][32 * C];       // ql rows of spans 0|2, then 1|3 (one TMA box)
  uint8_t qh[32 * C];          // qh rows
  __nv_bfloat16 sc[4][2][C];   // scale rows of (span, 16-half) (one TMA box)
  Q6DecX<BF16X> xp;
};
template <int C, bool BF16X>
using Q6DecRing = mrt::DecRing<Q6DecStage<C, BF16X>, kQ6DecStages<C>, C / 32>;

// element offset in a span of step s (chunk s / (G/32), t0 = 32 * (s %
// (G/32))), and the step's chunk and t0
struct Q6Step {
  int c, t0;
  __device__ Q6Step(int s, int G) : c(s / (G / 32)), t0(32 * (s % (G / 32))) {}
  __device__ int e0(int G) const { return c * G + t0; }
};

// The weight fragments of one step in registers: p, r, h are the ql (spans
// 0|2), ql (1|3) and qh words of columns c..c+3, rows 4t.. ([0]) and 16+4t..
// ([1]) of the step.
struct Q6Words {
  uint32_t p[2][4], r[2][4], h[2][4];
  template <int C, typename Stage>
  __device__ void load(const Stage& S, int c, int t) {
    mrt::w_frags<C>(S.ql[0], 0, c, t, p[0], p[1]);
    mrt::w_frags<C>(S.ql[1], 0, c, t, r[0], r[1]);
    mrt::w_frags<C>(S.qh, 0, c, t, h[0], h[1]);
  }
  // span j's codes of column c+i, elements 16*hf + 4t.. of the step
  __device__ uint32_t codes(int j, int hf, int i) const {
    return mrt::q6_codes(j, p[hf][i], r[hf][i], h[hf][i]);
  }
};

// K3's consumer warp over n steps: y[nt][m][e] = the f32 sums of x row 8nt
// + 2t + e%2 and column 32 * warp + 4g + 2m + e/2 (NT n-tiles: 1 up to 8
// rows).
template <int C, int NT>
__device__ __forceinline__ void q6_q8_consume(const Q6DecRing<C, false>& ring, int n, int warp,
                                              int lane, float (&y)[2][2][4]) {
  const int g = lane >> 2, t = lane & 3, c = 32 * warp + 4 * g;
  float acc[NT * 8];  // index (nt * 2 + m) * 4 + e
#pragma unroll
  for (int i = 0; i < NT * 8; ++i) acc[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    const Q6DecStage<C, false>& S = ring[i];
    ring.acquire(i);
    Q6Words w;
    w.load<C>(S, c, t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float sa[4], sb[4];  // s16 of the span's two 16-halves at columns c..c+3
      mrt::lds4(&S.sc[j][0][c], sa);
      mrt::lds4(&S.sc[j][1][c], sb);
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        lo[k] = w.codes(j, 0, k);
        hi[k] = w.codes(j, 1, k);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t xb[2];
        mrt::x_frag(S.xp.x[j], 8 * nt + g, t, xb);
        const int r = 8 * nt + 2 * t;  // rows r and r + 1
        const float2 xs = *reinterpret_cast<const float2*>(&S.xp.xs[j][r]);
        const float2 ma = *reinterpret_cast<const float2*>(&S.xp.xm[j][0][r]);
        const float2 mb = *reinterpret_cast<const float2*>(&S.xp.xm[j][1][r]);
        const float na[2] = {-32.f * ma.x, -32.f * ma.y}, nb[2] = {-32.f * mb.x, -32.f * mb.y};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          int dl[4] = {0, 0, 0, 0}, dh[4] = {0, 0, 0, 0};
          mrt::mma_s8_k16(dl, lo[2 * m], lo[2 * m + 1], xb[0]);
          mrt::mma_s8_k16(dh, hi[2 * m], hi[2 * m + 1], xb[1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = (nt * 2 + m) * 4 + e, col = 2 * m + (e >> 1), b = e & 1;
            const float blk = fmaf(mrt::exact_f32(dh[e]), sb[col], mrt::exact_f32(dl[e]) * sa[col]);
            acc[k] = fmaf(blk, b ? xs.y : xs.x, acc[k]);
            acc[k] = fmaf(na[b], sa[col], acc[k]);
            acc[k] = fmaf(nb[b], sb[col], acc[k]);
          }
        }
      }
    }
    mrt::fence_values(acc);  // every read of the stage has landed in a register
    ring.release(i);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[nt][m][e] = acc[(nt * 2 + m) * 4 + e];
}

// K4's consumer warp, y as K3's.
template <int C, int NT>
__device__ __forceinline__ void q6_bf16_consume(const Q6DecRing<C, true>& ring, int n, int warp,
                                                int lane, float (&y)[2][2][4]) {
  constexpr uint32_t kNeg128 = 0xC300C300u, kNeg32 = 0xC200C200u, kNegZero = 0x80008000u;
  const int g = lane >> 2, t = lane & 3, c = 32 * warp + 4 * g;
  float acc[NT * 2][4];  // index nt * 2 + m
#pragma unroll
  for (int i = 0; i < NT * 2; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int i = 0; i < n; ++i) {
    const Q6DecStage<C, true>& S = ring[i];
    ring.acquire(i);
    Q6Words w;
    w.load<C>(S, c, t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        // column c+k's s16 in both halves of a word, -128 s16 and -32 s16
        // (exact in bf16)
        uint32_t sp[4], n128[4], n32[4];
        mrt::scale_pairs(&S.sc[j][hf][c], sp);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          n128[k] = mrt::fma_bf16x2(sp[k], kNeg128, kNegZero);
          n32[k] = mrt::fma_bf16x2(sp[k], kNeg32, kNegZero);
        }
        // A of column c+k: elements 4t, 4t+1 (mma k 2t, 2t+1) and 4t+2, 4t+3
        // (k 2t+8, 2t+9) as bf16(q * s16), the 6-bit codes under 0x43
        uint32_t wl[4], wh[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          mrt::dec_code_pairs<6, false>(w.codes(j, hf, k), sp[k], n128[k], 0u, wl[k], wh[k]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // B: x row 8nt + g, elements 16hf + 4t.. of span j
          const uint2 xv = *reinterpret_cast<const uint2*>(&S.xp.x[8 * nt + g][j][16 * hf + 4 * t]);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const uint32_t a[4] = {wl[2 * m], wl[2 * m + 1], wh[2 * m], wh[2 * m + 1]};
            const uint32_t z[4] = {n32[2 * m], n32[2 * m + 1], n32[2 * m], n32[2 * m + 1]};
            mrt::mma_bf16(acc[nt * 2 + m], a, xv.x, xv.y);
            mrt::mma_bf16(acc[nt * 2 + m], z, xv.x, xv.y);
          }
        }
      }
#pragma unroll
    for (int k = 0; k < NT * 2; ++k) mrt::fence_values(acc[k]);  // the stage's reads have landed
    ring.release(i);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[nt][m][e] = acc[nt * 2 + m][e];
}

// The body of both decode kernels: a block of dec_threads(C) threads, the
// consumer warps 0..C/32-1, the producers the last two.
template <int C, bool BF16X>
__device__ __forceinline__ void q6_dec(const CUtensorMap* lmap, const CUtensorMap* hmap,
                                       const CUtensorMap* smap, const CUtensorMap* xmap,
                                       const int8_t* __restrict__ xq, const float* __restrict__ xs,
                                       const float* __restrict__ xsum16, void* out,
                                       int out_is_bf16, int B, int K, int O, int G,
                                       int steps_per_split) {
  constexpr int NW = C / 32;  // consumer warps; the producers are warps NW and NW + 1
  using Stage = Q6DecStage<C, BF16X>;
  extern __shared__ uint8_t smem[];
  const Q6DecRing<C, BF16X> ring(smem);
  const int splits = (int)gridDim.x, rank = (int)mrt::cluster_rank();
  const int col0 = blockIdx.y * C;
  const int s_begin = rank * steps_per_split;
  const int n = max(0, min(steps_per_split, K / 128 - s_begin));  // a stage a step
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  float y[2][2][4] = {};
  if (warp == NW) {  // the weights: three TMA boxes a step
    if (lane == 0) {
      mrt::prefetch_tensormap(lmap);
      mrt::prefetch_tensormap(hmap);
      mrt::prefetch_tensormap(smap);
      ring.produce(
          n, true, [](int) { return (uint32_t)kQ6DecWeightBytes<C>; },
          [&](Stage& S, int i, uint64_t* full) {
            const Q6Step st(s_begin + i, G);
            mrt::tma_load_4d(S.ql, lmap, col0, st.t0, 0, st.c, full);
            mrt::tma_load_2d(S.qh, hmap, col0, G * st.c + st.t0, full);
            mrt::tma_load_4d(S.sc, smap, col0, st.t0 / 16, 0, st.c, full);
          });
    }
    __syncwarp();
  } else if (warp == NW + 1) {  // x, once the kernel launched before has finished
    if (lane == 0) {
      mrt::grid_dep_wait();
      if constexpr (BF16X) {
        mrt::prefetch_tensormap(xmap);
        ring.produce(
            n, false, [](int) { return (uint32_t)sizeof(Q6DecX<true>); },
            [&](Stage& S, int i, uint64_t* full) {
              mrt::tma_load_3d(S.xp.x, xmap, Q6Step(s_begin + i, G).e0(G), 0, 0, full);
            });
      } else {
        ring.produce(
            n, false, [](int) { return (uint32_t)(4 * (512 + 64 + 128)); },
            [&](Stage& S, int i, uint64_t* full) {
              const int e0 = Q6Step(s_begin + i, G).e0(G);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const size_t sl = (size_t)(j * (K / 4) + e0) / 32;  // the span's 32-element slice
                mrt::bulk_g2s(S.xp.x[j], xq + sl * 512, 512, full);
                mrt::bulk_g2s(S.xp.xs[j], xs + sl * mrt::kDecRows, 64, full);
                mrt::bulk_g2s(S.xp.xm[j], xsum16 + 2 * sl * mrt::kDecRows, 128, full);
              }
            });
      }
    }
    __syncwarp();
  } else if constexpr (BF16X) {
    if (B > 8)
      q6_bf16_consume<C, 2>(ring, n, warp, lane, y);
    else
      q6_bf16_consume<C, 1>(ring, n, warp, lane, y);
  } else {
    if (B > 8)
      q6_q8_consume<C, 2>(ring, n, warp, lane, y);
    else
      q6_q8_consume<C, 1>(ring, n, warp, lane, y);
  }
  if (splits == 1) {  // no cluster to add up
    if (warp < NW) mrt::dec_store_out(y, B > 8 ? 2 : 1, out, out_is_bf16, B, O, col0, warp, lane);
    return;
  }
  __syncthreads();  // every stage consumed: the ring's memory holds the tile now
  float* red = static_cast<float*>(ring.base());
  if (warp < NW) mrt::dec_store_tile<C>(red, y, B > 8 ? 2 : 1, warp, lane);
  mrt::cluster_sync();
  mrt::dec_reduce<C>(red, out, out_is_bf16, B, O, col0, splits, rank);
  mrt::cluster_sync();  // no block leaves while another reads its tile
}

template <int C>
__global__ void __launch_bounds__(mrt::dec_threads(C), 3)
    q6k_q8_dec_kernel(const __grid_constant__ CUtensorMap lmap,
                      const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap smap, const int8_t* __restrict__ xq,
                      const float* __restrict__ xs, const float* __restrict__ xsum16, void* out,
                      int out_is_bf16, int B, int K, int O, int G, int steps_per_split) {
  q6_dec<C, false>(&lmap, &hmap, &smap, nullptr, xq, xs, xsum16, out, out_is_bf16, B, K, O, G,
                   steps_per_split);
}

template <int C>
__global__ void __launch_bounds__(mrt::dec_threads(C), 3)
    q6k_bf16_dec_kernel(const __grid_constant__ CUtensorMap lmap,
                        const __grid_constant__ CUtensorMap hmap,
                        const __grid_constant__ CUtensorMap smap,
                        const __grid_constant__ CUtensorMap xmap, void* out, int out_is_bf16,
                        int B, int K, int O, int G, int steps_per_split) {
  q6_dec<C, true>(&lmap, &hmap, &smap, &xmap, nullptr, nullptr, nullptr, out, out_is_bf16, B, K,
                  O, G, steps_per_split);
}

// The weight's tensor maps for C columns a box: ql [K/2, O] seen as
// [K/(4G)][2][G][O] in boxes of both halves' 32 rows, qh [K/4, O] in boxes
// of 32 rows (the 128-byte swizzle on both at C = 128), the scale [K/16, O]
// seen as [K/(4G)][4][G/16][O] in boxes of the four spans' two rows.
int q6_maps(CUtensorMap* lmap, CUtensorMap* hmap, CUtensorMap* smap, const void* ql,
            const void* qh, const void* scale, int G, int K, int O, int C) {
  const uint64_t chunks = (uint64_t)(K / (4 * G));
  const CUtensorMapSwizzle sw = C == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
  const uint64_t ldims[4] = {(uint64_t)O, (uint64_t)G, 2, chunks};
  const uint64_t lstr[3] = {(uint64_t)O, (uint64_t)G * O, 2 * (uint64_t)G * O};
  const uint32_t lbox[4] = {(uint32_t)C, 32, 2, 1};
  const uint64_t hdims[2] = {(uint64_t)O, (uint64_t)(K / 4)}, hstr[1] = {(uint64_t)O};
  const uint32_t hbox[2] = {(uint32_t)C, 32};
  const uint64_t sdims[4] = {(uint64_t)O, (uint64_t)(G / 16), 4, chunks};
  const uint64_t sstr[3] = {(uint64_t)O * 2, (uint64_t)(G / 16) * O * 2, (uint64_t)(G / 4) * O * 2};
  const uint32_t sbox[4] = {(uint32_t)C, 2, 4, 1};
  int err = mrt::tile_map(lmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, ql, ldims, lstr, lbox, sw);
  if (!err) err = mrt::tile_map(hmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qh, hdims, hstr, hbox, sw);
  if (!err)
    err = mrt::tile_map(smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, scale, sdims, sstr, sbox);
  return err;
}

// Whether (rows, grid, cluster, cols, stages) is the decode plan of
// ops/quant_matmul.q6k_q8_plan / q6k_bf16_plan for this call: B <= 16, a
// span G of whole 32-t steps, grid (K splits, column tiles of `cols`, 1),
// a cluster of the splits (<= 8), every split whole steps and none empty,
// the ring's stages.
bool q6_dec_plan_ok(const mrt::Workspace& w, int B, int K, int O, int G, int rows, int gx, int gy,
                    int gz, int cluster, int cols, int stages) {
  const int steps = K / 128;
  if (rows != 16 || G < 32 || G % 32 || K % (4 * G) || (cols != 128 && cols != 64)) return false;
  if (cluster != gx || gx < 1 || gx > 8 || gx > steps || !mrt::grid_covers(w, rows, cols, B, O, gx, gy, gz))
    return false;
  const int per = mrt::dec_per_split(steps, gx, kQ6DecSub);
  return (gx - 1) * per < steps &&
         stages == (cols == 128 ? kQ6DecStages<128> : kQ6DecStages<64>);
}

template <int C>
int launch_q6_q8_dec(const mrt::Workspace& w, const void* ql, const void* qh, const void* scale,
                     void* out, int out_is_bf16, int B, int K, int O, int G, int splits,
                     cudaStream_t st) {
  CUtensorMap lmap, hmap, smap;
  const int err = q6_maps(&lmap, &hmap, &smap, ql, qh, scale, G, K, O, C);
  if (err) return err;
  return mrt::launch_dec(q6k_q8_dec_kernel<C>, splits, (O + C - 1) / C, mrt::dec_threads(C),
                         Q6DecRing<C, false>::smem_bytes(), st, lmap, hmap, smap,
                         static_cast<const int8_t*>(w.xq), static_cast<const float*>(w.xs),
                         static_cast<const float*>(w.xsum), out, out_is_bf16, B, K, O, G,
                         mrt::dec_per_split(K / 128, splits, kQ6DecSub));
}

// K4's x [B, K] bf16 seen as [B][4][Kq] in boxes of 32 elements of the four
// spans for 16 rows (rows past B zero-filled)
template <int C>
int launch_q6_bf16_dec(const void* x, const void* ql, const void* qh, const void* scale,
                       void* out, int out_is_bf16, int B, int K, int O, int G, int splits,
                       cudaStream_t st) {
  CUtensorMap lmap, hmap, smap, xmap;
  int err = q6_maps(&lmap, &hmap, &smap, ql, qh, scale, G, K, O, C);
  const uint64_t xdims[3] = {(uint64_t)(K / 4), 4, (uint64_t)B};
  const uint64_t xstr[2] = {(uint64_t)(K / 4) * 2, (uint64_t)K * 2};
  const uint32_t xbox[3] = {32, 4, (uint32_t)mrt::kDecRows};
  if (!err) err = mrt::tile_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, xdims, xstr, xbox);
  if (err) return err;
  return mrt::launch_dec(q6k_bf16_dec_kernel<C>, splits, (O + C - 1) / C, mrt::dec_threads(C),
                         Q6DecRing<C, true>::smem_bytes(), st, lmap, hmap, smap, xmap, out,
                         out_is_bf16, B, K, O, G, mrt::dec_per_split(K / 128, splits, kQ6DecSub));
}

}  // namespace

// K3. Shapes are checked by the Python wrapper (ops/quant_matmul.py): K %
// 4G == 0, O % 16 == 0, 16-byte aligned pointers, and a workspace of
// ws_bytes (see mrt::carve). The launch is the plan of
// ops/quant_matmul.q6k_q8_plan, every field of it checked here (any other
// plan is refused): rows 16 (B <= 16; the JAX package routes K3 only
// there), grid (K splits, column tiles of `cols` = 128 or 64, 1), a
// cluster of the splits (at most 8), the ring's stages. Quantizes x (bf16
// or f32 [B,K]) per 32 into the decode layout with the per-16 sums, then
// launches the GEMV behind it (programmatic dependent launch): two
// launches. Returns the CUDA error code of the launches (0 = launched).
extern "C" int q6k_q8_gemv(const void* x, int x_is_bf16, const void* ql, const void* qh,
                           const void* scale, int G, void* ws, long long ws_bytes, void* out,
                           int out_is_bf16, int B, int K, int O, int rows, int gx, int gy, int gz,
                           int cluster, int cols, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mrt::Workspace w = mrt::carve(ws, B, K, O, 32, 16, gx, mrt::kDecode);
  if (!q6_dec_plan_ok(w, B, K, O, G, rows, gx, gy, gz, cluster, cols, stages) ||
      w.bytes > (size_t)ws_bytes)
    return (int)cudaErrorInvalidValue;
  mrt::launch_quantize<32>(x, x_is_bf16 != 0, w.xq, w.xs, nullptr, w.xsum, B, K, w.bpad, st,
                           mrt::kDecode);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return cols == 128 ? launch_q6_q8_dec<128>(w, ql, qh, scale, out, out_is_bf16, B, K, O, G, gx, st)
                     : launch_q6_q8_dec<64>(w, ql, qh, scale, out, out_is_bf16, B, K, O, G, gx, st);
}

// K4, for bf16 x kept in bf16. The launch is the plan of
// ops/quant_matmul.q6k_bf16_plan, every field of it checked here (any
// other plan is refused):
// - rows 16 (B <= 16): q6k_bf16_dec_kernel on the decode plan of K3 (grid
//   (K splits, column tiles of `cols`, 1), a cluster of the splits, the
//   ring's stages), no workspace: one launch;
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
  if (rows == 16) {
    const mrt::Workspace w = mrt::carve(ws, B, K, O, 0, 0, gx, mrt::kDecode);
    if (!q6_dec_plan_ok(w, B, K, O, G, rows, gx, gy, gz, cluster, cols, stages) ||
        w.bytes > (size_t)ws_bytes)
      return (int)cudaErrorInvalidValue;
    return cols == 128 ? launch_q6_bf16_dec<128>(x, ql, qh, scale, out, out_is_bf16, B, K, O, G, gx, st)
                       : launch_q6_bf16_dec<64>(x, ql, qh, scale, out, out_is_bf16, B, K, O, G, gx, st);
  }
  if (rows != 64 && rows != 128) return (int)cudaErrorInvalidValue;
  const mrt::Workspace w = mrt::carve(ws, B, K, O, 0, 16, gz, mrt::kTiled, rows, true);
  const bool grid_ok = mrt::grid_covers(w, rows, cols, B, O, gx, gy, gz) && G >= 128 &&
                       G % 128 == 0 && (G & (G - 1)) == 0 && K % (4 * G) == 0 && gz <= K / 512;
  if (!grid_ok || cluster != 1 || cols != mrt::kGemvCols || w.bytes > (size_t)ws_bytes || gz < 1)
    return (int)cudaErrorInvalidValue;
  // qh as the 2-bit planes, group 16, zs = the scale itself
  return mrt::plane_rows_call<mrt::Q6kFmt>(
      static_cast<const __nv_bfloat16*>(x), w, out, out_is_bf16, B, K, O, 16, rows,
      dim3(gx, gy, gz), stages, st, static_cast<const uint8_t*>(qh),
      static_cast<const uint8_t*>(ql), static_cast<const __nv_bfloat16*>(scale), G);
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
