// The whole Q5_K product with activations kept in bf16, at decode-sized row
// counts (1-16): the Q5_K route of PipelineConfig.int8_activations=False at
// 1-16 rows, one kernel where the JAX package runs two (the 17-256-row route
// stays K5's and K9b's rows instantiations and an add, ops/quant_matmul.py).
//
// Replaces the TPU kernels mistralrs_tpu/ops/quant_matmul.py::_q4k_kernel and
// ::_q5k_hbit_kernel as _q5k_matmul_padded calls them (the two pallas_calls
// and their sum y + 16 * yh), when the int8 gate MISTRALRS_Q5K_INT8 is off.
//
// Computes, for bf16 x [B, K], JAX's three roundings kept:
//   y4[b,o] = sum_sub scale[sub,o] * (sum_{k in sub} x[b,k] nib[k,o])
//             - sum_sub xsum[b,sub] * minv[sub,o]          (_q4k_kernel's sums)
//   yh[b,o] = sum_sub scale[sub,o] * (sum_{k in sub} x[b,k] hbit[k,o])
//                                                          (_q5k_hbit_kernel's)
//   out = bf16(bf16(y4) + 16 * bf16(yh)) for a bf16 out, y4 + 16 * yh for f32
// where nib[k,o] is the paired nibble of quant/gguf_linear.pack_q5k (qs row
// k, low, for k < K/2; row k - K/2, high, otherwise), hbit[k,o] bit k / (K/8)
// of qh row k % (K/8), xsum the f32 sums of every 32 x, and each sub-block's
// dot a fresh f32 sum times its scale (JAX's _q4k_kernel scales each 32-row
// dot; its hbit kernel forms hbit * s exactly in bf16, the same products).
// One f32 sum of y4 + 16 * yh, rounded once, would be another function:
// on a quantized weight it can differ from this one by more than one bf16
// ulp of max |y| (tests/test_torch_q5k_bf16_decode.py).
//
// Layouts (row-major): x [B,K] bf16, qs [K/2,O] u8, qh [K/8,O] u8,
// scale/minv [K/32,O] bf16, out [B,O] bf16 or f32. No workspace.
//
// What bounds it on an H100: the weight stream, 0.75 bytes a weight (qs 0.5,
// qh 0.125, two bf16 planes per 32), against 3.35 TB/s; close behind it the
// tensor-core issue of the two products (five bf16 m16n8k16 a 16 x 32 x 8
// product where K9's int8 route issues one k32).
// Design (q5k_bf16_dec_kernel): K9's decode geometry (csrc/q5k_q8_gemv.cu)
// with K5's arithmetic (csrc/plane_gemv.cuh Q4kFmt::kScaleOnAcc), on
// common.cuh's decode section:
// - a K step reads qh once: qh rows [32r, 32r+32) hold the high bits of the
//   8 sub-blocks j*K/256 + r (j = 0..7), whose nibbles are the low (j < 4)
//   and high (j >= 4) halves of the 4 qs row blocks m*K/8 + 32r (m = j mod
//   4); a ring stage is that step: qs seen as [4][K/8][O] in one 3-D box of
//   4 x 32 rows, qh's 32 rows, scale and minv seen as [8][K/256][O] in one
//   box each (24 KB of weights at C = 128 columns: two stages), brought by
//   one producer warp at most half the ring ahead of what has landed; the
//   other producer warp brings x's 8 strided 32-element pieces of the step
//   for 16 rows by one TMA box of x seen as [B][8][K/8] (rows past B zero),
//   after griddepcontrol.wait; every weight byte is read once;
// - the weight is the A operand of bf16 mma.m16n8k16 (an output column an A
//   row, mrt::w_frags) and x the B operand (one n-tile up to 8 rows, two up
//   to 16): the nibble as K5's exact pair (128 + c) - 128, the high bit as
//   bf16 1.0 or 0 on the same x fragments; a sub-block's two 16-element
//   halves run into fresh f32 fragments, and one FFMA a (row, column,
//   sub-block) adds each times the column's scale into its own accumulator
//   set (y4, yh); the min term is K5's, x's sums over the sub-block from a
//   bf16 mma with an all-ones A over the same x fragments, times -minv into
//   the y4 set;
// - the K splits of a column tile form one cluster (at most 8) that adds
//   both sets in distributed shared memory in rank order, then applies the
//   roundings above; one split writes out itself;
// - one launch a call, no workspace and no per-call state: a call can be
//   captured in a CUDA graph.
#include "plane_gemv.cuh"

namespace {

// a ring stage: the K step of qh rows 32r.. for C columns, and x's 32
// elements of each of the step's 8 sub-blocks for 16 rows
template <int C>
struct alignas(C == 128 ? 1024 : 128) Q5Bf16Stage {
  uint8_t qs[4][32 * C];                        // qs rows m*K/8 + 32r.. (swizzled at C = 128)
  uint8_t qh[32 * C];                           // qh rows 32r..
  __nv_bfloat16 sc[8][C];                       // scale of sub-block j*K/256 + r
  __nv_bfloat16 mn[8][C];                       // minv of the same
  __nv_bfloat16 x[mrt::kDecRows][8][32];        // x's elements j*K/8 + 32r.., 16 rows
};
template <int C>
constexpr int kQ5Bf16WeightBytes = 32 * C * 5 + 16 * C * 2;
template <int C>
constexpr int kQ5Bf16Stages = mrt::dec_stages(kQ5Bf16WeightBytes<C>);
template <int C>
using Q5Bf16Ring = mrt::DecRing<Q5Bf16Stage<C>, kQ5Bf16Stages<C>, C / 32>;
constexpr uint32_t kQ5Bf16XBytes = mrt::kDecRows * 8 * 32 * 2;

constexpr uint32_t kOne = 0x3F803F80u, kNeg128 = 0xC300C300u;

// Sub-block J of a step for a consumer warp: the nibble and high-bit dots of
// its two 16-element halves (A from the transposed qs words w[2] and qh
// words h[2], B the x fragments), times the columns' scale into acc (y4)
// and acch (yh), and x's sums times -minv into acc.
template <int C, int NT, int J>
__device__ __forceinline__ void q5_bf16_sub(const Q5Bf16Stage<C>& S, int c, int g, int t,
                                            const uint32_t (&w)[2][4], const uint32_t (&h)[2][4],
                                            float (&acc)[NT * 2][4], float (&acch)[NT * 2][4]) {
  uint32_t xv[2][NT][2];  // B: x row 8nt + g, elements 16hf + 4t.. of sub-block J
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 v = *reinterpret_cast<const uint2*>(&S.x[8 * nt + g][J][16 * hf + 4 * t]);
      xv[hf][nt][0] = v.x;
      xv[hf][nt][1] = v.y;
    }
  float s[4], mn[4];
  mrt::lds4(&S.sc[J][c], s);
  mrt::lds4(&S.mn[J][c], mn);
  {  // the nibbles and the min term into acc
    float d[NT * 2][4] = {};
    float xs[NT][4] = {};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint32_t wl[4], wh[4];  // the codes themselves, exact: (128 + c) - 128
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t cw = (J < 4 ? w[hf][k] : w[hf][k] >> 4) & 0x0F0F0F0Fu;
        wl[k] = mrt::fma_bf16x2(__byte_perm(cw, 0x43u, 0x4140), kOne, kNeg128);
        wh[k] = mrt::fma_bf16x2(__byte_perm(cw, 0x43u, 0x4342), kOne, kNeg128);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const uint32_t a[4] = {wl[2 * m], wl[2 * m + 1], wh[2 * m], wh[2 * m + 1]};
          mrt::mma_bf16(d[nt * 2 + m], a, xv[hf][nt][0], xv[hf][nt][1]);
        }
        const uint32_t ones[4] = {kOne, kOne, kOne, kOne};
        mrt::mma_bf16(xs[nt], ones, xv[hf][nt][0], xv[hf][nt][1]);
      }
    }
#pragma unroll
    for (int k = 0; k < NT * 2; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[k][e] = fmaf(d[k][e], s[2 * (k & 1) + (e >> 1)], acc[k][e]);
        acc[k][e] = fmaf(-xs[k >> 1][e & 1], mn[2 * (k & 1) + (e >> 1)], acc[k][e]);
      }
  }
  {  // the high bits into acch
    float d[NT * 2][4] = {};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint32_t bl[4], bh[4];  // bit J of each byte as bf16 1.0 or 0 (0x3F80 * bit)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t hb = (h[hf][k] >> J) & 0x01010101u;
        bl[k] = __byte_perm(hb, 0u, 0x4140) * 0x3F80u;
        bh[k] = __byte_perm(hb, 0u, 0x4342) * 0x3F80u;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const uint32_t a[4] = {bl[2 * m], bl[2 * m + 1], bh[2 * m], bh[2 * m + 1]};
          mrt::mma_bf16(d[nt * 2 + m], a, xv[hf][nt][0], xv[hf][nt][1]);
        }
    }
#pragma unroll
    for (int k = 0; k < NT * 2; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) acch[k][e] = fmaf(d[k][e], s[2 * (k & 1) + (e >> 1)], acch[k][e]);
  }
}

// A consumer warp over its n steps: y[v][nt][m][e] = the f32 sums of set v
// (0: y4, 1: yh) of x row 8nt + 2t + e%2 and column 32 * warp + 4g + 2m + e/2
// (NT n-tiles: 1 up to 8 rows).
template <int C, int NT>
__device__ __forceinline__ void q5_bf16_consume(const Q5Bf16Ring<C>& ring, int n, int warp,
                                                int lane, float (&y)[2][2][2][4]) {
  const int g = lane >> 2, t = lane & 3, c = 32 * warp + 4 * g;
  float acc[NT * 2][4] = {}, acch[NT * 2][4] = {};
  for (int i = 0; i < n; ++i) {
    const Q5Bf16Stage<C>& S = ring[i];
    ring.acquire(i);
    uint32_t h[2][4], w[2][4];  // rows 4t.. ([0]) and 16 + 4t.. ([1]) of columns c..c+3
    mrt::w_frags<C>(S.qh, 0, c, t, h[0], h[1]);
    mrt::w_frags<C>(S.qs[0], 0, c, t, w[0], w[1]);
    q5_bf16_sub<C, NT, 0>(S, c, g, t, w, h, acc, acch);
    q5_bf16_sub<C, NT, 4>(S, c, g, t, w, h, acc, acch);
    mrt::w_frags<C>(S.qs[1], 0, c, t, w[0], w[1]);
    q5_bf16_sub<C, NT, 1>(S, c, g, t, w, h, acc, acch);
    q5_bf16_sub<C, NT, 5>(S, c, g, t, w, h, acc, acch);
    mrt::w_frags<C>(S.qs[2], 0, c, t, w[0], w[1]);
    q5_bf16_sub<C, NT, 2>(S, c, g, t, w, h, acc, acch);
    q5_bf16_sub<C, NT, 6>(S, c, g, t, w, h, acc, acch);
    mrt::w_frags<C>(S.qs[3], 0, c, t, w[0], w[1]);
    q5_bf16_sub<C, NT, 3>(S, c, g, t, w, h, acc, acch);
    q5_bf16_sub<C, NT, 7>(S, c, g, t, w, h, acc, acch);
#pragma unroll
    for (int k = 0; k < NT * 2; ++k) {  // every read of the stage has landed in a register
      mrt::fence_values(acc[k]);
      mrt::fence_values(acch[k]);
    }
    ring.release(i);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[0][nt][m][e] = acc[nt * 2 + m][e];
        y[1][nt][m][e] = acch[nt * 2 + m][e];
      }
}

// JAX's epilogue of four outputs (columns c..c+3 of one row) from their y4
// and yh sums: bf16(bf16(y4) + 16 * bf16(yh)), or y4 + 16 * yh in f32
__device__ __forceinline__ void q5_store4(void* out, size_t o, int out_is_bf16, float4 y4,
                                          float4 yh) {
  if (out_is_bf16) {
    auto r = [](float a, float b) {
      return __bfloat162float(__float2bfloat16_rn(a)) +
             16.f * __bfloat162float(__float2bfloat16_rn(b));
    };
    __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out) + o;
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __floats2bfloat162_rn(r(y4.x, yh.x), r(y4.y, yh.y));
    *reinterpret_cast<__nv_bfloat162*>(p + 2) =
        __floats2bfloat162_rn(r(y4.z, yh.z), r(y4.w, yh.w));
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
        make_float4(y4.x + 16.f * yh.x, y4.y + 16.f * yh.y, y4.z + 16.f * yh.z,
                    y4.w + 16.f * yh.w);
  }
}

// the four sums of set v at (x row 8nt + 2t + e, columns c..c+3) of a lane
__device__ __forceinline__ float4 q5_quad(const float (&y)[2][2][2][4], int v, int nt, int e) {
  return make_float4(y[v][nt][0][e], y[v][nt][0][e + 2], y[v][nt][1][e], y[v][nt][1][e + 2]);
}

// A block of dec_threads(C) threads: the consumer warps 0..C/32-1, the
// producers the last two; NT n-tiles of 8 rows (1 up to 8 rows, 2 up to 16);
// steps_per_split = dec_per_split(K/256, splits, 1). Up to 8 rows the
// registers are bounded for three blocks an SM; at 9-16 rows for two: the
// two n-tiles' accumulator sets and dots did not fit three at 128 columns
// (96 registers, 240 bytes of spills a thread; 1.6x slower at gate|up on
// an H100, PERF.md §6).
template <int C, int NT>
__global__ void __launch_bounds__(mrt::dec_threads(C), NT == 1 ? 3 : 2)
    q5k_bf16_dec_kernel(const __grid_constant__ CUtensorMap qsmap,
                        const __grid_constant__ CUtensorMap qhmap,
                        const __grid_constant__ CUtensorMap smap,
                        const __grid_constant__ CUtensorMap mmap,
                        const __grid_constant__ CUtensorMap xmap, void* out, int out_is_bf16,
                        int B, int O, int steps, int steps_per_split) {
  constexpr int NW = C / 32;  // consumer warps; the producers are warps NW and NW + 1
  constexpr int kStride = C + 4;  // a row of a reduction tile (dec_store_tile's)
  using Stage = Q5Bf16Stage<C>;
  extern __shared__ uint8_t smem[];
  const Q5Bf16Ring<C> ring(smem);
  const int splits = (int)gridDim.x, rank = (int)mrt::cluster_rank();
  const int col0 = blockIdx.y * C;
  const int s_begin = rank * steps_per_split;
  const int n = max(0, min(steps_per_split, steps - s_begin));  // a stage a step
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  float y[2][2][2][4] = {};  // [y4 | yh][nt][m][e]
  if (warp == NW) {  // the weights: a TMA box an array a step
    if (lane == 0) {
      mrt::prefetch_tensormap(&qsmap);
      mrt::prefetch_tensormap(&qhmap);
      mrt::prefetch_tensormap(&smap);
      mrt::prefetch_tensormap(&mmap);
      ring.produce(
          n, true, [](int) { return (uint32_t)kQ5Bf16WeightBytes<C>; },
          [&](Stage& S, int i, uint64_t* full) {
            const int r = s_begin + i;
            mrt::tma_load_3d(S.qs, &qsmap, col0, 32 * r, 0, full);  // [4] blocks of 32 rows
            mrt::tma_load_2d(S.qh, &qhmap, col0, 32 * r, full);
            mrt::tma_load_3d(S.sc, &smap, col0, r, 0, full);  // [8] sub-blocks' rows
            mrt::tma_load_3d(S.mn, &mmap, col0, r, 0, full);
          });
    }
    __syncwarp();
  } else if (warp == NW + 1) {  // x, once the kernel launched before has finished
    if (lane == 0) {
      mrt::grid_dep_wait();
      mrt::prefetch_tensormap(&xmap);
      ring.produce(
          n, false, [](int) { return kQ5Bf16XBytes; },
          [&](Stage& S, int i, uint64_t* full) {
            mrt::tma_load_3d(S.x, &xmap, 32 * (s_begin + i), 0, 0, full);
          });
    }
    __syncwarp();
  } else {
    q5_bf16_consume<C, NT>(ring, n, warp, lane, y);
  }
  const int g = lane >> 2, t = lane & 3;
  if (splits == 1) {  // no cluster to add up: each consumer lane writes its outputs
    const int c = col0 + 32 * warp + 4 * g;
    if (warp >= NW || c >= O) return;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * nt + 2 * t + e;
        if (nt < NT && r < B)
          q5_store4(out, (size_t)r * O + c, out_is_bf16, q5_quad(y, 0, nt, e),
                    q5_quad(y, 1, nt, e));
      }
    return;
  }
  __syncthreads();  // every stage consumed: the ring's memory holds the two tiles now
  float* red = static_cast<float*>(ring.base());  // y4's tile, then yh's
  if (warp < NW) {
    float y4[2][2][4], yh[2][2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          y4[nt][m][e] = y[0][nt][m][e];
          yh[nt][m][e] = y[1][nt][m][e];
        }
    mrt::dec_store_tile<C>(red, y4, NT, warp, lane);
    mrt::dec_store_tile<C>(red + mrt::kDecRows * kStride, yh, NT, warp, lane);
  }
  mrt::cluster_sync();
  // block `rank` adds every `splits`-th float4 of both tiles over the
  // cluster's blocks in rank order, then applies the epilogue
  constexpr int kQuads = C / 4;
  for (int q = rank + splits * (int)threadIdx.x; q < B * kQuads; q += splits * (int)blockDim.x) {
    const int r = q / kQuads, c = 4 * (q % kQuads);
    if (col0 + c >= O) continue;
    float4 s[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const float* p = red + v * mrt::kDecRows * kStride + r * kStride + c;
      float4 part[8];  // every rank's tile first, so their latencies overlap
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < splits) part[k] = mrt::ld_cluster4(p, k);
      s[v] = part[0];
#pragma unroll
      for (int k = 1; k < 8; ++k)
        if (k < splits) {
          s[v].x += part[k].x;
          s[v].y += part[k].y;
          s[v].z += part[k].z;
          s[v].w += part[k].w;
        }
    }
    q5_store4(out, (size_t)r * O + col0 + c, out_is_bf16, s[0], s[1]);
  }
  mrt::cluster_sync();  // no block leaves while another reads its tiles
}

// The tensor maps of a call at C columns a box: qs [K/2, O] seen as
// [4][K/8][O] in boxes of 4 x 32 rows and qh [K/8, O] in boxes of 32 rows
// (both with the 128-byte swizzle at C = 128); scale and minv [K/32, O]
// seen as [8][K/256][O] in boxes of 8 rows; x [B, K] seen as [B][8][K/8] in
// boxes of 32 elements x 8 pieces x 16 rows (rows past B zero-filled).
// Returns the CUDA error.
template <int C>
int launch(const void* x, const void* qs, const void* qh, const void* scale, const void* minv,
           void* out, int out_is_bf16, int B, int K, int O, int splits, cudaStream_t st) {
  const int steps = K / 256;
  const uint64_t n8 = (uint64_t)steps, k8 = (uint64_t)(K / 8);
  const CUtensorMapSwizzle sw = C == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
  const uint64_t qdims[3] = {(uint64_t)O, k8, 4}, qstr[2] = {(uint64_t)O, k8 * O};
  const uint32_t qbox[3] = {(uint32_t)C, 32, 4};
  const uint64_t hdims[2] = {(uint64_t)O, k8}, hstr[1] = {(uint64_t)O};
  const uint32_t hbox[2] = {(uint32_t)C, 32};
  const uint64_t sdims[3] = {(uint64_t)O, n8, 8}, sstr[2] = {(uint64_t)O * 2, n8 * O * 2};
  const uint32_t sbox[3] = {(uint32_t)C, 1, 8};
  const uint64_t xdims[3] = {k8, 8, (uint64_t)B}, xstr[2] = {k8 * 2, (uint64_t)K * 2};
  const uint32_t xbox[3] = {32, 8, (uint32_t)mrt::kDecRows};
  CUtensorMap qsmap, qhmap, smap, mmap, xmap;
  int err = mrt::tile_map(&qsmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, qs, qdims, qstr, qbox, sw);
  if (!err) err = mrt::tile_map(&qhmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qh, hdims, hstr, hbox, sw);
  if (!err) err = mrt::tile_map(&smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, scale, sdims, sstr, sbox);
  if (!err) err = mrt::tile_map(&mmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, minv, sdims, sstr, sbox);
  if (!err) err = mrt::tile_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, xdims, xstr, xbox);
  if (err) return err;
  static_assert(2 * mrt::kDecRows * (C + 4) * 4 <= kQ5Bf16Stages<C> * (int)sizeof(Q5Bf16Stage<C>),
                "the two reduction tiles fit in the ring");
  return mrt::launch_dec(B > 8 ? q5k_bf16_dec_kernel<C, 2> : q5k_bf16_dec_kernel<C, 1>, splits,
                         (O + C - 1) / C, mrt::dec_threads(C), Q5Bf16Ring<C>::smem_bytes(), st,
                         qsmap, qhmap, smap, mmap, xmap, out, out_is_bf16, B, O, steps,
                         mrt::dec_per_split(steps, splits, 1));
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): K % 256 ==
// 0, O % 16 == 0, 16-byte aligned pointers. The launch is the plan of
// ops/quant_matmul.q5k_bf16_plan, every field of it checked here: rows 16,
// 1 <= B <= 16, grid (K splits, column tiles of `cols` = 128 or 64, 1), a
// cluster of the gx splits (at most 8, each whole steps of 256 elements,
// none empty), stages = kQ5Bf16Stages<cols>. One launch, no workspace.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int q5k_bf16_gemv(const void* x, const void* qs, const void* qh, const void* scale,
                             const void* minv, void* out, int out_is_bf16, int B, int K, int O,
                             int rows, int gx, int gy, int gz, int cluster, int cols, int stages,
                             void* stream) {
  const int steps = K / 256;
  if (rows != 16 || B < 1 || B > 16 || K % 256 || steps < 1 || gz != 1 ||
      (cols != 128 && cols != 64) || cluster != gx || gx < 1 || gx > 8 || gx > steps ||
      gy != (O + cols - 1) / cols || (gx - 1) * mrt::dec_per_split(steps, gx, 1) >= steps ||
      stages != (cols == 128 ? kQ5Bf16Stages<128> : kQ5Bf16Stages<64>))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cols == 128 ? launch<128>(x, qs, qh, scale, minv, out, out_is_bf16, B, K, O, gx, st)
                     : launch<64>(x, qs, qh, scale, minv, out, out_is_bf16, B, K, O, gx, st);
}
