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
// Not done yet (later work): TMA/wgmma at decode, fusing the split-K pass.
//
// At 17-256 rows (the rows instantiation below) the bound is the scaling
// epilogue: per (row, column, sub-block) a conversion, the xs * scale
// product and an fma, which the tensor cores cannot take since xs and
// scale change every 32 elements; it is bound by issue slots. Design for
// that: each weight tile is read once per call (twice at 129-256 rows, by
// grid neighbours that meet in L2) and decoded once per block; int8 wgmma
// does the dots; the epilogue of one sub-block overlaps the tensor cores'
// work on the next; the min term, a plain product of xsum and minv, goes
// to the tensor cores in bf16 (xsum split exactly into three parts); see
// q4k_q8_rows_kernel.
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

// ---- rows instantiation: 17 <= B <= 256 ----
//
// K2's design (q8_0_q8_gemv.cu) on the ring of common.cuh (mrt::Ring): a
// block owns 128 columns and BM = 64 or 128 rows, with two consumer
// warpgroups (at BM 128 one per 64 rows, wgmma N = 128; at BM 64 one per 64
// columns, N = 64) and a producer warpgroup; the grid is (row tiles, column
// tiles, ksplit), row tiles fastest. One K step is one sub-block pair p:
// - the copies: TMA boxes of the pair's 32 byte rows of qs and of its four
//   scale rows (scale and minv of sub-blocks p and K/64 + p), bulk copies
//   of x's codes of the two sub-blocks for the BM rows (A slices,
//   common.cuh tiled_off) and their xs and xsum;
// - the decode: low and high nibbles into two K-major B tiles (0..15 are
//   valid int8 codes), the scale rows into f32 at mrt::scale_pos, and the
//   pair's xsum (three bf16 parts) and minv into the slice's min tiles
//   (Q4MinTiles);
// - each consumer warpgroup issues wgmma.m64nNk32.s32.s8.s8 for the low
//   sub-block into one int32 accumulator and for the high one into
//   another, scales the low one while the high one runs, issues the next
//   pair's low sub-block, and scales the high one while that runs (the
//   conversion, exact below 2^24, xs * scale, an fma). After every 8th
//   pair, three bf16 wgmma.m64nNk16 put the slice's min term into the
//   high accumulator's registers, and 64 adds move it into the f32 sums.
//   The two warpgroups share each SM sub-partition.
namespace {

template <int BM>
struct __align__(128) Q4RowStage {
  uint8_t q[32 * mrt::kGemvCols];        // the pair's byte rows as stored, row r at r*128
  uint8_t lo[32 * mrt::kGemvCols];       // decoded B tile of sub-block p (low nibbles)
  uint8_t hi[32 * mrt::kGemvCols];       // and of sub-block K/64 + p (high nibbles)
  int8_t x[2][BM * 32];                  // x's codes of the two sub-blocks: A slices
  __nv_bfloat16 sc[4][mrt::kGemvCols];   // scale lo, scale hi, minv lo, minv hi as stored
  float scf[2][mrt::kScaleRow];          // the scales in f32, at scale_pos
  float xv[4][BM];                       // xs lo, xs hi, xsum lo, xsum hi of the BM rows
};

// The min term sum_sub xsum[b,sub] * minv[sub,o] on the tensor cores: every
// 8 pairs (16 sub-blocks, slots 2j and 2j+1 for the j-th pair's two) one
// bf16 wgmma.m64nNk16 per part subtracts it into the f32 accumulators. xsum
// is split exactly into three bf16 parts (hi + mid + lo); minv is bf16.
// Both are K-major tiles in the int8 tiles' layout, double-buffered by
// slice, written by the decode warps from each stage.
template <int BM>
struct __align__(128) Q4MinTiles {
  __nv_bfloat16 a[2][3][BM * 16];  // xsum parts: (r, k) at (r/64)*2048 + (k/8)*1024 + (r%64)*16 + (k%8)*2 bytes
  __nv_bfloat16 b[2][128 * 16];    // minv: (c, k) at (k/8)*2048 + c*16 + (k%8)*2 bytes
};

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int BM>
constexpr int kQ4Stages = mrt::ring_stages<Q4RowStage<BM>, sizeof(Q4MinTiles<BM>), 8>();
template <int BM>
using Q4Ring = mrt::Ring<Q4RowStage<BM>, kQ4Stages<BM>>;

template <int BM>
__global__ void __launch_bounds__(mrt::kRowThreads, 1)
    q4k_q8_rows_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap smap,
                       const __grid_constant__ CUtensorMap mmap, const int8_t* __restrict__ xq,
                       const float* __restrict__ xs, const float* __restrict__ xsum, void* out,
                       int out_mode, int B, int bpad, int K, int O, int pairs_per_split) {
  constexpr int N = BM == 128 ? 128 : 64;  // wgmma width of a consumer warpgroup
  using Stage = Q4RowStage<BM>;
  static_assert(kQ4Stages<BM> <= 8, "a slice's min tiles are rewritten 16 pairs later");
  extern __shared__ __align__(128) uint8_t smem[];
  const Q4Ring<BM> ring(smem, sizeof(Q4MinTiles<BM>));
  Q4MinTiles<BM>& mt = *static_cast<Q4MinTiles<BM>*>(ring.extra());
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * mrt::kGemvCols;
  const int npairs = K / 64;
  const int p_begin = blockIdx.z * pairs_per_split;
  const int n = max(0, min(pairs_per_split, npairs - p_begin));

  auto copy = [&](Stage& S, int i, uint64_t* full) {
    const int pr = p_begin + i;
    mrt::tma_load_2d(S.q, &qmap, col0, 32 * pr, full);
    mrt::tma_load_3d(S.sc[0], &smap, col0, pr, 0, full);  // rows pr, npairs + pr
    mrt::tma_load_3d(S.sc[2], &mmap, col0, pr, 0, full);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t sub = (size_t)(h ? npairs + pr : pr);
      mrt::bulk_g2s(S.x[h], xq + sub * bpad * 32 + (size_t)row0 * 32, BM * 32, full);
      mrt::bulk_g2s(S.xv[h], xs + sub * bpad + row0, BM * 4, full);
      mrt::bulk_g2s(S.xv[2 + h], xsum + sub * bpad + row0, BM * 4, full);
    }
  };
  auto decode = [&](Stage& S, int i, int lane) {
    const uint32_t sel = mrt::rot_sel(lane >> 1);
    // the 4 byte-row octets of the lane's column quad
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      uint32_t w[8];
      mrt::load_quad8(S.q, 8 * o, lane, sel, w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * lane + ((j + (lane >> 1)) & 3);
        mrt::store_b8(S.lo, c, 8 * o, w[j] & 0x0F0F0F0Fu, w[4 + j] & 0x0F0F0F0Fu);
        mrt::store_b8(S.hi, c, 8 * o, (w[j] >> 4) & 0x0F0F0F0Fu, (w[4 + j] >> 4) & 0x0F0F0F0Fu);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const uint2 u = *reinterpret_cast<const uint2*>(&S.sc[a][4 * lane]);
      S.scf[a][mrt::scale_pos(4 * lane)] = mrt::bf16_lo(u.x);
      S.scf[a][mrt::scale_pos(4 * lane + 1)] = mrt::bf16_hi(u.x);
      S.scf[a][mrt::scale_pos(4 * lane + 2)] = mrt::bf16_lo(u.y);
      S.scf[a][mrt::scale_pos(4 * lane + 3)] = mrt::bf16_hi(u.y);
    }
    // this pair's slots 2j, 2j+1 of the slice's min tiles (and zeros in the
    // slots past the last pair)
    const int buf = (i >> 3) & 1, j = i & 7;
    uint8_t* ma = reinterpret_cast<uint8_t*>(mt.a[buf][0]);
    uint8_t* mb = reinterpret_cast<uint8_t*>(mt.b[buf]);
    for (int r = lane; r < BM; r += 32) {
      __nv_bfloat16 pl[3], ph[3];
      mrt::split3(S.xv[2][r], pl);
      mrt::split3(S.xv[3][r], ph);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        *reinterpret_cast<uint32_t*>(ma + t * BM * 32 + (r >> 6) * 2048 + (j >> 2) * 1024 +
                                     (r & 63) * 16 + 4 * (j & 3)) = pack2(pl[t], ph[t]);
    }
#pragma unroll
    for (int c = lane; c < mrt::kGemvCols; c += 32)
      *reinterpret_cast<uint32_t*>(mb + (j >> 2) * 2048 + c * 16 + 4 * (j & 3)) =
          pack2(S.sc[2][c], S.sc[3][c]);
    if (i == n - 1)
      for (int jz = j + 1; jz < 8; ++jz) {
        for (int r = lane; r < BM; r += 32)
#pragma unroll
          for (int t = 0; t < 3; ++t)
            *reinterpret_cast<uint32_t*>(ma + t * BM * 32 + (r >> 6) * 2048 + (jz >> 2) * 1024 +
                                         (r & 63) * 16 + 4 * (jz & 3)) = 0u;
        for (int c = lane; c < mrt::kGemvCols; c += 32)
          *reinterpret_cast<uint32_t*>(mb + (jz >> 2) * 2048 + c * 16 + 4 * (jz & 3)) = 0u;
      }
  };
  // consumer warpgroup wg: rows 64*wr.., columns 64*wc.. of the tile
  auto consume = [&](int wg) {
    const int wr = BM == 128 ? wg : 0, wc = BM == 128 ? 0 : wg;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int t = lane & 3;
    const int rl = wr * 64 + warp * 16 + (lane >> 2);  // rows rl and rl + 8 of the tile
    const int sp = t * 36 + wc * 16;                   // the thread's columns in scf rows
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    int dl[N / 2], dh[N / 2];
    // wgmma of the low (h = 0) or high (h = 1) sub-block of pair i into d
    auto mma = [&](int (&d)[N / 2], int i, int h) {
      const Stage& S = ring[i];
      if (h == 0) ring.acquire(i);
      mrt::fence_operand(d);
      mrt::wgmma_fence();
      mrt::wgmma_s8<N>(d, mrt::kmajor_desc(S.x[h] + wr * 2048, mrt::kALbo, mrt::kTileSbo),
                       mrt::kmajor_desc((h ? S.hi : S.lo) + wc * 1024, mrt::kBLbo, mrt::kTileSbo),
                       0);
      mrt::wgmma_commit();
    };
    // acc += d * xs * scale of sub-block h of a stage
    auto scale_into = [&](const int (&d)[N / 2], const Stage& S, int h) {
      const float x0 = S.xv[h][rl], x1 = S.xv[h][rl + 8];
#pragma unroll
      for (int jj = 0; jj < N / 8; jj += 2) {
        const float4 a4 = *reinterpret_cast<const float4*>(&S.scf[h][sp + 2 * jj]);
        const float sc[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {  // n-tiles jj, jj + 1; bit 0 column, bit 1 row
          const int idx = 4 * jj + e;
          acc[idx] = fmaf((float)d[idx], ((e & 2) ? x1 : x0) * sc[(e >> 2) * 2 + (e & 1)],
                          acc[idx]);
        }
      }
    };
    if (n > 0) {
      mma(dl, 0, 0);
      mma(dh, 0, 1);
    }
    // the low sub-block's epilogue runs while the high one's wgmma does, the
    // high one's while the next pair's low one's does
    for (int i = 0; i < n; ++i) {
      const Stage& S = ring[i];
      mrt::wgmma_wait<1>();  // the low sub-block of pair i is done
      mrt::fence_operand(dl);
      scale_into(dl, S, 0);
      if (i + 1 < n) {
        mma(dl, i + 1, 0);
        mrt::wgmma_wait<1>();  // the high sub-block of pair i is done
      } else {
        mrt::wgmma_wait<0>();
      }
      mrt::fence_operand(dh);
      scale_into(dh, S, 1);
      ring.release(i);
      if ((i & 7) == 7 || i == n - 1) {
        // the slice's last pair: its min term, in dh's registers (free until
        // the next pair's high sub-block), added into acc
        const int buf = (i >> 3) & 1;
        mrt::fence_operand(dh);
        mrt::wgmma_fence();
#pragma unroll
        for (int t = 0; t < 3; ++t)
          mrt::wgmma_bf16_neg<N>(
              dh, mrt::kmajor_desc(mt.a[buf][t] + wr * 64 * 16, mrt::kALbo, mrt::kTileSbo),
              mrt::kmajor_desc(mt.b[buf] + wc * 64 * 8, mrt::kBLbo, mrt::kTileSbo), t);
        mrt::wgmma_commit();
        mrt::wgmma_wait<0>();
        mrt::fence_operand(dh);
#pragma unroll
        for (int k = 0; k < N / 2; ++k) acc[k] += __int_as_float(dh[k]);
      }
      if (i + 1 < n) mma(dh, i + 1, 1);
    }
    mrt::store_rows(out, out_mode, acc, B, O, row0 + rl, col0 + wc * 64 + 2 * t);
  };
  ring.run(n, 32 * mrt::kGemvCols + 4 * 2 * mrt::kGemvCols + 64 * BM + 16 * BM, copy, decode,
           consume);
}

template <int BM>
int launch_rows(const mrt::Workspace& w, const void* qs, const void* scale, const void* minv,
                void* out, int out_is_bf16, int B, int K, int O, dim3 grid, cudaStream_t st) {
  const int npairs = K / 64;
  // qs [K/2, O] in boxes of 32 byte rows x 128 columns; scale and minv
  // [K/32, O] seen as [2, K/64, O], so one box holds rows p and K/64 + p
  CUtensorMap qmap, smap, mmap;
  const uint64_t qdims[2] = {(uint64_t)O, (uint64_t)(K / 2)}, qstr[1] = {(uint64_t)O};
  const uint32_t qbox[2] = {mrt::kGemvCols, 32};
  const uint64_t sdims[3] = {(uint64_t)O, (uint64_t)npairs, 2};
  const uint64_t sstr[2] = {(uint64_t)O * 2, (uint64_t)npairs * O * 2};
  const uint32_t sbox[3] = {mrt::kGemvCols, 1, 2};
  int err = mrt::tile_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qs, qdims, qstr, qbox);
  if (!err) err = mrt::tile_map(&smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, scale, sdims, sstr, sbox);
  if (!err) err = mrt::tile_map(&mmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, minv, sdims, sstr, sbox);
  if (err) return err;
  auto* kern = q4k_q8_rows_kernel<BM>;
  const int smem = Q4Ring<BM>::smem_bytes(sizeof(Q4MinTiles<BM>));
  const int ksplit = (int)grid.z;
  return mrt::launch_ring(kern, smem, w, out, out_is_bf16, ksplit, B * O, st,
                          [&](void* dst, int mode) {
                            kern<<<grid, mrt::kRowThreads, smem, st>>>(
                                qmap, smap, mmap, w.xq, w.xs, w.xsum, dst, mode, B, w.bpad, K, O,
                                (npairs + ksplit - 1) / ksplit);
                          });
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/quant_matmul.py): K % 64 == 0,
// O % 16 == 0, 16-byte aligned pointers, and a workspace of ws_bytes (see
// mrt::carve). `rows` is the row tile of a block (16: the decode kernel; 64
// or 128: the rows instantiation) and (gx, gy, gz) the grid of the launch
// plan (ops/quant_matmul.int8_gemv_plan), which also gives the K split (gy
// for the decode kernel, gz for the rows instantiation; at most K/64).
// Quantizes x (bf16 or f32 [B,K]) per 32, then runs the GEMV and, unless a
// rows call has one split, the split-K pass. Returns the CUDA error code of
// the launches (0 = launched).
extern "C" int q4k_q8_gemv(const void* x, int x_is_bf16, const void* qs, const void* scale,
                           const void* minv, void* ws, long long ws_bytes, void* out,
                           int out_is_bf16, int B, int K, int O, int rows, int gx, int gy, int gz,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows != 16 && rows != 64 && rows != 128) return (int)cudaErrorInvalidValue;
  const bool tiled = rows != 16;
  const int ksplit = tiled ? gz : gy;
  const mrt::Workspace w = mrt::carve(ws, B, K, O, 32, 32, ksplit, rows);
  if (w.bytes > (size_t)ws_bytes || ksplit < 1 || ksplit > K / 64 ||
      !mrt::grid_covers(w, rows, B, O, gx, gy, gz))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gx, gy, gz);
  mrt::launch_quantize<32>(x, x_is_bf16 != 0, w.xq, w.xs, w.xsum, nullptr, B, K, w.bpad, st,
                           tiled);
  if (tiled) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (rows == 64) return launch_rows<64>(w, qs, scale, minv, out, out_is_bf16, B, K, O, grid, st);
    return launch_rows<128>(w, qs, scale, minv, out, out_is_bf16, B, K, O, grid, st);
  }
  const int npairs = K / 64;
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
