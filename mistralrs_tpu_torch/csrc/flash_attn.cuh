// Pieces shared by the attention kernels K7 (paged_decode.cu), K11
// (splash_prefill.cu) and K12 (ragged_attention.cu): FlashAttention-2 on
// bf16 mma.sync tensor cores, head dim D = 128 or 256. (K6 and K6' run on
// the Hopper core of flash_sm90.cuh.)
//
// Tiles of rows x D bf16 (2D-byte rows) are staged in shared memory by
// 16-byte cp.async copies; the 16-byte chunk c of row r sits at r * 2D +
// ((c ^ (r & 7)) << 4), so the ldmatrix reads below are conflict-free. A
// warp owns 16 query rows: it takes their Q fragments from registers (D =
// 128) or reads them again from the staged tile at each use (D = 256, where
// the 128 f32 output accumulators a thread leave no room for them),
// computes a 16 x NK score tile with mma.m16n8k16 (f32 accumulators), turns
// the scores into base-2 logits (scale, and an optional tanh soft cap, in
// f32), runs the online softmax in base 2 in f32, and feeds the
// probabilities, rounded to bf16, straight from the accumulator registers as
// the A operand of P.V (V read with ldmatrix.trans).
//
// Accumulator layout of mma.m16n8k16 (lane = 4g + t): n-tile j holds
// columns 8j..8j+7; element e of it is row g + 8 * (e >> 1), column
// 8j + 2t + (e & 1).
#pragma once

#include "common.cuh"

namespace fa {

constexpr int kTileRows = 64;  // rows of a staged Q tile, and of a K/V tile at D = 128
constexpr int kThreads = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int row_bytes() {
  return 2 * D;
}

// byte offset of the 16-byte chunk c of row r in a staged tile
template <int D>
__device__ __forceinline__ uint32_t swz_off(int r, int c) {
  return r * row_bytes<D>() + ((c ^ (r & 7)) << 4);
}

// Stage ROWS rows of D bf16 into a tile: the first n from src + off(r) (an
// element offset), the rest zero-filled (their source is not read). Each
// thread copies one fixed 16-byte column of every few rows.
template <int D, int ROWS, class RowOff>
__device__ __forceinline__ void stage_rows(uint8_t* tile, int n, const __nv_bfloat16* src,
                                           RowOff off) {
  for (int i = threadIdx.x; i < ROWS * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = r < n;
    mrt::cp_async16(tile + swz_off<D>(r, c), src + (ok ? off(r) + 8 * c : 0), ok);
  }
}

// The same for the K and V tiles of one key tile: row r of both sits at the
// same offset of its pool, so it is looked up once.
template <int D, int ROWS, class RowOff>
__device__ __forceinline__ void stage_kv(uint8_t* ktile, uint8_t* vtile, int n,
                                         const __nv_bfloat16* k, const __nv_bfloat16* v,
                                         RowOff off) {
  for (int i = threadIdx.x; i < ROWS * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = r < n;
    const size_t o = ok ? off(r) + 8 * c : 0;
    mrt::cp_async16(ktile + swz_off<D>(r, c), k + o, ok);
    mrt::cp_async16(vtile + swz_off<D>(r, c), v + o, ok);
  }
}

using mrt::ldsm_x4;
using mrt::ldsm_x4_trans;
using mrt::mma_bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of a warp's 16 query rows row0..row0+15 of a staged Q
// tile (ldmatrix matrices 0..3: rows +0/+8 (lm & 1) x dims +0/+8 (lm >> 1)),
// held in registers ...
template <int D>
struct QInRegs {
  uint32_t f[D / 16][4];
  __device__ __forceinline__ void load(uint32_t qbase, int row0) {
    const int lane = threadIdx.x & 31, lr = lane & 7, lm = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(qbase + swz_off<D>(row0 + 8 * (lm & 1) + lr, 2 * kk + (lm >> 1)), f[kk]);
  }
  __device__ __forceinline__ void frag(int kk, uint32_t (&a)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = f[kk][i];
  }
};

// ... or read from the tile again at each use (the tile must stay in place)
template <int D>
struct QInSmem {
  uint32_t base;  // this lane's row of the tile
  int row, half;
  __device__ __forceinline__ void load(uint32_t qbase, int row0) {
    const int lane = threadIdx.x & 31;
    row = row0 + 8 * ((lane >> 3) & 1) + (lane & 7);
    half = lane >> 4;
    base = qbase;
  }
  __device__ __forceinline__ void frag(int kk, uint32_t (&a)[4]) const {
    ldsm_x4(base + swz_off<D>(row, 2 * kk + half), a);
  }
};

// registers at D = 128, the staged tile at D = 256
template <int D>
struct QFragsOf {
  using type = QInRegs<D>;
};
template <>
struct QFragsOf<256> {
  using type = QInSmem<256>;
};
template <int D>
using QFrags = typename QFragsOf<D>::type;

// A raw score s = q . k as a base-2 logit: s * scale * log2(e), or with a
// soft cap, cap * log2(e) * tanh(s * scale / cap) (tanhf: the soft cap of
// Gemma-2 is 50, so tanh's error is scaled 50-fold into the logit).
template <bool CAP>
struct Logit;
template <>
struct Logit<false> {
  float mul;  // scale * log2(e)
  __host__ __device__ static Logit make(float scale, float) { return {scale * kLog2e}; }
  __device__ __forceinline__ float operator()(float s) const { return s * mul; }
};
template <>
struct Logit<true> {
  float mul, cap2;  // scale / cap, cap * log2(e)
  __host__ __device__ static Logit make(float scale, float cap) {
    return {scale / cap, cap * kLog2e};
  }
  __device__ __forceinline__ float operator()(float s) const { return cap2 * tanhf(s * mul); }
};

// Running state of one warp's 16 query rows: rows g and g + 8 of this lane.
template <int D>
struct RowState {
  float o[D / 8][4];  // output accumulators: n-tile j holds dims 8j..8j+7
  float m[2];         // running max (base-2 logits); -inf before any key
  float l[2];         // this lane's part of the running exp-sum
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
  // l summed over the 4 lanes (quad) that hold a row
  __device__ __forceinline__ void reduce_l() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }
};

// One warp attends its 16 query rows (fragments q) to NK keys: rows
// krow0..krow0+NK-1 of the staged K and V tiles at kbase / vbase. lg turns
// each score into a logit. When `masked`, keep(row, key) (row 0..15 of the
// warp, key 0..NK-1 of this call) says whether a score counts; a row that
// has seen no key yet keeps m = -inf, l = 0 and o = 0, so fully masked rows
// stay finite.
template <int D, int NK, class QF, class Lg, class Keep>
__device__ __forceinline__ void attend(uint32_t kbase, uint32_t vbase, int krow0, const QF& q,
                                       RowState<D>& st, Lg lg, bool masked, Keep keep) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;

  // S = Q K^T: n-tile j holds keys 8j..8j+7
  float s[NK / 8][4];
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[4];
    q.frag(kk, qa);
#pragma unroll
    for (int jp = 0; jp < NK / 16; ++jp) {
      // matrices: keys +0/+8 (lm >> 1) x dims +0/+8 (lm & 1) = b0, b1 of
      // n-tiles 2jp and 2jp + 1
      uint32_t bf[4];
      ldsm_x4(kbase + swz_off<D>(krow0 + 16 * jp + 8 * (lm >> 1) + lr, 2 * kk + (lm & 1)), bf);
      mma_bf16(s[2 * jp], qa, bf[0], bf[1]);
      mma_bf16(s[2 * jp + 1], qa, bf[2], bf[3]);
    }
  }

  // online softmax, base 2
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = lg(s[j][e]);
      if (masked && !keep(g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1))) x = -INFINITY;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2], msub[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the 4 lanes of a quad hold one row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const bool none = mx[r] == -INFINITY;  // no key of this row so far
    alpha[r] = none ? 1.f : exp2f(st.m[r] - mx[r]);
    msub[r] = none ? 0.f : mx[r];
    st.m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(s[j][e] - msub[e >> 1]);
      rs[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + rs[r];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] *= alpha[e >> 1];

  // O += P V: the S accumulators of n-tiles 2kk, 2kk + 1 are the A fragment
  // of keys 16kk..16kk+15
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int jp = 0; jp < D / 16; ++jp) {
      // matrices (transposed): keys +0/+8 (lm & 1) x dims +0/+8 (lm >> 1)
      // = b0, b1 of n-tiles 2jp and 2jp + 1
      uint32_t bf[4];
      ldsm_x4_trans(vbase + swz_off<D>(krow0 + 16 * kk + 8 * (lm & 1) + lr, 2 * jp + (lm >> 1)),
                    bf);
      mma_bf16(st.o[2 * jp], pa, bf[0], bf[1]);
      mma_bf16(st.o[2 * jp + 1], pa, bf[2], bf[3]);
    }
  }
}

// Shared memory of the prefill kernels K11 and K12: a 64-row Q tile,
// then the K and V tiles (KT rows each) of two stages.
template <int D, int KT>
__host__ __device__ constexpr size_t prefill_smem_bytes() {
  return (size_t)kTileRows * row_bytes<D>() + 4 * (size_t)KT * row_bytes<D>();
}

// The block loop of K11 and K12: the block's 64 query rows (staged by
// the caller at offset 0 and not yet committed) against key tiles
// t_lo..t_hi-1 of KT rows, staged by stage_kv(it, k_tile, v_tile) and
// double-buffered. on_q() runs once the Q tile has arrived, before its
// fragments are read (it may rewrite the tile and then __syncthreads()).
// Tile it asks keep(row, key) (row 0..63 of the block, key index from 0)
// for each score when masked(it).
template <int D, int KT, class QF, class Lg, class StageKV, class OnQ, class Masked, class Keep>
__device__ __forceinline__ void prefill_rows(uint8_t* smem, int t_lo, int t_hi, Lg lg,
                                             StageKV stage_kv, OnQ on_q, Masked masked, Keep keep,
                                             RowState<D>& st) {
  constexpr int kQBytes = kTileRows * row_bytes<D>();
  constexpr int kKVBytes = KT * row_bytes<D>();
  const uint32_t sbase = mrt::smem_u32(smem);
  const int warp = threadIdx.x >> 5;
  if (t_lo < t_hi) stage_kv(t_lo, smem + kQBytes, smem + kQBytes + kKVBytes);
  mrt::cp_async_commit();
  QF q;
  st.init();
  for (int it = t_lo; it < t_hi; ++it) {
    const int sg = (it - t_lo) & 1;
    if (it + 1 < t_hi) {
      uint8_t* next = smem + kQBytes + 2 * (sg ^ 1) * kKVBytes;
      stage_kv(it + 1, next, next + kKVBytes);
      mrt::cp_async_commit();
      mrt::cp_async_wait<1>();
    } else {
      mrt::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == t_lo) {
      on_q();
      q.load(sbase, warp * 16);
    }
    const int k0 = it * KT;
    const uint32_t kb = sbase + kQBytes + 2 * sg * kKVBytes;
    attend<D, KT>(kb, kb + kKVBytes, 0, q, st, lg, masked(it),
                  [&](int r, int kj) { return keep(warp * 16 + r, k0 + kj); });
    __syncthreads();  // this stage's K/V are free for the tile after next
  }
  mrt::cp_async_wait<0>();  // nothing left in flight when no tile ran
}

// Normalize a warp's rows and write them as bf16: row r (0..15 of the
// warp) goes to out_row(r), or nowhere when that is null. A row that saw no
// key is written as zeros.
template <int D, class OutRow>
__device__ __forceinline__ void store_rows(RowState<D>& st, OutRow out_row) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  st.reduce_l();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* op = out_row(g + 8 * r);
    if (op == nullptr) continue;
    const float inv = st.l[r] > 0.f ? 1.f / st.l[r] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(op + 8 * j + 2 * t) =
          pack_bf16(st.o[j][2 * r] * inv, st.o[j][2 * r + 1] * inv);
  }
}

}  // namespace fa
