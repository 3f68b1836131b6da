// K12: ragged paged attention over a combined K/V pool, for continuation
// chunks and decode steps alike, with an optional sliding window and an
// optional tanh soft cap.
//
// Replaces the TPU library kernel jax.experimental.pallas.ops.tpu
// .ragged_paged_attention, called by mistralrs_tpu/ops/ragged_attention.py
// ::ragged_attention (from ragged_attention_padded, the decoder's route on
// the ragged backend).
//
// q [N,Hq,D] bf16, queries packed by sequence: sequence i < num_seqs[0] owns
// rows cu[i] .. cu[i+1]-1, and its query j sits at position kv_lens[i] -
// q_len + j. It attends to the positions p <= its own, and with a window w
// to p > its own - w, read through tables[i] (int32 [B, W]) from one
// layer's combined pool [P,page,2*Hkv,D] bf16: K of kv head h at head index
// 2h, V at 2h + 1 (a token-major pool whose slot stride is 2*Hkv*D and
// whose V sits D elements after its K). out [N,Hq,D] bf16; D = 128 or 256;
// Hq/Hkv a power of two up to 16. As the reference: the scale is applied
// to the f32 scores, then cap * tanh(s / cap) (tanhf) when a cap is given,
// then the mask; the softmax runs in f32 (online, base 2) and P is rounded
// to bf16 for P.V, which accumulates in f32. Rows of sequences at or past
// num_seqs are not written. Nothing is read from the host: the grid is
// sized by what the host knows (sequences B, the most queries a sequence
// has) and a block with nothing to do exits.
//
// What bounds it on an H100: bytes at decode (every key costs 2 x 2D bytes
// of K and V against 4 * D * Hq/Hkv flops, ~4 flops a byte), operations on
// chunks of hundreds of rows (4 * D flops per kept (query, key) pair of
// every query head against the K/V read once).
// Design: two instantiations of the FlashAttention-2 pieces of
// csrc/flash_attn.cuh, chosen by the host from the most queries a sequence
// has in the step.
// - Chunks (ragged_chunk): a block of 4 warps owns 64 rows of one sequence
//   and one kv head, each row a (query, head) pair of the kv head's
//   Hq/Hkv query heads (64 / (Hq/Hkv) consecutive queries), so every K/V
//   tile staged serves all the query heads that read it. It walks the
//   64-key tiles (32 at D = 256, where a warp reads its Q fragments from
//   shared memory) from its first query's window start to its last query's
//   position, looked up page by page in the table, double-buffered with
//   cp.async, masking only tiles that cross the diagonal or the window
//   start. As K6' and K11.
// - Decode (ragged_decode, one query a sequence): as K7, a block works on
//   one (sequence, kv head, split of the sequence's keys inside its window)
//   at a time, with the query heads of the kv head as the rows of a 16-row
//   mma tile and each warp taking 16 keys of every 64-key tile; each warp
//   writes (max, exp-sum, unnormalized output) and a second kernel combines
//   the partials in a fixed order. The grid is one wave of CTAs, which take
//   the work items in turn; the number of splits follows the live
//   sequences, read on the device (as many as give every CTA an item), so
//   padding slots cost nothing, and each sequence's keys inside its window
//   are shared evenly among its splits.
// wgmma and TMA are later work.
#include "flash_attn.cuh"

namespace {

constexpr int kNoWindow = 1 << 30;
constexpr int kQRows = 16;  // rows of the decode kernel's mma tile

template <int D>
__host__ __device__ constexpr int chunk_key_tile() {
  return D == 256 ? 32 : 64;
}

// element offset of a key position's slot in the combined pool, through
// one sequence's table (the K of kv head 0; add 2 * kvh * D for kv head kvh,
// and D more for its V); s_page and s_slot stay kernel parameters
__device__ __forceinline__ size_t pool_slot(const int* table, int p, int page, int page_shift,
                                            long long s_page, long long s_slot) {
  return (size_t)table[p >> page_shift] * s_page + (size_t)(p & (page - 1)) * s_slot;
}

// Splits of each live (sequence, kv head) pair in the decode kernel: as
// many as give every CTA of the kernel's one wave (`ctas`) a split, at most
// `max_splits` (the stride of the partials).
__device__ __forceinline__ int live_splits(int live, int Hkv, int ctas, int max_splits) {
  return min(max_splits, max(1, ctas / max(1, live * Hkv)));
}

template <int D, bool CAP>
__global__ void __launch_bounds__(fa::kThreads)
    ragged_chunk_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ pool, const int* __restrict__ kv_lens,
                        const int* __restrict__ tables, const int* __restrict__ cu,
                        const int* __restrict__ num_seqs, __nv_bfloat16* __restrict__ out, int Hq,
                        int Hkv, int W, int page, int page_shift, long long s_page,
                        long long s_slot, int win, fa::Logit<CAP> lg) {
  constexpr int KT = chunk_key_tile<D>();
  constexpr int BQ = fa::kTileRows;  // (query, head) rows per block, 16 per warp
  extern __shared__ __align__(128) uint8_t smem[];
  const int kvh = blockIdx.y, b = blockIdx.z;
  if (b >= num_seqs[0]) return;
  const int G = Hq / Hkv;
  const int per_block = BQ / G;  // queries per block
  const int q_start = cu[b], q_len = cu[b + 1] - q_start, kv_len = kv_lens[b];
  const int t0 = (gridDim.x - 1 - blockIdx.x) * per_block;  // the longest rows first
  if (t0 >= q_len) return;
  const int warp = threadIdx.x >> 5;
  const int pos_first = kv_len - q_len + t0;
  const int pos_last = kv_len - q_len + min(t0 + per_block, q_len) - 1;
  const int len = min(kv_len, W * page);
  // keys of the block: from its first query's window start to its last
  // query's position
  const int lo = max(0, pos_first - win + 1);
  const int hi = min(pos_last, len - 1);
  const int t_lo = lo / KT;
  const int t_hi = hi >= lo ? hi / KT + 1 : t_lo;
  // every row keeps every key of a tile that ends at or before the first
  // query's position and starts inside the last query's window
  const int lo_full = pos_last - win + 1;
  const int* table = tables + (size_t)b * W;
  const __nv_bfloat16* kpool = pool + (size_t)2 * kvh * D;

  const size_t q_row0 = ((size_t)(q_start + t0) * Hq + kvh * G) * D;
  fa::stage_rows<D, BQ>(smem, (q_len - t0) * G, q, [&](int r) -> size_t {
    return q_row0 + ((size_t)(r / G) * Hq + r % G) * D;
  });
  fa::RowState<D> st;
  fa::prefill_rows<D, KT, fa::QFrags<D>>(
      smem, t_lo, t_hi, lg,
      [&](int it, uint8_t* kt, uint8_t* vt) {
        const int p0 = it * KT;
        fa::stage_kv<D, KT>(kt, vt, len - p0, kpool, kpool + D, [&](int r) {
          return pool_slot(table, p0 + r, page, page_shift, s_page, s_slot);
        });
      },
      [] {}, [&](int it) { return it * KT + KT - 1 > pos_first || it * KT < lo_full; },
      [&](int row, int p) {
        const int pos = pos_first + row / G;
        return p <= pos && p > pos - win;
      },
      st);
  fa::store_rows(st, [&](int r) -> __nv_bfloat16* {
    const int row = warp * 16 + r, t = t0 + row / G;
    return t < q_len ? out + ((size_t)(q_start + t) * Hq + kvh * G + row % G) * D : nullptr;
  });
}

template <int D>
__host__ __device__ constexpr size_t decode_q_bytes() {
  return (size_t)kQRows * fa::row_bytes<D>();
}
template <int D>
__host__ __device__ constexpr size_t decode_kv_bytes() {  // the K or the V of a 64-key tile
  return (size_t)fa::kTileRows * fa::row_bytes<D>();
}
template <int D>
__host__ __device__ constexpr size_t decode_smem_bytes() {
  return decode_q_bytes<D>() + 4 * decode_kv_bytes<D>();
}

template <int D, bool CAP>
__global__ void __launch_bounds__(fa::kThreads)
    ragged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ pool, const int* __restrict__ kv_lens,
                         const int* __restrict__ tables, const int* __restrict__ cu,
                         const int* __restrict__ num_seqs, float* __restrict__ part_o,
                         float* __restrict__ part_ml, int Hq, int Hkv, int W, int page,
                         int page_shift, long long s_page, long long s_slot, int win,
                         int max_splits, fa::Logit<CAP> lg) {
  constexpr size_t kQBytes = decode_q_bytes<D>(), kKVBytes = decode_kv_bytes<D>();
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = mrt::smem_u32(smem);
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int live = num_seqs[0];
  const int splits = live_splits(live, Hkv, gridDim.x, max_splits);
  const int parts = 4 * max_splits;  // the partials' stride: one a warp of each split
  // work items (sequence, kv head, split), split fastest, taken by the CTAs
  // in turn
  for (int item = blockIdx.x; item < live * Hkv * splits; item += gridDim.x) {
    const int split = item % splits, kvh = item / splits % Hkv, b = item / (splits * Hkv);
    const int q_row = cu[b];
    if (cu[b + 1] - q_row != 1) continue;  // no query: nothing to combine either
    const int part = split * 4 + warp;
    const int kv_len = kv_lens[b];
    const int len = max(0, min(kv_len, W * page));
    const int lo = max(0, kv_len - win);  // the window of the query at kv_len - 1
    // this split's share of the tiles that hold a kept key
    const int tl = lo / fa::kTileRows, th = (len + fa::kTileRows - 1) / fa::kTileRows;
    const int per = (max(0, th - tl) + splits - 1) / splits;
    const int t0 = tl + split * per;
    const int t1 = min(t0 + per, th);
    const int* table = tables + (size_t)b * W;
    const __nv_bfloat16* kpool = pool + (size_t)2 * kvh * D;

    auto stage_tile = [&](int it, int sg) {
      uint8_t* kt = smem + kQBytes + 2 * sg * kKVBytes;
      const int p0 = it * fa::kTileRows;
      fa::stage_kv<D, fa::kTileRows>(kt, kt + kKVBytes, len - p0, kpool, kpool + D, [&](int r) {
        return pool_slot(table, p0 + r, page, page_shift, s_page, s_slot);
      });
    };

    fa::RowState<D> st;
    st.init();
    if (t0 < t1) {
      fa::stage_rows<D, kQRows>(smem, G, q, [&](int r) -> size_t {
        return ((size_t)q_row * Hq + kvh * G + r) * D;
      });
      stage_tile(t0, 0);
      mrt::cp_async_commit();
      fa::QFrags<D> qf;
      for (int it = t0; it < t1; ++it) {
        const int sg = (it - t0) & 1;
        if (it + 1 < t1) {
          stage_tile(it + 1, sg ^ 1);
          mrt::cp_async_commit();
          mrt::cp_async_wait<1>();
        } else {
          mrt::cp_async_wait<0>();
        }
        __syncthreads();
        if (it == t0) qf.load(sbase, 0);
        const int p0 = it * fa::kTileRows + warp * 16;  // this warp's 16 keys
        const uint32_t kbase = sbase + kQBytes + 2 * sg * kKVBytes;
        fa::attend<D, 16>(kbase, kbase + kKVBytes, warp * 16, qf, st, lg,
                          p0 < lo || p0 + 16 > len,
                          [&](int, int kj) { return p0 + kj >= lo && p0 + kj < len; });
        __syncthreads();  // this stage (and, after the last tile, the Q tile) is free
      }
    }

    // this warp's partial for each real query row (rows g and g + 8)
    st.reduce_l();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row >= G) continue;
      const size_t base = ((size_t)b * Hq + kvh * G + row) * parts + part;
      if (t == 0) {
        part_ml[2 * base] = st.m[r];
        part_ml[2 * base + 1] = st.l[r];
      }
      float* po = part_o + base * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(po + 8 * j + 2 * t) =
            make_float2(st.o[j][2 * r], st.o[j][2 * r + 1]);
    }
  }
}

// out[row, h, d] = sum_p o_p[d] 2^(m_p - M) / sum_p l_p 2^(m_p - M), over the
// partials p of the splits that ran, in order; partials that saw no key
// (m = -inf) are skipped. `stride` partials are laid out for each (b, h).
template <int D>
__global__ void __launch_bounds__(D)
    ragged_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                          const int* __restrict__ cu, const int* __restrict__ num_seqs,
                          __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int ctas,
                          int max_splits) {
  const size_t bh = blockIdx.x;
  const int b = (int)(bh / Hq), h = (int)(bh % Hq);
  if (b >= num_seqs[0] || cu[b + 1] - cu[b] != 1) return;
  const int d = threadIdx.x;
  const int parts = 4 * live_splits(num_seqs[0], Hkv, ctas, max_splits);
  const size_t stride = 4 * (size_t)max_splits;
  const float* ml = part_ml + bh * stride * 2;
  float M = -INFINITY;
  for (int p = 0; p < parts; ++p) M = fmaxf(M, ml[2 * p]);
  float L = 0.f, acc = 0.f;
  if (M != -INFINITY) {
    for (int p = 0; p < parts; ++p) {
      const float mp = ml[2 * p];
      if (mp == -INFINITY) continue;
      const float w = exp2f(mp - M);
      L += ml[2 * p + 1] * w;
      acc += part_o[(bh * stride + p) * D + d] * w;
    }
  }
  out[((size_t)cu[b] * Hq + h) * D + d] = __float2bfloat16_rn(L > 0.f ? acc / L : 0.f);
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* pool;
  const int *kv_lens, *tables, *cu, *num_seqs;
  int B, Hq, Hkv, W, page, page_shift, win;
  float scale, softcap;
  cudaStream_t st;
  // element strides of a page and a slot of the combined pool
  template <int D>
  long long s_slot() const {
    return 2LL * Hkv * D;
  }
  template <int D>
  long long s_page() const {
    return (long long)page * s_slot<D>();
  }
};

template <int D, bool CAP>
int launch_chunk(const Args& a, __nv_bfloat16* out, int max_q_len) {
  constexpr size_t smem = fa::prefill_smem_bytes<D, chunk_key_tile<D>()>();
  cudaError_t err = mrt::allow_smem(ragged_chunk_kernel<D, CAP>, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_block = fa::kTileRows / (a.Hq / a.Hkv);
  const dim3 grid((max_q_len + per_block - 1) / per_block, a.Hkv, a.B);
  ragged_chunk_kernel<D, CAP><<<grid, fa::kThreads, smem, a.st>>>(
      a.q, a.pool, a.kv_lens, a.tables, a.cu, a.num_seqs, out, a.Hq, a.Hkv, a.W, a.page,
      a.page_shift, a.s_page<D>(), a.s_slot<D>(), a.win,
      fa::Logit<CAP>::make(a.scale, a.softcap));
  return (int)cudaGetLastError();
}

template <int D, bool CAP>
int launch_decode(const Args& a, float* part_o, float* part_ml, __nv_bfloat16* out,
                  int max_splits, int ctas) {
  cudaError_t err = mrt::allow_smem(ragged_decode_kernel<D, CAP>, (int)decode_smem_bytes<D>());
  if (err != cudaSuccess) return (int)err;
  ragged_decode_kernel<D, CAP><<<ctas, fa::kThreads, decode_smem_bytes<D>(), a.st>>>(
      a.q, a.pool, a.kv_lens, a.tables, a.cu, a.num_seqs, part_o, part_ml, a.Hq, a.Hkv, a.W,
      a.page, a.page_shift, a.s_page<D>(), a.s_slot<D>(), a.win, max_splits,
      fa::Logit<CAP>::make(a.scale, a.softcap));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ragged_combine_kernel<D><<<a.B * a.Hq, D, 0, a.st>>>(part_o, part_ml, a.cu, a.num_seqs, out,
                                                       a.Hq, a.Hkv, ctas, max_splits);
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* pool, const void* kv_lens, const void* tables,
               const void* cu, const void* num_seqs, int B, int Hq, int Hkv, int W, int page,
               int page_shift, float scale, float softcap, int window, void* stream) {
  return Args{static_cast<const __nv_bfloat16*>(q),
              static_cast<const __nv_bfloat16*>(pool),
              static_cast<const int*>(kv_lens),
              static_cast<const int*>(tables),
              static_cast<const int*>(cu),
              static_cast<const int*>(num_seqs),
              B, Hq, Hkv, W, page, page_shift,
              window > 0 ? window : kNoWindow,
              scale, softcap,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Shapes, layouts and types are checked by the Python wrapper
// (ops/ragged_attention.py::ragged_attention): head dim D = 128 or 256,
// Hq/Hkv a power of two up to 16, a page size of 2^page_shift, contiguous
// 16-byte aligned bf16 q and pool, int32 kv_lens [B], tables [B, W], cu
// [B+1] and num_seqs [1]. window <= 0 means none; softcap <= 0 means none.
// Each returns the CUDA error code of its launches (0 = launched;
// cudaErrorInvalidValue for another D).

// Any number of queries a sequence, at most max_q_len.
extern "C" int ragged_chunk(const void* q, const void* pool, const void* kv_lens,
                            const void* tables, const void* cu, const void* num_seqs, void* out,
                            int B, int max_q_len, int Hq, int Hkv, int W, int page,
                            int page_shift, int D, float scale, float softcap, int window,
                            void* stream) {
  const Args a = make_args(q, pool, kv_lens, tables, cu, num_seqs, B, Hq, Hkv, W, page,
                           page_shift, scale, softcap, window, stream);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const bool cap = softcap > 0.f;
  if (D == 128) return cap ? launch_chunk<128, true>(a, o, max_q_len)
                           : launch_chunk<128, false>(a, o, max_q_len);
  if (D == 256) return cap ? launch_chunk<256, true>(a, o, max_q_len)
                           : launch_chunk<256, false>(a, o, max_q_len);
  return (int)cudaErrorInvalidValue;
}

// At most one query a sequence; `ctas` CTAs (one wave) take the work items
// in turn, each live (sequence, kv head) pair's keys split min(max_splits,
// ctas / (num_seqs * Hkv)) ways; f32 scratch part_o [B,Hq,4*max_splits,D]
// and part_ml [B,Hq,4*max_splits,2].
extern "C" int ragged_decode(const void* q, const void* pool, const void* kv_lens,
                             const void* tables, const void* cu, const void* num_seqs,
                             void* part_o, void* part_ml, void* out, int B, int Hq, int Hkv,
                             int W, int page, int page_shift, int max_splits, int ctas, int D,
                             float scale, float softcap, int window, void* stream) {
  const Args a = make_args(q, pool, kv_lens, tables, cu, num_seqs, B, Hq, Hkv, W, page,
                           page_shift, scale, softcap, window, stream);
  float* po = static_cast<float*>(part_o);
  float* pm = static_cast<float*>(part_ml);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const bool cap = softcap > 0.f;
  if (D == 128) return cap ? launch_decode<128, true>(a, po, pm, o, max_splits, ctas)
                           : launch_decode<128, false>(a, po, pm, o, max_splits, ctas);
  if (D == 256) return cap ? launch_decode<256, true>(a, po, pm, o, max_splits, ctas)
                           : launch_decode<256, false>(a, po, pm, o, max_splits, ctas);
  return (int)cudaErrorInvalidValue;
}
