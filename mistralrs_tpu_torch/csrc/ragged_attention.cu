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
// Design: two instantiations, chosen by the host from the most queries a
// sequence has in the step.
// - Chunks (ragged_chunk): the Hopper attention core of csrc/flash_sm90.cuh
//   (K6's: a persistent grid, a TMA-fed ring of K/V tiles, two consumer
//   warpgroups on bf16 wgmma with P from registers, ping-pong). A work item
//   is 128 (query, head) rows of one sequence and one kv head: 128/G
//   consecutive queries times the kv head's G = Hq/Hkv query heads, row
//   r = t * G + g, so every K/V tile staged serves all the query heads that
//   read it. Q comes by TMA through a 4-D map of q_flat seen as (D, G, Hkv,
//   N), one box (64 columns, G heads, 128/G queries) a 64-column block: a
//   box that runs past the sequence reads the next one's queries (past N,
//   zeros), rows that are never stored. K and V come by TMA through one 4-D
//   map of the combined pool, (D, 2*Hkv, page, P), at head 2*kvh and
//   2*kvh + 1, a box of min(page, key tile) slots a page, its page id read
//   from the table on the device (pages past the context are asked for at
//   page P, outside the map, and land as zeros; the V rows of the rest of
//   the last page are zeroed in shared memory, so a stale slot, even a NaN,
//   never reaches the output). An item walks the key tiles from its first
//   query's window start to its last query's position, and masks only the
//   tiles that cross a row's diagonal, its window start or the context's
//   end. The soft cap turns the scaled f32 scores into base-2 logits before
//   the running max (the core folds the scale into the exponent only
//   without a cap). A stage's K and V are freed apart (K once every warp's
//   Q.K^T of it is done, V once its P.V is), so a tile's K loads while the
//   tile before it is in P.V: D = 128 runs K6's tiles, 128 keys in three
//   stages; D = 256 64-key tiles in two (a stage of K and V is 64 KB beside
//   the 64 KB Q tile; freeing whole stages there was 1.38x slower, PERF.md
//   §6), its O accumulators (128 f32 a thread) in the 232 registers
//   setmaxnreg gives the consumers, its output rows staged in the last
//   stage's K and V tiles. The rows of a sequence go out by 16-byte stores
//   from the staged tile, only those that are its queries: a TMA box would
//   also write the next sequence's first rows, which another block owns
//   (TMA for the whole boxes measured no faster). Items run the last query
//   tiles (the most keys) first; an item with no queries does nothing. The
//   grid and tiles come from the Python plan
//   (ops/ragged_attention.py::ragged_chunk_plan), checked here.
// - Decode (ragged_decode, one query a sequence): as K7, a block works on
//   one (sequence, kv head, split of the sequence's keys inside its window)
//   at a time, with the query heads of the kv head as the rows of a 16-row
//   mma tile and each warp taking 16 keys of every 64-key tile (the
//   FlashAttention-2 pieces of csrc/flash_attn.cuh, mma.sync and cp.async);
//   each warp writes (max, exp-sum, unnormalized output) and a second
//   kernel combines the partials in a fixed order. The grid is one wave of
//   CTAs, which take the work items in turn; the number of splits follows
//   the live sequences, read on the device (as many as give every CTA an
//   item), so padding slots cost nothing, and each sequence's keys inside
//   its window are shared evenly among its splits.
#include "flash_attn.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int kNoWindow = 1 << 30;
constexpr int kQRows = 16;  // rows of the decode kernel's mma tile

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

// A work item of the chunk instantiation: 128 (query, head) rows of
// sequence b and kv head kvh (the kv head's G query heads of 128/G
// consecutive queries t0..), over n key tiles from tile t_lo.
struct ChunkItem {
  int n;       // key tiles (0: nothing to attend)
  int b, kvh;  // sequence, kv head
  int t0;      // the item's first query
  int q_len;   // the sequence's queries when the item holds some, else 0
  int q_row0;  // the sequence's first row of q_flat and out
  int pos0;    // the position of query t0
  int len;     // keys the sequence's table holds: min(kv_len, W * page)
  int t_lo;    // the first key tile
  int lo_full; // every row's window holds the keys from here on
};

// Item w of B * Hkv * qtiles: query tile qtiles - 1 - w / (B * Hkv) (the
// last tiles, the most keys, first) of sequence (w % (B * Hkv)) / Hkv, kv
// head w % Hkv.
template <int KT>
__device__ __forceinline__ ChunkItem chunk_item(int w, const int* cu, const int* kv_lens,
                                                int live, int B, int Hkv, int qtiles,
                                                int gshift, int W, int page, int win) {
  ChunkItem it{};
  const int per = B * Hkv, r = w % per, qt = fa3::kRows >> gshift;
  it.b = r / Hkv;
  it.kvh = r % Hkv;
  it.t0 = (qtiles - 1 - w / per) * qt;
  if (it.b >= live) return it;
  it.q_row0 = cu[it.b];
  const int q_len = cu[it.b + 1] - it.q_row0;
  if (it.t0 >= q_len) return it;
  it.q_len = q_len;
  const int kv = kv_lens[it.b];
  it.pos0 = kv - q_len + it.t0;
  const int pos_last = kv - q_len + min(it.t0 + qt, q_len) - 1;
  it.len = min(kv, W * page);
  // keys of the item: from its first query's window start to its last
  // query's position
  const int lo = max(0, it.pos0 - win + 1), hi = min(pos_last, it.len - 1);
  it.t_lo = lo / KT;
  it.n = hi >= lo ? hi / KT + 1 - it.t_lo : 0;
  it.lo_full = pos_last - win + 1;
  return it;
}

template <int D, bool CAP>
__global__ void __launch_bounds__(mrt::kRowThreads, 1)
    ragged_chunk_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kvmap,
                             const int* __restrict__ kv_lens, const int* __restrict__ tables,
                             const int* __restrict__ cu, const int* __restrict__ num_seqs,
                             __nv_bfloat16* __restrict__ out, int B, int Hq, int Hkv, int qtiles,
                             int gshift, int W, int P, int page, int page_shift, int win,
                             float mul, fa3::CapLogit cap) {
  using C = fa3::ChunkCore<D>;
  constexpr int KT = C::kKeys;
  constexpr int kPer = C::kBlocks / 2;  // 64-column blocks a producer warp loads
  extern __shared__ __align__(1024) uint8_t smem[];
  const int live = num_seqs[0];
  const int box = min(page, KT);  // slots of one TMA box
  const int nbox = KT / box;
  std::conditional_t<CAP, fa3::CapLogit, fa3::RawLogit> lg{};
  if constexpr (CAP) lg = cap;
  // out's rows of warpgroup wg's queries tw.. that are the sequence's
  // (the first nr of its 64)
  auto wg_rows = [&](const ChunkItem& it, int wg, int& tw) {
    tw = it.t0 + wg * (64 >> gshift);
    return min(64, max(0, it.q_len - tw) << gshift);
  };
  auto out_row = [&](const ChunkItem& it, int tw, int r) {
    return out + ((size_t)(it.q_row0 + tw + (r >> gshift)) * Hq + (it.kvh << gshift) +
                  (r & ((1 << gshift) - 1))) *
                     D;
  };
  fa3::run_items<C>(
      smem, B * Hkv * qtiles, mul,
      [&](int w) {
        return chunk_item<KT>(w, cu, kv_lens, live, B, Hkv, qtiles, gshift, W, page, win);
      },
      [&](const ChunkItem& it, int t, uint8_t* dst, uint64_t* bar, int piece, uint8_t* q,
          int lane) {
        if (q && lane < C::kBlocks)
          mrt::tma_load_4d(q + lane * C::kQBlock, &qmap, 64 * lane, 0, it.kvh,
                           it.q_row0 + it.t0, bar);
        const int p0 = (it.t_lo + t) * KT, head = 2 * it.kvh + (piece >> 1);
        // lane j issues box j's copy (and j + 32, ...), after reading its
        // page id from the table itself
        for (int j = lane; j < kPer * nbox; j += 32) {
          const int blk = j / nbox, p = p0 + (j - blk * nbox) * box;
          const int pg = p < it.len ? tables[(size_t)it.b * W + (p >> page_shift)] : P;
          mrt::tma_load_4d(dst + blk * C::kKVBlock + (p - p0) * 128, &kvmap,
                           64 * ((piece & 1) * kPer + blk), head, p & (page - 1), pg, bar);
        }
      },
      // a tile is unmasked when its last key is at or before the first
      // query's position, its first key inside the last query's window, and
      // its keys inside the table
      [&](const ChunkItem& it, int tt) {
        const int k0 = (it.t_lo + tt) * KT;
        return k0 + KT - 1 > it.pos0 || k0 < it.lo_full || k0 + KT > it.len;
      },
      [&](const ChunkItem& it, int r, int key) {
        const int p = it.t_lo * KT + key, pos = it.pos0 + (r >> gshift);
        return p <= pos && p > pos - win && p < it.len;
      },
      // the rest of the context's last page, loaded with the tile: P = 0
      // there does not cancel a NaN or Inf that a recycled page's stale
      // slots may hold, so its V rows are zeroed
      [&](const ChunkItem& it, uint8_t* v) {
        const int k0 = (it.t_lo + it.n - 1) * KT;
        const int lo = it.len - k0, hi = min(((it.len + page - 1) & -page) - k0, KT);
        if (lo >= hi) return false;
        for (int i = threadIdx.x & 127; i < (hi - lo) * (D / 8); i += 128) {
          const int c = i % (D / 8);
          *reinterpret_cast<uint4*>(v + (c >> 3) * C::kKVBlock + (lo + i / (D / 8)) * 128 +
                                    (c & 7) * 16) = make_uint4(0u, 0u, 0u, 0u);
        }
        return true;
      },
      // queries that see no key (a table shorter than the context): zeros
      [&](const ChunkItem& it, int wg) {
        int tw;
        const int nr = wg_rows(it, wg, tw);
        for (int i = threadIdx.x & 127; i < nr * (D / 8); i += 128)
          *reinterpret_cast<uint4*>(out_row(it, tw, i / (D / 8)) + 8 * (i % (D / 8))) =
              make_uint4(0u, 0u, 0u, 0u);
      },
      lg,
      // 16-byte stores of the rows that are the sequence's, from the staged
      // tile (16-byte chunk c of row r at chunk (c & 7) ^ (r & 7) of its
      // 64-column block): a TMA box would also write the next sequence's
      // rows, another item's
      [&](const ChunkItem& it, int wg, const float(&o)[D / 2], float(&l)[2], uint8_t* rows) {
        fa3::stage_out<C>(o, l, wg, rows);
        int tw;
        const int nr = wg_rows(it, wg, tw);
        for (int i = threadIdx.x & 127; i < nr * (D / 8); i += 128) {
          const int r = i / (D / 8), c = i % (D / 8);
          *reinterpret_cast<uint4*>(out_row(it, tw, r) + 8 * c) =
              *reinterpret_cast<const uint4*>(rows + (c >> 3) * C::kKVBlock + r * 128 +
                                              (((c & 7) ^ (r & 7)) << 4));
        }
        fa3::bar_sync(3 + wg, 128);
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

// The maps of a chunk call, both with the 128-byte swizzle: q_flat [N, Hq,
// D] as (D, G, Hkv, N) in boxes of 64 columns x G heads x 128/G queries (a
// Q tile's 64-column block, row t * G + g); the combined pool [P, page,
// 2*Hkv, D] as (D, 2*Hkv, page, P) in boxes of 64 columns x one head x
// `box` slots.
int q_map(CUtensorMap* map, const void* q, int N, int G, int Hkv, int D) {
  const uint64_t row = (uint64_t)D * 2;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)G, (uint64_t)Hkv, (uint64_t)N};
  const uint64_t str[3] = {row, row * G, row * G * Hkv};
  const uint32_t bx[4] = {64, (uint32_t)G, 1, (uint32_t)(fa3::kRows / G)};
  return mrt::tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, q, dims, str, bx,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}
int pool_map(CUtensorMap* map, const void* pool, int P, int page, int Hkv, int D, int box) {
  const uint64_t row = (uint64_t)D * 2;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)(2 * Hkv), (uint64_t)page, (uint64_t)P};
  const uint64_t str[3] = {row, row * 2 * Hkv, row * 2 * Hkv * page};
  const uint32_t bx[4] = {64, 1, (uint32_t)box, 1};
  return mrt::tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, pool, dims, str, bx,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// A chunk call at head dim D on the plan's launch, which must be this
// configuration's (rows, key tile, stages, threads, enough shared memory)
// with 1 to B * Hkv * query tiles blocks in x.
template <int D>
int launch_chunk(const Args& a, void* out, int N, int max_q_len, int P, int rows, int keys,
                 int stages, int threads, int gx, int gy, int gz, int smem) {
  using C = fa3::ChunkCore<D>;
  const int G = a.Hq / a.Hkv, gshift = __builtin_ctz((unsigned)G);
  if (G < 1 || G > 16 || (1 << gshift) != G || max_q_len < 1)
    return (int)cudaErrorInvalidValue;
  const int qt = fa3::kRows >> gshift, qtiles = (max_q_len + qt - 1) / qt;
  if (rows != fa3::kRows || keys != C::kKeys || stages != C::kStages ||
      threads != mrt::kRowThreads || gx < 1 || gx > a.B * a.Hkv * qtiles || gy != 1 || gz != 1 ||
      smem < C::kSmemBytes)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kvmap;
  int err = q_map(&qmap, a.q, N, G, a.Hkv, D);
  if (!err) err = pool_map(&kvmap, a.pool, P, a.page, a.Hkv, D, min(a.page, C::kKeys));
  if (err) return err;
  const bool cap = a.softcap > 0.f;
  const fa3::CapLogit lg{cap ? a.scale / a.softcap : 0.f, a.softcap * fa3::kLog2e};
  const float mul = cap ? 1.f : a.scale * fa3::kLog2e;
  auto go = [&](auto kern) {
    return fa3::launch(kern, dim3(gx, gy, gz), smem, a.st, qmap, kvmap, a.kv_lens,
                       a.tables, a.cu, a.num_seqs, static_cast<__nv_bfloat16*>(out), a.B, a.Hq,
                       a.Hkv, qtiles, gshift, a.W, P, a.page, a.page_shift, a.win, mul, lg);
  };
  return cap ? go(ragged_chunk_sm90_kernel<D, true>) : go(ragged_chunk_sm90_kernel<D, false>);
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

// Any number of queries a sequence, at most max_q_len: N rows of q_flat
// and out, P pages in the pool; scale > 0 without a soft cap. The launch
// (rows, key tile, stages, threads, grid and shared memory) comes from the
// plan (ops/ragged_attention.py::ragged_chunk_plan) and is checked here.
extern "C" int ragged_chunk(const void* q, const void* pool, const void* kv_lens,
                            const void* tables, const void* cu, const void* num_seqs, void* out,
                            int N, int B, int max_q_len, int Hq, int Hkv, int W, int P, int page,
                            int page_shift, int D, float scale, float softcap, int window,
                            int rows, int keys, int stages, int threads, int gx, int gy, int gz,
                            int smem, void* stream) {
  const Args a = make_args(q, pool, kv_lens, tables, cu, num_seqs, B, Hq, Hkv, W, page,
                           page_shift, scale, softcap, window, stream);
  if (D == 128)
    return launch_chunk<128>(a, out, N, max_q_len, P, rows, keys, stages, threads, gx, gy, gz,
                             smem);
  if (D == 256)
    return launch_chunk<256>(a, out, N, max_q_len, P, rows, keys, stages, threads, gx, gy, gz,
                             smem);
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
