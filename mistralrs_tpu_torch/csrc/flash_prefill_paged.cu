// K6': causal flash attention of a continuation prefill chunk over its
// paged context.
//
// Replaces the TPU library kernel jax.experimental.pallas.ops.tpu
// .flash_attention as mistralrs_tpu/ops/paged_attention.py
// ::flash_prefill_continuation calls it (right-aligned span + segment ids),
// on continuation chunks of at most a 4096-token span.
//
// q [B,T,Hq,D] bf16, the chunk's queries; query i of row b sits at position
// kv_lens[b] - T + i (a chunk padded from n to T rows has kv_len = start +
// T, so its real queries sit at start + i). It attends to the positions p
// <= its own with p < kv_lens[b], read through block_tables[b] (int64
// [B, MP]) from one layer's K and V pools, token-major [P,page,Hkv,D] or
// head-major [Hkv,P,page,D]. out [B,T,Hq,D] bf16; D = 128. Query head h
// reads kv head h / (Hq/Hkv) directly. Numerics as K6: the scale is applied
// to the f32 scores, the softmax runs in f32, P is rounded to bf16 for P.V.
// Padding queries past a row's real chunk read real or zero slots, stay
// finite and are discarded by the caller. Slots at or past kv_len are never
// read into the result, whatever they hold.
//
// What bounds it on an H100: operations. A 512-row chunk at a 4096-token
// context does 4 * D * Hq * T * ~3840 flops per row against ~25 MB of K/V
// per row read once.
// Design: the Hopper attention core of csrc/flash_sm90.cuh over the block
// table. The TPU version right-aligns the whole span into a padded
// [B, Hq, S, D] query and masks it with segment ids, because its kernel has
// only a top-left causal mask, which costs S^2/2 work; here a work item is
// 128 query rows of one (row, head) over the 128-key tiles of its row's
// context in position order. Each lane of a producer warp reads the page
// id of one page of a tile from the table and loads that page's rows (at
// most 128) of its warp's piece of K or V with TMA through a 4-D map of
// the pool, (D, Hkv, page, P) or (D, page, P, Hkv) (page sizes are powers
// of two: a shift, not a divide); pages past the row's context are asked
// for at page P, outside the map, and land as zeros; the V rows of the
// rest of the last page are zeroed in shared memory. An item stops after
// the tile that holds its last query's position, and masks only the tiles
// that reach past its first query's position (the diagonal, which may
// straddle two tiles, and the length boundary).
#include "flash_sm90.cuh"

namespace {

__global__ void __launch_bounds__(mrt::kRowThreads, 1)
    flash_prefill_paged_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap omap,
                               const long long* __restrict__ tables,
                               const long long* __restrict__ kv_lens,
                               __nv_bfloat16* __restrict__ out, int B, int T, int Hq, int Hkv,
                               int qtiles, int MP, int P, int page, int page_shift,
                               int head_major, float mul) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int G = Hq / Hkv;
  const int box = min(page, fa3::kKeys);  // rows of one TMA box
  const int nbox = fa3::kKeys / box;
  fa3::run_items<fa3::K6Core>(
      smem, Hq * B * qtiles, mul,
      [&](int w) {
        fa3::Item it = fa3::item_at(w, Hq, B, qtiles);
        it.kv = (int)kv_lens[it.b];
        // keys up to the last query's position (query i sits at kv - T + i),
        // below kv
        const int kmax = min(it.kv - T + min(it.q0 + fa3::kRows - 1, T - 1), it.kv - 1);
        it.n = kmax >= 0 ? kmax / fa3::kKeys + 1 : 0;
        return it;
      },
      [&](const fa3::Item& it, int t, uint8_t* dst, uint64_t* bar, int piece, uint8_t* q,
          int lane) {
        if (q && lane == 0) fa3::load_rows(q, &qmap, it.h, it.q0, it.b, bar);
        const int len = min(it.kv, MP * page);
        const CUtensorMap* map = piece < 2 ? &kmap : &vmap;
        // lane j issues box j's copy (and j + 32, ... for pages below 4
        // slots), after reading its page id from the table itself
        for (int j = lane; j < nbox; j += 32) {
          const int p = t * fa3::kKeys + j * box;
          const int pg = p < len ? (int)tables[(size_t)it.b * MP + (p >> page_shift)] : P;
          const int slot = p & (page - 1);
          if (head_major)
            mrt::tma_load_4d(dst + j * box * 128, map, 64 * (piece & 1), slot, pg, it.h / G, bar);
          else
            mrt::tma_load_4d(dst + j * box * 128, map, 64 * (piece & 1), it.h / G, slot, pg, bar);
        }
      },
      // a tile is unmasked when its last key is at or before the first
      // query's position
      [&](const fa3::Item& it, int t) {
        const int lo = it.kv - T + it.q0 + 1;
        return t >= (lo > 0 ? lo / fa3::kKeys : 0);
      },
      [&](const fa3::Item& it, int r, int p) { return p <= it.kv - T + it.q0 + r && p < it.kv; },
      // the rest of the row's last page, loaded with the tile: P = 0 there
      // does not cancel a NaN or Inf that a recycled page's stale slots may
      // hold, so its V rows are zeroed (pages past the context land as
      // zeros)
      [&](const fa3::Item& it, uint8_t* v) {
        const int k0 = (it.n - 1) * fa3::kKeys;
        const int lo = it.kv - k0, hi = min(((it.kv + page - 1) & -page) - k0, fa3::kKeys);
        if (lo >= hi) return false;
        // 16 chunks of 16 bytes a row, 8 in each 64-column half
        for (int i = threadIdx.x & 127; i < (hi - lo) * 16; i += 128)
          *reinterpret_cast<uint4*>(v + (i & 8) / 8 * fa3::kHalfBytes + (lo + i / 16) * 128 +
                                    (i & 7) * 16) = make_uint4(0u, 0u, 0u, 0u);
        return true;
      },
      // an item past its row's context (kv_len 0): zeros
      [&](const fa3::Item& it, int wg) {
        const int lane = threadIdx.x & 31;
        const int row0 = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
        for (int r = row0; r < row0 + 16; r += 8) {
          const int qi = it.q0 + r;
          if (qi >= T) continue;
          __nv_bfloat16* op = out + ((size_t)(it.b * T + qi) * Hq + it.h) * fa3::kD;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<uint32_t*>(op + 8 * j + 2 * (lane & 3)) = 0u;
        }
      },
      fa3::RawLogit{},
      [&](const fa3::Item& it, int wg, const float(&o)[fa3::kD / 2], float(&l)[2],
          uint8_t* rows) { fa3::store(o, l, wg, rows, &omap, it.h, it.q0, it.b); });
}

// The map of one layer's pool in boxes of 64 columns x `box` slots of one
// page and kv head, 128-byte swizzle: token-major [P, page, Hkv, D] as
// (D, Hkv, page, P), head-major [Hkv, P, page, D] as (D, page, P, Hkv).
int pool_map(CUtensorMap* map, const void* pool, int P, int page, int Hkv, int head_major) {
  const uint64_t row = (uint64_t)fa3::kD * 2;
  const uint32_t box = (uint32_t)min(page, fa3::kKeys);
  if (head_major) {
    const uint64_t dims[4] = {(uint64_t)fa3::kD, (uint64_t)page, (uint64_t)P, (uint64_t)Hkv};
    const uint64_t str[3] = {row, row * page, row * page * P};
    const uint32_t bx[4] = {64, box, 1, 1};
    return mrt::tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, pool, dims, str, bx,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  }
  const uint64_t dims[4] = {(uint64_t)fa3::kD, (uint64_t)Hkv, (uint64_t)page, (uint64_t)P};
  const uint64_t str[3] = {row, row * Hkv, row * Hkv * page};
  const uint32_t bx[4] = {64, 1, box, 1};
  return mrt::tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, pool, dims, str, bx,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// Shapes, layouts and types are checked by the Python wrapper
// (ops/paged_attention.py::flash_prefill_continuation): head dim 128,
// Hq % Hkv == 0, P pages of a page size of 2^page_shift, contiguous 16-byte
// aligned bf16 q and pools, int64 tables and kv_lens, scale > 0. The launch
// (rows, key tile, stages, threads, grid and shared memory) comes from its
// plan (ops/flash_attention.py::flash_plan) and is checked here. Returns
// the CUDA error code of the launch (0 = launched).
extern "C" int flash_prefill_paged(const void* q, const void* kpool, const void* vpool,
                                   const void* tables, const void* kv_lens, void* out, int B,
                                   int T, int Hq, int Hkv, int MP, int P, int page, int page_shift,
                                   int head_major, float scale, int rows, int keys, int stages,
                                   int threads, int gx, int gy, int gz, int smem, void* stream) {
  if (!fa3::plan_fits(rows, keys, stages, threads, gx, gy, gz, smem, B, T, Hq))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap, omap;
  int err = fa3::rows_map(&qmap, q, B, T, Hq);
  if (!err) err = pool_map(&kmap, kpool, P, page, Hkv, head_major);
  if (!err) err = pool_map(&vmap, vpool, P, page, Hkv, head_major);
  if (!err) err = fa3::rows_map(&omap, out, B, T, Hq, 64);
  if (err) return err;
  return fa3::launch(flash_prefill_paged_kernel, dim3(gx, gy, gz), smem,
                     static_cast<cudaStream_t>(stream), qmap, kmap, vmap, omap,
                     static_cast<const long long*>(tables),
                     static_cast<const long long*>(kv_lens), static_cast<__nv_bfloat16*>(out), B,
                     T, Hq, Hkv, (T + fa3::kRows - 1) / fa3::kRows, MP, P, page, page_shift,
                     head_major, scale * fa3::kLog2e);
}
