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
// head-major [Hkv,P,page,D]: the element strides of a page, a slot and a kv
// head give the layout. out [B,T,Hq,D] bf16; D = 128. Query head h reads kv
// head h / (Hq/Hkv) directly. Numerics as K6: the scale is applied to the
// f32 scores, the softmax runs in f32, P is rounded to bf16 for P.V.
// Padding queries past a row's real chunk read real or page-0 slots, stay
// finite and are discarded by the caller.
//
// What bounds it on an H100: operations. A 512-row chunk at a 4096-token
// context does 4 * D * Hq * T * ~3840 flops per row against ~25 MB of K/V
// per row read once.
// Design: K6's block loop (csrc/flash_attn.cuh) over the block table. The
// TPU version right-aligns the whole span into a padded [B, Hq, S, D] query
// and masks it with segment ids, because its kernel has only a top-left
// causal mask, which costs S^2/2 work; here a block of 4 warps owns 64
// query rows of one head and walks the 64-key tiles of its row's context in
// position order (a tile of 64 keys is 4 pages of 16), looking each key's
// page up in the table once for K and V as it stages the tile with cp.async
// (page sizes are powers of two: a shift, not a divide). It stops after the
// tile that holds its last query's position, and masks only the tiles that
// reach past its first query's position (the diagonal and the length
// boundary). Slots past kv_len are zero-filled, never read.
#include "flash_attn.cuh"

namespace {

constexpr int D = 128;
constexpr int BQ = 64;  // query rows per block, 16 per warp
constexpr size_t kSmemBytes = fa::prefill_smem_bytes<D, fa::kTileRows>();

__global__ void __launch_bounds__(fa::kThreads)
    flash_prefill_paged_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ kpool,
                               const __nv_bfloat16* __restrict__ vpool,
                               const long long* __restrict__ tables,
                               const long long* __restrict__ kv_lens,
                               __nv_bfloat16* __restrict__ out, int T, int Hq, int Hkv, int MP,
                               int page, int page_shift, long long s_page, long long s_slot,
                               long long s_head, fa::Logit<false> lg) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int kv_len = (int)kv_lens[b];
  const int qoff = kv_len - T;  // position of query 0
  const int span = MP * page;
  const long long* row_table = tables + (size_t)b * MP;
  const size_t head_off = (size_t)kvh * s_head;

  // keys up to the last query's position, below kv_len
  const int last_q = min(q0 + BQ - 1, T - 1);
  const int kmax = min(qoff + last_q, kv_len - 1);
  const int ntiles = kmax >= 0 ? kmax / fa::kTileRows + 1 : 0;
  // a tile is unmasked when its last key is at or before the first query's position
  const int lo = qoff + q0 + 1;
  const int first_masked = lo > 0 ? lo / fa::kTileRows : 0;

  // element offset of position p's slot in a pool (p < min(kv_len, span))
  auto slot = [&](int p) -> size_t {
    return (size_t)row_table[p >> page_shift] * s_page + (size_t)(p & (page - 1)) * s_slot +
           head_off;
  };
  const int len = min(kv_len, span);
  fa::stage_rows<D, fa::kTileRows>(smem, T - q0, q, [&](int r) -> size_t {
    return ((size_t)(b * T + q0 + r) * Hq + h) * D;
  });
  fa::RowState<D> st;
  fa::prefill_rows<D, fa::kTileRows, fa::QFrags<D>>(
      smem, 0, ntiles, lg,
      [&](int it, uint8_t* kt, uint8_t* vt) {
        const int p0 = it * fa::kTileRows;
        fa::stage_kv<D, fa::kTileRows>(kt, vt, len - p0, kpool, vpool,
                                       [&](int r) { return slot(p0 + r); });
      },
      [] {}, [&](int it) { return it >= first_masked; },
      [&](int qr, int p) { return p <= qoff + q0 + qr && p < kv_len; }, st);
  fa::store_rows(st, [&](int r) -> __nv_bfloat16* {
    const int qi = q0 + warp * 16 + r;
    return qi < T ? out + ((size_t)(b * T + qi) * Hq + h) * D : nullptr;
  });
}

}  // namespace

// Shapes, layouts and types are checked by the Python wrapper
// (ops/paged_attention.py::flash_prefill_continuation): head dim 128,
// Hq % Hkv == 0, a page size of 2^page_shift, contiguous 16-byte aligned
// bf16 q and pools, int64 tables and kv_lens. Returns the CUDA error code of
// the launch (0 = launched).
extern "C" int flash_prefill_paged(const void* q, const void* kpool, const void* vpool,
                                   const void* tables, const void* kv_lens, void* out, int B,
                                   int T, int Hq, int Hkv, int MP, int page, int page_shift,
                                   long long s_page, long long s_slot, long long s_head,
                                   float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_paged_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, Hq, B);
  flash_prefill_paged_kernel<<<grid, fa::kThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kpool),
      static_cast<const __nv_bfloat16*>(vpool), static_cast<const long long*>(tables),
      static_cast<const long long*>(kv_lens), static_cast<__nv_bfloat16*>(out), T, Hq, Hkv, MP,
      page, page_shift, s_page, s_slot, s_head, fa::Logit<false>::make(scale, 0.f));
  return (int)cudaGetLastError();
}
