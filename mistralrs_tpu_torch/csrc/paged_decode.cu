// K7: block-table decode attention, one query token per row.
//
// Replaces the TPU library kernel jax.experimental.pallas.ops.tpu
// .paged_attention, called by mistralrs_tpu/ops/paged_attention.py
// ::paged_decode_attention on decode steps over head-major pools.
//
// q [B,Hq,D] bf16 (the decoder's [B,1,Hq,D]); out[b,h] = softmax(scale *
// q[b,h] . K^T) . V over the first kv_lens[b] positions of block_tables[b]
// (int64 [B, MP]), read from one layer's K and V pools, head-major
// [Hkv,P,page,D] on the serving path (token-major [P,page,Hkv,D] also
// works: the element strides of a page, a slot and a kv head give the
// layout); D = 128. The scale is applied to the f32 scores, the softmax runs
// in f32, P is rounded to bf16 for P.V. A row with kv_len 0 gives zeros.
//
// What bounds it on an H100: bytes. Every key costs 2 x 256 bytes of K and V
// and 4 * D * (Hq/Hkv) flops, ~4 flops a byte, far below the ~295 the card
// needs to be compute-bound; only the pages the table names are read, once.
// Design: one block of 4 warps per (row, kv head, split of the span) serves
// all Hq/Hkv query heads of its kv head, so each K/V page is read once:
// 64-key tiles (4 pages of 16) are staged by 16-byte cp.async copies,
// double-buffered, and each warp attends its 16 keys of the tile with the
// shared FlashAttention-2 step (csrc/flash_attn.cuh), the group's query
// heads as the rows of a 16-row mma tile (rows past Hq/Hkv are zeros). The
// splits let B * Hkv pairs fill 132 SMs at small batch; each warp writes
// its (max, exp-sum, unnormalized output) and a second kernel combines
// them in a fixed order, so results never depend on block order.
#include "flash_attn.cuh"

namespace {

using fa::D;
constexpr int kQRows = 16;                            // rows of the mma tile
constexpr int kQBytes = kQRows * fa::kRowBytes;       // the staged Q tile
constexpr int kStageBytes = 2 * fa::kTileBytes;       // K and V of a 64-key tile
constexpr size_t kSmemBytes = kQBytes + 2 * kStageBytes;

__global__ void __launch_bounds__(fa::kThreads)
    paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kpool,
                        const __nv_bfloat16* __restrict__ vpool,
                        const long long* __restrict__ tables,
                        const long long* __restrict__ kv_lens, float* __restrict__ part_o,
                        float* __restrict__ part_ml, int Hq, int Hkv, int MP, int page,
                        int page_shift, long long s_page, long long s_slot, long long s_head,
                        int per, float scale_log2) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = mrt::smem_u32(smem);
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int parts = gridDim.x * 4;  // one partial per warp
  const int part = split * 4 + warp;
  const int len = max(0, min((int)kv_lens[b], MP * page));
  const int t0 = split * per;
  const int t1 = min(t0 + per, (len + fa::kTileRows - 1) / fa::kTileRows);
  const long long* row_table = tables + (size_t)b * MP;
  const size_t head_off = (size_t)kvh * s_head;

  // stage the K and V of 64-key tile `it` into stage sg
  auto stage_tile = [&](int it, int sg) {
    uint8_t* kt = smem + kQBytes + sg * kStageBytes;
    const int p0 = it * fa::kTileRows;
    fa::stage_kv(kt, kt + fa::kTileBytes, len - p0, kpool, vpool, [&](int r) -> size_t {
      const int p = p0 + r;
      return (size_t)row_table[p >> page_shift] * s_page + (size_t)(p & (page - 1)) * s_slot +
             head_off;
    });
  };

  fa::RowState st;
  st.init();
  if (t0 < t1) {
    fa::stage_rows<kQRows>(smem, G, q,
                           [&](int r) -> size_t { return ((size_t)b * Hq + kvh * G + r) * D; });
    stage_tile(t0, 0);
    mrt::cp_async_commit();
    uint32_t qf[D / 16][4];
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
      if (it == t0) fa::load_q(sbase, 0, qf);
      const int p0 = it * fa::kTileRows + warp * 16;  // this warp's 16 keys
      const uint32_t kbase = sbase + kQBytes + sg * kStageBytes;
      fa::attend<16>(kbase, kbase + fa::kTileBytes, warp * 16, qf, st, scale_log2, p0 + 16 > len,
                     [&](int, int kj) { return p0 + kj < len; });
      __syncthreads();  // this stage is free for the tile after next
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

// out[bh, d] = sum_p o_p[d] 2^(m_p - M) / sum_p l_p 2^(m_p - M), over the
// partials p in order; partials that saw no key (m = -inf) are skipped.
__global__ void __launch_bounds__(D)
    decode_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                          __nv_bfloat16* __restrict__ out, int parts) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * parts * 2;
  float M = -INFINITY;
  for (int p = 0; p < parts; ++p) M = fmaxf(M, ml[2 * p]);
  float L = 0.f, acc = 0.f;
  if (M != -INFINITY) {
    for (int p = 0; p < parts; ++p) {
      const float mp = ml[2 * p];
      if (mp == -INFINITY) continue;
      const float w = exp2f(mp - M);
      L += ml[2 * p + 1] * w;
      acc += part_o[(bh * parts + p) * D + d] * w;
    }
  }
  out[bh * D + d] = __float2bfloat16_rn(L > 0.f ? acc / L : 0.f);
}

}  // namespace

// Shapes, layouts and types are checked by the Python wrapper
// (ops/paged_attention.py::paged_decode_attention): head dim 128,
// Hq % Hkv == 0, Hq/Hkv <= 16, a page size of 2^page_shift, contiguous
// 16-byte aligned bf16 q and pools, int64 tables and kv_lens, f32 scratch
// part_o [B,Hq,4*splits,D] and part_ml [B,Hq,4*splits,2]; `per` 64-key
// tiles per split. Returns the CUDA error code of the launches (0 =
// launched).
extern "C" int paged_decode(const void* q, const void* kpool, const void* vpool,
                            const void* tables, const void* kv_lens, void* part_o, void* part_ml,
                            void* out, int B, int Hq, int Hkv, int MP, int page,
                            int page_shift, int splits, long long s_page, long long s_slot,
                            long long s_head, int per, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  paged_decode_kernel<<<dim3(splits, Hkv, B), fa::kThreads, kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kpool),
      static_cast<const __nv_bfloat16*>(vpool), static_cast<const long long*>(tables),
      static_cast<const long long*>(kv_lens), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), Hq, Hkv, MP, page, page_shift, s_page, s_slot, s_head, per,
      scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<B * Hq, D, 0, st>>>(static_cast<const float*>(part_o),
                                              static_cast<const float*>(part_ml),
                                              static_cast<__nv_bfloat16*>(out), splits * 4);
  return (int)cudaGetLastError();
}
