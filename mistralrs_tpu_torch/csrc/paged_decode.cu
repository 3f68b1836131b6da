// K7: block-table decode attention, one query token per row.
//
// Replaces the TPU library kernel jax.experimental.pallas.ops.tpu
// .paged_attention, called by mistralrs_tpu/ops/paged_attention.py
// ::paged_decode_attention on decode steps over head-major pools.
//
// q [B,Hq,D] bf16 (the decoder's [B,1,Hq,D]); out[b,h] = softmax(s) . V
// over the first kv_lens[b] positions of block_tables[b] (int64 [B, MP]),
// read from one layer's K and V pools, head-major [Hkv,P,page,D] on the
// serving path (token-major [P,page,Hkv,D] also works: the element strides
// of a page, a slot and a kv head give the layout); D = 128 or 256. The
// logit s is scale * (q[b,h] . k) on the f32 scores, soft-capped as cap *
// tanh(s / cap) when a cap is given (Gemma-2: 50); the softmax runs in f32,
// P is rounded to bf16 for P.V. A row with kv_len 0 gives zeros.
//
// What bounds it on an H100: bytes. Every key costs 2 x 2D bytes of K and V
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
// them in a fixed order, so results never depend on block order. At D = 256
// a block holds 136 KB of shared memory (one block an SM, where D = 128
// fits two) and reads its Q fragments from shared memory at each use.
#include "flash_attn.cuh"

namespace {

constexpr int kQRows = 16;  // rows of the mma tile

template <int D>
__host__ __device__ constexpr size_t q_bytes() {
  return (size_t)kQRows * fa::row_bytes<D>();
}
template <int D>
__host__ __device__ constexpr size_t kv_bytes() {  // the K or the V tile of a 64-key tile
  return (size_t)fa::kTileRows * fa::row_bytes<D>();
}
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return q_bytes<D>() + 4 * kv_bytes<D>();
}

template <int D, bool CAP>
__global__ void __launch_bounds__(fa::kThreads)
    paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kpool,
                        const __nv_bfloat16* __restrict__ vpool,
                        const long long* __restrict__ tables,
                        const long long* __restrict__ kv_lens, float* __restrict__ part_o,
                        float* __restrict__ part_ml, int Hq, int Hkv, int MP, int page,
                        int page_shift, long long s_page, long long s_slot, long long s_head,
                        int per, fa::Logit<CAP> lg) {
  constexpr size_t kQBytes = q_bytes<D>(), kKVBytes = kv_bytes<D>();
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
    uint8_t* kt = smem + kQBytes + 2 * sg * kKVBytes;
    const int p0 = it * fa::kTileRows;
    fa::stage_kv<D, fa::kTileRows>(kt, kt + kKVBytes, len - p0, kpool, vpool,
                                   [&](int r) -> size_t {
                                     const int p = p0 + r;
                                     return (size_t)row_table[p >> page_shift] * s_page +
                                            (size_t)(p & (page - 1)) * s_slot + head_off;
                                   });
  };

  fa::RowState<D> st;
  st.init();
  if (t0 < t1) {
    fa::stage_rows<D, kQRows>(smem, G, q,
                              [&](int r) -> size_t { return ((size_t)b * Hq + kvh * G + r) * D; });
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
      fa::attend<D, 16>(kbase, kbase + kKVBytes, warp * 16, qf, st, lg, p0 + 16 > len,
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
template <int D>
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

template <int D, bool CAP>
int launch(const void* q, const void* kpool, const void* vpool, const void* tables,
           const void* kv_lens, void* part_o, void* part_ml, void* out, int B, int Hq, int Hkv,
           int MP, int page, int page_shift, int splits, long long s_page, long long s_slot,
           long long s_head, int per, float scale, float softcap, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<D, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes<D>());
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<D, CAP><<<dim3(splits, Hkv, B), fa::kThreads, smem_bytes<D>(), st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kpool),
      static_cast<const __nv_bfloat16*>(vpool), static_cast<const long long*>(tables),
      static_cast<const long long*>(kv_lens), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), Hq, Hkv, MP, page, page_shift, s_page, s_slot, s_head, per,
      fa::Logit<CAP>::make(scale, softcap));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<D><<<B * Hq, D, 0, st>>>(static_cast<const float*>(part_o),
                                                 static_cast<const float*>(part_ml),
                                                 static_cast<__nv_bfloat16*>(out), splits * 4);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes, layouts and types are checked by the Python wrapper
// (ops/paged_attention.py::paged_decode_attention): head dim D = 128 or
// 256, Hq % Hkv == 0, Hq/Hkv <= 16, a page size of 2^page_shift, contiguous
// 16-byte aligned bf16 q and pools, int64 tables and kv_lens, f32 scratch
// part_o [B,Hq,4*splits,D] and part_ml [B,Hq,4*splits,2]; `per` 64-key
// tiles per split; softcap 0 for none. Returns the CUDA error code of the
// launches (0 = launched; cudaErrorInvalidValue for another D).
extern "C" int paged_decode(const void* q, const void* kpool, const void* vpool,
                            const void* tables, const void* kv_lens, void* part_o, void* part_ml,
                            void* out, int B, int Hq, int Hkv, int MP, int page,
                            int page_shift, int splits, long long s_page, long long s_slot,
                            long long s_head, int per, int D, float scale, float softcap,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MRT_DECODE(DD, CAP)                                                                   \
  launch<DD, CAP>(q, kpool, vpool, tables, kv_lens, part_o, part_ml, out, B, Hq, Hkv, MP, page, \
                  page_shift, splits, s_page, s_slot, s_head, per, scale, softcap, st)
  const bool cap = softcap > 0.f;
  if (D == 128) return cap ? MRT_DECODE(128, true) : MRT_DECODE(128, false);
  if (D == 256) return cap ? MRT_DECODE(256, true) : MRT_DECODE(256, false);
#undef MRT_DECODE
  return (int)cudaErrorInvalidValue;
}
