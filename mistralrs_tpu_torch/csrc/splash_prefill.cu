// K11: causal first-chunk attention with an optional local window and an
// optional tanh soft cap on the logits.
//
// Replaces the TPU library kernel jax.experimental.pallas.ops.tpu
// .splash_attention (make_splash_mqa_single_device over CausalMask or
// LocalMask), called by mistralrs_tpu/ops/splash.py::splash_prefill on the
// first prompt chunks the plain flash kernel K6 rejects: a logit soft cap
// (Gemma-2) or a sliding window that clips inside the chunk.
//
// q [B,T,Hq,D], k/v [B,T,Hkv,D] bf16 (token-major, as the decoder holds
// them), out [B,T,Hq,D] bf16; D = 128 or 256. Query head h reads kv head
// h / (Hq/Hkv) directly (no repeated K/V). As splash_prefill does: the scale
// is folded into q in bf16 (qs = bf16(q * bf16(scale))), the score is qs . k
// on bf16 tensor cores into f32, soft-capped as cap * tanh(s / cap) (tanhf,
// f32) when a cap is given, then masked: query t keeps key u iff u <= t and,
// with a window w, u >= t - (w - 1). The softmax runs in f32 (online, base
// 2); P is rounded to bf16 for the P.V product, which accumulates in f32.
// Any T; padding rows of the caller's batch are zeroed by the caller.
//
// What bounds it on an H100: operations. A first chunk of T >= 256 does
// 4 * D flops per kept (query, key) pair against the bytes of q, k, v and
// out read or written once (Gemma-2-9B at B=4, T=512: 4.3 GFLOP against
// 50 MB).
// Design: K6's FlashAttention-2 loop (csrc/flash_attn.cuh). A block of 4
// warps owns 64 query rows of one head, 16 per warp, and walks only the key
// tiles that hold a kept key: from the tile of its first row's window start
// to the diagonal; only tiles that reach past the diagonal or before the
// last row's window start are masked, the window boundary exactly per score.
// The bf16 scale is applied to the staged Q tile in shared memory once. At
// D = 128 the key tiles hold 64 rows and a warp keeps its Q fragments in
// registers (80 KB of shared memory). At D = 256 a warp's 16 x 256 f32
// output tile alone is 128 registers a thread, so its Q fragments are read
// from shared memory at each use and key tiles hold 32 rows, which keeps
// the score tile at 16 registers and a block at 96 KB (two blocks an SM).
// wgmma, TMA and a faster tanh are later work.
#include "flash_attn.cuh"

namespace {

constexpr int BQ = fa::kTileRows;  // query rows per block, 16 per warp

template <int D>
__host__ __device__ constexpr int key_tile() {
  return D == 256 ? 32 : 64;
}

template <int D, bool CAP>
__global__ void __launch_bounds__(fa::kThreads)
    splash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                          int T, int Hq, int Hkv, int win, float qscale, fa::Logit<CAP> lg) {
  constexpr int KT = key_tile<D>();
  extern __shared__ __align__(128) uint8_t smem[];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  // keys of the block: from its first row's window start to its last row
  const int q_last = min(q0 + BQ - 1, T - 1);
  const int t_lo = max(0, q0 - (win - 1)) / KT;
  const int t_hi = q_last / KT + 1;
  // a tile is unmasked when every row keeps every key of it: its last key
  // at or before the first row, its first key inside the last row's window
  const int lo_full = q0 + BQ - 1 - (win - 1);

  auto row = [&](int H, int hh, int t) -> size_t { return ((size_t)(b * T + t) * H + hh) * D; };
  fa::stage_rows<D, BQ>(smem, T - q0, q, [&](int r) { return row(Hq, h, q0 + r); });
  fa::RowState<D> st;
  fa::prefill_rows<D, KT, fa::QFrags<D>>(
      smem, t_lo, t_hi, lg,
      [&](int it, uint8_t* kt, uint8_t* vt) {
        const int t0 = it * KT;
        fa::stage_kv<D, KT>(kt, vt, T - t0, k, v, [&](int r) { return row(Hkv, kvh, t0 + r); });
      },
      [&] {
        // qs = bf16(q * bf16(scale)) in place: each thread rescales the
        // 16-byte chunks it staged
        const __nv_bfloat162 s2 = __float2bfloat162_rn(qscale);
        for (int i = threadIdx.x; i < BQ * (D / 8); i += fa::kThreads) {
          uint4* p = reinterpret_cast<uint4*>(smem + fa::swz_off<D>(i / (D / 8), i % (D / 8)));
          uint4 c = *p;
          __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&c);
#pragma unroll
          for (int j = 0; j < 4; ++j) e[j] = __hmul2(e[j], s2);
          *p = c;
        }
        __syncthreads();
      },
      [&](int it) { return it * KT + KT - 1 > q0 || it * KT < lo_full; },
      [&](int qr, int kj) {
        const int qi = q0 + qr;
        return kj <= qi && kj >= qi - (win - 1) && kj < T;
      },
      st);
  fa::store_rows(st, [&](int r) -> __nv_bfloat16* {
    const int qi = q0 + warp * 16 + r;
    return qi < T ? out + ((size_t)(b * T + qi) * Hq + h) * D : nullptr;
  });
}

template <int D, bool CAP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int T, int Hq, int Hkv,
           int win, float scale, float softcap, cudaStream_t st) {
  constexpr size_t smem = fa::prefill_smem_bytes<D, key_tile<D>()>();
  cudaError_t err = cudaFuncSetAttribute(splash_prefill_kernel<D, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, Hq, B);
  splash_prefill_kernel<D, CAP><<<grid, fa::kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), T, Hq, Hkv, win,
      scale, fa::Logit<CAP>::make(1.f, softcap));
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/splash.py): head dim D = 128
// or 256, Hq % Hkv == 0, contiguous 16-byte aligned bf16 tensors. window <= 0
// means none; softcap <= 0 means none. Returns the CUDA error code of the
// launch (0 = launched; cudaErrorInvalidValue for another D).
extern "C" int splash_prefill(const void* q, const void* k, const void* v, void* out, int B,
                              int T, int Hq, int Hkv, int D, int window, float scale,
                              float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a window of T or more clips nothing
  const int win = (window <= 0 || window > T) ? T : window;
  const bool cap = softcap > 0.f;
  if (D == 128)
    return cap ? launch<128, true>(q, k, v, out, B, T, Hq, Hkv, win, scale, softcap, st)
               : launch<128, false>(q, k, v, out, B, T, Hq, Hkv, win, scale, softcap, st);
  if (D == 256)
    return cap ? launch<256, true>(q, k, v, out, B, T, Hq, Hkv, win, scale, softcap, st)
               : launch<256, false>(q, k, v, out, B, T, Hq, Hkv, win, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}
