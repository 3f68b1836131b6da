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
// Design: the Hopper attention core of csrc/flash_sm90.cuh in K12's chunk
// configuration (fa3::ChunkCore: 128-key tiles in three stages at D = 128,
// 64-key tiles in two at D = 256, a stage's K and V freed apart), so two
// consumer warpgroups run bf16 wgmma on TMA-fed tiles with ping-pong:
// - a work item is 128 query rows of one (batch row, head), K6's items:
//   the last query tiles (the most key tiles) first, the heads that share a
//   kv head side by side; Q, K and V come by TMA through 4-D maps of the
//   three tensors, (D, H, T, B) in boxes of 64 columns (rows past T land as
//   zeros), and the output leaves by K6's TMA store, which drops rows past
//   T;
// - an item walks the key tiles from the one that holds its first row's
//   window start to the diagonal; a tile is masked only where it crosses
//   the diagonal or the last row's window start;
// - the scale is folded once an item into the Q tile in shared memory:
//   each consumer warpgroup multiplies its own 64 rows in place (a uniform
//   multiply does not care about the 128-byte swizzle), then orders those
//   generic writes before its wgmmas read the tile (fence.proxy.async) and
//   syncs the warpgroup; the scores are then already scaled, so without a
//   cap the exponent's factor is log2(e), and with one fa3::CapLogit takes
//   them with pre = 1 / cap (the scale on the f32 scores instead would be
//   another function than JAX's and the plain version's).
// A tanhf on every score is what holds the capped chunks above their
// bound (as K12's); a faster tanh is later work for both.
#include "flash_sm90.cuh"

namespace {

constexpr int kNoWindow = 1 << 30;

// A work item: 128 query rows q0.. of head h, batch row b, over n key
// tiles from tile t_lo.
struct SplashItem {
  int h, b, q0, n, t_lo;
};

template <int D, bool CAP>
__global__ void __launch_bounds__(mrt::kRowThreads, 1)
    splash_prefill_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap omap, int B, int T, int Hq,
                          int Hkv, int qtiles, int win, float scale, float mul,
                          fa3::CapLogit cap) {
  using C = fa3::ChunkCore<D>;
  constexpr int KT = C::kKeys;
  constexpr int kPer = C::kBlocks / 2;  // 64-column blocks a producer warp loads
  extern __shared__ __align__(1024) uint8_t smem[];
  const int G = Hq / Hkv;
  std::conditional_t<CAP, fa3::CapLogit, fa3::RawLogit> lg{};
  if constexpr (CAP) lg = cap;
  const __nv_bfloat162 s2 = __float2bfloat162_rn(scale);
  fa3::run_items<C>(
      smem, Hq * B * qtiles, mul,
      [&](int w) {
        const fa3::Item k6 = fa3::item_at(w, Hq, B, qtiles);
        SplashItem it{k6.h, k6.b, k6.q0, 0, max(0, k6.q0 - (win - 1)) / KT};
        // keys of the item: from its first row's window start to its last row
        it.n = min(k6.q0 + fa3::kRows - 1, T - 1) / KT + 1 - it.t_lo;
        return it;
      },
      [&](const SplashItem& it, int t, uint8_t* dst, uint64_t* bar, int piece, uint8_t* q,
          int lane) {
        if (q && lane < C::kBlocks)
          mrt::tma_load_4d(q + lane * C::kQBlock, &qmap, 64 * lane, it.h, it.q0, it.b, bar);
        if (lane < kPer)
          mrt::tma_load_4d(dst + lane * C::kKVBlock, piece < 2 ? &kmap : &vmap,
                           64 * ((piece & 1) * kPer + lane), it.h / G, (it.t_lo + t) * KT, it.b,
                           bar);
      },
      // qs = bf16(q * bf16(scale)) in place, warpgroup wg's 64 rows of each
      // 64-column block (8 KB at wg * 8 KB of the block's 16 KB)
      [&](const SplashItem&, int wg, uint8_t* qtile) {
        for (int i = threadIdx.x & 127; i < C::kBlocks * 512; i += 128) {
          uint4* p = reinterpret_cast<uint4*>(qtile + (i >> 9) * C::kQBlock + wg * 8192 +
                                              (i & 511) * 16);
          uint4 c = *p;
          __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&c);
#pragma unroll
          for (int j = 0; j < 4; ++j) e[j] = __hmul2(e[j], s2);
          *p = c;
        }
        mrt::fence_proxy_async();  // the writes, before the tensor cores read the tile
        fa3::bar_sync(3 + wg, 128);
      },
      // a tile is unmasked when every row keeps every key of it: its last
      // key at or before the first row, its first key inside the last row's
      // window
      [&](const SplashItem& it, int tt) {
        const int k0 = (it.t_lo + tt) * KT;
        return k0 + KT - 1 > it.q0 || k0 < it.q0 + fa3::kRows - 1 - (win - 1);
      },
      // keys past T sit past every real query's position
      [&](const SplashItem& it, int r, int key) {
        const int qi = it.q0 + r, kj = it.t_lo * KT + key;
        return kj <= qi && kj > qi - win;
      },
      [](const SplashItem&, uint8_t*) { return false; },  // rows past T land as zeros
      [](const SplashItem&, int) {},  // every item has a key tile (its own rows')
      lg,
      [&](const SplashItem& it, int wg, const float(&o)[D / 2], float(&l)[2], uint8_t* rows) {
        fa3::store<C>(o, l, wg, rows, &omap, it.h, it.q0, it.b);
      });
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/splash.py): head dim D = 128
// or 256, Hq % Hkv == 0, contiguous 16-byte aligned bf16 tensors. window
// <= 0 means none; softcap <= 0 means none. The launch (rows, key
// tile, stages, threads, grid and shared memory) comes from its plan
// (ops/splash.py::splash_plan) and is checked here: this configuration's
// rows, key tile, stages and threads, 1 to Hq * B * query tiles blocks in
// x, enough shared memory. Returns the CUDA error code of the launch (0 =
// launched; cudaErrorInvalidValue for another D or plan).
extern "C" int splash_prefill(const void* q, const void* k, const void* v, void* out, int B,
                              int T, int Hq, int Hkv, int D, int window, float scale,
                              float softcap, int rows, int keys, int stages, int threads, int gx,
                              int gy, int gz, int smem, void* stream) {
  if ((D != 128 && D != 256) || B < 1 || T < 1 || Hkv < 1 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const int qtiles = (T + fa3::kRows - 1) / fa3::kRows;
  const int want_keys = D == 128 ? fa3::ChunkCore<128>::kKeys : fa3::ChunkCore<256>::kKeys;
  const int want_stages = D == 128 ? fa3::ChunkCore<128>::kStages : fa3::ChunkCore<256>::kStages;
  const int want_smem =
      D == 128 ? fa3::ChunkCore<128>::kSmemBytes : fa3::ChunkCore<256>::kSmemBytes;
  if (rows != fa3::kRows || keys != want_keys || stages != want_stages ||
      threads != mrt::kRowThreads || gx < 1 || gx > Hq * B * qtiles || gy != 1 || gz != 1 ||
      smem < want_smem)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap, omap;
  int err = fa3::rows_map(&qmap, q, B, T, Hq, fa3::kRows, D);
  if (!err) err = fa3::rows_map(&kmap, k, B, T, Hkv, keys, D);
  if (!err) err = fa3::rows_map(&vmap, v, B, T, Hkv, keys, D);
  if (!err) err = fa3::rows_map(&omap, out, B, T, Hq, 64, D);
  if (err) return err;
  // a window of T or more clips nothing
  const int win = (window <= 0 || window >= T) ? kNoWindow : window;
  const bool cap = softcap > 0.f;
  const fa3::CapLogit lg{cap ? 1.f / softcap : 0.f, softcap * fa3::kLog2e};
  // the scores are scaled already: the exponent's factor is log2(e), or 1
  // when the cap's logit is in base 2
  const float mul = cap ? 1.f : fa3::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kern) {
    return fa3::launch(kern, dim3(gx, gy, gz), smem, st, qmap, kmap, vmap, omap, B, T, Hq, Hkv,
                       qtiles, win, scale, mul, lg);
  };
  if (D == 128)
    return cap ? go(splash_prefill_kernel<128, true>) : go(splash_prefill_kernel<128, false>);
  return cap ? go(splash_prefill_kernel<256, true>) : go(splash_prefill_kernel<256, false>);
}
