// K6: causal flash attention for a first prefill chunk.
//
// Replaces the TPU library kernel jax.experimental.pallas.ops.tpu
// .flash_attention, called by mistralrs_tpu/models/decoder.py::_attention
// on first prompt chunks.
//
// q [B,T,Hq,D], k/v [B,T,Hkv,D] bf16 (row-major, token-major as the decoder
// holds them), out [B,T,Hq,D] bf16; D = 128. Query head h reads kv head
// h / (Hq/Hkv) directly (no repeated K/V). Scores are scale * (q . k) with
// the dot on bf16 tensor cores into f32; the softmax runs in f32 with a
// running max and sum (online softmax, in base 2 with log2(e) folded into
// the scale); P is rounded to bf16 for the P.V product, which accumulates in
// f32. Any T, including a ragged last tile.
//
// What bounds it on an H100: operations. At T >= 256 the causal work,
// about 2 * D * T^2 flops per (batch, head), is far above the bytes moved
// (q, k, v, out read and written once), so the kernel has to run on the
// tensor cores at the wgmma rate.
// Design: the Hopper attention core of csrc/flash_sm90.cuh. A work item is
// 128 query rows of one (row, head), two consumer warpgroups of 64 rows on
// bf16 wgmma, over the 128-key tiles up to the diagonal; the producer loads
// Q, K and V with TMA through 4-D maps (D, H, T, B) of the three tensors,
// so rows past T land as zeros. Only the last (diagonal) tile is masked.
// The persistent grid takes the last query tiles (the most key tiles)
// first.
#include "flash_sm90.cuh"

namespace {

__global__ void __launch_bounds__(mrt::kRowThreads, 1)
    flash_prefill_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap omap, int B, int Hq, int Hkv,
                         int qtiles, float mul) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int G = Hq / Hkv;
  fa3::run_items<fa3::K6Core>(
      smem, Hq * B * qtiles, mul,
      [&](int w) {
        fa3::Item it = fa3::item_at(w, Hq, B, qtiles);
        it.n = it.q0 / fa3::kKeys + 1;  // key tiles up to the diagonal
        return it;
      },
      [&](const fa3::Item& it, int t, uint8_t* dst, uint64_t* bar, int piece, uint8_t* q,
          int lane) {
        if (lane != 0) return;
        if (q) fa3::load_rows(q, &qmap, it.h, it.q0, it.b, bar);
        mrt::tma_load_4d(dst, piece < 2 ? &kmap : &vmap, 64 * (piece & 1), it.h / G,
                         t * fa3::kKeys, it.b, bar);
      },
      [](const fa3::Item& it, int t) { return t == it.n - 1; },
      // keys past T sit past every real query's position
      [](const fa3::Item& it, int r, int key) { return key <= it.q0 + r; },
      [](const fa3::Item&, uint8_t*) { return false; },  // rows past T land as zeros
      [](const fa3::Item&, int) {},  // every item has a key tile
      fa3::RawLogit{},
      [&](const fa3::Item& it, int wg, const float(&o)[fa3::kD / 2], float(&l)[2],
          uint8_t* rows) { fa3::store(o, l, wg, rows, &omap, it.h, it.q0, it.b); });
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/flash_attention.py): head
// dim 128, Hq % Hkv == 0, contiguous 16-byte aligned bf16 tensors, scale >
// 0. The launch (rows, key tile, stages, threads, grid and shared memory)
// comes from its plan (flash_plan) and is checked here. Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int flash_prefill(const void* q, const void* k, const void* v, void* out, int B, int T,
                             int Hq, int Hkv, float scale, int rows, int keys, int stages,
                             int threads, int gx, int gy, int gz, int smem, void* stream) {
  if (!fa3::plan_fits(rows, keys, stages, threads, gx, gy, gz, smem, B, T, Hq))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap, omap;
  int err = fa3::rows_map(&qmap, q, B, T, Hq);
  if (!err) err = fa3::rows_map(&kmap, k, B, T, Hkv);
  if (!err) err = fa3::rows_map(&vmap, v, B, T, Hkv);
  if (!err) err = fa3::rows_map(&omap, out, B, T, Hq, 64);
  if (err) return err;
  return fa3::launch(flash_prefill_kernel, dim3(gx, gy, gz), smem,
                     static_cast<cudaStream_t>(stream), qmap, kmap, vmap, omap, B, Hq, Hkv,
                     (T + fa3::kRows - 1) / fa3::kRows, scale * fa3::kLog2e);
}
