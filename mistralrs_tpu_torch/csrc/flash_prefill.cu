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
// tensor cores.
// Design (FlashAttention-2 on mma.sync, csrc/flash_attn.cuh, shared with
// K6', K7 and K11): a block of 4 warps owns 64 query rows of one head, 16 per
// warp, and walks the 64-key tiles up to the diagonal. Q, then K and V tiles
// (double-buffered) are staged in shared memory by 16-byte cp.async copies,
// XOR-swizzled so ldmatrix reads are conflict-free; each warp keeps its Q
// fragments in registers and feeds the probabilities straight from the
// score accumulators as the A operand of P.V. Only the last (diagonal) tile
// is masked. Blocks with the most key tiles are launched first. wgmma, TMA
// and warp specialisation are later work.
#include "flash_attn.cuh"

namespace {

constexpr int D = 128;
// query rows per block, 16 per warp; equal to the key tile, so the diagonal
// tile is the last
constexpr int BQ = 64;
constexpr size_t kSmemBytes = fa::prefill_smem_bytes<D, fa::kTileRows>();

__global__ void __launch_bounds__(fa::kThreads)
    flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                         int T, int Hq, int Hkv, fa::Logit<false> lg) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int ntiles = q0 / fa::kTileRows + 1;  // key tiles up to the diagonal

  // element offset of row t, head hh of a [B*T, H, D] tensor
  auto row = [&](int H, int hh, int t) -> size_t { return ((size_t)(b * T + t) * H + hh) * D; };
  fa::stage_rows<D, fa::kTileRows>(smem, T - q0, q, [&](int r) { return row(Hq, h, q0 + r); });
  fa::RowState<D> st;
  fa::prefill_rows<D, fa::kTileRows, fa::QFrags<D>>(
      smem, 0, ntiles, lg,
      [&](int it, uint8_t* kt, uint8_t* vt) {
        const int t0 = it * fa::kTileRows;
        fa::stage_kv<D, fa::kTileRows>(kt, vt, T - t0, k, v,
                                       [&](int r) { return row(Hkv, kvh, t0 + r); });
      },
      [] {}, [&](int it) { return it == ntiles - 1; },
      [&](int qr, int kj) { return kj <= q0 + qr && kj < T; }, st);
  fa::store_rows(st, [&](int r) -> __nv_bfloat16* {
    const int qi = q0 + warp * 16 + r;
    return qi < T ? out + ((size_t)(b * T + qi) * Hq + h) * D : nullptr;
  });
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/flash_attention.py):
// head dim 128, Hq % Hkv == 0, contiguous 16-byte aligned bf16 tensors.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int flash_prefill(const void* q, const void* k, const void* v, void* out, int B, int T,
                             int Hq, int Hkv, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, Hq, B);
  flash_prefill_kernel<<<grid, fa::kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), T, Hq, Hkv,
      fa::Logit<false>::make(scale, 0.f));
  return (int)cudaGetLastError();
}
