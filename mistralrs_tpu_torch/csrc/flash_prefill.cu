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
// Design (FlashAttention-2 on mma.sync): a block of 4 warps owns 64 query
// rows of one head, 16 per warp, and walks the 64-key tiles up to the
// diagonal. Q, then K and V tiles (double-buffered) are staged in shared
// memory by 16-byte cp.async copies, each 256-byte row with its 16-byte
// chunks XOR-swizzled by the row, so ldmatrix reads are conflict-free. Each
// warp keeps its Q fragments in registers, computes its 16 x 64 score tile
// with bf16 mma.m16n8k16, and feeds the probabilities straight from the
// accumulator registers as the A operand of P.V (V read with ldmatrix.trans).
// Only the last (diagonal) tile is masked. Blocks with the most key tiles are
// launched first. wgmma, TMA and warp specialisation are later work.
#include "common.cuh"

namespace {

constexpr int BQ = 64;               // query rows per block, 16 per warp
constexpr int BK = 64;               // keys per tile (== BQ: the diagonal tile is the last)
constexpr int D = 128;               // head dim
constexpr int kThreads = 32 * (BQ / 16);
constexpr int kRowBytes = D * 2;
constexpr int kTileBytes = 64 * kRowBytes;    // one [64][128] bf16 tile
constexpr size_t kSmemBytes = 5 * kTileBytes;  // Q, then K and V of two stages

// byte offset of the 16-byte chunk c of row r in a staged tile
__device__ __forceinline__ uint32_t swz_off(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

// Stage rows t0..t0+63 of head h of a [B*T, H, D] tensor; rows past T are
// zero-filled (their source is not read).
__device__ __forceinline__ void stage_tile(uint8_t* tile, const __nv_bfloat16* src, int b, int T,
                                           int H, int h, int t0) {
  for (int i = threadIdx.x; i < 64 * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = t0 + r < T;
    const __nv_bfloat16* g = ok ? src + ((size_t)(b * T + t0 + r) * H + h) * D + 8 * c : src;
    mrt::cp_async16(tile + swz_off(r, c), g, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += A (16x16 bf16, row) * B (16x8 bf16, col), f32
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads)
    flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                         int T, int Hq, int Hkv, float scale_log2) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = mrt::smem_u32(smem);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;    // accumulator row g (and g + 8), columns 2t, 2t + 1
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row of, and index of, the 8x8 matrix
  const int ntiles = q0 / BK + 1;           // key tiles up to the diagonal

  // stage s of K/V sits at (1 + 2s) and (2 + 2s) tiles
  stage_tile(smem, q, b, T, Hq, h, q0);
  stage_tile(smem + kTileBytes, k, b, T, Hkv, kvh, 0);
  stage_tile(smem + 2 * kTileBytes, v, b, T, Hkv, kvh, 0);
  mrt::cp_async_commit();

  uint32_t qf[D / 16][4];  // A fragments of the warp's 16 query rows
  float o[D / 8][4];       // output accumulators: n-tile j holds dims 8j..8j+7
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8 (l: this lane's part)
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      stage_tile(smem + (3 - 2 * st) * kTileBytes, k, b, T, Hkv, kvh, (it + 1) * BK);
      stage_tile(smem + (4 - 2 * st) * kTileBytes, v, b, T, Hkv, kvh, (it + 1) * BK);
      mrt::cp_async_commit();
      mrt::cp_async_wait<1>();
    } else {
      mrt::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      // matrices 0..3: rows +0/+8 (lm & 1) x dims +0/+8 (lm >> 1) = a0..a3
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(sbase + swz_off(warp * 16 + 8 * (lm & 1) + lr, 2 * kk + (lm >> 1)), qf[kk]);
    }
    const uint32_t kbase = sbase + (1 + 2 * st) * kTileBytes;
    const uint32_t vbase = sbase + (2 + 2 * st) * kTileBytes;

    // S = Q K^T for 16 rows x 64 keys: n-tile j holds keys 8j..8j+7
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {
        // matrices: keys +0/+8 (lm >> 1) x dims +0/+8 (lm & 1) = b0, b1 of
        // n-tiles 2jp and 2jp + 1
        uint32_t bf[4];
        ldsm_x4(kbase + swz_off(16 * jp + 8 * (lm >> 1) + lr, 2 * kk + (lm & 1)), bf);
        mma_bf16(s[2 * jp], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // online softmax over the tile, base 2; the diagonal tile is the last
    const bool diag = it == ntiles - 1;
    const int k0 = it * BK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (diag) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          const int qi = q0 + warp * 16 + g + 8 * (e >> 1);
          if (kj > qi || kj >= T) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 lanes of a quad hold one row; every row has a key <= itself
      // below T in the first tile, so the max is finite from then on
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

    // O += P V: the S accumulators of n-tiles 2kk, 2kk + 1 are the A
    // fragment of keys 16kk..16kk+15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < D / 16; ++jp) {
        // matrices (transposed): keys +0/+8 (lm & 1) x dims +0/+8 (lm >> 1)
        // = b0, b1 of n-tiles 2jp and 2jp + 1
        uint32_t bf[4];
        ldsm_x4_trans(vbase + swz_off(16 * kk + 8 * (lm & 1) + lr, 2 * jp + (lm >> 1)), bf);
        mma_bf16(o[2 * jp], pa, bf[0], bf[1]);
        mma_bf16(o[2 * jp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage's K/V are free for the tile after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= T) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* op = out + ((size_t)(b * T + qi) * Hq + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(op + 8 * j) = pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
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
  flash_prefill_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), T, Hq, Hkv,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
