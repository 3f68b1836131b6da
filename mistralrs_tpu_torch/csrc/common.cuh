// Pieces shared by the hand-written Hopper kernels of mistralrs_tpu_torch:
// bf16 helpers, the int8 and bf16 tensor-core GEMV building blocks, the
// activation quantize kernel, the GEMV workspace layout and the split-K pass.
//
// Every kernel source is compiled on its own into a shared library with a
// plain C interface (see mistralrs_tpu_torch/ops/kernels.py); the sources
// that use a piece of this header each compile their own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mrt {

// bf16 -> f32 is exact: a bf16 is the high half of an f32.
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// 4x4 byte transpose: on entry a_i holds row i of four consecutive columns
// (byte j = column j); on exit a_j holds column j of the four rows (byte i =
// row i), 4 consecutive K values of one column as an mma B operand wants them.
__device__ __forceinline__ void transpose4(uint32_t& a0, uint32_t& a1, uint32_t& a2,
                                           uint32_t& a3) {
  const uint32_t t0 = __byte_perm(a0, a1, 0x5140);  // a0.b0 a1.b0 a0.b1 a1.b1
  const uint32_t t1 = __byte_perm(a2, a3, 0x5140);  // a2.b0 a3.b0 a2.b1 a3.b1
  const uint32_t t2 = __byte_perm(a0, a1, 0x7362);  // a0.b2 a1.b2 a0.b3 a1.b3
  const uint32_t t3 = __byte_perm(a2, a3, 0x7362);  // a2.b2 a3.b2 a2.b3 a3.b3
  a0 = __byte_perm(t0, t1, 0x5410);
  a1 = __byte_perm(t0, t1, 0x7632);
  a2 = __byte_perm(t2, t3, 0x5410);
  a3 = __byte_perm(t2, t3, 0x7632);
}

// ---- tensor-core GEMV building blocks (K1, K2, K3, K4, K9) ----
//
// A block owns 128 output columns (4 warps x 32) and a 16-row tile of x. The
// weight bytes of one K step (32 rows x 128 columns) are staged in shared
// memory with cp.async; in each 16-byte chunk index the row's
// swz(r) = ((r >> 2) & 3) << 1 is XORed, so the 32-bit reads below hit 32
// different banks.
constexpr int kGemvCols = 128;
constexpr int kGemvThreads = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy global -> shared; zero-fills when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int swz(int r) { return ((r >> 2) & 3) << 1; }

// byte offset of (row r, column c) in a staged 128-column tile
__device__ __forceinline__ int tile_off(int r, int c) {
  return r * kGemvCols + ((((c >> 4) ^ swz(r)) << 4) | (c & 15));
}

// Stage `rows` rows x 128 columns of a row-major [*, O] byte matrix starting
// at row r0 and column c0 (O % 16 == 0; chunks past O are zero-filled).
__device__ __forceinline__ void stage_bytes(uint8_t* tile, const uint8_t* src, int r0, int rows,
                                            int c0, int O) {
  for (int i = threadIdx.x; i < rows * 8; i += kGemvThreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = c0 + 16 * c < O;
    const uint8_t* g = ok ? src + (size_t)(r0 + r) * O + c0 + 16 * c : src;
    cp_async16(tile + r * kGemvCols + ((c ^ swz(r)) << 4), g, ok);
  }
}

// B fragments of mma.m16n8k32 for the 4 n-tiles of a warp, from K rows
// k0..k0+31 of a staged tile. n-tile j of warp w holds the columns
// w*32 + 4n + j (n = 0..7), so lane (g = lane/4, t = lane%4) reads the 4
// columns w*32 + 4g .. +3 of rows k0+4t.. (b0) and k0+16+4t.. (b1), and one
// 4x4 byte transpose yields b0/b1 of all 4 n-tiles: b0[j] = rows k0+4t..+3
// of column w*32 + 4g + j.
__device__ __forceinline__ void b_frags(const uint8_t* tile, int k0, int warp, int lane,
                                        uint32_t b0[4], uint32_t b1[4]) {
  const int g = lane >> 2, t = lane & 3;
  const int c = warp * 32 + 4 * g;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b0[i] = *reinterpret_cast<const uint32_t*>(tile + tile_off(k0 + 4 * t + i, c));
    b1[i] = *reinterpret_cast<const uint32_t*>(tile + tile_off(k0 + 16 + 4 * t + i, c));
  }
  transpose4(b0[0], b0[1], b0[2], b0[3]);
  transpose4(b1[0], b1[1], b1[2], b1[3]);
}

// A fragment of mma.m16n8k32 (16 x 32 int8, row-major) from a staged x tile
// (16 rows of `stride` bytes): rows lane/4 and lane/4 + 8, bytes k0 + 4t..
// and k0 + 16 + 4t.. (t = lane%4).
__device__ __forceinline__ void a_frag(const int8_t* xt, int stride, int k0, int lane,
                                       uint32_t a[4]) {
  const int g = lane >> 2, t = lane & 3;
  const int8_t* p0 = xt + g * stride + k0 + 4 * t;
  const int8_t* p1 = p0 + 8 * stride;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
}

// Stage `chunks` 16-byte chunks of each of x's rows row0..row0+15 into a
// tile of `stride`-byte rows: chunk c of row r comes from
// xq + (row0 + r) * K + col(c); rows past B are zero-filled. Uses threads
// [first, first + 16 * chunks) of the block.
template <typename ColFn>
__device__ __forceinline__ void stage_x(int8_t* xt, int stride, const int8_t* xq, int B, int K,
                                        int row0, int chunks, int first, ColFn col) {
  const int i = (int)threadIdx.x - first;
  if (i < 0 || i >= 16 * chunks) return;
  const int r = i / chunks, c = i % chunks;
  const bool ok = row0 + r < B;
  cp_async16(xt + r * stride + 16 * c, ok ? xq + (size_t)(row0 + r) * K + col(c) : xq, ok);
}

// Stage 16 floats v[row0 .. row0+15] of a transposed [*, Bpad] activation
// scale array (4 chunks) with threads [first, first + 4).
__device__ __forceinline__ void stage_rows16(float* dst, const float* v, int first) {
  const int c = (int)threadIdx.x - first;
  if (c >= 0 && c < 4) cp_async16(dst + 4 * c, v + 4 * c, true);
}

// d += A (16x32 s8, row) * B (32x8 s8, col), int32 (exact)
__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A (16x16 s8, row) * B (16x8 s8, col), int32 (exact): the per-16 dots
// of K3. With a_frag's registers, {a[0], a[1]} is the A fragment of bytes
// k0..k0+15 and {a[2], a[3]} that of k0+16..k0+31; b_frags' b0 and b1 are
// the matching B fragments.
__device__ __forceinline__ void mma_s8_k16(int d[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// Four 8x8 b16 matrices from shared memory (lane i gives the address of a row
// of matrix i / 8), and the same transposed (ldmatrix.trans).
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

// d += A (16x16 bf16, row) * B (16x8 bf16, col), f32 accumulators (K4, K13).
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Write a warp's [16 rows x 32 columns] f32 accumulators to part[B, O]: C
// element e of n-tile j sits at row row0 + lane/4 + 8*(e/2), column
// col0 + warp*32 + 8*(lane%4) + 4*(e%2) + j.
__device__ __forceinline__ void store_part(float* part, const float (&acc)[4][4], int B, int O,
                                           int row0, int col0, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + g + 8 * (e >> 1);
      const int c = col0 + warp * 32 + 8 * t + 4 * (e & 1) + j;
      if (r < B && c < O) part[(size_t)r * O + c] = acc[j][e];
    }
}

// 4 consecutive f32 from shared memory holding bf16 or f32 values
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float o[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  o[0] = bf16_lo(u.x);
  o[1] = bf16_hi(u.x);
  o[2] = bf16_lo(u.y);
  o[3] = bf16_hi(u.y);
}
__device__ __forceinline__ void lds4(const float* p, float o[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Activation quantization per GS-element block, one warp per block:
//   xs = max(max|x_block|, 1e-10) * (1/127)   (f32 multiply, not a divide)
//   xq = clip(rint(x / xs), -127, 127)        (IEEE divide, round half to even)
// (skipped when xq is null: K4 only takes sums), and, when xsum32 / xsum16
// are given, the f32 sums of every 32 / 16 original values. The plain
// PyTorch version (ops/quant_matmul._quantize_acts_q8_gs) does the same f32
// operations, so xq and xs agree bit for bit; only the sums' order differs.
// xq is [B, K]; xs, xsum32 and xsum16 are written transposed, [K/GS][bpad],
// [K/32][bpad] and [K/16][bpad] (bpad = B rounded up to 16), so a GEMV
// block can stage the values of its 16 rows as 16-byte chunks.
template <typename XT, int GS>
__global__ void quantize_acts_kernel(const XT* __restrict__ x, int8_t* __restrict__ xq,
                                     float* __restrict__ xs, float* __restrict__ xsum32,
                                     float* __restrict__ xsum16, long long nblocks,
                                     int nblk_row, int bpad) {
  constexpr int E = GS / 32;
  const long long g = (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (g >= nblocks) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int b = (int)(g / nblk_row), kb = (int)(g % nblk_row);
  float v[E];
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] = to_f32(x[g * GS + e * 32 + lane]);
    amax = fmaxf(amax, fabsf(v[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (xq != nullptr) {
    const float s = fmaxf(amax, 1e-10f) * (1.0f / 127.0f);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float q = fminf(fmaxf(rintf(v[e] / s), -127.f), 127.f);
      xq[g * GS + e * 32 + lane] = (int8_t)(int)q;
    }
    if (lane == 0) xs[(size_t)kb * bpad + b] = s;
  }
  if (xsum32 != nullptr) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float t = v[e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
      if (lane == 0) xsum32[(size_t)(kb * E + e) * bpad + b] = t;
    }
  }
  if (xsum16 != nullptr) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float t = v[e];  // lanes 0..15 and 16..31 sum apart
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
      if ((lane & 15) == 0) xsum16[(size_t)(2 * (kb * E + e) + (lane >> 4)) * bpad + b] = t;
    }
  }
}

template <int GS>
inline void launch_quantize(const void* x, bool x_is_bf16, int8_t* xq, float* xs, float* xsum32,
                            float* xsum16, int B, int K, int bpad, cudaStream_t st) {
  const int warps = 8;
  const long long nblocks = (long long)B * (K / GS);
  const unsigned grid = (unsigned)((nblocks + warps - 1) / warps);
  if (x_is_bf16)
    quantize_acts_kernel<__nv_bfloat16, GS><<<grid, 32 * warps, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), xq, xs, xsum32, xsum16, nblocks, K / GS, bpad);
  else
    quantize_acts_kernel<float, GS><<<grid, 32 * warps, 0, st>>>(
        static_cast<const float*>(x), xq, xs, xsum32, xsum16, nblocks, K / GS, bpad);
}

// Scratch of one GEMV call, carved from one workspace buffer in this order,
// each piece 256-byte aligned (ops/quant_matmul._workspace_bytes mirrors it).
inline size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

struct Workspace {
  int8_t* xq;   // [B, K], nullptr when gs is 0
  float* xs;    // [K/gs, bpad], nullptr when gs is 0
  float* xsum;  // [K/sum_gs, bpad], nullptr when sum_gs is 0
  float* part;  // [ksplit, B, O]
  int bpad;     // B rounded up to 16
  size_t bytes;
};

inline Workspace carve(void* ws, int B, int K, int O, int gs, int sum_gs, int ksplit) {
  char* p = static_cast<char*>(ws);
  Workspace w;
  w.bpad = (B + 15) / 16 * 16;
  size_t off = 0;
  w.xq = nullptr;
  w.xs = nullptr;
  if (gs) {
    w.xq = reinterpret_cast<int8_t*>(p + off);
    off += align256((size_t)B * K);
    w.xs = reinterpret_cast<float*>(p + off);
    off += align256((size_t)(K / gs) * w.bpad * 4);
  }
  w.xsum = sum_gs ? reinterpret_cast<float*>(p + off) : nullptr;
  if (sum_gs) off += align256((size_t)(K / sum_gs) * w.bpad * 4);
  w.part = reinterpret_cast<float*>(p + off);
  off += align256((size_t)ksplit * B * O * 4);
  w.bytes = off;
  return w;
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Sum the split-K partials part[ksplit, n] into out[n] in a fixed order, so a
// result does not depend on which block finished first.
template <typename OutT>
__global__ void splitk_reduce_kernel(const float* __restrict__ part, OutT* __restrict__ out,
                                     int ksplit, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int y = 0; y < ksplit; ++y) s += part[(size_t)y * n + i];
  store_out(out + i, s);
}

template <typename OutT>
inline void launch_reduce(const float* part, void* out, int ksplit, int n, cudaStream_t st) {
  splitk_reduce_kernel<OutT><<<(n + 255) / 256, 256, 0, st>>>(part, static_cast<OutT*>(out),
                                                               ksplit, n);
}

// The tail of every GEMV's C entry point: check the GEMV's launch, then add
// the split-K partials into out (bf16 or f32). Returns the CUDA error code.
inline int finish_gemv(const Workspace& w, void* out, int out_is_bf16, int ksplit, int n,
                       cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (out_is_bf16)
    launch_reduce<__nv_bfloat16>(w.part, out, ksplit, n, st);
  else
    launch_reduce<float>(w.part, out, ksplit, n, st);
  return (int)cudaGetLastError();
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB it must ask).
template <typename F>
inline cudaError_t allow_smem(F* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace mrt
