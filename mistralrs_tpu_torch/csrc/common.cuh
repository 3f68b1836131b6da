// Pieces shared by the hand-written Hopper kernels of mistralrs_tpu_torch:
// bf16 helpers, the int8 and bf16 tensor-core GEMV building blocks, the
// activation quantize kernel, the GEMV workspace layout and the split-K pass.
//
// Every kernel source is compiled on its own into a shared library with a
// plain C interface (see mistralrs_tpu_torch/ops/kernels.py); the sources
// that use a piece of this header each compile their own copy.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only; nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mrt {

// bf16 -> f32 is exact: a bf16 is the high half of an f32.
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// v split into three bf16 parts, hi first: v = p[0] + p[1] + p[2] to within
// 2^-24 of |v| (each part takes the bits the one before left).
__device__ __forceinline__ void split3(float v, __nv_bfloat16 p[3]) {
  p[0] = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r);
  p[2] = __float2bfloat16_rn(r - __bfloat162float(p[1]));
}

// two bf16 as one 32-bit word, lo in the low half
__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

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

// ---- tensor-core GEMV building blocks (the mma wrappers of K1-K5, K8-K10,
// the Q5_K x bf16 decode kernel and K13) ----
//
// A block of the rows instantiations owns 128 output columns.
constexpr int kGemvCols = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy global -> shared; zero-fills when !valid (src unread)
// (the mma.sync attention kernels of flash_attn.cuh: K7, K12's decode).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += A (16x32 s8, row) * B (32x8 s8, col), int32 (exact)
__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A (16x32 u8, row) * B (32x8 s8, col), int32 (exact)
__device__ __forceinline__ void mma_u8s8(int d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A (16x16 s8, row) * B (16x8 s8, col), int32 (exact): the per-16 dots
// of K3 (csrc/q6k_gemv.cu), A the weight's codes of two columns (a0: A row
// g, a1: row g + 8; 4 K bytes each) and B x's 16 bytes of one row.
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

// ---- Hopper pieces of the rows instantiations (K1, K2 at 17-256 rows) ----
//
// mbarriers, bulk copies (cp.async.bulk, completion counted in bytes on an
// mbarrier), the proxy fence that orders the generic stores of a decoded
// tile before the tensor cores read it, and int8 wgmma with operands in
// shared memory.

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16, 16-byte aligned ends) global -> shared; the
// arrival is counted on `bar` in bytes.
__device__ __forceinline__ void bulk_g2s(void* smem, const void* gmem, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// TMA: a box of a tensor map (a __grid_constant__ kernel parameter) global ->
// shared, counted on `bar` in bytes (the whole box; parts past the tensor's
// edge are zero-filled).
__device__ __forceinline__ void tma_load_2d(void* smem, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* smem, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* smem, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// TMA: shared -> a box of a tensor map, in the thread's bulk group (parts
// past the tensor's edge are not written); wait until the bulk groups have
// read their shared memory before it is reused or the block exits.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* smem, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(smem)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// A tiled tensor map of a tensor of rank <= 5: dims[0] elements of `dtype`
// in the innermost dimension, byte strides of the outer ones, a box of `box`
// elements, no swizzle unless asked. cuTensorMapEncodeTiled is looked up
// through the CUDA runtime (cudaGetDriverEntryPoint), so the library links
// nothing of libcuda. Returns a CUDA error.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline int tile_map(CUtensorMap* map, CUtensorMapDataType dtype, int rank, const void* base,
                    const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  if (rank < 1 || rank > 5) return (int)cudaErrorInvalidValue;
  cuuint64_t d[5], st[4];
  cuuint32_t b[5], es[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    es[i] = 1;
    if (i) st[i - 1] = strides[i - 1];
  }
  const CUresult r = encode(map, dtype, (cuuint32_t)rank, const_cast<void*>(base), d, st, b, es,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major int8 operand without swizzle:
// core matrices of 8 rows x 16 bytes (128 contiguous bytes); `lbo` bytes
// from the first 16 K-bytes of a row to the next 16, `sbo` bytes from one
// group of 8 rows to the next.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// The two int8 tile layouts of the rows instantiations, both K-major over one
// 32-element K slice: A (x's codes, tiled_off) puts row r, byte k of a 64-row
// block at (k/16)*1024 + r*16 + k%16; B (a decoded weight tile of 128
// columns) puts column c, byte k at (k/16)*2048 + c*16 + k%16.
constexpr uint32_t kALbo = 1024, kBLbo = 2048, kTileSbo = 128;

// d[N/2] (+)= A (64x32 s8, K-major, smem) * B (32xN s8, K-major, smem),
// exact int32, N = 128 or 64. scale_d 0 overwrites d, 1 adds to it.
// Accumulator i of a thread holds row 16*(warp%4) + lane/4 + 8*((i/2)%2),
// column 8*(i/4) + 2*(lane%4) + i%2.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 128)
    wgmma_s8_n128(d, da, db, scale_d);
  else
    wgmma_s8_n64(d, da, db, scale_d);
}

// d[N/2] = -A (64x16 bf16, K-major, smem) * B (16xN bf16, K-major, smem)
// (+ d when scale_d is 1), f32 accumulators held in int registers as bits:
// K1's min term on the tensor cores, in an int8 accumulator's registers
// while they are free. The bf16 K-major tiles use the int8 tiles' layouts
// (8 bf16 are 16 bytes).
__device__ __forceinline__ void wgmma_bf16_neg_n128(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, -1, 1, 0, 0;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_bf16_neg_n64(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, -1, 1, 0, 0;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <int N>
__device__ __forceinline__ void wgmma_bf16_neg(int (&d)[N / 2], uint64_t da, uint64_t db,
                                               int scale_d) {
  if constexpr (N == 128)
    wgmma_bf16_neg_n128(d, da, db, scale_d);
  else
    wgmma_bf16_neg_n64(d, da, db, scale_d);
}

// The bf16 products of the plane rows kernel (K10 at 17-256 rows), f32
// accumulators:
// - wgmma_bf16: d[N/2] += A (64x16, smem, K-major) * B (16xN, smem,
//   K-major);
// - wgmma_bf16_rs_neg: d[N/2] += -A (64x16, registers: the A fragments of
//   mma.m16n8k16 per warp) * B (16xN, smem, MN-major), the zs term.
// N = 128 or 64; accumulator i of a thread holds row 16*(warp%4) + lane/4 +
// 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) + i%2.
#define MRT_F8(i)                                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define MRT_ACC32_STR                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define MRT_ACC64_STR                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "    \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63}"

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 128)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MRT_ACC64_STR
                 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : MRT_F8(0), MRT_F8(8), MRT_F8(16), MRT_F8(24), MRT_F8(32), MRT_F8(40),
                   MRT_F8(48), MRT_F8(56)
                 : "l"(da), "l"(db), "r"(1));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MRT_ACC32_STR
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : MRT_F8(0), MRT_F8(8), MRT_F8(16), MRT_F8(24)
                 : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16_rs_neg(float (&d)[N / 2], const uint32_t (&a)[4],
                                                  uint64_t db) {
  if constexpr (N == 128)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " MRT_ACC64_STR
                 ", {%64, %65, %66, %67}, %68, p, -1, 1, 1;\n}\n"
                 : MRT_F8(0), MRT_F8(8), MRT_F8(16), MRT_F8(24), MRT_F8(32), MRT_F8(40),
                   MRT_F8(48), MRT_F8(56)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MRT_ACC32_STR
                 ", {%32, %33, %34, %35}, %36, p, -1, 1, 1;\n}\n"
                 : MRT_F8(0), MRT_F8(8), MRT_F8(16), MRT_F8(24)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// K13's product (the grouped GEMM above 32 rows a group): d[128] += A
// (64x16, smem, K-major) * B (16x256, smem, MN-major: the row-major [K, N]
// weight read in place), the accumulators as wgmma_bf16's.
#define MRT_ACC128_STR                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "       \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "    \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "    \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, "    \
  "%73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "    \
  "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "    \
  "%123, %124, %125, %126, %127}"
__device__ __forceinline__ void wgmma_bf16_ss_t(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " MRT_ACC128_STR
               ", %128, %129, p, 1, 1, 0, 1;\n}\n"
               : MRT_F8(0), MRT_F8(8), MRT_F8(16), MRT_F8(24), MRT_F8(32), MRT_F8(40),
                 MRT_F8(48), MRT_F8(56), MRT_F8(64), MRT_F8(72), MRT_F8(80), MRT_F8(88),
                 MRT_F8(96), MRT_F8(104), MRT_F8(112), MRT_F8(120)
               : "l"(da), "l"(db), "r"(1));
}
#undef MRT_F8
#undef MRT_ACC32_STR
#undef MRT_ACC64_STR
#undef MRT_ACC128_STR

// Shared-memory matrix descriptors with a swizzle: `lbo` and `sbo` as for
// kmajor_desc (for a K-major operand lbo is unused), layout 1 = the 128-byte
// swizzle, 2 = 64-byte, 3 = 32-byte (the pattern TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B, _64B, _32B; the tile starts on the pattern's
// period: 1024, 512, 256 bytes).
__device__ __forceinline__ uint64_t swizzled_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                                  uint32_t layout) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

// A compiler-level fence on accumulator registers (no instruction): reads
// and writes of d are not moved across it, so the epilogue's reads stay
// after the wgmma.wait that completes d, and before the next wgmma into d.
template <int NA>
__device__ __forceinline__ void fence_operand(int (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int NA>
__device__ __forceinline__ void fence_operand(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for a wgmma's A fragments held in registers: placed after the
// wait that completes it, their registers are not reused before
template <int NA>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The warpgroup index, broadcast from lane 0 so that the compiler sees it is
// the same in every thread of a warp (a branch on it is then not divergent,
// which wgmma's register pipeline needs).
__device__ __forceinline__ int warpgroup_idx() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

// Decode 4 columns x 8 K rows of a staged [rows][128] byte tile (row r at
// r*128) for a K-major B tile: w[i] = the 4 bytes of row r0+i. The bytes of
// each word are rotated by `rot` columns first, so that after the two 4x4
// transposes w[j] (rows r0..r0+3) and w[4+j] (rows r0+4..r0+7) hold column
// (j + rot) & 3 of the quad: lanes that store at the same step then hit
// other banks.
__device__ __forceinline__ void load_quad8(const uint8_t* raw, int r0, int quad, uint32_t sel,
                                           uint32_t w[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = __byte_perm(*reinterpret_cast<const uint32_t*>(raw + (r0 + i) * kGemvCols + 4 * quad),
                       0, sel);
  transpose4(w[0], w[1], w[2], w[3]);
  transpose4(w[4], w[5], w[6], w[7]);
}
// the byte_perm selector of a rotation by rot columns
__device__ __forceinline__ uint32_t rot_sel(int rot) {
  return (uint32_t)(rot & 3) | ((uint32_t)((rot + 1) & 3) << 4) |
         ((uint32_t)((rot + 2) & 3) << 8) | ((uint32_t)((rot + 3) & 3) << 12);
}
// column c's 8 bytes of K rows k0..k0+7 (k0 % 8 == 0, < 32) in a B tile
__device__ __forceinline__ void store_b8(uint8_t* tile, int c, int k0, uint32_t lo, uint32_t hi) {
  *reinterpret_cast<uint2*>(tile + (k0 >> 4) * kBLbo + c * 16 + (k0 & 15)) = make_uint2(lo, hi);
}
// Where column c's f32 scale sits in a permuted row of kScaleRow floats:
// thread t = lane%4 of a wgmma accumulator owns columns 8j + 2t + e, and
// finds them at t*36 + 2j + e, so 4 of them come in one 16-byte load and
// the four t read other banks (36, not 32).
constexpr int kScaleRow = 4 * 36;
__device__ __forceinline__ int scale_pos(int c) { return ((c & 7) >> 1) * 36 + (c >> 3) * 2 + (c & 1); }

// Store a thread's [2 rows x NA/2 columns] of a 64-row wgmma tile (acc
// index i: row rbase + 8*((i/2)%2), column cbase + 8*(i/4) + i%2) to
// out[B, O] (f32 or bf16) or to f32 partials.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <typename OutT, int NA>
__device__ __forceinline__ void store_acc(OutT* out, const float (&acc)[NA], int B, int O,
                                          int rbase, int cbase) {
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int r = rbase + 8 * ((i >> 1) & 1), c = cbase + 8 * (i >> 2);
    if (r < B && c < O) store_pair(out + (size_t)r * O + c, acc[i], acc[i + 1]);
  }
}
// out_mode 0: f32 out [B, O]; 1: bf16 out; 2: f32 partials [ksplit, B, O],
// this block's split at blockIdx.z
template <int NA>
__device__ __forceinline__ void store_rows(void* out, int out_mode, const float (&acc)[NA], int B,
                                           int O, int rbase, int cbase) {
  if (out_mode == 1)
    store_acc(static_cast<__nv_bfloat16*>(out), acc, B, O, rbase, cbase);
  else
    store_acc(static_cast<float*>(out) + (out_mode == 2 ? (size_t)blockIdx.z * B * O : 0), acc,
              B, O, rbase, cbase);
}

// ---- The ring of the rows instantiations ----
//
// A block of kRowThreads threads: consumer warpgroups 0 and 1, then a
// producer warpgroup. Over the block's n K steps, step i uses stage i %
// kStages of a ring in shared memory (the stages, then `extra` bytes of
// other buffers, then three mbarriers a stage):
// - thread 0 of producer warp 0 waits until the stage is free (`empty`,
//   one arrival per consumer warp), announces the step's `tx` bytes on
//   `full` and issues its copies, whose landing completes `full`;
// - producer warps 1-3 take the steps round robin, a whole stage each
//   (a stage's decode is a chain of dependent shared-memory steps, so
//   three run at once): once `full`, they decode it, order their generic
//   stores before the tensor cores' reads (fence.proxy.async), and arrive
//   on `ready`;
// - the consumers wait for `full` and `ready` (acquire), read the stage,
//   and free it (release), every warp apart.
// The producer warpgroup gives up registers (kProducerRegs a thread, 40
// by default) to the consumers (the rest of the 64K: 232 at 40). A ring
// with kDecode false has no decode step (the attention kernels K6 and
// K6', csrc/flash_sm90.cuh): all four producer
// warps issue a step's copies, copy(stage, i, full, ready, warp, lane) on
// every lane; warps 0-1 announce their bytes on `full`, warps 2-3 on
// `ready`, a second barrier of the step (two arrivals each); the consumers
// wait for either (acquire, acquire_ready). With kSplitEmpty as well, a
// stage's K and V are freed apart: warps 0-1 wait on `empty`, which the
// consumers arrive on once their Q.K^T of the stage is done (release_k),
// and warps 2-3 on a fourth barrier of the step, `vempty` (release), so a
// ring of two stages still loads a tile's K while the tile before it is in
// P.V (K12's chunks, csrc/flash_sm90.cuh).
constexpr int kRowThreads = 384;

// Stages of a ring: as many as kBudget bytes of shared memory (~200 KB;
// 226 KB leaves room for the barriers in the card's 227) hold beside kExtra
// bytes of other buffers, at most kMax (12: the copies of a stage take ~1-2
// us to land, and the consumers need one every few hundred ns), and a
// multiple of the three decode warps: a decode warp then also decoded the
// stage's previous use, so it never waits on a `full` barrier two phases
// ahead (a parity wait would pass there at once).
constexpr int kRingBudget = 200 * 1024;
constexpr int kRingBudgetMax = 226 * 1024;
template <typename Stage, int kExtra = 0, int kMax = 12, int kBudget = kRingBudget>
__host__ __device__ constexpr int ring_stages() {
  return ((int)((kBudget - kExtra) / sizeof(Stage)) < kMax
              ? (int)((kBudget - kExtra) / sizeof(Stage))
              : kMax) /
         3 * 3;
}

template <typename Stage, int kStages, bool kDecode = true, int kProducerRegs = 40,
          bool kSplitEmpty = false>
struct Ring {
  static_assert(!(kDecode && kSplitEmpty), "a decode ring frees whole stages");
  // the consumers' registers: what the producers leave of the 64K, in 8s
  static constexpr int kConsumerRegs = (65536 - 128 * kProducerRegs) / 256 / 8 * 8;
  static constexpr int kBars = kSplitEmpty ? 4 : 3;  // mbarriers a stage
  // dynamic shared memory of the ring with `extra` bytes of other buffers
  static constexpr int smem_bytes(int extra) {
    return kStages * ((int)sizeof(Stage) + kBars * 8) + extra;
  }
  Stage* st;
  uint64_t* bar;  // full[kStages], ready[kStages], empty[kStages](, vempty[kStages])

  __device__ Ring(uint8_t* smem, int extra)
      : st(reinterpret_cast<Stage*>(smem)),
        bar(reinterpret_cast<uint64_t*>(smem + kStages * sizeof(Stage) + extra)) {}
  // the buffers after the stages
  __device__ void* extra() const { return st + kStages; }
  __device__ Stage& operator[](int i) const { return st[i % kStages]; }
  __device__ static int parity(int i) { return (i / kStages) & 1; }
  __device__ uint64_t* full(int i) const { return bar + i % kStages; }
  __device__ uint64_t* ready(int i) const { return bar + kStages + i % kStages; }
  __device__ uint64_t* empty(int i) const { return bar + 2 * kStages + i % kStages; }
  __device__ uint64_t* vempty(int i) const { return bar + 3 * kStages + i % kStages; }

  // by every consumer thread before it reads step i's stage
  __device__ void acquire(int i) const {
    mbar_wait(full(i), parity(i));
    if constexpr (kDecode) mbar_wait(ready(i), parity(i));
  }
  // without kDecode: by every consumer thread before it reads what step i
  // announced on `ready`
  __device__ void acquire_ready(int i) const { mbar_wait(ready(i), parity(i)); }
  // by every consumer thread once its warp's reads of step i are done (with
  // kSplitEmpty: its reads of step i's V)
  __device__ void release(int i) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(kSplitEmpty ? vempty(i) : empty(i));
  }
  // with kSplitEmpty, by every consumer thread once its warp's reads of step
  // i's K are done; nothing without
  __device__ void release_k(int i) const {
    if constexpr (kSplitEmpty) {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty(i));
    }
  }

  // The whole block: copy(stage, i, full barrier) issues step i's copies
  // (`tx` bytes, or tx(i) bytes when tx is a function of the step; without
  // kDecode copy(stage, i, full, ready, warp, lane) by every producer
  // thread, and `tx` unused), decode(stage, i, lane) decodes it (not called
  // without kDecode), consume(wg) is a consumer warpgroup's work.
  template <typename Tx, typename Copy, typename Decode, typename Consume>
  __device__ __forceinline__ void run(int n, Tx tx, Copy&& copy, Decode&& decode,
                                      Consume&& consume) const {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) {
        mbar_init(full(i), kDecode ? 1 : 2);
        mbar_init(ready(i), kDecode ? 1 : 2);
        mbar_init(empty(i), 8);  // one arrival per consumer warp
        if constexpr (kSplitEmpty) mbar_init(vempty(i), 8);
      }
      mbar_init_fence();
    }
    __syncthreads();
    const int wg = warpgroup_idx();
    if (wg == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
      const int pw = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
      if constexpr (!kDecode) {
        for (int i = 0; i < n; ++i) {
          if (i >= kStages)
            mbar_wait(kSplitEmpty && pw >= 2 ? vempty(i) : empty(i), parity(i) ^ 1);
          copy((*this)[i], i, full(i), ready(i), pw, lane);
        }
      } else if (pw == 0) {
        if (lane == 0)
          for (int i = 0; i < n; ++i) {
            if (i >= kStages) mbar_wait(empty(i), parity(i) ^ 1);
            if constexpr (std::is_invocable_v<Tx, int>)
              mbar_expect_tx(full(i), tx(i));
            else
              mbar_expect_tx(full(i), (uint32_t)tx);
            copy((*this)[i], i, full(i));
          }
      } else {
        for (int i = pw - 1; i < n; i += 3) {
          mbar_wait(full(i), parity(i));
          decode((*this)[i], i, lane);
          fence_proxy_async();  // the decoded tiles, before the tensor cores read them
          __syncwarp();
          if (lane == 0) mbar_arrive(ready(i));
        }
      }
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
      consume(wg);
    }
  }
};

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
// and, when xsum32 / xsum16 are given, the f32 sums of every 32 / 16
// original values. The plain PyTorch version
// (ops/quant_matmul._quantize_acts_q8_gs) does the same f32 operations, so
// xq and xs agree bit for bit; only the sums' order differs.
// xs, xsum32 and xsum16 are written transposed, [K/GS][bpad], [K/32][bpad]
// and [K/16][bpad], so a GEMV block can copy the values of its rows as one
// piece.
//
// The layout of xq (XLayout): `kTiled` (the rows instantiations of K1, K2
// and K9): bpad is B rounded up to the block's row tile (64 or 128), the
// rows B..bpad-1 are quantized as zeros, and xq is
// written in the int8 wgmma A layout of tiled_off, so one bulk copy brings
// a 32-element slice of a row tile into shared memory ready for the tensor
// cores; `kDecode` (the decode instantiations of K1, K2, K3 and K9): bpad is
// 16, rows B..15 are zeros, and each 32-element slice of the 16 rows is 512
// contiguous bytes (decode_off), read as mma B fragments.
enum XLayout { kTiled = 1, kDecode = 2 };

__host__ __device__ __forceinline__ size_t tiled_off(int b, int k, int bpad) {
  return (size_t)(k >> 5) * bpad * 32 + (size_t)(b >> 6) * 2048 + ((k >> 4) & 1) * 1024 +
         (b & 63) * 16 + (k & 15);
}
// [K/32][16 rows][32 bytes], the two 16-byte halves of a row swapped in rows
// 4-7 and 12-15, so that the B fragments of mma.m16n8k32 (row g, bytes 4t..
// of a half) hit 32 different banks.
__host__ __device__ __forceinline__ size_t decode_off(int b, int k) {
  return (size_t)(k >> 5) * 512 + b * 32 + ((((k >> 4) & 1) ^ ((b >> 2) & 1)) << 4) + (k & 15);
}

template <typename XT, int GS>
__global__ void quantize_acts_kernel(const XT* __restrict__ x, int8_t* __restrict__ xq,
                                     float* __restrict__ xs, float* __restrict__ xsum32,
                                     float* __restrict__ xsum16, long long nblocks,
                                     int nblk_row, int bpad, int B, int layout) {
  constexpr int E = GS / 32;
  const long long g = (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (g >= nblocks) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int b = (int)(g / nblk_row), kb = (int)(g % nblk_row);
  const bool live = b < B;  // the padding rows of a tiled or decode call quantize zeros
  float v[E];
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] = live ? to_f32(x[g * GS + e * 32 + lane]) : 0.f;
    amax = fmaxf(amax, fabsf(v[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(amax, 1e-10f) * (1.0f / 127.0f);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float q = fminf(fmaxf(rintf(v[e] / s), -127.f), 127.f);
    const int k = kb * GS + e * 32 + lane;
    xq[layout == kTiled ? tiled_off(b, k, bpad) : decode_off(b, k)] = (int8_t)(int)q;
  }
  if (lane == 0) xs[(size_t)kb * bpad + b] = s;
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

// Quantize x [B, K] into the tiled or decode layout, over all bpad rows.
template <int GS>
inline void launch_quantize(const void* x, bool x_is_bf16, int8_t* xq, float* xs, float* xsum32,
                            float* xsum16, int B, int K, int bpad, cudaStream_t st,
                            XLayout layout) {
  const int warps = 8;
  const long long nblocks = (long long)bpad * (K / GS);
  const unsigned grid = (unsigned)((nblocks + warps - 1) / warps);
  if (x_is_bf16)
    quantize_acts_kernel<__nv_bfloat16, GS><<<grid, 32 * warps, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), xq, xs, xsum32, xsum16, nblocks, K / GS, bpad, B,
        layout);
  else
    quantize_acts_kernel<float, GS><<<grid, 32 * warps, 0, st>>>(
        static_cast<const float*>(x), xq, xs, xsum32, xsum16, nblocks, K / GS, bpad, B, layout);
}

// Scratch of one GEMV call, carved from one workspace buffer in this order,
// each piece 256-byte aligned (ops/quant_matmul._workspace_bytes mirrors it).
inline size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

// With kTiled (the rows instantiations of K1, K2 and K9; `rows` is their row tile):
// bpad is B rounded up to the row tile, so a block's bulk copies of x's codes,
// scales and sums stay inside their pieces; xq holds all bpad rows; the
// partials are there only when ksplit > 1 (with one split the GEMV writes
// out itself). With kDecode (the decode instantiations of K1, K2, K3, K9):
// bpad is 16, xq holds 16 rows, and there are no partials (the K splits of a
// column tile add theirs in the cluster's shared memory).
// With xcopy (K10's rows instantiation, tiled) a bf16 copy of x [bpad, K]
// in the GEMV's step order follows xsum.
struct Workspace {
  int8_t* xq;   // [bpad, K] (tiled or decode), nullptr when gs is 0
  float* xs;    // [K/gs, bpad], nullptr when gs is 0
  float* xsum;  // [K/sum_gs, bpad], nullptr when sum_gs is 0
  __nv_bfloat16* xc;  // [bpad, K], nullptr without xcopy
  float* part;  // [ksplit, B, O], nullptr when tiled with ksplit 1 or decode
  int bpad;     // B rounded up to 16 (to the row tile when tiled)
  size_t bytes;
};

inline Workspace carve(void* ws, int B, int K, int O, int gs, int sum_gs, int ksplit,
                       XLayout layout, int rows = 16, bool xcopy = false) {
  char* p = static_cast<char*>(ws);
  Workspace w;
  if (layout != kTiled) rows = 16;
  w.bpad = (B + rows - 1) / rows * rows;
  size_t off = 0;
  w.xq = nullptr;
  w.xs = nullptr;
  if (gs) {
    w.xq = reinterpret_cast<int8_t*>(p + off);
    off += align256((size_t)w.bpad * K);
    w.xs = reinterpret_cast<float*>(p + off);
    off += align256((size_t)(K / gs) * w.bpad * 4);
  }
  w.xsum = sum_gs ? reinterpret_cast<float*>(p + off) : nullptr;
  if (sum_gs) off += align256((size_t)(K / sum_gs) * w.bpad * 4);
  w.xc = xcopy ? reinterpret_cast<__nv_bfloat16*>(p + off) : nullptr;
  if (xcopy) off += align256((size_t)w.bpad * K * 2);
  w.part = nullptr;
  if (layout == kTiled && ksplit > 1) {
    w.part = reinterpret_cast<float*>(p + off);
    off += align256((size_t)ksplit * B * O * 4);
  }
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

// Whether the grid (gx, gy, gz) of a K1 or K2 call whose blocks own `cols`
// columns x `rows` rows covers the call with one block per tile: the
// decode instantiations' order is (K splits, column tiles, 1), B <= 16;
// the rows instantiations' (row tiles, column tiles, K splits), 128
// columns, row tiles inside the workspace's bpad rows.
inline bool grid_covers(const Workspace& w, int rows, int cols, int B, int O, int gx, int gy,
                        int gz) {
  if (gy != (O + cols - 1) / cols) return false;
  if (rows == 16) return B <= 16 && gz == 1 && gx >= 1;
  return cols == kGemvCols && gx == (B + rows - 1) / rows && gx * rows <= w.bpad;
}

// Launch a rows kernel (kRowThreads threads, `smem` bytes of dynamic shared
// memory) through launch(out, out_mode): into out with one split, else into
// the partials (out_mode 2), then the fixed-order split-K pass.
template <typename Kern, typename Launch>
inline int launch_ring(Kern* kern, int smem, const Workspace& w, void* out, int out_is_bf16,
                       int ksplit, int n_out, cudaStream_t st, Launch&& launch) {
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  launch(ksplit > 1 ? static_cast<void*>(w.part) : out, ksplit > 1 ? 2 : out_is_bf16);
  if (ksplit == 1) return (int)cudaGetLastError();
  return finish_gemv(w, out, out_is_bf16, ksplit, n_out, st);
}

// ---- The decode instantiations of K1-K5, K8-K10 and the Q5_K x bf16
// kernel (1-16 rows) ----
//
// A block owns `C` = 128 or 64 columns of out and all 16 rows of the row
// tile, and one K split of the call; the K splits of a column tile are one
// thread-block cluster (grid (splits, column tiles), cluster (splits, 1, 1),
// at most 8), which adds their f32 tiles in its distributed shared memory.
// A ring stage holds kDecSub K steps (64 byte rows of codes: 2 sub-block
// pairs of K1, 64/gs scale groups of K2; K3's and K4's, csrc/q6k_gemv.cu,
// one 14 KB step of Q6_K; K5's, K8's and K10's, csrc/plane_gemv.cuh, one
// step of 64 or 32 byte rows and their scale rows; K9's, csrc/q5k_q8_gemv.cu,
// and the Q5_K x bf16 kernel's, csrc/q5k_bf16_gemv.cu, one 24 KB step of
// 32 qh rows and the 4 qs blocks whose high bits they hold). Two producer warps (the block's last two) fill it, each on its
// own arrival at the stage's `full` barrier: one with TMA boxes of the
// weights, at most half the ring ahead of what has landed (so every
// block's first stages land first and its consumers start while the rest
// streams), one with bulk copies (K9: TMA boxes) of x's codes and scales,
// once the quantize kernel launched just before has
// finished (the GEMV is launched behind it by programmatic dependent
// launch, so the launch and the first weight stages overlap its end).
// C / 32 consumer warps run the stage's int8 mma.sync and its scaling into
// f32 sums, then free it. No per-call state: the barriers are set up by
// each block, nothing in global memory needs zeroing, and the launches
// can be captured in a CUDA graph.
//
// Ring depth (Little's law): the card streams 3.35 TB/s from memory that
// answers in ~1-2 us under load, so ~3.35-6.7 MB must be in flight, ~25-50
// KB an SM over 132 SMs. A block's ring holds kDecInFlight = 32 KB of
// weights (dec_stages stages: four of ~9-10 KB at C = 128, seven or eight
// of ~5 KB at C = 64), at most half of it in flight, the other half
// holding what has landed for the consumers; the plans put up to three
// blocks on an SM (the kernels' launch bounds), so up to ~48 KB an SM is
// in flight. (With every stage issued at once, the blocks' first stages
// landed only when most of a weight had: ~5 us in, on the card, with
// nothing to compute before.)
constexpr int kDecRows = 16;
constexpr int kDecSub = 2;
// a block's threads: a consumer warp a 32-column group, two producer warps
__host__ __device__ constexpr int dec_threads(int C) { return 32 * (C / 32 + 2); }
constexpr int kDecInFlight = 32 * 1024;
__host__ __device__ constexpr int dec_stages(int weight_bytes) {
  return (kDecInFlight + weight_bytes - 1) / weight_bytes;
}

// K steps a split of `steps` over `splits` blocks takes: whole stages of
// `sub` steps, the last split fewer (ops/quant_matmul.int8_gemv_plan picks
// splits with none empty)
__host__ __device__ constexpr int dec_per_split(int steps, int splits, int sub = kDecSub) {
  return ((steps + splits - 1) / splits + sub - 1) / sub * sub;
}

// Wait until the grid this one was launched behind (programmatic dependent
// launch) has finished and its writes are visible.
__device__ __forceinline__ void grid_dep_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// Make the compiler compute v before this point (no instruction): the
// loads it depends on have then completed, so shared memory they read can
// be handed back to the copy engines.
template <int N>
__device__ __forceinline__ void fence_values(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i])::"memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster: writes to shared memory
// before it are seen by the reads of other blocks after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// the float4 at the shared-memory address of p in block `rank` of the cluster
__device__ __forceinline__ float4 ld_cluster4(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// An int32 of magnitude below 2^22 to f32, exactly, on the integer and FMA
// pipes: its bits added to those of 1.5 * 2^23 (whose ulp is 1), minus 1.5 *
// 2^23. An I2F conversion runs at a quarter of their rate, and the decode
// epilogue converts every int32 dot.
__device__ __forceinline__ float exact_f32(int d) {
  return __int_as_float(0x4B400000 + d) - 12582912.0f;
}

// A 32-bit word of a staged [rows][C] byte tile, as TMA lays it down: with
// the 128-byte swizzle at C = 128 (16-byte chunk j of row r at j ^ (r % 8)),
// plain at C = 64.
template <int C>
__device__ __forceinline__ uint32_t ld_tile_word(const uint8_t* tile, int r, int c) {
  const int off = r * C + c;
  return *reinterpret_cast<const uint32_t*>(tile + (C == 128 ? off ^ ((r & 7) << 4) : off));
}
// The mma.m16n8k32 A fragments of 32 K rows k0.. of a staged weight tile for
// the 4 columns c..c+3 of a lane (g = lane/4, t = lane%4; the weight is the
// A operand, an output column an A row): after the two 4x4 byte
// transposes w0[j] holds rows k0+4t..+3 and w1[j] rows k0+16+4t..+3 of
// column c+j, so {w0[2m], w0[2m+1], w1[2m], w1[2m+1]} is the fragment of
// m-tile m, whose A rows g and g+8 are the columns c+2m and c+2m+1.
template <int C>
__device__ __forceinline__ void w_frags(const uint8_t* tile, int k0, int c, int t, uint32_t w0[4],
                                        uint32_t w1[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w0[j] = ld_tile_word<C>(tile, k0 + 4 * t + j, c);
    w1[j] = ld_tile_word<C>(tile, k0 + 16 + 4 * t + j, c);
  }
  transpose4(w0[0], w0[1], w0[2], w0[3]);
  transpose4(w1[0], w1[1], w1[2], w1[3]);
}
// The B fragment (x rows r = 8*nt + g, K bytes 4t.. and 16+4t..) of a
// 512-byte slice of x's codes in the decode layout.
__device__ __forceinline__ void x_frag(const int8_t* slice, int r, int t, uint32_t b[2]) {
  const int8_t* row = slice + r * 32 + 4 * t;
  const int sw = ((r >> 2) & 1) << 4;
  b[0] = *reinterpret_cast<const uint32_t*>(row + sw);
  b[1] = *reinterpret_cast<const uint32_t*>(row + (16 ^ sw));
}

// The ring of a decode kernel: kStages stages (each aligned for the 128-byte
// swizzle), then a full and an empty mbarrier a stage, in dynamic shared
// memory whose start is rounded up to 1024 bytes.
template <typename Stage, int kStages, int kConsumerWarps>
struct DecRing {
  static constexpr int smem_bytes() { return 1024 + kStages * ((int)sizeof(Stage) + 16); }
  Stage* st;
  uint64_t* bar;  // full[kStages], empty[kStages]

  __device__ explicit DecRing(uint8_t* smem)
      : st(reinterpret_cast<Stage*>(smem + ((1024 - (smem_u32(smem) & 1023)) & 1023))),
        bar(reinterpret_cast<uint64_t*>(st + kStages)) {}
  __device__ Stage& operator[](int i) const { return st[i % kStages]; }
  __device__ static int parity(int i) { return (i / kStages) & 1; }
  __device__ uint64_t* full(int i) const { return bar + i % kStages; }
  __device__ uint64_t* empty(int i) const { return bar + kStages + i % kStages; }
  // the start of the ring's shared memory, free once every stage is consumed
  __device__ void* base() const { return st; }

  // by thread 0, before a __syncthreads: `full` takes the two producers'
  // arrivals (each with its bytes), `empty` one a consumer warp
  __device__ void init() const {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), 2);
      mbar_init(empty(i), kConsumerWarps);
    }
    mbar_init_fence();
  }
  // by one thread of a producer warp, for stages 0..n-1: once stage i's
  // slot is free (and, when `paced`, once stage i - kStages/2 has landed),
  // arrive on its `full` barrier with bytes(i) and issue copy(stage, i,
  // full barrier)
  template <typename Bytes, typename Copy>
  __device__ void produce(int n, bool paced, Bytes&& bytes, Copy&& copy) const {
    constexpr int kAhead = kStages / 2 > 0 ? kStages / 2 : 1;
    for (int i = 0; i < n; ++i) {
      if (i >= kStages) mbar_wait(empty(i), parity(i) ^ 1);
      if (paced && i >= kAhead) mbar_wait(full(i - kAhead), parity(i - kAhead));
      mbar_expect_tx(full(i), bytes(i));  // this producer's arrival and its bytes
      copy((*this)[i], i, full(i));
    }
  }
  // by every consumer thread before it reads stage i, and once its warp's
  // reads are consumed (fence_values on what they fed); the proxy fence
  // orders the thread's reads (generic proxy) before the copies that refill
  // the stage (async proxy): without it K4 at down, 16 rows, gave another
  // result in about one call of 400 on an H100 (one of 40 with a 4-stage
  // ring), as if a refill overtook a read of the stage's previous step
  __device__ void acquire(int i) const { mbar_wait(full(i), parity(i)); }
  __device__ void release(int i) const {
    fence_proxy_async();
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(i));
  }
};

// The end of a decode kernel, by every thread of every block of the
// cluster, once the block's ring is drained: each consumer lane has put its
// f32 sums y[nt][m][e] (x row 8nt + 2t + e%2, column c + 2m + e/2 of the
// tile, c = 32 * warp + 4g) into the tile red [16][C + 4] (at the ring's
// start); then block `rank` of `splits` adds the tiles of blocks 0, 1, ...
// in that order for every `splits`-th float4 of the B x C outputs (splits
// <= 8) and writes them to out (bf16 or f32 [B, O]) from column col0. The
// order does not depend on timing, so a result is the same on every run.
template <int C>
__device__ __forceinline__ void dec_store_tile(float* red, const float (&y)[2][2][4], int nt_live,
                                               int warp, int lane) {
  constexpr int kStride = C + 4;  // +4: the rows 2t of a store land on other banks
  const int g = lane >> 2, t = lane & 3, c = 32 * warp + 4 * g;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
    if (nt < nt_live)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float4*>(red + (8 * nt + 2 * t + e) * kStride + c) =
            make_float4(y[nt][0][e], y[nt][0][e + 2], y[nt][1][e], y[nt][1][e + 2]);
}
// With one split (a cluster of one block) there is nothing to add: each
// consumer lane writes its sums straight to out.
__device__ __forceinline__ void dec_store_out(const float (&y)[2][2][4], int nt_live, void* out,
                                              int out_is_bf16, int B, int O, int col0, int warp,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3, c = col0 + 32 * warp + 4 * g;
  if (c >= O) return;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * nt + 2 * t + e;
      if (nt >= nt_live || r >= B) continue;
      const float4 v = make_float4(y[nt][0][e], y[nt][0][e + 2], y[nt][1][e], y[nt][1][e + 2]);
      const size_t o = (size_t)r * O + c;
      if (out_is_bf16) {
        __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out) + o;
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
        *reinterpret_cast<__nv_bfloat162*>(p + 2) = __floats2bfloat162_rn(v.z, v.w);
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = v;
      }
    }
}
template <int C>
__device__ __forceinline__ void dec_reduce(const float* red, void* out, int out_is_bf16, int B,
                                           int O, int col0, int splits, int rank) {
  constexpr int kStride = C + 4, kQuads = C / 4;
  for (int q = rank + splits * (int)threadIdx.x; q < B * kQuads; q += splits * (int)blockDim.x) {
    const int r = q / kQuads, c = 4 * (q % kQuads);
    if (col0 + c >= O) continue;
    float4 v[8];  // every rank's tile first, so their latencies overlap
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < splits) v[k] = ld_cluster4(red + r * kStride + c, k);
    float4 s = v[0];
#pragma unroll
    for (int k = 1; k < 8; ++k)
      if (k < splits) {
        s.x += v[k].x;
        s.y += v[k].y;
        s.z += v[k].z;
        s.w += v[k].w;
      }
    const size_t o = (size_t)r * O + col0 + c;
    if (out_is_bf16) {
      __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out) + o;
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(s.x, s.y);
      *reinterpret_cast<__nv_bfloat162*>(p + 2) = __floats2bfloat162_rn(s.z, s.w);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = s;
    }
  }
}

// Launch a decode kernel: grid (splits, column tiles), clusters of the
// splits, by programmatic dependent launch behind the quantize kernel just
// enqueued: it is launched while that one finishes (its blocks exiting
// are its trigger), streams its first weight stages, and reads x's codes
// only after grid_dep_wait. Returns the CUDA error code.
template <typename... KArgs, typename... Args>
inline int launch_dec(void (*kern)(KArgs...), int splits, int ctiles, int threads, int smem,
                      cudaStream_t st, Args... args) {
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits, (unsigned)ctiles, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  return (int)err;
}

}  // namespace mrt
