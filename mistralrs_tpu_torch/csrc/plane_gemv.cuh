// The plane-major GEMV with the weight rounded to bf16 before the product,
//   y[b, o] = sum_k x[b, k] * bf16(code[k, o] * s[g(k), o])      (bf16 MMA, f32 sums)
//           - sum_g xsum_g[b] * zs[g, o]                           (f32, when there is a zs term)
// shared by five GEMVs: K10 (csrc/affine_gemv.cu: unsigned codes of 1, 2,
// 4 or 8 bits, bf16 scale and zs), K8 (csrc/q8_0_bf16_gemv.cu: signed 8-bit
// codes, a bf16 or f32 scale per 32, no zs), K5 (csrc/q4k_bf16_gemv.cu:
// Q4_K's nibbles, zs = minv, whose weight q * s is never rounded: at 17-256
// rows two exact bf16 parts, at 1-16 rows the raw nibble with the scale on
// each 32-element group's f32 dot) and, at 17-256 rows only, K9b
// (csrc/q5k_hbit_bf16_gemv.cu: the 1-bit high-bit planes of Q5_K, a bf16
// scale per 32, no zs) and K4 (csrc/q6k_gemv.cu: Q6_K's 6-bit codes from two
// byte arrays, a bf16 scale per 16, zs = 32 * scale).
//
// The layout, with PER = 8 / BITS codes a byte and Kp = K / PER byte rows:
// bits BITS*j of q row r hold element j*Kp + r ("plane" j is the contiguous
// element chunk [j*Kp, (j+1)*Kp)); at BITS = 8 q holds one code a byte in
// element order. s and zs are [K/group, O], group a multiple of 16. An f32 s
// is rounded to bf16 first (as the JAX kernels cast the scale to x's dtype);
// bf16(code * s) is then one rounding of the exact product (|code| < 256 and
// a bf16 s make an exact f32).
//
// Layouts (row-major): x [B,K] bf16, q [Kp,O] u8 (int8 when signed), s
// [K/group,O] bf16 or f32, zs [K/group,O] bf16, out [B,O] bf16 or f32.
//
// What bounds it on an H100: at decode the weight stream (codes at BITS/8
// bytes a weight, s and zs at 2 or 4 bytes a group), against 3.35 TB/s; at
// 256 rows, the bf16 tensor-core operations.
//
// Two kernels, each with its design written beside it:
// - plane_dec_kernel (at the end of this file): K10, K8 and K5 at 1-16
//   rows, K4's decode design on common.cuh's decode section: one launch a
//   call, weights and x by TMA, the K splits of a column tile summed in a
//   cluster, the zs term as a second bf16 mma;
// - plane_rows_kernel: K10, K9b, K4, K8 and K5 at 17-256 rows (TMA, a
//   producer warpgroup that decodes each stage once, bf16 wgmma, the zs
//   term on the tensor cores).
#pragma once

#include "common.cuh"

namespace mrt {

// bf16 pair (lo, hi) from two floats, round to nearest even
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d = a * b + c on bf16 pairs, rounded once
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// ---- The rows instantiation (17-256 rows): plane_rows_kernel ----
//
// What bounds it on an H100: the bf16 tensor cores (2*B*K*O operations; at
// K10's gate|up, B = 256, 0.061 ms), and close behind the decode of the
// codes into bf16 tiles, which no unit but the CUDA cores can do. Design
// (K1's rows kernel, csrc/q4k_rows.cuh, on common.cuh's mrt::Ring):
// - a block owns 128 columns and BM = 64 or 128 rows (two consumer
//   warpgroups: one per 64 rows at BM 128, wgmma N = 128; one per 64
//   columns at BM 64, N = 64) and a producer warpgroup; the grid is (row
//   tiles, column tiles, K splits), row tiles fastest, so each weight tile
//   is read by at most two blocks, neighbours that meet in L2; K is split
//   only to fill one wave (ops/quant_matmul.plane_gemv_plan);
// - a main K step takes kR byte rows of q, which hold kPer = 8/BITS chunks
//   of kR elements (plane j: elements j*Kp + r0..), kE = kPer * kR elements
//   in all (64; 32 at 8 bits, to keep six stages; a format may take other
//   step sizes, PlaneRowGeom's KE): thread 0 of the producer warpgroup
//   brings the rows (TMA), their scale rows (one TMA box over scale seen as
//   [kPer][Kp/group][O]) and x's kE elements for the BM rows (one TMA box
//   of 128- or 64-byte rows with the swizzle of that width, from a copy of
//   x in step order that plane_prep_kernel writes before the GEMV with the
//   per-group sums: with TMA boxes of x's own chunks, 16-64-byte pieces,
//   HQQ-1's gate|up at B = 256 took 0.261 ms, not 0.177; at 8 bits the
//   step order is x's own, so without the zs term (K8) the box reads x in
//   place, rows past B zero-filled by TMA, and there is no pre-pass), and
//   a producer warp decodes the rows once into a K-major bf16 B tile: a 4x4
//   byte transpose per column quad (K1's load_quad8), then per code
//   bf16(code * s), one rounding of the exact product as the JAX kernel's
//   bf16 `vals * srep`: below 8 bits the pair (128 + c0, 128 + c1) is built
//   as bf16 bits (0x43cc) and one fma.rn.bf16x2 with (s, s) and (-128 s,
//   -128 s) gives c * s rounded once; at 8 bits 2^23 + c as f32 bits and
//   an f32 fma with -2^23 s (exact), rounded to bf16 by the pack;
// - the consumers run bf16 wgmma.m64nNk16 on the x tile (A) and the
//   decoded tile (B) straight into the f32 accumulators: the scale is in
//   the weight, so there is no epilogue per step;
// - the zs term: every Z = kZU * group / kE main steps (a slice: kZU = 32
//   groups at 64-element steps, 16 at 32; kZU/kPer in each plane) one zs
//   step brings the slice's per-group sums of x (xsum, [kPer][Kp/group]
//   [bpad] f32, from plane_prep_kernel) and its zs rows (bf16, two
//   64-column boxes with the 128-byte swizzle, the MN-major B operand);
//   each consumer thread splits its sums exactly into three bf16 parts held
//   as wgmma A fragments, and three wgmma.m64nNk16 a 16 groups with A
//   negated subtract xsum @ zs into the same accumulators (3/16 of the main
//   product's tensor work at group 16, 3/128 at group 128, and no FMAs);
//   without the zs term (ZS false: K9b, K8) there are no zs steps, no sums,
//   and K is split at 4 main steps;
// - a stage is freed as soon as the wgmmas that read it have completed; one
//   split writes out directly, more splits go through the fixed-order
//   split-K pass;
// - group, Z and the scale rows a step are powers of two, so the per-step
//   index arithmetic is shifts and a multiply-high (a runtime division in
//   the single-thread producer, decode and consumer loops cost 13%).
// What holds it above the tensor bound (PERF.md §6): a step's ring round
// trip (TMA, decode, the products, the release), which the ~5 stages that
// fit in shared memory do not hide.
// The format F of an instantiation tells it what a main step brings and how
// that is decoded; the ring, the zs step and the consumers know no format:
// - F::G, the step geometry (PlaneRowGeom); F::kZs, whether there is a zs
//   term, and F::kZsMul, the factor on its sums; F::Stage<BM>, a ring stage;
// - F::Maps, the weight side's tensor maps (a grid-constant kernel
//   parameter), and F::Shifts, the shifts its boxes and decode need (a
//   kernel parameter passed by value, so they stay in registers: read
//   through a reference beside the maps, K10 rows ran up to 4% slower on an
//   H100); F::make_maps (host) builds both and the zs map from the format's
//   own arrays;
// - F::copy issues a main step's weight boxes and F::w_tx counts their
//   bytes; F::zs_at places a slice's zs rows in the zs map; F::decode turns
//   a stage's bytes into the bf16 tile;
// - F::kParts, the bf16 tiles a main step's decode writes (1; Q4kFmt's 2):
//   the consumers run the step's wgmmas over each part with the same x tile
//   as A, the one thing a consumer learns of a format.
// PlaneFmt<BITS, SIGNED, ST, ZS, KE> is the plane layout above: K10
// instantiates unsigned codes with bf16 scales and the zs term
// (csrc/affine_gemv.cu), K9b one bit with bf16 scales and no zs term
// (csrc/q5k_hbit_bf16_gemv.cu), K8 signed 8-bit codes with bf16 (wire
// Q8_0) or f32 (rq8) scales and no zs term (csrc/q8_0_bf16_gemv.cu): each
// code is bf16(code * bf16(s)), bit-equal to the plain version's weight.
//
// Q4kFmt (K5, csrc/q4k_bf16_gemv.cu) is the 4-bit plane layout with an
// exact weight. Q4_K's paired layout (qs row r holds element r in its low
// nibble and K/2 + r in its high one) is the 4-bit planes; scale and minv
// [K/32, O] are seen as [2][Kp/32][O]; the min term is the zs term (zs =
// minv, the sums of x per 32). The JAX kernel multiplies each sub-block's
// f32 dot by its scale, so the weight q * s must not be rounded to bf16
// (on random Q4_K codes that moves y by 1-2e-3 of max |y|, ten times the
// kernel's tolerance of 1e-4): q * s has at most 12 significant
// bits (a 4-bit code, a bf16 scale), so hi = bf16(q * s) and lo = q * s -
// hi (at most 5 bits) are exact, and hi + lo = q * s. The decode writes
// both as two bf16 tiles of the step (per pair: (128 + c) as bf16 bits,
// hi = fma.rn.bf16x2 with (s, s) and (-128 s, -128 s), c = (128 + c) -
// 128, lo = fma.rn.bf16x2 of c, s and -hi, each rounded once from an exact
// value), and the consumers run the step's wgmmas twice, over the hi tile
// and over the lo tile with the same x tile as A: every product x * hi and
// x * lo is exact in f32, and only the f32 sums' order differs from the
// plain version's (twice the tensor work of a rounded weight). K5 takes
// 32-element steps: the two tiles make a stage at 64 twice K10's, three in
// the ring. At 1-16 rows (plane_dec_kernel) kScaleOnAcc takes the place of
// the two parts: the raw nibble in the product, the scale on the f32 dots.
//
// Q6kFmt (K4, csrc/q6k_gemv.cu) is the 2-bit geometry with 6-bit codes.
// Q6_K's chunked layout (chunk span G, Kq = K/4, C = K/(4G) chunks; element
// j*Kq + c*G + t) is plane-major with 4 planes (span j is plane j, r = c*G +
// t):
// - qh [Kq, O] is the 2-bit plane layout itself (bits 2j of row r), the q
//   of a main step's 16 rows (2 KB);
// - the nibbles sit in ql row 2Gc + (j&1)*G + t (the low nibble for j < 2,
//   the high one above): a step's 16 r lie in one chunk (G % 16 == 0), so
//   its two halves are one TMA box over ql seen as [2C][G][O] (4 KB);
// - the scale per 16 sits in row c*G/4 + j*G/16 + t/16 (chunk-major): the
//   step's four rows are one box over scale seen as [4C][G/16][O];
// - w = bf16(q * s16) - 32 * s16 per element: the -32 term is the zs term
//   with zs = s16 and the sums times 32 (exact in f32); a slice (8 groups a
//   plane, 128 r) lies in one chunk for G % 128 == 0, so its zs rows are one
//   box over the same chunk-major view;
// - code = nibble | ((qh >> 2j) & 3) << 4 (below 128, so decode8's pair
//   trick is exact), bit-equal to the plain version's bf16(q * s16).
// The stage keeps its ql and qh bytes in the last 6 KB of the decoded tile,
// which the decode warp reads into registers before it writes the tile over
// them: 33 KB a stage at BM 128, so six fit (39 KB with their own buffers:
// three).

template <int BITS, int KE = (BITS == 8 ? 32 : 64)>
struct PlaneRowGeom {
  static_assert(KE == 32 || KE == 64, "a main step is 32 or 64 elements");
  static constexpr int kBits = BITS;
  static constexpr int kPer = 8 / BITS;           // planes of a byte row
  static constexpr int kE = KE;                   // elements a main step
  static constexpr int kR = kE / kPer;            // byte rows a step: the elements of a chunk
  static constexpr int kScRows = kPer > kE / 16 ? kPer : kE / 16;  // scale rows a step, at most
  static constexpr int kXRow = 2 * kE;            // bytes of a row of the x tile
  // groups of a zs slice: 32 where a stage's x tile holds their sums (64-
  // element steps), else 16
  static constexpr int kZU = kE == 64 ? 32 : 16;
  // the wgmma layout type of the x tile (the swizzle TMA writes)
  static constexpr uint32_t kXLayout = kXRow == 128 ? 1 : 2;
  static constexpr CUtensorMapSwizzle kXSwizzle =
      kXRow == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

// A stage: at a main step the x tile, the decoded B tiles (PARTS of them,
// one after the other), the byte rows and the scale rows; at a zs step the
// slice's sums in x's place (kZU x BM f32) and its zs tile in the B tile's
// (2 x kZU rows of 64 bf16).
template <typename G, int BM, typename ST, int PARTS = 1>
struct alignas(1024) PlaneRowStage {
  uint8_t x[BM * G::kE * 2];                 // [BM][kE] bf16, the step's chunks in plane order
  uint8_t w[PARTS * G::kE * kGemvCols * 2];  // (c, k) at (k/8)*2048 + c*16 + (k%8)*2
  uint8_t q[G::kR * kGemvCols];              // byte row r at r*128
  ST sc[G::kScRows][kGemvCols];              // plane j's scale rows from j * nr
};

// K4's stage (Q6kFmt): the x tile, the decoded tile, whose last 6 KB hold
// the step's ql rows ([2][16][128]: both halves) and qh rows ([16][128])
// until the decode warp has read them, and the four spans' scale rows.
template <int BM>
struct alignas(1024) Q6kRowStage {
  using G = PlaneRowGeom<2>;
  static constexpr int kQl = 10240, kQh = 14336;  // byte offsets in w
  uint8_t x[BM * G::kE * 2];
  uint8_t w[G::kE * kGemvCols * 2];
  __nv_bfloat16 sc[G::kPer][kGemvCols];
};

// main steps a slice (kZU groups and a zs step); without the zs term, the
// K split's unit
template <typename G, bool ZS>
__host__ __device__ constexpr int plane_slice_steps(int group) {
  return ZS ? G::kZU * group / G::kE : 4;
}

// 8 codes of a column (K rows r..r+3 in the bytes of lo, r+4..r+7 in hi,
// plane shifted down) as bf16(code * s), in K order; ss is the column's
// scale s as a bf16 pair (s, s)
template <int BITS, bool SIGNED>
__device__ __forceinline__ uint4 decode8(uint32_t lo, uint32_t hi, uint32_t ss) {
  if constexpr (BITS < 8) {
    constexpr uint32_t kMask = ((1u << BITS) - 1u) * 0x01010101u;
    const __nv_bfloat162 s2 = *reinterpret_cast<const __nv_bfloat162*>(&ss);
    const __nv_bfloat162 nb = __hmul2(s2, __float2bfloat162_rn(-128.f));  // exact
    auto pair = [&](uint32_t t, uint32_t sel) {  // bf16 bits 0x43cc = 128 + cc
      const uint32_t v = __byte_perm(t, 0x43u, sel);
      const __nv_bfloat162 r = __hfma2(*reinterpret_cast<const __nv_bfloat162*>(&v), s2, nb);
      return *reinterpret_cast<const uint32_t*>(&r);
    };
    lo &= kMask;
    hi &= kMask;
    return make_uint4(pair(lo, 0x4140), pair(lo, 0x4342), pair(hi, 0x4140), pair(hi, 0x4342));
  } else {
    const float s = bf16_lo(ss);
    const float nb = -8388608.f * s;  // -2^23 s, exact
    if constexpr (SIGNED) {  // flipping the sign bit maps -128..127 onto 0..255
      lo ^= 0x80808080u;
      hi ^= 0x80808080u;
    }
    auto code_s = [&](uint32_t t, int i) {  // c * s exactly: (2^23 + c) * s - 2^23 s
      const float v = fmaf(__uint_as_float(__byte_perm(t, 0x4Bu, 0x4550 + i)), s, nb);
      return SIGNED ? fmaf(-128.f, s, v) : v;
    };
    return make_uint4(bf16x2(code_s(lo, 0), code_s(lo, 1)), bf16x2(code_s(lo, 2), code_s(lo, 3)),
                      bf16x2(code_s(hi, 0), code_s(hi, 1)), bf16x2(code_s(hi, 2), code_s(hi, 3)));
  }
}

// 8 nibble codes of a column (K rows r..r+3 in the bytes of lo, r+4..r+7 in
// hi, plane shifted down) as the two exact bf16 parts of c * s, in K order:
// hp = bf16(c * s) and lp = c * s - hp (Q4kFmt); ss is (s, s) as bf16 bits
__device__ __forceinline__ void decode8_split(uint32_t lo, uint32_t hi, uint32_t ss, uint4& hp,
                                              uint4& lp) {
  const __nv_bfloat162 s2 = *reinterpret_cast<const __nv_bfloat162*>(&ss);
  const __nv_bfloat162 nb = __hmul2(s2, __float2bfloat162_rn(-128.f));  // exact
  const __nv_bfloat162 k128 = __float2bfloat162_rn(128.f);
  auto pair = [&](uint32_t t, uint32_t sel, uint32_t& h, uint32_t& l) {
    const uint32_t v = __byte_perm(t, 0x43u, sel);  // bf16 bits 0x43cc = 128 + cc
    const __nv_bfloat162 vb = *reinterpret_cast<const __nv_bfloat162*>(&v);
    const __nv_bfloat162 hb = __hfma2(vb, s2, nb);  // c * s rounded once
    // c exactly, then c * s - hb: exact in f32 and in bf16, so the fma's one
    // rounding leaves it as it is
    const __nv_bfloat162 lb = __hfma2(__hsub2(vb, k128), s2, __hneg2(hb));
    h = *reinterpret_cast<const uint32_t*>(&hb);
    l = *reinterpret_cast<const uint32_t*>(&lb);
  };
  lo &= 0x0F0F0F0Fu;
  hi &= 0x0F0F0F0Fu;
  pair(lo, 0x4140, hp.x, lp.x);
  pair(lo, 0x4342, hp.y, lp.y);
  pair(hi, 0x4140, hp.z, lp.z);
  pair(hi, 0x4342, hp.w, lp.w);
}

// The scales of a lane's column quad (columns 4*lane..+3 of a scale row) as
// bf16 bits, (cols 0, 1) and (2, 3); an f32 row is rounded to bf16 first
__device__ __forceinline__ uint2 scale_quad(const __nv_bfloat16* row, int lane) {
  return *reinterpret_cast<const uint2*>(row + 4 * lane);
}
__device__ __forceinline__ uint2 scale_quad(const float* row, int lane) {
  const float4 v = *reinterpret_cast<const float4*>(row + 4 * lane);
  return make_uint2(bf16x2(v.x, v.y), bf16x2(v.z, v.w));
}

// The 6-bit Q6_K codes of span j from the transposed ql words (spans 0|2: p,
// 1|3: r) and qh word h, four K rows a register (one byte each); j is a
// constant after the callers' loops unroll.
__device__ __forceinline__ uint32_t q6_codes(int j, uint32_t p, uint32_t r, uint32_t h) {
  switch (j) {
    case 0: return (p & 0x0F0F0F0Fu) | ((h << 4) & 0x30303030u);
    case 1: return (r & 0x0F0F0F0Fu) | ((h << 2) & 0x30303030u);
    case 2: return ((p >> 4) & 0x0F0F0F0Fu) | (h & 0x30303030u);
    default: return ((r >> 4) & 0x0F0F0F0Fu) | ((h >> 2) & 0x30303030u);
  }
}

// The lane's 4 columns in the rotated order of load_quad8: for word j,
// the byte_perm selector that puts column 4*lane + ((j + rot) & 3)'s bf16
// scale in both halves of a word
__device__ __forceinline__ void scale_splats(int rot, uint32_t splat[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t b = 2 * ((j + rot) & 3);
    splat[j] = (b | ((b + 1) << 4)) * 0x101u;
  }
}

// The zs map (K10: over zs; K4: over its scale): the scale view's dims and
// strides with a box of the slice's kZU/kPer rows a plane, 64 columns, the
// 128-byte swizzle of the MN-major B operand
template <typename G>
int zs_tile_map(CUtensorMap* zmap, const void* base, const uint64_t* dims, const uint64_t* str) {
  const uint32_t box[3] = {64, G::kZU / G::kPer, G::kPer};
  return tile_map(zmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, str, box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int BITS, bool SIGNED, typename ST, bool ZS, int KE = (BITS == 8 ? 32 : 64)>
struct PlaneFmt {
  static_assert(!SIGNED || BITS == 8, "signed codes are bytes");
  static_assert(BITS == 8 || sizeof(ST) == 2, "below 8 bits the scales are bf16");
  static_assert(!ZS || sizeof(ST) == 2, "the zs term comes with bf16 scales (K10)");
  using G = PlaneRowGeom<BITS, KE>;
  using Scale = ST;
  static constexpr bool kSigned = SIGNED;
  static constexpr bool kZs = ZS;
  static constexpr float kZsMul = 1.f;
  static constexpr int kParts = 1;
  // the decode instantiation multiplies each 32-element group's f32 dot by
  // its scale (Q4kFmt) instead of rounding the weight to bf16(q * s)
  static constexpr bool kScaleOnAcc = false;
  template <int BM>
  using Stage = PlaneRowStage<G, BM, ST>;
  // q [Kp, O] in boxes of kR byte rows x 128 columns, scale [K/group, O]
  // seen as [kPer][Kp/group][O]
  struct Maps {
    CUtensorMap q, sc;
  };
  // gsh = log2(group), nsh = log2 of a plane's scale rows a step (group and
  // kR are powers of two: shifts, no divisions)
  struct Shifts {
    int gsh, nsh;
  };
  // at 1 bit a step's kR = 8 rows of a plane lie in one group (group >=
  // 16): one scale row a plane, known when the kernel is compiled (K9b and
  // HQQ-1 ran 3% faster with it on an H100; the 2-bit instantiations, where
  // it holds too, 1-2% slower, so they keep the shifts)
  static constexpr bool kOneScaleRow = BITS == 1;

  __device__ static uint32_t w_tx(Shifts h) {
    return G::kR * kGemvCols + (G::kPer << h.nsh) * kGemvCols * (uint32_t)sizeof(ST);
  }
  template <typename S>
  __device__ static void copy(S& st, const Maps& m, Shifts h, int r0, int col0, uint64_t* full) {
    tma_load_2d(st.q, &m.q, col0, r0, full);
    tma_load_3d(st.sc, &m.sc, col0, r0 >> h.gsh, 0, full);
  }
  // the zs map's box at the slice whose first group of a plane is z
  __device__ static int2 zs_at(Shifts, int z) { return make_int2(z, 0); }
  template <typename S>
  __device__ static void decode(S& st, Shifts h, int lane) {
    const uint8_t* __restrict__ qt = st.q;
    const ST* __restrict__ sct = &st.sc[0][0];
    uint8_t* __restrict__ wt = st.w;
    // the lane's 4 columns in the rotated order of load_quad8: column
    // 4*lane + q_j for word j
    const int rot = (lane >> 1) & 3;
    uint32_t splat[4];
    scale_splats(rot, splat);
    uint32_t w[G::kR / 8][8];  // every octet's codes first, so the loads overlap
#pragma unroll
    for (int o = 0; o < G::kR / 8; ++o) load_quad8(qt, 8 * o, lane, rot_sel(lane >> 1), w[o]);
#pragma unroll
    for (int p = 0; p < G::kPer; ++p)
#pragma unroll
      for (int o = 0; o < G::kR / 8; ++o) {
        // the octet's scale row within its plane's rows (several when kR > group)
        const int srow = kOneScaleRow ? p : (p << h.nsh) + ((8 * o) >> h.gsh);
        const uint2 sq = scale_quad(sct + srow * kGemvCols, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * lane + ((j + rot) & 3);
          *reinterpret_cast<uint4*>(wt + (p * G::kR / 8 + o) * 2048 + c * 16) =
              decode8<BITS, SIGNED>(w[o][j] >> (BITS * p), w[o][4 + j] >> (BITS * p),
                                    __byte_perm(sq.x, sq.y, splat[j]));
        }
      }
  }

  // q [Kp, O], scale [K/group, O], zs [K/group, O] (ZS; else unused).
  // Returns the CUDA error.
  static int make_maps(Maps& m, Shifts& h, CUtensorMap& zmap, int K, int O, int group,
                       const uint8_t* q, const ST* scale, const __nv_bfloat16* zs) {
    const int Kp = K / G::kPer, gpp = Kp / group;  // groups a plane
    const uint64_t es = sizeof(ST);
    const uint64_t qdims[2] = {(uint64_t)O, (uint64_t)Kp}, qstr[1] = {(uint64_t)O};
    const uint32_t qbox[2] = {kGemvCols, G::kR};
    const uint64_t sdims[3] = {(uint64_t)O, (uint64_t)gpp, (uint64_t)G::kPer};
    const uint64_t sstr[2] = {(uint64_t)O * es, (uint64_t)gpp * O * es};
    const uint32_t sbox[3] = {kGemvCols, (uint32_t)(G::kR > group ? G::kR / group : 1), G::kPer};
    h.gsh = __builtin_ctz((unsigned)group);
    h.nsh = G::kR > group ? __builtin_ctz((unsigned)G::kR) - h.gsh : 0;
    int err = tile_map(&m.q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, qdims, qstr, qbox);
    if (!err)
      err = tile_map(&m.sc, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                     3, scale, sdims, sstr, sbox);
    if constexpr (ZS) {
      if (!err) err = zs_tile_map<G>(&zmap, zs, sdims, sstr);
    } else {
      zmap = m.q;  // unused
    }
    return err;
  }
};

struct Q6kFmt {
  using G = PlaneRowGeom<2>;
  static constexpr bool kZs = true;
  static constexpr float kZsMul = 32.f;  // the zs term is 32 * xsum16 @ s16 (exact in f32)
  static constexpr int kParts = 1;
  template <int BM>
  using Stage = Q6kRowStage<BM>;
  // qh [K/4, O] in boxes of 16 rows, ql [K/2, O] seen as [2C][G][O] in
  // boxes of both halves' 16 rows, the scale [K/16, O] seen as
  // [4C][G/16][O]
  struct Maps {
    CUtensorMap qh, ql, sc;
  };
  // span_sh = log2(G) (r = c*G + t: c = r >> span_sh)
  struct Shifts {
    int span_sh;
  };

  __device__ static uint32_t w_tx(Shifts) {
    return 3 * G::kR * kGemvCols + G::kPer * kGemvCols * 2;
  }
  template <typename S>
  __device__ static void copy(S& st, const Maps& m, Shifts h, int r0, int col0, uint64_t* full) {
    const int c = r0 >> h.span_sh, t0 = r0 & ((1 << h.span_sh) - 1);
    tma_load_2d(st.w + S::kQh, &m.qh, col0, r0, full);
    tma_load_3d(st.w + S::kQl, &m.ql, col0, t0, 2 * c, full);
    tma_load_3d(st.sc, &m.sc, col0, t0 >> 4, 4 * c, full);
  }
  // the scale's box at (group in chunk, 4 * chunk) of the slice's first r
  __device__ static int2 zs_at(Shifts h, int z) {
    const int r = z << 4;
    return make_int2((r & ((1 << h.span_sh) - 1)) >> 4, 4 * (r >> h.span_sh));
  }
  // every lane's ql and qh bytes into registers first, then (the warp's
  // reads done) the 4 spans x 16 rows of bf16(code * s16) over them
  template <typename S>
  __device__ static void decode(S& st, Shifts, int lane) {
    // no __restrict__: the tile's stores below overwrite these bytes
    const uint8_t* ql = st.w + S::kQl;
    const uint8_t* qh = st.w + S::kQh;
    const int rot = (lane >> 1) & 3;
    const uint32_t sel = rot_sel(lane >> 1);
    uint32_t l0[2][8], l1[2][8], h[2][8];  // the two octets of the step's 16 rows
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      load_quad8(ql, 8 * o, lane, sel, l0[o]);
      load_quad8(ql + 16 * kGemvCols, 8 * o, lane, sel, l1[o]);
      load_quad8(qh, 8 * o, lane, sel, h[o]);
    }
    __syncwarp();
    uint32_t splat[4];
    scale_splats(rot, splat);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint2 sq = scale_quad(&st.sc[p][0], lane);
#pragma unroll
      for (int o = 0; o < 2; ++o)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * lane + ((j + rot) & 3);
          *reinterpret_cast<uint4*>(st.w + (2 * p + o) * 2048 + c * 16) = decode8<6, false>(
              q6_codes(p, l0[o][j], l1[o][j], h[o][j]),
              q6_codes(p, l0[o][4 + j], l1[o][4 + j], h[o][4 + j]),
              __byte_perm(sq.x, sq.y, splat[j]));
        }
    }
  }

  // qh [K/4, O], ql [K/2, O], scale [K/16, O], span G a power of two and a
  // multiple of 128 (group is 16). Returns the CUDA error.
  static int make_maps(Maps& m, Shifts& h, CUtensorMap& zmap, int K, int O, int /*group*/,
                       const uint8_t* qh, const uint8_t* ql, const __nv_bfloat16* scale, int span) {
    const uint64_t hdims[2] = {(uint64_t)O, (uint64_t)(K / 4)}, hstr[1] = {(uint64_t)O};
    const uint32_t hbox[2] = {kGemvCols, G::kR};
    const uint64_t ldims[3] = {(uint64_t)O, (uint64_t)span, (uint64_t)(2 * (K / (4 * span)))};
    const uint64_t lstr[2] = {(uint64_t)O, (uint64_t)span * O};
    const uint32_t lbox[3] = {kGemvCols, G::kR, 2};
    const uint64_t sdims[3] = {(uint64_t)O, (uint64_t)(span / 16), (uint64_t)(K / span)};
    const uint64_t sstr[2] = {(uint64_t)O * 2, sdims[1] * O * 2};
    const uint32_t sbox[3] = {kGemvCols, 1, G::kPer};
    h.span_sh = __builtin_ctz((unsigned)span);
    int err = tile_map(&m.qh, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qh, hdims, hstr, hbox);
    if (!err) err = tile_map(&m.ql, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, ql, ldims, lstr, lbox);
    if (!err)
      err = tile_map(&m.sc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, scale, sdims, sstr, sbox);
    if (!err) err = zs_tile_map<G>(&zmap, scale, sdims, sstr);
    return err;
  }
};

// Q4_K (K5): the 4-bit planes with bf16 scale and minv per 32 (the zs
// term), PlaneFmt's maps and boxes, and a decode into the two exact parts
// of q * s (the hi tile, then the lo tile kE * 256 bytes on)
template <int KE>
struct Q4kFmt : PlaneFmt<4, false, __nv_bfloat16, true, KE> {
  using Base = PlaneFmt<4, false, __nv_bfloat16, true, KE>;
  using G = typename Base::G;
  using Shifts = typename Base::Shifts;
  static_assert(G::kR <= 32, "a step's rows lie in one 32-element group of each plane");
  static constexpr int kParts = 2;
  static constexpr bool kScaleOnAcc = true;
  template <int BM>
  using Stage = PlaneRowStage<G, BM, __nv_bfloat16, 2>;

  template <typename S>
  __device__ static void decode(S& st, Shifts, int lane) {
    const uint8_t* __restrict__ qt = st.q;
    uint8_t* __restrict__ wt = st.w;
    constexpr int kLo = G::kE * kGemvCols * 2;  // the lo tile
    const int rot = (lane >> 1) & 3;
    uint32_t splat[4];
    scale_splats(rot, splat);
    uint32_t w[G::kR / 8][8];  // every octet's codes first, so the loads overlap
#pragma unroll
    for (int o = 0; o < G::kR / 8; ++o) load_quad8(qt, 8 * o, lane, rot_sel(lane >> 1), w[o]);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint2 sq = scale_quad(&st.sc[p][0], lane);  // the plane's one scale row
#pragma unroll
      for (int o = 0; o < G::kR / 8; ++o)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = (p * G::kR / 8 + o) * 2048 + (4 * lane + ((j + rot) & 3)) * 16;
          uint4 hp, lp;
          decode8_split(w[o][j] >> (4 * p), w[o][4 + j] >> (4 * p),
                        __byte_perm(sq.x, sq.y, splat[j]), hp, lp);
          *reinterpret_cast<uint4*>(wt + at) = hp;
          *reinterpret_cast<uint4*>(wt + kLo + at) = lp;
        }
    }
  }
};

template <typename F, int BM>
constexpr int kPlaneRowStages =
    ring_stages<typename F::template Stage<BM>, 1024, 12, kRingBudgetMax>();
// the decode warps keep a stage's codes and their scales in registers: 88
// a producer thread, 208 a consumer thread (its f32 tile needs ~110)
constexpr int kPlaneProducerRegs = 88;
template <typename F, int BM>
using PlaneRowRing =
    Ring<typename F::template Stage<BM>, kPlaneRowStages<F, BM>, true, kPlaneProducerRegs>;

// Before the rows kernel, for x [B, K] bf16: each group's f32 sum into xsum
// [K/group][bpad] (unless xsum is null: no zs term), and x into xc [bpad,
// K] in the kernel's step order: element j*Kp + r (plane j) of a row at (r /
// kR) * kE + j * kR + r % kR, so a step's x is kE contiguous elements of
// each row (one TMA box of 64- or 128-byte rows). Rows B..bpad-1 are zeros.
// A thread takes c = max(8, group/32) consecutive elements of a row in
// 16-byte pieces (each lands in 8 consecutive places of xc: kR is a
// multiple of 8), and the S = group/c threads of a group (a power of two,
// at most 32, aligned in the warp) add their sums with shuffles. A group
// lies in one plane (Kp % group == 0).
__global__ void plane_prep_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ xsum,
                                  __nv_bfloat16* __restrict__ xc, int B, int K, int group,
                                  int bpad, int per, int kr, int ke, int c, long long n) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per_row = K / c;
  const int b = (int)(v / per_row), e0 = c * (int)(v % per_row);
  const bool live = v < n;  // threads past the end still take part in the shuffles
  const int kp = K / per, j = e0 / kp;
  float s = 0.f;
  if (live)
    for (int e = e0; e < e0 + c; e += 8) {
      const uint4 u = b < B ? *reinterpret_cast<const uint4*>(x + (size_t)b * K + e)
                            : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) s += bf16_lo(w[h]) + bf16_hi(w[h]);
      const int r = e - j * kp;
      *reinterpret_cast<uint4*>(xc + (size_t)b * K + (r / kr) * ke + j * kr + r % kr) = u;
    }
  if (xsum == nullptr) return;
  const int S = group / c;  // threads of a group
  for (int off = S / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (live && (threadIdx.x & (S - 1)) == 0) xsum[(size_t)(e0 / group) * bpad + b] = s;
}

template <typename G>
inline void launch_plane_prep(const __nv_bfloat16* x, const Workspace& w, int B, int K, int group,
                              cudaStream_t st) {
  const int c = group / 32 > 8 ? group / 32 : 8;
  const long long n = (long long)w.bpad * (K / c);
  plane_prep_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      x, w.xsum, w.xc, B, K, group, w.bpad, G::kPer, G::kR, G::kE, c, n);
}

template <typename F, int BM>
__global__ void __launch_bounds__(kRowThreads, 1)
    plane_rows_kernel(const __grid_constant__ typename F::Maps fm, const typename F::Shifts sh,
                      const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap zmap,
                      const __grid_constant__ CUtensorMap summap, void* out, int out_mode, int B,
                      int K, int O, int group, int slices_per_split) {
  using G = typename F::G;
  using Stage = typename F::template Stage<BM>;
  static_assert(kPlaneRowStages<F, BM> >= 3, "the ring holds a stage for each decode warp");
  constexpr bool ZS = F::kZs;
  constexpr int N = BM == 128 ? 128 : 64;  // wgmma width of a consumer warpgroup
  constexpr int kPer = G::kPer, kR = G::kR, kE = G::kE, kXRow = G::kXRow;
  extern __shared__ uint8_t smem_prow[];
  uint8_t* base = smem_prow + ((1024 - (smem_u32(smem_prow) & 1023)) & 1023);
  const PlaneRowRing<F, BM> ring(base, 0);
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * kGemvCols;
  // Z is a power of two (plane_rows_take): the ring's slice index is one
  // multiply-high, no division (each of which costs a single-thread chain
  // of ~40 instructions in the hot loops)
  const int Kp = K / kPer;
  const int Z = plane_slice_steps<G, ZS>(group);
  const int s_begin = blockIdx.z * slices_per_split * Z;  // the split's first main step
  const int n_main = max(0, min(slices_per_split * Z, Kp / kR - s_begin));
  const int Zr = ZS ? Z + 1 : Z;  // ring steps a slice
  const int n = ZS ? n_main + (n_main + Z - 1) / Z : n_main;
  // i / Zr for the ring's step indices: the high word of i * ceil(2^32 / Zr),
  // exact for i < 2^32 / Zr
  const uint32_t zr_magic = (uint32_t)(0xFFFFFFFFu / (uint32_t)Zr) + 1u;
  auto slice_of = [&](int i) { return (int)__umulhi((uint32_t)i, zr_magic); };
  // ring step i of slice k: its main steps, then (ZS) its zs step
  auto is_main = [&](int i) {
    if constexpr (!ZS) return true;
    const int k = slice_of(i);
    return i - k * Zr < min(Z, n_main - k * Z);
  };
  auto main_step = [&](int i) { return s_begin + i - (ZS ? slice_of(i) : 0); };

  constexpr int kZU = G::kZU;
  // a slice's first group of a plane
  auto zs_row = [&](int i) { return (blockIdx.z * slices_per_split + slice_of(i)) * (kZU / kPer); };
  auto copy = [&](Stage& S, int i, uint64_t* full) {
    if (is_main(i)) {
      const int s = main_step(i);
      F::copy(S, fm, sh, s * kR, col0, full);
      tma_load_2d(S.x, &xmap, s * kE, row0, full);
    } else if constexpr (ZS) {
      // the slice's sums ([kPer][Kp/group][bpad]) and its zs rows
      const int2 z = F::zs_at(sh, zs_row(i));
      tma_load_3d(S.x, &summap, row0, zs_row(i), 0, full);
      tma_load_3d(S.w, &zmap, col0, z.x, z.y, full);
      tma_load_3d(S.w + kZU * 128, &zmap, col0 + 64, z.x, z.y, full);
    }
  };
  const uint32_t main_tx = F::w_tx(sh) + kE * BM * 2;
  const uint32_t zs_tx = kZU * BM * 4 + 2 * kZU * 64 * 2;
  auto tx = [&](int i) { return is_main(i) ? main_tx : zs_tx; };
  auto decode = [&](Stage& S, int i, int lane) {
    if (is_main(i)) F::decode(S, sh, lane);
  };

  // the A descriptor of k16 slice kk of the x tile, rows 64*wr..
  auto x_desc = [&](const uint8_t* x, int kk, int wr) {
    return swizzled_desc(x + wr * 64 * kXRow + kk * 32, 16, 8 * kXRow, G::kXLayout);
  };
  // consumer warpgroup wg: rows 64*wr.., columns 64*wc.. of the tile
  auto consume = [&](int wg) {
    const int wr = BM == 128 ? wg : 0, wc = BM == 128 ? 0 : wg;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int t = lane & 3;
    const int rl = wr * 64 + warp * 16 + (lane >> 2);  // rows rl and rl + 8 of the tile
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    uint32_t za[kZU / 16][3][4] = {};  // a zs step's A fragments: xsum's three bf16 parts
    for (int i = 0; i < n; ++i) {
      const Stage& S = ring[i];
      ring.acquire(i);
      if (is_main(i)) {
        // each decoded part (Q4kFmt: hi, then lo) against the same x tile
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < F::kParts * kE / 16; ++kk)
          wgmma_bf16<N>(acc, x_desc(S.x, kk % (kE / 16), wr),
                        kmajor_desc(S.w + kk * 4096 + wc * 1024, 2048, 128));
        wgmma_commit();
      } else if constexpr (ZS) {
        // A fragment a of k16 half h: rows rl + 8 (a % 2), units 16h + 2t +
        // 8 (a / 2) and + 1; the zs tile's two 64-column blocks kZU rows apart
        const float* xs = reinterpret_cast<const float*>(S.x);
#pragma unroll
        for (int h = 0; h < kZU / 16; ++h)
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int r = rl + 8 * (a & 1), u = 16 * h + 2 * t + 8 * (a >> 1);
            __nv_bfloat16 p0[3], p1[3];
            split3(F::kZsMul * xs[u * BM + r], p0);
            split3(F::kZsMul * xs[(u + 1) * BM + r], p1);
#pragma unroll
            for (int q = 0; q < 3; ++q) za[h][q][a] = bf16_pair(p0[q], p1[q]);
          }
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < kZU / 16; ++h)
#pragma unroll
          for (int q = 0; q < 3; ++q)
            wgmma_bf16_rs_neg<N>(acc, za[h][q],
                                 swizzled_desc(S.w + wc * kZU * 128 + h * 2048, kZU * 128, 1024, 1));
        wgmma_commit();
      }
      // the stage is freed as soon as its products are done (holding it
      // until the next step's products were issued measured 7% slower)
      wgmma_wait<0>();
      if constexpr (ZS) {
#pragma unroll
        for (int h = 0; h < kZU / 16; ++h)
#pragma unroll
          for (int q = 0; q < 3; ++q) fence_operand(za[h][q]);
      }
      ring.release(i);
    }
    fence_values(acc);
    store_rows(out, out_mode, acc, B, O, row0 + rl, col0 + wc * 64 + 2 * t);
  };
  ring.run(n, tx, copy, decode, consume);
}

// Whether the rows kernel reads x in place: at 8 bits its step order is x's
// own, and without the zs term there are no sums to take before it.
template <typename F>
constexpr bool kPlaneXInPlace = F::G::kPer == 1 && !F::kZs;

// Launch plane_rows_kernel (after launch_plane_prep) with the format's maps:
// x's step-ordered copy xc [bpad, K] (kPlaneXInPlace: x [B, K] itself, the
// rows past B zero-filled by TMA) in boxes of kE elements x BM rows; with
// the zs term, xsum [K/group][bpad] seen as [kPer][Kp/group][bpad] in boxes
// of the slice's groups. Returns the CUDA error.
template <typename F, int BM>
int launch_plane_rows(const __nv_bfloat16* x, const Workspace& w, const typename F::Maps& fm,
                      typename F::Shifts sh, const CUtensorMap& zmap, void* out, int out_is_bf16,
                      int B, int K, int O, int group, dim3 grid, cudaStream_t st) {
  using G = typename F::G;
  constexpr bool kInPlace = kPlaneXInPlace<F>;
  const int Kp = K / G::kPer, gpp = Kp / group;  // groups a plane
  const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)(kInPlace ? B : w.bpad)};
  const uint64_t xstr[1] = {(uint64_t)K * 2};
  const uint32_t xbox[2] = {G::kE, BM};
  CUtensorMap xmap, summap;
  int err = tile_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kInPlace ? x : w.xc, xdims, xstr,
                     xbox, G::kXSwizzle);
  if constexpr (F::kZs) {
    const uint64_t mdims[3] = {(uint64_t)w.bpad, (uint64_t)gpp, (uint64_t)G::kPer};
    const uint64_t mstr[2] = {(uint64_t)w.bpad * 4, (uint64_t)gpp * w.bpad * 4};
    const uint32_t mbox[3] = {BM, G::kZU / G::kPer, G::kPer};
    if (!err)
      err = tile_map(&summap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, w.xsum, mdims, mstr, mbox);
  } else {
    summap = xmap;  // unused
  }
  if (err) return err;
  const int Z = plane_slice_steps<G, F::kZs>(group);
  const int nslices = (Kp / G::kR + Z - 1) / Z;
  const int ksplit = (int)grid.z;
  auto* kern = plane_rows_kernel<F, BM>;
  const int smem = PlaneRowRing<F, BM>::smem_bytes(0) + 1024;  // + alignment to 1024
  return launch_ring(kern, smem, w, out, out_is_bf16, ksplit, B * O, st, [&](void* dst, int mode) {
    kern<<<grid, kRowThreads, smem, st>>>(fm, sh, xmap, zmap, summap, dst, mode, B, K, O, group,
                                          (nslices + ksplit - 1) / ksplit);
  });
}

// The rows route of a call (after the caller's shape checks): the plan's
// stage count checked, the format's maps built from its arrays (fa: see
// its make_maps), the pre-pass (x in step order, and the per-group sums
// with the zs term; none when x is read in place), then plane_rows_kernel
// at the plan's row tile (64 or 128). Returns the CUDA error.
template <typename F, typename... A>
int plane_rows_call(const __nv_bfloat16* x, const Workspace& w, void* out, int out_is_bf16, int B,
                    int K, int O, int group, int rows, dim3 grid, int stages, cudaStream_t st,
                    A... fa) {
  if (stages != (rows == 64 ? kPlaneRowStages<F, 64> : kPlaneRowStages<F, 128>))
    return (int)cudaErrorInvalidValue;
  typename F::Maps fm;
  typename F::Shifts sh;
  CUtensorMap zmap;
  int err = F::make_maps(fm, sh, zmap, K, O, group, fa...);
  if (err) return err;
  if constexpr (!kPlaneXInPlace<F>) {
    launch_plane_prep<typename F::G>(x, w, B, K, group, st);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return rows == 64 ? launch_plane_rows<F, 64>(x, w, fm, sh, zmap, out, out_is_bf16, B, K, O,
                                               group, grid, st)
                    : launch_plane_rows<F, 128>(x, w, fm, sh, zmap, out, out_is_bf16, B, K, O,
                                                group, grid, st);
}


// ---- The decode instantiation (1-16 rows): plane_dec_kernel ----
//
// K10, K8 and K5 at 1-16 rows, one template over PlaneFmt<BITS, SIGNED, ST,
// ZS> (K10: unsigned codes of 1, 2, 4 or 8 bits, bf16 scale and zs; K8:
// signed bytes, a bf16 or f32 scale per 32, no zs) and Q4kFmt (K5: 4 bits,
// group 32, zs = minv, the scale on the accumulator), on K4's decode design
// (csrc/q6k_gemv.cu) and common.cuh's decode section, whose pieces it uses
// (DecRing, dec_store_tile / dec_reduce / dec_store_out, w_frags,
// launch_dec, dec_stages, dec_per_split). What bounds it: the weight
// stream. Design:
// - a K step is kR byte rows of q (64 at 8 bits, 32 below), which hold
//   kPer = 8/BITS planes of kR elements each (plane j's elements j*Kp +
//   r0..); sized from the bytes: at C = 128 columns 8 KB of codes at 8
//   bits (K8 with 0.5 or 1 KB of scale rows, GPTQ-8 0.25 + 0.25 KB of
//   scale and zs at group 128), 4 KB below (Q2_K with 2 + 2 KB of scale and
//   zs rows, a row a 16 elements); a ring stage is one step, and the ring
//   holds dec_stages of the stage's most weight bytes (four stages at 128
//   columns at 2 and 8 bits, six at 4, three at 1);
// - a block owns C = 128 or 64 columns and one K split; the splits of a
//   column tile are one cluster (at most 8) that adds its f32 tiles in
//   distributed shared memory in rank order (no partials in global memory,
//   no split-K pass); one split writes out itself;
// - one producer warp brings a step's weights in one TMA box an array, at
//   most half the ring ahead of what has landed: q as [Kp][O] (the 128-byte
//   swizzle at C = 128); scale and zs each seen as [kPer][Kp/group][O], so
//   every plane's rows of the step arrive in one box of nr rows a plane
//   (plane_dec_rows: kR/group when a group divides the step, 1 when the
//   step divides a group, else the most a step can touch, 2); the step's
//   first group g and its first row's place in it are walked from step to
//   step (PlaneGroupWalk), so a group of any multiple of 16 rows that lies
//   in one plane, a per-channel group of all K (14336) or one that spans
//   several steps (GPTQ-8's 128 at 64-row steps) included, finds its row;
// - the other producer warp brings x after griddepcontrol.wait by one TMA
//   box of x seen as [B][kPer][Kp] (kR elements of every plane for 16 rows,
//   rows past B zero-filled): no quantize kernel, no workspace, one launch
//   a call;
// - C/32 consumer warps, each 32 columns: the weight is the A operand of
//   bf16 mma.m16n8k16 (an output column an A row, w_frags) and x the B
//   operand (one n-tile up to 8 rows, two up to 16), f32 accumulators;
//   plane j's codes a shift and a mask of the transposed words;
// - bf16(code * s) rounded once, with the plain version's bits: below 8
//   bits K4's pair (bytes under 0x43 are bf16 128 + c; one fma.rn.bf16x2
//   (128 + c) * s - 128 * s); at 8 bits 128 + c needs 9 bits, so the pair
//   is built from the code's low 7 bits, 128 + (c & 127), and the fma's
//   exact addend picks the top bit's share by a select on the sign-extended
//   byte: -128 s or 0 for an unsigned code (K10), -128 s or -256 s for a
//   signed one (K8): 4.5 instructions a pair against 2 below 8 bits; by
//   count a consumer warp's step (~290 instructions at 8 bits) fills under
//   half the issue slots that the step's 9 KB take to stream at two blocks
//   an SM (the f32 route of the rows kernel, 2^23 + c and an f32 fma, then
//   the bf16 pack, costs 5 unsigned and 7 signed, and the pack runs on the
//   conversion pipe); K8's f32 rq8 scale is rounded to bf16 once, as it
//   is read;
// - the zs term: a second bf16 mma into the same accumulators with A = -zs
//   (exact in bf16, constant over a 16-element half) and x's B fragments
//   already in registers, in f32 over the original bf16 x as the plain
//   version's (x sums @ zs), never folded into the rounded weight (kept
//   over per-16 sums of the staged x and FMAs a row, column and group: one
//   mma a 16 x 8 x 16 product against the adds over 16 rows x kE elements
//   a step and 16 FMAs a half for every consumer warp);
// - K5 (F::kScaleOnAcc): the JAX kernel multiplies each 32-element
//   sub-block's f32 dot by its scale, and bf16(q * s) moves y by 1-2e-3 of
//   max |y| on random Q4_K codes (ten times K5's 1e-4), so the A operand
//   is the nibble itself, (128 + c) - 128 in one exact fma.rn.bf16x2; a
//   plane's two 16-element halves run into a fresh f32 fragment, which one
//   FFMA a (row, column, group) adds times the column's scale (the step's
//   32 rows are one group of each plane); the min term is a second FFMA,
//   x's f32 sums over the group times -minv, the sums taken by a bf16 mma
//   with an all-ones A over the x fragments already in registers: one mma
//   a half and n-tile where the zs term's -minv takes two (one a column
//   pair); on an H100 5-8% faster at gate|up and down than the zs term,
//   and 7x closer to the plain version's xsum @ minv;
// - no per-call state: each block sets up its own barriers and nothing in
//   global memory needs zeroing, so a call replays in a CUDA graph.

// the decode step of BITS-bit planes: kR byte rows (kPer planes of kR
// elements), at most kNR scale rows a plane (a row a 16 elements)
template <int BITS>
struct PlaneDecGeom {
  static constexpr int kPer = 8 / BITS;
  static constexpr int kR = BITS == 8 ? 64 : 32;
  static constexpr int kNR = kR / 16;
};

// scale rows a plane of a step's box: the most groups kR rows can touch
// (rows start at multiples of 16 in a group)
__host__ __device__ constexpr int plane_dec_rows(int R, int group) {
  return R % group == 0 ? R / group : group % R == 0 ? 1 : (group - 16 + R - 1) / group + 1;
}

template <typename F, int C>
struct alignas(C == 128 ? 1024 : 128) PlaneDecStage {
  using G = PlaneDecGeom<F::G::kBits>;
  using ST = typename F::Scale;
  static constexpr int kScRows = G::kPer * G::kNR;
  // the weight bytes a stage holds at most: codes, scale and zs rows
  static constexpr int kWeightBytes =
      G::kR * C + kScRows * C * ((int)sizeof(ST) + (F::kZs ? 2 : 0));
  uint8_t q[G::kR * C];                         // the byte rows (TMA, swizzled at C = 128)
  ST sc[kScRows][C];                            // plane j's rows from j * nr
  __nv_bfloat16 zs[F::kZs ? kScRows : 1][C];    // the same rows of zs
  __nv_bfloat16 x[kDecRows][G::kPer][G::kR];    // x's kR elements of every plane, 16 rows
};
template <typename F, int C>
constexpr int kPlaneDecStages = dec_stages(PlaneDecStage<F, C>::kWeightBytes);
template <typename F, int C>
using PlaneDecRing = DecRing<PlaneDecStage<F, C>, kPlaneDecStages<F, C>, C / 32>;

// A step's place among the groups of a plane (a group lies in one plane,
// so every plane's is the same): its first group g and its first row's
// offset rem in it, walked from step to step without a division.
struct PlaneGroupWalk {
  int g, rem;
  __device__ PlaneGroupWalk(int r0, int group) : g(r0 / group), rem(r0 % group) {}
  // row[h]: the box row (the group past g) of the step's rows 16h..16h+15
  template <int NH>
  __device__ void rows(int group, int (&row)[NH]) const {
    int next = group - rem, r = 0;  // the step's row where the next group starts
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      if (16 * h >= next) {  // a group holds at least 16 rows: one start a half at most
        ++r;
        next += group;
      }
      row[h] = r;
    }
  }
  __device__ void step(int R, int group) {
    rem += R;
    while (rem >= group) {
      rem -= group;
      ++g;
    }
  }
};

// the bf16 pairs (s, s) of columns c..c+3 of a staged scale row; an f32
// row is rounded to bf16 first
__device__ __forceinline__ void scale_pairs(const __nv_bfloat16* p, uint32_t sp[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  sp[0] = __byte_perm(u.x, 0, 0x1010);
  sp[1] = __byte_perm(u.x, 0, 0x3232);
  sp[2] = __byte_perm(u.y, 0, 0x1010);
  sp[3] = __byte_perm(u.y, 0, 0x3232);
}
__device__ __forceinline__ void scale_pairs(const float* p, uint32_t sp[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  sp[0] = bf16x2(v.x, v.x);
  sp[1] = bf16x2(v.y, v.y);
  sp[2] = bf16x2(v.z, v.z);
  sp[3] = bf16x2(v.w, v.w);
}

// prmt with the selector's sign-extend bits (which __byte_perm masks off):
// byte i of the result is byte (sel_i & 7) of w, or its sign bit replicated
// when sel_i & 8
__device__ __forceinline__ uint32_t prmt_sext(uint32_t w, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(w), "r"(0u), "r"(sel));
  return d;
}

// The A words of 4 codes of a column (K rows 4t..4t+3, bytes 0..3 of cw,
// below 8 bits already shifted down and masked): lo = rows 4t, 4t+1 (mma k
// 2t, 2t+1), hi = rows 4t+2, 4t+3 (k 2t+8, 2t+9), each bf16(code * s)
// rounded once; sp = (s, s), n128 = -128 s and n256 = -256 s (exact; only
// signed 8-bit codes read it). K4's decode kernel (csrc/q6k_gemv.cu) takes
// its 6-bit pairs from here too.
template <int BITS, bool SIGNED>
__device__ __forceinline__ void dec_code_pairs(uint32_t cw, uint32_t sp, uint32_t n128,
                                               uint32_t n256, uint32_t& lo, uint32_t& hi) {
  if constexpr (BITS < 8) {  // 0x43cc = 128 + c: (128 + c) s - 128 s
    lo = fma_bf16x2(__byte_perm(cw, 0x43u, 0x4140), sp, n128);
    hi = fma_bf16x2(__byte_perm(cw, 0x43u, 0x4342), sp, n128);
  } else {
    // 0x43cc of the low 7 bits = 128 + (c & 127); the top bit's share in
    // the addend: c = (c & 127) + 128 (unsigned) or (c & 127) - 128 (signed)
    // when it is set, (c & 127) when not
    const uint32_t low7 = cw & 0x7F7F7F7Fu;
    const uint32_t tl = prmt_sext(cw, 0x9988), th = prmt_sext(cw, 0xBBAA);  // 0xFFFF: bit 7 set
    const uint32_t al = SIGNED ? (tl & n256) | (~tl & n128) : ~tl & n128;
    const uint32_t ah = SIGNED ? (th & n256) | (~th & n128) : ~th & n128;
    lo = fma_bf16x2(__byte_perm(low7, 0x43u, 0x4140), sp, al);
    hi = fma_bf16x2(__byte_perm(low7, 0x43u, 0x4342), sp, ah);
  }
}

// A consumer warp over its n steps: y[nt][m][e] = the f32 sums of x row 8nt
// + 2t + e%2 and column 32 * warp + 4g + 2m + e/2 (NT n-tiles: 1 up to 8
// rows); r0 = the split's first byte row, nr = scale rows a plane a step.
template <typename F, int C, int NT>
__device__ __forceinline__ void plane_dec_consume(const PlaneDecRing<F, C>& ring, int n, int r0,
                                                  int group, int nr, int warp, int lane,
                                                  float (&y)[2][2][4]) {
  using Stage = PlaneDecStage<F, C>;
  using G = typename Stage::G;
  constexpr int BITS = F::G::kBits, kPer = G::kPer, kR = G::kR;
  constexpr uint32_t kMask = ((1u << BITS) - 1u) * 0x01010101u;  // BITS low bits of each byte
  constexpr uint32_t kNeg128 = 0xC300C300u, kNeg256 = 0xC380C380u, kNegZero = 0x80008000u;
  constexpr uint32_t kOne = 0x3F803F80u;
  static_assert(!F::kScaleOnAcc || (kR == 32 && F::kZs), "a scale a 32-row group, zs = minv");
  const int g = lane >> 2, t = lane & 3, c = 32 * warp + 4 * g;
  float acc[NT * 2][4];  // index nt * 2 + m
#pragma unroll
  for (int i = 0; i < NT * 2; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  PlaneGroupWalk walk(r0, group);
  for (int i = 0; i < n; ++i) {
    const Stage& S = ring[i];
    int srow[kR / 16];  // the scale row of each 16 rows of the step, in a plane's box rows
    walk.rows(group, srow);
    walk.step(kR, group);
    ring.acquire(i);
#pragma unroll
    for (int cc = 0; cc < kR / 32; ++cc) {
      uint32_t w[2][4];  // rows 32cc + 4t.. ([0]) and 32cc + 16 + 4t.. ([1]) of columns c..c+3
      w_frags<C>(S.q, 32 * cc, c, t, w[0], w[1]);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float d[NT * 2][4];  // kScaleOnAcc: plane j's 32-row group dots, before its scale
        float xs[NT][4];     // kScaleOnAcc: x's sums over the group (an all-ones A)
        if constexpr (F::kScaleOnAcc) {
#pragma unroll
          for (int k = 0; k < NT * 2; ++k) d[k][0] = d[k][1] = d[k][2] = d[k][3] = 0.f;
#pragma unroll
          for (int k = 0; k < NT; ++k) xs[k][0] = xs[k][1] = xs[k][2] = xs[k][3] = 0.f;
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = j * nr + srow[2 * cc + hf];
          uint32_t wl[4], wh[4];
          if constexpr (F::kScaleOnAcc) {  // the codes themselves, exact: (128 + c) - 128
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const uint32_t cw = (w[hf][k] >> (BITS * j)) & kMask;
              wl[k] = fma_bf16x2(__byte_perm(cw, 0x43u, 0x4140), kOne, kNeg128);
              wh[k] = fma_bf16x2(__byte_perm(cw, 0x43u, 0x4342), kOne, kNeg128);
            }
          } else {
            uint32_t sp[4], n128[4], n256[4];
            scale_pairs(&S.sc[row][c], sp);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              n128[k] = fma_bf16x2(sp[k], kNeg128, kNegZero);
              n256[k] = F::kSigned ? fma_bf16x2(sp[k], kNeg256, kNegZero) : 0u;
              dec_code_pairs<BITS, F::kSigned>((w[hf][k] >> (BITS * j)) & kMask, sp[k], n128[k],
                                              n256[k], wl[k], wh[k]);
            }
          }
          uint32_t nz[4];  // -zs of columns c..c+3 in both halves of a word
          if constexpr (F::kZs && !F::kScaleOnAcc) {
            uint2 zu = *reinterpret_cast<const uint2*>(&S.zs[row][c]);
            zu.x ^= 0x80008000u;
            zu.y ^= 0x80008000u;
            nz[0] = __byte_perm(zu.x, 0, 0x1010);
            nz[1] = __byte_perm(zu.x, 0, 0x3232);
            nz[2] = __byte_perm(zu.y, 0, 0x1010);
            nz[3] = __byte_perm(zu.y, 0, 0x3232);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            // B: x row 8nt + g, elements 32cc + 16hf + 4t.. of plane j
            const uint2 xv =
                *reinterpret_cast<const uint2*>(&S.x[8 * nt + g][j][32 * cc + 16 * hf + 4 * t]);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const uint32_t a[4] = {wl[2 * m], wl[2 * m + 1], wh[2 * m], wh[2 * m + 1]};
              mma_bf16(F::kScaleOnAcc ? d[nt * 2 + m] : acc[nt * 2 + m], a, xv.x, xv.y);
              if constexpr (F::kZs && !F::kScaleOnAcc) {
                const uint32_t z[4] = {nz[2 * m], nz[2 * m + 1], nz[2 * m], nz[2 * m + 1]};
                mma_bf16(acc[nt * 2 + m], z, xv.x, xv.y);
              }
            }
            if constexpr (F::kScaleOnAcc) {
              const uint32_t ones[4] = {kOne, kOne, kOne, kOne};
              mma_bf16(xs[nt], ones, xv.x, xv.y);
            }
          }
        }
        if constexpr (F::kScaleOnAcc) {  // the scale on the dots, minus sums x minv
          float s[4], mn[4];
          lds4(&S.sc[j * nr + srow[2 * cc]][c], s);
          lds4(&S.zs[j * nr + srow[2 * cc]][c], mn);
#pragma unroll
          for (int k = 0; k < NT * 2; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[k][e] = fmaf(d[k][e], s[2 * (k & 1) + (e >> 1)], acc[k][e]);
              acc[k][e] = fmaf(-xs[k >> 1][e & 1], mn[2 * (k & 1) + (e >> 1)], acc[k][e]);
            }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NT * 2; ++k) fence_values(acc[k]);  // the stage's reads have landed
    ring.release(i);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[nt][m][e] = acc[nt * 2 + m][e];
}

// A block of dec_threads(C) threads: the consumer warps 0..C/32-1, the
// producers the last two. steps = the call's K steps (the last one past
// Kp is zero-filled), steps_per_split = dec_per_split(steps, splits, 1).
template <typename F, int C>
__global__ void __launch_bounds__(dec_threads(C), 3)
    plane_dec_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap smap,
                     const __grid_constant__ CUtensorMap zmap,
                     const __grid_constant__ CUtensorMap xmap, void* out, int out_is_bf16, int B,
                     int O, int steps, int group, int nr, int steps_per_split) {
  constexpr int NW = C / 32;  // consumer warps; the producers are warps NW and NW + 1
  using Stage = PlaneDecStage<F, C>;
  using G = typename Stage::G;
  extern __shared__ uint8_t smem_pdec[];
  const PlaneDecRing<F, C> ring(smem_pdec);
  const int splits = (int)gridDim.x, rank = (int)cluster_rank();
  const int col0 = blockIdx.y * C;
  const int s_begin = rank * steps_per_split;
  const int n = max(0, min(steps_per_split, steps - s_begin));  // a stage a step
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  float y[2][2][4] = {};
  if (warp == NW) {  // the weights: a TMA box an array a step
    if (lane == 0) {
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&smap);
      if constexpr (F::kZs) prefetch_tensormap(&zmap);
      const uint32_t tx = G::kR * C +
                          nr * G::kPer * C * ((uint32_t)sizeof(typename Stage::ST) + (F::kZs ? 2 : 0));
      PlaneGroupWalk walk(s_begin * G::kR, group);
      ring.produce(
          n, true, [&](int) { return tx; },
          [&](Stage& S, int i, uint64_t* full) {
            tma_load_2d(S.q, &qmap, col0, (s_begin + i) * G::kR, full);
            tma_load_3d(S.sc, &smap, col0, walk.g, 0, full);
            if constexpr (F::kZs) tma_load_3d(S.zs, &zmap, col0, walk.g, 0, full);
            walk.step(G::kR, group);
          });
    }
    __syncwarp();
  } else if (warp == NW + 1) {  // x, once the kernel launched before has finished
    if (lane == 0) {
      grid_dep_wait();
      prefetch_tensormap(&xmap);
      ring.produce(
          n, false, [](int) { return (uint32_t)sizeof(Stage::x); },
          [&](Stage& S, int i, uint64_t* full) {
            tma_load_3d(S.x, &xmap, (s_begin + i) * G::kR, 0, 0, full);
          });
    }
    __syncwarp();
  } else if (B > 8) {
    plane_dec_consume<F, C, 2>(ring, n, s_begin * G::kR, group, nr, warp, lane, y);
  } else {
    plane_dec_consume<F, C, 1>(ring, n, s_begin * G::kR, group, nr, warp, lane, y);
  }
  if (splits == 1) {  // no cluster to add up
    if (warp < NW) dec_store_out(y, B > 8 ? 2 : 1, out, out_is_bf16, B, O, col0, warp, lane);
    return;
  }
  __syncthreads();  // every stage consumed: the ring's memory holds the tile now
  float* red = static_cast<float*>(ring.base());
  if (warp < NW) dec_store_tile<C>(red, y, B > 8 ? 2 : 1, warp, lane);
  cluster_sync();
  dec_reduce<C>(red, out, out_is_bf16, B, O, col0, splits, rank);
  cluster_sync();  // no block leaves while another reads its tile
}

// Whether (rows, grid, cluster, cols, stages) is the decode plan of
// ops/quant_matmul.plane_dec_plan for this call: B <= 16, a group of
// whole 16-element halves inside one plane ((K/kPer) % group == 0), grid
// (K splits, column tiles of `cols` = 128 or 64, 1), a cluster of the
// splits (at most 8), every split whole steps and none empty, the ring's
// stages.
template <typename F>
bool plane_dec_plan_ok(int B, int K, int O, int group, int rows, int gx, int gy, int gz,
                       int cluster, int cols, int stages) {
  using G = PlaneDecGeom<F::G::kBits>;
  const int Kp = K / G::kPer, steps = (Kp + G::kR - 1) / G::kR;
  if (rows != 16 || B < 1 || B > 16 || gz != 1 || (cols != 128 && cols != 64)) return false;
  if (group < 16 || group % 16 || Kp % group || Kp % 32) return false;
  if (F::kScaleOnAcc && group != G::kR) return false;  // a scale a step's 32 rows
  if (cluster != gx || gx < 1 || gx > 8 || gx > steps || gy != (O + cols - 1) / cols) return false;
  const int per = dec_per_split(steps, gx, 1);
  return (gx - 1) * per < steps &&
         stages == (cols == 128 ? kPlaneDecStages<F, 128> : kPlaneDecStages<F, 64>);
}

// Launch plane_dec_kernel with C columns a block and `splits` K splits (a
// cluster each column tile): q [Kp, O] in boxes of kR rows (the 128-byte
// swizzle at C = 128), scale and zs [K/group, O] seen as [kPer][Kp/group][O]
// in boxes of nr rows a plane, x [B, K] bf16 seen as [B][kPer][Kp] in boxes
// of kR elements of every plane for 16 rows. Returns the CUDA error.
template <typename F, int C>
int launch_plane_dec(const void* x, const void* q, const void* scale, const void* zs, void* out,
                     int out_is_bf16, int B, int K, int O, int group, int splits,
                     cudaStream_t st) {
  using Stage = PlaneDecStage<F, C>;
  using G = typename Stage::G;
  const int Kp = K / G::kPer, steps = (Kp + G::kR - 1) / G::kR, nr = plane_dec_rows(G::kR, group);
  const uint64_t es = sizeof(typename Stage::ST);
  const uint64_t qdims[2] = {(uint64_t)O, (uint64_t)Kp}, qstr[1] = {(uint64_t)O};
  const uint32_t qbox[2] = {(uint32_t)C, (uint32_t)G::kR};
  const uint64_t sdims[3] = {(uint64_t)O, (uint64_t)(Kp / group), (uint64_t)G::kPer};
  const uint64_t sstr[2] = {(uint64_t)O * es, (uint64_t)(Kp / group) * O * es};
  const uint32_t sbox[3] = {(uint32_t)C, (uint32_t)nr, (uint32_t)G::kPer};
  const uint64_t zstr[2] = {(uint64_t)O * 2, (uint64_t)(Kp / group) * O * 2};
  const uint64_t xdims[3] = {(uint64_t)Kp, (uint64_t)G::kPer, (uint64_t)B};
  const uint64_t xstr[2] = {(uint64_t)Kp * 2, (uint64_t)K * 2};
  const uint32_t xbox[3] = {(uint32_t)G::kR, (uint32_t)G::kPer, (uint32_t)kDecRows};
  CUtensorMap qmap, smap, zmap, xmap;
  int err = tile_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, qdims, qstr, qbox,
                     C == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!err)
    err = tile_map(&smap, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                   3, scale, sdims, sstr, sbox);
  if (!err && F::kZs)
    err = tile_map(&zmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, zs, sdims, zstr, sbox);
  if (!F::kZs) zmap = smap;  // unused
  if (!err) err = tile_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, x, xdims, xstr, xbox);
  if (err) return err;
  return launch_dec(plane_dec_kernel<F, C>, splits, (O + C - 1) / C, dec_threads(C),
                    PlaneDecRing<F, C>::smem_bytes(), st, qmap, smap, zmap, xmap, out, out_is_bf16,
                    B, O, steps, group, nr, dec_per_split(steps, splits, 1));
}

// The decode route of a call: the plan checked (any other is refused),
// then plane_dec_kernel at its column width. Returns the CUDA error.
template <typename F>
int plane_dec_call(const void* x, const void* q, const void* scale, const void* zs, void* out,
                   int out_is_bf16, int B, int K, int O, int group, int rows, int gx, int gy,
                   int gz, int cluster, int cols, int stages, cudaStream_t st) {
  if (!plane_dec_plan_ok<F>(B, K, O, group, rows, gx, gy, gz, cluster, cols, stages))
    return (int)cudaErrorInvalidValue;
  return cols == 128
             ? launch_plane_dec<F, 128>(x, q, scale, zs, out, out_is_bf16, B, K, O, group, gx, st)
             : launch_plane_dec<F, 64>(x, q, scale, zs, out, out_is_bf16, B, K, O, group, gx, st);
}

}  // namespace mrt
