// K13: grouped GEMM over expert-sorted rows (the dropless MoE dispatch).
//
// Replaces the TPU library kernel jax.experimental.pallas.ops.tpu.megablox
// .gmm, called by mistralrs_tpu/ops/grouped_gemm.py::_gmm from
// grouped_matmul in mistralrs_tpu/models/decoder.py::_moe_mlp_grouped.
//
// lhs [M, K] bf16, rows sorted by group; rhs [G, K, N] bf16 (N contiguous);
// group_sizes [G] int32 on the device, summing to M; out [M, N] bf16 with
// out[m] = lhs[m] @ rhs[g(m)], the products on bf16 tensor cores summed in
// f32 and rounded to bf16 once.
//
// What bounds it on an H100: at decode (a few rows a group) the weight
// bytes: every group with rows reads its whole [K, N] matrix once, so a
// Mixtral gate call at M = 32 moves 940 MB (0.28 ms at 3.35 TB/s) for 3.8
// GFLOP. From ~300 rows a group on, the operations (2 M K N).
// Design: the host does not know the group sizes (they stay on the device,
// so the decode step never waits), so the grid is the most row tiles that
// group boundaries can make, ceil(M / TM) + G - 1, times N / 128 column
// tiles. Each block reads the sizes into shared memory, walks them to find
// its group and its TM rows (a group's tiles start at the group's first
// row), and exits if it has none: an empty group costs nothing and reads
// none of its weights. The rows of a block are TM = 16, 64 or 128 by the
// average rows a group (chosen by the host from M and G), so decode pays one
// m16 tile of mostly padding and prefill re-reads each weight tile M / TM
// times at most. A 4-stage cp.async ring stages [TM, 32] of lhs and
// [32, 128] of rhs per K step, XOR-swizzled so the ldmatrix reads are
// conflict-free (rhs fragments come through ldmatrix.trans from the
// row-major [K, N] weight); rows past the group's end and columns past N are
// zero-filled and never stored. wgmma, TMA, split-K at decode and sharing
// one read of x between gate and up are later work.
#include "common.cuh"

namespace {

constexpr int BN = 128;  // columns a block: 4 warps of 32 across
constexpr int BK = 32;   // K a stage
constexpr int STAGES = 4;
constexpr int MAX_GROUPS = 256;

template <int TM>
struct Cfg {
  static constexpr int MT = TM == 16 ? 1 : TM == 64 ? 2 : 4;  // m16 tiles a warp
  static constexpr int WARPS_M = TM / (16 * MT);
  static constexpr int THREADS = 32 * 4 * WARPS_M;
  static constexpr int A_BYTES = TM * BK * 2;  // [TM, 32] bf16, 64-byte rows
  static constexpr int B_BYTES = BK * BN * 2;  // [32, 128] bf16, 256-byte rows
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
};

// byte offset of 16-byte chunk c of row r in an lhs tile (4 chunks a row)
__device__ __forceinline__ uint32_t a_off(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}
// byte offset of 16-byte chunk c of row k in an rhs tile (16 chunks a row)
__device__ __forceinline__ uint32_t b_off(int k, int c) { return k * 256 + ((c ^ (k & 7)) << 4); }

template <int TM>
__device__ __forceinline__ void load_stage(uint8_t* sa, uint8_t* sb,
                                           const __nv_bfloat16* __restrict__ lhs,
                                           const __nv_bfloat16* __restrict__ w, int row0,
                                           int rows, int k0, int col0, int K, int N) {
  for (int i = threadIdx.x; i < TM * 4; i += Cfg<TM>::THREADS) {
    const int r = i >> 2, c = i & 3;
    const bool ok = r < rows;
    mrt::cp_async16(sa + a_off(r, c), ok ? lhs + (size_t)(row0 + r) * K + k0 + 8 * c : lhs, ok);
  }
  for (int i = threadIdx.x; i < BK * 16; i += Cfg<TM>::THREADS) {
    const int k = i >> 4, c = i & 15;
    const bool ok = col0 + 8 * c < N;
    mrt::cp_async16(sb + b_off(k, c), ok ? w + (size_t)(k0 + k) * N + col0 + 8 * c : w, ok);
  }
}

template <int TM>
__global__ void __launch_bounds__(Cfg<TM>::THREADS)
    grouped_gemm_kernel(const __nv_bfloat16* __restrict__ lhs,
                        const __nv_bfloat16* __restrict__ rhs,
                        const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ out,
                        int M, int K, int N, int G) {
  using C = Cfg<TM>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_sizes[MAX_GROUPS];
  __shared__ int s_group, s_row0, s_rows;
  for (int g = threadIdx.x; g < G; g += C::THREADS) s_sizes[g] = max(group_sizes[g], 0);
  __syncthreads();
  if (threadIdx.x == 0) {
    // group g owns tiles tile .. tile + ceil(n_g / TM) - 1, in group order
    int start = 0, tile = 0, rows = 0, group = 0, row0 = 0;
    for (int g = 0; g < G; ++g) {
      const int n = s_sizes[g];
      const int t = (n + TM - 1) / TM;
      if ((int)blockIdx.y < tile + t) {
        const int j = blockIdx.y - tile;
        group = g;
        row0 = start + j * TM;
        rows = min(TM, n - j * TM);
        break;
      }
      tile += t;
      start += n;
    }
    s_group = group;
    s_row0 = row0;
    s_rows = max(0, min(rows, M - row0));  // rows past M (sizes summing above M) are dropped
  }
  __syncthreads();
  const int rows = s_rows;
  if (rows == 0) return;
  const int row0 = s_row0;
  const int col0 = blockIdx.x * BN;
  const __nv_bfloat16* w = rhs + (size_t)s_group * K * N;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / 4, wn = warp % 4;  // warp's row block and 32-column block
  float acc[C::MT][4][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = K / BK;
  auto stage_a = [&](int s) { return smem + s * C::STAGE_BYTES; };
  auto stage_b = [&](int s) { return smem + s * C::STAGE_BYTES + C::A_BYTES; };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage<TM>(stage_a(s), stage_b(s), lhs, w, row0, rows, s * BK, col0, K, N);
    mrt::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    mrt::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed, and every warp is done with stage kt - 1
    const int pf = kt + STAGES - 1;
    if (pf < nk)
      load_stage<TM>(stage_a(pf % STAGES), stage_b(pf % STAGES), lhs, w, row0, rows, pf * BK,
                     col0, K, N);
    mrt::cp_async_commit();
    const uint32_t sa = mrt::smem_u32(stage_a(kt % STAGES));
    const uint32_t sb = mrt::smem_u32(stage_b(kt % STAGES));
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[C::MT][4];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        // matrices 0..3: rows +0/+8 (lane bit 3) x k +0/+8 (lane bit 4)
        const int r = (wm * C::MT + i) * 16 + (lane & 15);
        mrt::ldsm_x4(sa + a_off(r, (kk >> 3) + (lane >> 4)), a[i]);
      }
      uint32_t b[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        // matrices 0..3: k +0/+8 (lane bit 3) x n-tiles 2p / 2p + 1 (lane bit 4)
        const int k = kk + (lane & 7) + (lane & 8);
        uint32_t t[4];
        mrt::ldsm_x4_trans(sb + b_off(k, wn * 4 + 2 * p + (lane >> 4)), t);
        b[2 * p][0] = t[0];
        b[2 * p][1] = t[1];
        b[2 * p + 1][0] = t[2];
        b[2 * p + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mrt::mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  mrt::cp_async_wait<0>();

  // C fragment of tile (i, j): e = 0, 1 at row g, e = 2, 3 at row g + 8;
  // columns 2t, 2t + 1 of the n-tile
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + wn * 32 + j * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * C::MT + i) * 16 + g + 8 * h;
        if (r >= rows) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + r) * N + col) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

template <int TM>
int launch(const void* lhs, const void* rhs, const void* group_sizes, void* out, int M, int K,
           int N, int G, cudaStream_t st) {
  using C = Cfg<TM>;
  cudaError_t err = mrt::allow_smem(grouped_gemm_kernel<TM>, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + TM - 1) / TM + G - 1);
  grouped_gemm_kernel<TM><<<grid, C::THREADS, C::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(lhs), static_cast<const __nv_bfloat16*>(rhs),
      static_cast<const int*>(group_sizes), static_cast<__nv_bfloat16*>(out), M, K, N, G);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes are checked by the Python wrapper (ops/grouped_gemm.py): bf16
// contiguous 16-byte aligned lhs, rhs and out, int32 group_sizes on the same
// device, K % 32 == 0, N % 8 == 0, 1 <= G <= 256, M >= 1, tm 16, 64 or 128.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int grouped_gemm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                            int M, int K, int N, int G, int tm, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tm == 16) return launch<16>(lhs, rhs, group_sizes, out, M, K, N, G, st);
  if (tm == 64) return launch<64>(lhs, rhs, group_sizes, out, M, K, N, G, st);
  if (tm == 128) return launch<128>(lhs, rhs, group_sizes, out, M, K, N, G, st);
  return (int)cudaErrorInvalidValue;
}
