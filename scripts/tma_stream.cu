// A TMA streaming microbenchmark (scripts/torch_tma_stream.py runs it): blocks
// stream a [rows, O] u8 matrix in boxes of NB x 128 columns x R rows (the
// 128-byte swizzle) through a D-deep ring of mbarrier stages, one producer
// thread issuing the boxes; four consumer warps only wait and release. No
// compute: what it measures is how fast the card streams such a layout.
#include "../mistralrs_tpu_torch/csrc/common.cuh"
namespace {
template <int NB, int R, int D>
__global__ void __launch_bounds__(160) stream_kernel(const __grid_constant__ CUtensorMap map, int rows_per_split, int rows, int* sink) {
  extern __shared__ uint8_t smem[];
  uint8_t* base = smem + ((1024 - (mrt::smem_u32(smem) & 1023)) & 1023);
  constexpr int kStage = NB * 128 * R;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + D * kStage);
  uint64_t* empty = full + D;
  const int r0 = blockIdx.x * rows_per_split;
  const int n = max(0, min(rows_per_split, rows - r0)) / R;
  const int col0 = blockIdx.y * NB * 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < D; ++i) { mrt::mbar_init(full + i, 1); mrt::mbar_init(empty + i, 4); }
    mrt::mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4) {
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int s = i % D;
        if (i >= D) mrt::mbar_wait(empty + s, ((i / D) & 1) ^ 1);
        mrt::mbar_expect_tx(full + s, kStage);
        for (int b = 0; b < NB; ++b)
          mrt::tma_load_2d(base + s * kStage + b * 128 * R, &map, col0 + 128 * b, r0 + i * R, full + s);
      }
    }
    __syncwarp();
  } else {
    int acc = 0;
    for (int i = 0; i < n; ++i) {
      const int s = i % D;
      mrt::mbar_wait(full + s, (i / D) & 1);
      acc += base[s * kStage + lane * 4 + warp];
      __syncwarp();
      if (lane == 0) mrt::mbar_arrive(empty + s);
    }
    if (acc == 123456789) sink[0] = acc;
  }
}
template <int NB, int R, int D>
int launch(const void* w, int rows, int O, int splits, int* sink, cudaStream_t st) {
  CUtensorMap map;
  const uint64_t dims[2] = {(uint64_t)O, (uint64_t)rows}, str[1] = {(uint64_t)O};
  const uint32_t box[2] = {128, R};
  int err = mrt::tile_map(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dims, str, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const int smem = 1024 + D * NB * 128 * R + 16 * D;
  auto* k = stream_kernel<NB, R, D>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int per = (rows + splits - 1) / splits;
  k<<<dim3(splits, O / (NB * 128)), 160, smem, st>>>(map, (per + R - 1) / R * R, rows, sink);
  return (int)cudaGetLastError();
}
}  // namespace
extern "C" int stream_run(int cfg, const void* w, int rows, int O, int splits, int* sink, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cfg) {
    case 0: return launch<1, 64, 4>(w, rows, O, splits, sink, st);
    case 1: return launch<1, 128, 2>(w, rows, O, splits, sink, st);
    case 2: return launch<1, 64, 8>(w, rows, O, splits, sink, st);
    case 3: return launch<2, 64, 4>(w, rows, O, splits, sink, st);
    case 4: return launch<2, 32, 8>(w, rows, O, splits, sink, st);
    case 5: return launch<4, 32, 4>(w, rows, O, splits, sink, st);
    case 6: return launch<1, 32, 8>(w, rows, O, splits, sink, st);
    case 7: return launch<1, 256, 2>(w, rows, O, splits, sink, st);
  }
  return -1;
}
