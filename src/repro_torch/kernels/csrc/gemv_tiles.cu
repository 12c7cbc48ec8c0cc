// Owner-ordered GEMV partial tiles for Hopper (sm_90a): the compute side of
// the fused GEMV+AllReduce.
//
// Replaces the TPU kernel src/repro/kernels/gemv_tiles.py::gemv_tiles_pallas
// (body _kernel).  It computes y[M, N] = A[M, K] @ x[K, N] (float32
// accumulation, the result in A's dtype) in row tiles of bm rows, and issues
// the tiles in remote-first owner order: order[c] is the c-th tile to issue,
// the tiles of this device's ring successor first and its own tiles last
// (remote_first_order in gemv_tiles.py).  The second output, owner_served[c],
// is the owner device of the c-th issued tile, order[c] / tiles_per_dev.
//
// On the TPU the grid runs in order, so grid step t simply computes order[t].
// A CUDA grid has no issue order between blocks: writing order[blockIdx.x]
// would only relabel the grid.  So the kernel is persistent: each block claims
// the next issue index c from a global counter (atomicAdd), computes tile
// order[c] whole (all bm rows, full K; gemv_tile.cuh), records its owner, and
// claims again until c reaches the tile count.  Tiles start in order[] order.
// The counter is zeroed on the launch's stream before every launch.
//
// Bound on an H100 SXM (3.35 TB/s): as gemv, the function reads A once.  At the
// path's gemma3-27b shape (A = w.T, 5376 x 5376 bf16, bm = 64) that is 57.8 MB,
// about 17.3 us.  That shape has 84 tiles, so at most 84 of the 132 SMs work;
// splitting a tile's K across blocks is a later change.
//
// C interface (bound with ctypes): gemv_tiles_launch returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take.

#include <algorithm>

#include "gemv_tile.cuh"

using namespace repro_torch;

namespace {

template <typename T, bool kColMajor>
__global__ void __launch_bounds__(kGemvThreads)
gemv_tiles_kernel(GemvArgs p, int bm, const int* __restrict__ order, int tiles_per_dev,
                  int n_tiles, int* counter, int* __restrict__ owner_served) {
  __shared__ __align__(16) float xs[kMaxN * kChunkK];
  __shared__ int claim;
  for (;;) {
    if (threadIdx.x == 0) claim = atomicAdd(counter, 1);
    __syncthreads();
    const int c = claim;
    __syncthreads();  // every thread has read the claim before the next one
    if (c >= n_tiles) return;
    const int t = order[c];
    gemv_tile<T, kColMajor>(p, t * bm, bm, xs);
    if (threadIdx.x == 0) owner_served[c] = t / tiles_per_dev;
  }
}

template <typename T, bool kColMajor>
int launch_layout(const GemvArgs& p, int bm, const int* order, int tiles_per_dev, int n_tiles,
           int* counter, int* owner_served, cudaStream_t s) {
  auto kernel = gemv_tiles_kernel<T, kColMajor>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGemvThreads, 0);
  }
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = std::min(n_tiles, std::max(1, sms * per_sm));
  kernel<<<blocks, kGemvThreads, 0, s>>>(p, bm, order, tiles_per_dev, n_tiles, counter,
                                          owner_served);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const GemvArgs& p, int col_major, int bm, const int* order, int tiles_per_dev,
           int n_tiles, int* counter, int* owner_served, cudaStream_t s) {
  return col_major
      ? launch_layout<T, true>(p, bm, order, tiles_per_dev, n_tiles, counter, owner_served, s)
      : launch_layout<T, false>(p, bm, order, tiles_per_dev, n_tiles, counter, owner_served, s);
}

}  // namespace

// As gemv_launch, plus: bm rows a tile (1..64, dividing M; a multiple of the
// 16-byte vector when col_major), order[M / bm] the tile issue order (device
// int32), counter one device int32 of scratch, owner_served[M / bm] int32 out.
extern "C" int gemv_tiles_launch(const void* a, const void* x, void* y, int* owner_served,
                                 const int* order, int* counter, int M, int K, int N,
                                 long long lda, int col_major, int bm, int tiles_per_dev,
                                 int dtype, void* stream) {
  const GemvArgs p{a, x, y, M, K, N, lda};
  if (const int bad = gemv_check(p, col_major, dtype)) return bad;
  const int vec = dtype == kFloat32 ? kVec<float> : kVec<__nv_bfloat16>;
  if (bm < 1 || bm > kMaxTileRows || M % bm != 0 || (col_major && bm % vec != 0) ||
      tiles_per_dev < 1 || (M / bm) % tiles_per_dev != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = M / bm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == kFloat32
      ? launch<float>(p, col_major, bm, order, tiles_per_dev, n_tiles, counter, owner_served, s)
      : launch<__nv_bfloat16>(p, col_major, bm, order, tiles_per_dev, n_tiles, counter,
                              owner_served, s);
}
