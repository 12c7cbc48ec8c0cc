// Split-K streaming GEMV for Hopper (sm_90a): y[M, N] = A[M, K] @ x[K, N], N <= 8.
//
// Replaces the TPU kernel src/repro/kernels/gemv.py::gemv_pallas (body
// _gemv_kernel): float32 accumulation, the result cast to A's dtype (float32
// or bfloat16; x has A's dtype).  The Pallas grid's sequential K axis, which
// accumulated bm x bk tiles into the output block, becomes K slices streamed
// through a shared-memory ring inside each block and summed across blocks in
// slice order by the last block to arrive (gemv_tile.cuh).  A is row-major or
// the transpose of a row-major w[K, M] (the collective's weight shard, read
// without a copy).
//
// Bound on an H100 SXM (3.35 TB/s): the function reads A once, M K itemsize
// bytes; x and y are small and 2 M K N flops at N <= 8 are far below the
// card's rate.  At the fused GEMV+AllReduce's shard, A = w.T of one rank's
// gemma3-27b down-projection, 5376 x 5376 bf16 (57.8 MB): 17.28 us.
//
// Launch: one block a work item, items slice-major (all boxes of slice 0,
// then of slice 1, ...), so neighbouring blocks read neighbouring runs of the
// same rows of w.  The plan (box rows, splits, slice length, ring depth)
// comes from the wrapper's gemv_plan: at the gemma shard 84 boxes of 64 rows
// x 4 slices of 1344, 336 blocks, all resident at once (three an SM).
//
// Device time a launch at the gemma shard, torch.profiler (chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700.00 W): 26.18 us with A warm from the call
// before, 28.76 us cold (A rotated over 4 copies), against cuBLAS's 26.79 and
// 26.69 us for torch.matmul in the same runs; 66% and 60% of the byte bound's
// rate.  The previous design (one block a 32-row tile, its K loop draining
// every 1024 rows) took 52.29 us.  Row-major A: 79.75 us (x's reads there
// conflict in shared memory; the path does not use that layout).
//
// C interface (bound with ctypes): gemv_launch returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take;
// gemv_blocks_per_sm returns the blocks an SM holds for a plan (or minus a
// CUDA error).

#include "gemv_tile.cuh"

using namespace repro_torch;

namespace {

template <typename T, bool kColMajor, int R, int NP>
__global__ void __launch_bounds__(kThreads, 3)
gemv_kernel(GemvArgs p, int rows_per_box, int n_boxes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x / n_boxes, box = blockIdx.x % n_boxes;
  const int row0 = box * rows_per_box;
  gemv_item<T, kColMajor, R, NP>(p, row0, min(rows_per_box, p.M - row0), s, box, smem);
}

struct Launch {
  GemvArgs p;
  int rows;            // rows a box
  cudaStream_t stream;
  int* blocks_per_sm;  // non-null: report the occupancy instead of launching

  template <typename T, bool kColMajor, int R, int NP>
  int run() const {
    auto kernel = gemv_kernel<T, kColMajor, R, NP>;
    const long long smem = gemv_smem_bytes<T, R, NP>(p.slice_k);
    int device = 0, max_smem = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > max_smem) return static_cast<int>(cudaErrorInvalidValue);
    static long long smem_set[64] = {};  // this instance's opt-in so far, by device
    if (device >= 64 || smem > smem_set[device]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err == cudaSuccess && device < 64) smem_set[device] = smem;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks_per_sm != nullptr) {
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, kernel, kThreads, static_cast<size_t>(smem)));
    }
    const int n_boxes = (p.M + rows - 1) / rows;
    if (p.splits > 1) {
      err = cudaMemsetAsync(p.arrivals, 0, sizeof(int) * n_boxes, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<n_boxes * p.splits, kThreads, smem, stream>>>(p, rows, n_boxes);
    return static_cast<int>(cudaGetLastError());
  }
};

int run(const void* a, const void* x, void* y, void* ws, int M, int K, int N, long long lda,
        int col_major, int dtype, int rows, int splits, int slice_k, cudaStream_t stream,
        int* blocks_per_sm) {
  GemvArgs p{a, x, y, nullptr, nullptr, M, K, N, lda, splits, slice_k};
  if (splits > 1 && ws != nullptr) {
    p.partials = static_cast<float*>(ws);
    p.arrivals = reinterpret_cast<int*>(p.partials + static_cast<long long>(splits) * M * N);
  }
  if (blocks_per_sm == nullptr) {
    if (const int bad = gemv_check(p, col_major, dtype)) return bad;
  }
  const int vec = dtype == kFloat32 ? kVec<float> : kVec<__nv_bfloat16>;
  if (rows < 1 || box_rows(rows) == 0 || (col_major && rows % vec != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(Launch{p, rows, stream, blocks_per_sm}, dtype, col_major, rows, N);
}

}  // namespace

// dtype: kFloat32 (0) or kBFloat16 (1).  col_major: 0 for A[m, k] at
// a[m * lda + k], 1 for a[m + k * lda].  K, lda (and M when col_major) must be
// multiples of the 16-byte vector (4 float32, 8 bf16), a 16-byte aligned;
// x is [K, N] and y [M, N], both contiguous, 1 <= N <= 8.  The plan: boxes of
// `rows` rows (at most 256; a multiple of the vector when col_major), K cut
// into `splits` slices of `slice_k` elements (a multiple of the vector; the
// last may be shorter).  With splits > 1, ws holds splits * M * N float32
// partials and then one int32 counter a box; the launch zeroes the counters.
extern "C" int gemv_launch(const void* a, const void* x, void* y, void* ws, int M, int K,
                           int N, long long lda, int col_major, int dtype, int rows,
                           int splits, int slice_k, void* stream) {
  return run(a, x, y, ws, M, K, N, lda, col_major, dtype, rows, splits, slice_k,
             static_cast<cudaStream_t>(stream), nullptr);
}

// Blocks of gemv_launch's kernel one SM holds for this plan, or minus a CUDA
// error code.
extern "C" int gemv_blocks_per_sm(int N, int col_major, int dtype, int rows, int slice_k) {
  int blocks = 0;
  const int err = run(nullptr, nullptr, nullptr, nullptr, 1, slice_k, N, 0, col_major, dtype,
                      rows, 1, slice_k, nullptr, &blocks);
  return err != 0 ? -err : blocks;
}
