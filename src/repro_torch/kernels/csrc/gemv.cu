// Tiled GEMV for Hopper (sm_90a): y[M, N] = A[M, K] @ x[K, N], N <= 8.
//
// Replaces the TPU kernel src/repro/kernels/gemv.py::gemv_pallas (body
// _gemv_kernel): float32 accumulation, the result cast to A's dtype (float32
// or bfloat16; x has A's dtype).  The Pallas grid's sequential K axis, which
// accumulated bm x bk tiles into the output block, becomes a K loop inside
// the block (gemv_tile.cuh), so there is no bk and K needs only to be a
// multiple of 16 bytes.  A is row-major or the transpose of a row-major
// w[K, M] (the collective's weight shard, read without a copy).
//
// Bound on an H100 SXM (3.35 TB/s): the function reads A once, M * K * itemsize
// bytes, and x and y are small; 2 * M * K * N flops at N <= 8 are far below
// the card's rate.  At the fused GEMV+AllReduce's shapes, A = w.T of one
// rank's gemma3-27b down-projection shard, 5376 x 5376 bf16 (57.8 MB): about
// 17.3 us.
//
// Design: one block of 256 threads per 32-row tile, so that the 5376-row
// shard gives 168 blocks, more than the 132 SMs.  Each thread keeps up to
// kInFlight 16-byte loads of A in flight before it uses them.
//
// C interface (bound with ctypes): gemv_launch returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take.

#include "gemv_tile.cuh"

using namespace repro_torch;

namespace {

constexpr int kTileRows = 32;

template <typename T, bool kColMajor>
__global__ void __launch_bounds__(kGemvThreads) gemv_kernel(GemvArgs p) {
  __shared__ __align__(16) float xs[kMaxN * kChunkK];
  const int row0 = blockIdx.x * kTileRows;
  gemv_tile<T, kColMajor>(p, row0, min(kTileRows, p.M - row0), xs);
}

template <typename T>
void launch(const GemvArgs& p, int col_major, cudaStream_t s) {
  const int blocks = (p.M + kTileRows - 1) / kTileRows;
  if (col_major) {
    gemv_kernel<T, true><<<blocks, kGemvThreads, 0, s>>>(p);
  } else {
    gemv_kernel<T, false><<<blocks, kGemvThreads, 0, s>>>(p);
  }
}

}  // namespace

// dtype: kFloat32 (0) or kBFloat16 (1).  col_major: 0 for A[m, k] at
// a[m * lda + k], 1 for a[m + k * lda].  K, lda (and M when col_major) must be
// multiples of the 16-byte vector (4 float32, 8 bf16), a 16-byte aligned;
// x is [K, N] and y [M, N], both contiguous, 1 <= N <= 8.
extern "C" int gemv_launch(const void* a, const void* x, void* y, int M, int K, int N,
                           long long lda, int col_major, int dtype, void* stream) {
  const GemvArgs p{a, x, y, M, K, N, lda};
  if (const int bad = gemv_check(p, col_major, dtype)) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    launch<float>(p, col_major, s);
  } else {
    launch<__nv_bfloat16>(p, col_major, s);
  }
  return static_cast<int>(cudaGetLastError());
}
