// Owner-ordered split-K GEMV for Hopper (sm_90a): the compute side of the
// fused GEMV+AllReduce.
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
// A CUDA grid has no issue order between blocks, so the kernel is persistent:
// each block claims the next item index c from a global counter (atomicAdd)
// until the items run out.  An item is (group, K slice): a group is up to
// `group` consecutive issued tiles of one owner (remote-first order lists an
// owner's tiles consecutively, as consecutive rows), and c = group index *
// splits + slice, so every group's slices are claimed in order and tiles start
// in order[] order.  The claimant of a group's slice 0 writes owner_served for
// its tiles.  Each item streams its box through the ring of gemv_tile.cuh;
// the last slice of a group to arrive sums the partials in slice order and
// writes y, so no block waits for another (four processes may share the card,
// and nothing guarantees that the blocks of one launch are co-resident).  The
// counters are zeroed on the launch's stream before every launch.
//
// Bound on an H100 SXM (3.35 TB/s): as gemv, the function reads A once.  At the
// path's gemma3-27b shape (A = w.T, 5376 x 5376 bf16, bm = 64, 84 tiles) that
// is 57.8 MB, 17.28 us.  There the wrapper's plan takes groups of 2 tiles
// (44 groups: 21 tiles an owner leave one single) x 6 slices of 896: 264
// items on 396 resident blocks.
//
// Device time a launch at the gemma shard, torch.profiler (chip_smoke.py,
// NVIDIA H100 80GB HBM3, 700.00 W): 26.55 us warm, 28.81 us cold (A rotated
// over 4 copies), against cuBLAS's 26.79 and 26.69 us in the same runs.  The
// previous design (one block a whole tile, at most 84 blocks on the 132 SMs)
// took 80.84 us.
//
// C interface (bound with ctypes): gemv_tiles_launch returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take;
// gemv_tiles_blocks_per_sm returns the blocks an SM holds (or minus an error).

#include <algorithm>

#include "gemv_tile.cuh"

using namespace repro_torch;

namespace {

struct Schedule {
  const int* order;   // [n_tiles] issue order
  int* claim;         // the item counter
  int* owner_served;  // [n_tiles] out
  int bm, tiles_per_dev, group, groups_per_owner, n_items;
};

template <typename T, bool kColMajor, int R, int NP>
__global__ void __launch_bounds__(kThreads, 3)
gemv_tiles_kernel(GemvArgs p, Schedule q) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int claim;
  for (;;) {
    if (threadIdx.x == 0) claim = atomicAdd(q.claim, 1);
    __syncthreads();
    const int c = claim;  // read by all before gemv_item's first barrier
    if (c >= q.n_items) return;
    const int g = c / p.splits, s = c % p.splits;
    const int chunk = g % q.groups_per_owner;
    const int first = (g / q.groups_per_owner) * q.tiles_per_dev + chunk * q.group;
    const int count = min(q.group, q.tiles_per_dev - chunk * q.group);
    if (s == 0 && static_cast<int>(threadIdx.x) < count) {
      q.owner_served[first + threadIdx.x] = q.order[first + threadIdx.x] / q.tiles_per_dev;
    }
    gemv_item<T, kColMajor, R, NP>(p, q.order[first] * q.bm, count * q.bm, s, g, smem);
  }
}

struct Launch {
  GemvArgs p;
  Schedule q;
  int n_counters;      // the claim counter and one arrival counter a group
  cudaStream_t stream;
  int* blocks_per_sm;  // non-null: report the occupancy instead of launching

  template <typename T, bool kColMajor, int R, int NP>
  int run() const {
    auto kernel = gemv_tiles_kernel<T, kColMajor, R, NP>;
    const long long smem = gemv_smem_bytes<T, R, NP>(p.slice_k);
    int device = 0, max_smem = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > max_smem) return static_cast<int>(cudaErrorInvalidValue);
    static long long smem_set[64] = {};  // this instance's opt-in so far, by device
    if (device >= 64 || smem > smem_set[device]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err == cudaSuccess && device < 64) smem_set[device] = smem;
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                          static_cast<size_t>(smem));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks_per_sm != nullptr) {
      *blocks_per_sm = per_sm;
      return 0;
    }
    err = cudaMemsetAsync(q.claim, 0, sizeof(int) * n_counters, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = std::min(q.n_items, std::max(1, sms * per_sm));
    kernel<<<blocks, kThreads, smem, stream>>>(p, q);
    return static_cast<int>(cudaGetLastError());
  }
};

int run(const void* a, const void* x, void* y, int* owner_served, const int* order, void* ws,
        int M, int K, int N, long long lda, int col_major, int bm, int tiles_per_dev, int group,
        int splits, int slice_k, int dtype, cudaStream_t stream, int* blocks_per_sm) {
  GemvArgs p{a, x, y, nullptr, nullptr, M, K, N, lda, splits, slice_k};
  const long long n_partials = splits > 1 ? static_cast<long long>(splits) * M * N : 0;
  int* counters = reinterpret_cast<int*>(static_cast<float*>(ws) + n_partials);
  if (splits > 1) {
    p.partials = static_cast<float*>(ws);
    p.arrivals = counters + 1;
  }
  const int vec = dtype == kFloat32 ? kVec<float> : kVec<__nv_bfloat16>;
  if (blocks_per_sm == nullptr) {
    if (const int bad = gemv_check(p, col_major, dtype)) return bad;
    if (ws == nullptr || bm < 1 || bm > 64 || M % bm != 0 || tiles_per_dev < 1 ||
        (M / bm) % tiles_per_dev != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (group < 1 || box_rows(group * bm) == 0 || (col_major && bm % vec != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups_per_owner = (tiles_per_dev + group - 1) / group;
  const int n_groups = (M / bm / tiles_per_dev) * groups_per_owner;
  const Schedule q{order, counters, owner_served, bm, tiles_per_dev, group, groups_per_owner,
                   n_groups * splits};
  return dispatch(Launch{p, q, 1 + n_groups, stream, blocks_per_sm}, dtype, col_major,
                  group * bm, N);
}

}  // namespace

// As gemv_launch, plus: bm rows a tile (1..64, dividing M; a multiple of the
// 16-byte vector when col_major), order[M / bm] the tile issue order (device
// int32, remote-first: an owner's tiles consecutive), tiles_per_dev tiles an
// owner, `group` tiles an item (group * bm <= 256), owner_served[M / bm] int32
// out; splits and slice_k as for gemv_launch.  ws holds splits * M * N
// float32 partials when splits > 1, then 1 + (number of groups) int32
// counters, which the launch zeroes.
extern "C" int gemv_tiles_launch(const void* a, const void* x, void* y, int* owner_served,
                                 const int* order, void* ws, int M, int K, int N, long long lda,
                                 int col_major, int bm, int tiles_per_dev, int group, int splits,
                                 int slice_k, int dtype, void* stream) {
  return run(a, x, y, owner_served, order, ws, M, K, N, lda, col_major, bm, tiles_per_dev,
             group, splits, slice_k, dtype, static_cast<cudaStream_t>(stream), nullptr);
}

// Blocks of gemv_tiles_launch's kernel one SM holds for this plan, or minus a
// CUDA error code.
extern "C" int gemv_tiles_blocks_per_sm(int N, int col_major, int dtype, int rows, int slice_k) {
  int blocks = 0;
  const int err = run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, rows, slice_k, N, 0,
                      col_major, rows, 1, 1, 1, slice_k, dtype, nullptr, &blocks);
  return err != 0 ? -err : blocks;
}
