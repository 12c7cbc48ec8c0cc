// numpy sum: float64 segment sums in numpy's own order (np.add.reduce of a
// contiguous float64 vector).
//
// Replaces no TPU kernel.  The tiered lockstep solver (core/lockstep_tiered.py)
// must reproduce the reference's float(q.sum()) bit for bit, and numpy's sum
// is neither left to right nor torch's tree.  numpy 2.0 adds the vector's
// blocks of 8192 elements left to right into 0.0; each block is summed
// pairwise (pairwise_sum in numpy's loops_utils.h.src):
//   n < 8:      res = 0.0; res += a[i], left to right
//   n <= 128:   eight strided accumulators r[j] = a[j] + a[j + 8] + ...,
//               res = ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)),
//               then the n % 8 remaining elements added left to right
//   otherwise:  n2 = n / 2 rounded down to a multiple of 8;
//               pairwise(a, n2) + pairwise(a + n2, n - n2)
// Every add is one __dadd_rn (nothing reassociated).
//
// What bounds it: the bytes, each element read once, as long as the card is
// kept full; a segment's own tree is only a few hundred dependent adds.  So
// the design spreads the independent parts of the tree over the card and
// keeps only the ordered parts in order:
//   - one CTA a block of 8,192: CTA s < S takes block 0 of segment s, CTA
//     S + c - 1 the block of a longer segment that starts in the window
//     [8192 c, 8192 (c + 1)) of x (at most one does), found by a 32-way
//     search of offs.  The grid comes from S and x.numel() alone; a block
//     of 64 KB a CTA keeps a long segment's blocks on many SMs at once;
//   - a block's tree is at most 7 deep, so 128 paths (one a thread, the bits
//     of its index left or right, high bit first) name every node, a node by
//     its leftmost path;
//   - an 8-lane group sums a leaf: lane j keeps accumulator r[j] over the
//     leaf's 64-byte rows, read in two batches of eight loads in flight
//     (40 registers: six CTAs of 256 threads an SM), streamed past the L2
//     (evict-first), so that they do not push out what another kernel left
//     there; the eight are combined by shuffles in numpy's order, lane 0 adds
//     the rest;
//   - the inner nodes are added bottom up: the five lowest levels by
//     shuffles inside each warp, the two highest by one thread;
//   - a segment of several blocks: each block's CTA leaves its sum in the
//     workspace and takes a ticket; the last one adds the block sums left to
//     right into 0.0 and sets the ticket back to 0 for the next launch.
// Each CTA reads offs before its first load, a dependent round trip that a
// library sum over fixed rows never pays.  On an NVIDIA H100 80GB HBM3
// (700 W), a level of 256 x 65,280 read cold (x past the L2, as the solver
// gives it) takes 48.6-48.9 us, ~2.75 TB/s, 7-9% above torch.sum of its
// rows (chip_smoke.py, profiler; PERF.md section 6).
//
// C interface (bound with ctypes): numpy_sum_launch returns
// cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // 32 leaf groups of 8 lanes
constexpr int64_t kBlock = 8192;    // numpy's ufunc buffer, in elements
constexpr int kLeaf = 128;          // PW_BLOCKSIZE
constexpr int kBatch = kLeaf / 16;  // half a leaf's rows of 8
constexpr int kDepth = 7;           // a block's tree is at most 7 deep
constexpr int kPaths = 1 << kDepth;

// numpy's leaf sum of a[0, m) by the 8-lane group whose lane j calls it;
// the sum is lane 0's.  All 8 lanes take part (mask: the group's lanes).
// Loads stream past the L2 (evict-first).
__device__ __forceinline__ double leaf_sum(const double* __restrict__ a, int m, int j,
                                           unsigned mask) {
  if (m < 8) {
    double res = 0.0;
    if (j == 0) {
      for (int i = 0; i < m; ++i) res = __dadd_rn(res, __ldcs(a + i));
    }
    return res;
  }
  // rows in two batches of kBatch loads in flight a lane
  const int rows = m >> 3;
  double v[kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) v[i] = i < rows ? __ldcs(a + 8 * i + j) : 0.0;
  double r = v[0];
#pragma unroll
  for (int i = 1; i < kBatch; ++i) {
    if (i < rows) r = __dadd_rn(r, v[i]);
  }
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    v[i] = kBatch + i < rows ? __ldcs(a + 8 * (kBatch + i) + j) : 0.0;
  }
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if (kBatch + i < rows) r = __dadd_rn(r, v[i]);
  }
  // ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)) lands in lane 0
  r = __dadd_rn(r, __shfl_down_sync(mask, r, 1, 8));
  r = __dadd_rn(r, __shfl_down_sync(mask, r, 2, 8));
  r = __dadd_rn(r, __shfl_down_sync(mask, r, 4, 8));
  if (j == 0) {
    for (int i = rows * 8; i < m; ++i) r = __dadd_rn(r, __ldcs(a + i));
  }
  return r;
}

// The smallest i in [0, S] with offs[i] >= w, or S + 1 if none; warp 0's
// 32 lanes probe 32 points of the range a round.
__device__ __forceinline__ int64_t lower_bound_warp(const int64_t* __restrict__ offs,
                                                    int64_t S, int64_t w, int lane) {
  int64_t a = 0, b = S + 1;  // the answer lies in [a, b]
  while (b > a) {
    const int64_t step = (b - a + 31) / 32;
    const int64_t p = a + lane * step;
    const bool below = p < b && offs[p] < w;
    const int n = __popc(__ballot_sync(0xffffffffu, below));  // a prefix of the lanes
    const int64_t p_last = a + static_cast<int64_t>(n - 1) * step;
    const int64_t p_next = a + static_cast<int64_t>(n) * step;
    if (n > 0) a = p_last + 1;
    if (n < 32 && p_next < b) b = p_next;  // n == 0: b = a, found
  }
  return a;
}

template <int kT>
__global__ void __launch_bounds__(kT, 6)
numpy_sum_kernel(const double* __restrict__ x, const int64_t* __restrict__ offs,
                 double* __restrict__ out, double* __restrict__ ws, int* __restrict__ tickets,
                 int64_t S) {
  __shared__ int64_t job[4];  // segment, its start, its end, the block's index in it
  __shared__ double vals[kPaths];
  __shared__ double warp_vals[kPaths / 32];
  __shared__ int leaf_path[kPaths], leaf_lo[kPaths], leaf_m[kPaths];
  __shared__ int n_leaves;

  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    int64_t s = -1, lo = 0, hi = 0, k = 0;
    if (blockIdx.x < S) {
      s = blockIdx.x;
      lo = offs[s];
      hi = offs[s + 1];
    } else {
      // the block starting in window c of a segment that started before it
      const int64_t w0 = (static_cast<int64_t>(blockIdx.x) - S + 1) * kBlock;
      const int64_t i = lower_bound_warp(offs, S, w0, lane);
      if (i >= 1 && i <= S) {
        lo = offs[i - 1];
        hi = offs[i];
        k = (w0 - lo + kBlock - 1) / kBlock;
        if (lo + k * kBlock < hi) s = i - 1;
      }
    }
    if (tid == 0) {
      job[0] = s;
      job[1] = lo;
      job[2] = hi;
      job[3] = k;
      n_leaves = 0;
    }
  }
  __syncthreads();
  const int64_t s = job[0];
  if (s < 0) return;
  const int64_t lo = job[1], hi = job[2], k = job[3];
  if (hi <= lo) {  // an empty segment
    if (tid == 0) out[s] = 0.0;
    return;
  }
  const int64_t start = lo + k * kBlock;
  const int n = static_cast<int>(hi - start < kBlock ? hi - start : kBlock);
  const double* a = x + start;

  double bsum = 0.0;  // thread 0's
  if (n <= kLeaf) {
    if (tid < 8) bsum = leaf_sum(a, n, tid, 0xffu);
  } else {
    // path t: its leaf (start, length, depth); a leaf's own path is its
    // leftmost, the one whose bits below the leaf's depth are 0
    int depth = 0, llo = 0, lm = n;
    if (tid < kPaths) {
      while (lm > kLeaf) {
        const int m2 = (lm / 2) & ~7;
        if ((tid >> (kDepth - 1 - depth)) & 1) {
          llo += m2;
          lm -= m2;
        } else {
          lm = m2;
        }
        ++depth;
      }
      if ((tid & ((1 << (kDepth - depth)) - 1)) == 0) {
        const int at = atomicAdd(&n_leaves, 1);
        leaf_path[at] = tid;
        leaf_lo[at] = llo;
        leaf_m[at] = lm;
      }
    }
    __syncthreads();
    const int g = tid >> 3, j = tid & 7;
    const unsigned mask = 0xffu << (lane & 24);
    for (int i = g; i < n_leaves; i += kT / 8) {  // uniform within each group
      const double sum = leaf_sum(a + leaf_lo[i], leaf_m[i], j, mask);
      if (j == 0) vals[leaf_path[i]] = sum;
    }
    __syncthreads();
    if (tid < kPaths) {
      // levels 6 .. 2: a node at depth d adds its right child's value, at
      // path t + 2^(6 - d), when its path goes deeper than d
      double v = vals[tid];
#pragma unroll
      for (int d = kDepth - 1; d >= 2; --d) {
        const double right = __shfl_down_sync(0xffffffffu, v, 1 << (kDepth - 1 - d));
        if ((tid & ((1 << (kDepth - d)) - 1)) == 0 && depth > d) v = __dadd_rn(v, right);
      }
      if (lane == 0) warp_vals[tid >> 5] = v;
    }
    __syncthreads();
    if (tid == 0) {
      // levels 1 and 0: the root's halves, inner when longer than a leaf
      const int m2 = (n / 2) & ~7;
      const double left = m2 > kLeaf ? __dadd_rn(warp_vals[0], warp_vals[1]) : warp_vals[0];
      const double right = n - m2 > kLeaf ? __dadd_rn(warp_vals[2], warp_vals[3])
                                          : warp_vals[2];
      bsum = __dadd_rn(left, right);
    }
  }
  if (tid != 0) return;
  const int64_t nb = (hi - lo + kBlock - 1) / kBlock;
  if (nb == 1) {
    out[s] = __dadd_rn(0.0, bsum);
    return;
  }
  // several blocks: slot 2c for a segment's first block (c its window; at
  // most one segment of several blocks starts in a window), 2c + 1 for the
  // later block starting in window c; the ticket is the first window's
  const int64_t c0 = lo / kBlock;
  ws[k == 0 ? 2 * c0 : 2 * (start / kBlock) + 1] = bsum;
  __threadfence();
  if (atomicAdd(tickets + c0, 1) != nb - 1) return;
  __threadfence();
  double acc = __dadd_rn(0.0, __ldcg(ws + 2 * c0));
  for (int64_t kk = 1; kk < nb; kk += 8) {  // eight loads in flight, then their adds
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      v[u] = kk + u < nb ? __ldcg(ws + 2 * ((lo + (kk + u) * kBlock) / kBlock) + 1) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (kk + u < nb) acc = __dadd_rn(acc, v[u]);
    }
  }
  out[s] = acc;
  tickets[c0] = 0;
}

}  // namespace

extern "C" int numpy_sum_launch(const void* x, const void* offs, void* out, void* ws,
                                void* tickets, int64_t S, int64_t ctas, void* stream) {
  numpy_sum_kernel<kThreads><<<static_cast<unsigned>(ctas), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const int64_t*>(offs),
      static_cast<double*>(out), static_cast<double*>(ws), static_cast<int*>(tickets), S);
  return static_cast<int>(cudaGetLastError());
}
