// Ordered scan: an inclusive prefix sum of float64 along the leading dimension
// of a row-major [L, R] matrix, each column added strictly in order; with the
// totals flag, only its last row.
//
// Replaces no TPU kernel: the lockstep solvers (core/lockstep.py,
// core/lockstep_tiered.py) must add their per-port busy chains and queued-time
// sums in numpy's order (np.cumsum is a sequential add.accumulate), and
// torch.cumsum / torch.sum on the card add in a parallel order, one ulp apart.
// out[0, c] = x[0, c] (a copy: -0.0 and NaN stay as they are), then
// out[j, c] = out[j - 1, c] + x[j, c], one IEEE round-to-nearest add a step
// (__dadd_rn: nothing may be contracted or reassociated).
//
// What bounds it: the bytes (one add for every 16 bytes read and written, 8
// with the totals flag) where the matrix is wide, and each column's chain of
// dependent adds (~8 SM cycles an add on an H100) where it is tall and
// narrow.  The design keeps rows flowing to the adder at the chain's pace:
//   - the wide plan (R >= kStrip) gives each CTA a strip of kStrip columns,
//     one 128-byte row segment, so R = 4,096 spreads over 256 CTAs (every SM);
//   - the narrow plan (R < kStrip) takes kNarrowSlot / R consecutive rows at
//     a time, one contiguous block of doubles, in one CTA;
//   - three copier warps fill a ring of kStages tiles in shared memory by
//     cp.async (16 bytes a copy where x and R allow, else 8), each slot
//     guarded by a full and an empty mbarrier, so the copies run up to
//     kStages tiles ahead of the adds with no block-wide barrier;
//   - one lane a column of warp 0 walks its column down each tile, reading
//     kAhead rows ahead of the add chain from shared memory (a tile row is
//     contiguous: one conflict-free read), stores each row's sums coalesced,
//     or with the totals flag only the last row, once, and frees the slot;
//   - the tiny plan (L <= kTinyRows) skips the ring: a thread a column reads
//     its few rows from x directly, the shortest code for a launch that is
//     all latency.
// Measured on an NVIDIA H100 80GB HBM3 (700 W; PERF.md section 6): the add
// chain runs ~10 SM cycles a row with one lane active, ~13 with 16; bulk
// copies (TMA) of 128-byte row segments were 2-4x slower than this ring, and
// a block-wide barrier a tile in place of the mbarriers 30% slower at
// [4096, 256].
// One launch a call; offsets are int64.
//
// C interface (bound with ctypes): ordered_scan_launch returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a plan
// the arguments do not allow.

#include "common.cuh"

namespace {

using repro_torch::cp_async16;
using repro_torch::cp_async8;
using repro_torch::cp_async_mbar_arrive;
using repro_torch::cp_async_wait_all;
using repro_torch::mbar_arrive;
using repro_torch::mbar_init;
using repro_torch::mbar_init_fence;
using repro_torch::mbar_wait;

enum Plan { kTiny = 0, kNarrow = 1, kWide = 2 };  // the launch function's `plan`

constexpr int kThreads = 128;      // warp 0 adds, warps 1-3 copy
constexpr int kCopiers = kThreads - 32;
constexpr int kStrip = 16;         // columns a wide CTA: a 128-byte row segment
constexpr int kRows = 256;         // rows a wide tile: 32 KB
constexpr int kNarrowSlot = 4096;  // doubles a narrow tile: 32 KB
constexpr int kStages = 3;
constexpr int kAhead = 16;         // rows read ahead of the add chain
constexpr int kTinyRows = 16;      // the tiny plan's most rows

// Lane c's walk of rows [0, rows) of one tile (t: the tile's column c, row r
// at t[r * ld]); o: out at the tile's first row, column c (row r at o[r * R]).
// The matrix's row 0 (first) is copied, not added.  The slot holds kAhead
// rows past the tile, so the reads ahead need no guard (the rows past `rows`
// are read, never added).
template <bool kTotal>
__device__ __forceinline__ void add_rows(const double* t, int ld, int rows, bool first,
                                         double& acc, double* o, int64_t R) {
  int j = 0;
  if (first) {
    acc = t[0];
    if (!kTotal) o[0] = acc;
    j = 1;
  }
  double cur[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) cur[i] = t[(j + i) * ld];
#pragma unroll 2
  for (; j + kAhead <= rows; j += kAhead) {
    double nxt[kAhead];  // the next rows, off the chain
#pragma unroll
    for (int i = 0; i < kAhead; ++i) nxt[i] = t[(j + kAhead + i) * ld];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      acc = __dadd_rn(acc, cur[i]);
      if (!kTotal) o[(j + i) * R] = acc;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) cur[i] = nxt[i];
  }
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (j + i < rows) {
      acc = __dadd_rn(acc, cur[i]);
      if (!kTotal) o[(j + i) * R] = acc;
    }
  }
}

// kPlan kWide: a strip of kStrip columns a CTA, tiles of kRows rows; kNarrow:
// one CTA, tiles of `tile_rows` whole rows; kTiny: a thread a column, no ring.
// kVec: doubles a copy (2: every copy 16-byte aligned).  kTotal: write only
// the last row, out [R].  slot: doubles a ring slot.
template <int kPlan, int kVec, bool kTotal>
__global__ void __launch_bounds__(kThreads)
ordered_scan_kernel(const double* __restrict__ x, double* __restrict__ out, int64_t L,
                    int64_t R, int tile_rows, int slot) {
  if constexpr (kPlan == kTiny) {
    const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (c >= R) return;
    double acc = x[c];
    if (!kTotal) out[c] = acc;
#pragma unroll 4
    for (int i = 1; i < L; ++i) {
      acc = __dadd_rn(acc, x[i * R + c]);
      if (!kTotal) out[i * R + c] = acc;
    }
    if (kTotal) out[c] = acc;
    return;
  }
  constexpr bool kWideCta = kPlan == kWide;
  extern __shared__ __align__(128) double ring[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int64_t col0 = kWideCta ? static_cast<int64_t>(blockIdx.x) * kStrip : 0;
  const int cols = kWideCta ? static_cast<int>(R - col0 < kStrip ? R - col0 : kStrip)
                            : static_cast<int>(R);
  const int ld = kWideCta ? kStrip : static_cast<int>(R);  // a tile row's stride in the ring
  const int64_t tiles = (L + tile_rows - 1) / tile_rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kCopiers);
      mbar_init(&empty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp > 0) {  // the copiers: tile t into slot t % kStages once the adder freed it
    for (int64_t t = 0; t < tiles; ++t) {
      const int s = static_cast<int>(t % kStages);
      if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      const int64_t row0 = t * tile_rows;
      const int rows = static_cast<int>(L - row0 < tile_rows ? L - row0 : tile_rows);
      double* dst = ring + s * slot;
      const double* src = x + row0 * R + col0;
      if (kWideCta) {  // `rows` segments of `cols` doubles, R apart in x, kStrip in the ring
        constexpr int per = kStrip / kVec;  // copies a full segment
        for (int k = threadIdx.x - 32; k < rows * per; k += kCopiers) {
          const int r = k / per, e = k % per * kVec;
          if (e >= cols) continue;  // cols is even where kVec is 2
          if (kVec == 2) {
            cp_async16(dst + r * kStrip + e, src + r * R + e);
          } else {
            cp_async8(dst + r * kStrip + e, src + r * R + e);
          }
        }
      } else {  // one segment of rows * R doubles
        const int len = rows * static_cast<int>(R);
        for (int e = (threadIdx.x - 32) * kVec; e < len; e += kCopiers * kVec) {
          if (kVec == 2 && e + 1 < len) {
            cp_async16(dst + e, src + e);
          } else {
            cp_async8(dst + e, src + e);
          }
        }
      }
      cp_async_mbar_arrive(&full[s]);
    }
    cp_async_wait_all();  // no copy outlives its thread
    return;
  }
  double acc = 0.0;  // warp 0: the adder
  for (int64_t t = 0; t < tiles; ++t) {
    const int s = static_cast<int>(t % kStages);
    mbar_wait(&full[s], (t / kStages) & 1);
    if (lane < cols) {
      const int64_t row0 = t * tile_rows;
      const int rows = static_cast<int>(L - row0 < tile_rows ? L - row0 : tile_rows);
      add_rows<kTotal>(ring + s * slot + lane, ld, rows, t == 0, acc,
                       out + row0 * R + col0 + lane, R);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (kTotal && lane < cols) out[col0 + lane] = acc;
}

template <int kPlan, int kVec, bool kTotal>
int launch(const double* x, double* out, int64_t L, int64_t R, cudaStream_t stream) {
  auto kernel = ordered_scan_kernel<kPlan, kVec, kTotal>;
  if constexpr (kPlan == kTiny) {
    kernel<<<static_cast<unsigned>((R + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        x, out, L, R, 0, 0);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t width = kPlan == kWide ? kStrip : R;  // doubles a tile row holds
  // narrow: an even row count keeps every tile's start 16-byte aligned
  const int tile_rows =
      kPlan == kWide ? kRows : static_cast<int>((kNarrowSlot / R) & ~int64_t{1});
  const int64_t tiles = (L + tile_rows - 1) / tile_rows;
  // a slot: the tile's rows (all of L if fewer) and kAhead rows of room
  const int64_t held = (L < tile_rows ? L : tile_rows) + kAhead;
  const int slot = static_cast<int>((held * width + 1) & ~int64_t{1});
  const size_t smem = static_cast<size_t>(tiles < kStages ? tiles : kStages) * slot * 8;
  // the largest ring: a narrow slot holds at most kNarrowSlot + kAhead * R doubles
  const size_t most = static_cast<size_t>(kStages) * 8 *
                      (kPlan == kWide ? (kRows + kAhead) * kStrip : kNarrowSlot + kAhead * kStrip);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool opted[64] = {};  // this instance's opt-in to `most` bytes, by device
  if (device >= 64 || !opted[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(most));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) opted[device] = true;
  }
  const int64_t ctas = kPlan == kWide ? (R + kStrip - 1) / kStrip : 1;
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, stream>>>(x, out, L, R, tile_rows, slot);
  return static_cast<int>(cudaGetLastError());
}

template <int kPlan, int kVec>
int launch_total(const double* x, double* out, int64_t L, int64_t R, int total,
                 cudaStream_t stream) {
  return total ? launch<kPlan, kVec, true>(x, out, L, R, stream)
               : launch<kPlan, kVec, false>(x, out, L, R, stream);
}

}  // namespace

// plan: 0 tiny (L <= 16), 1 narrow (R < 16), 2 wide (R >= 16); vec: 16 for
// 16-byte copies (x 16-byte aligned, and R even in the wide plan), else 8
// (the tiny plan copies nothing: 8); total: write only the last row, out [R].
extern "C" int ordered_scan_launch(const void* x, void* out, int64_t L, int64_t R, int plan,
                                   int vec, int total, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool fits = plan == kTiny ? L <= kTinyRows : plan == kNarrow ? R < kStrip : R >= kStrip;
  if (L < 1 || R < 1 || !fits || (vec != 8 && vec != 16) ||
      (vec == 16 && (plan == kTiny || !aligned || (plan == kWide && R % 2 != 0)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xs = static_cast<const double*>(x);
  auto* o = static_cast<double*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (plan == kTiny) return launch_total<kTiny, 1>(xs, o, L, R, total, s);
  if (plan == kWide) {
    return vec == 16 ? launch_total<kWide, 2>(xs, o, L, R, total, s)
                     : launch_total<kWide, 1>(xs, o, L, R, total, s);
  }
  return vec == 16 ? launch_total<kNarrow, 2>(xs, o, L, R, total, s)
                   : launch_total<kNarrow, 1>(xs, o, L, R, total, s);
}
