// Port chain: the per-port busy recurrence of the tiered lockstep solver,
// in float64, in numpy's order of operations.
//
// Replaces no TPU kernel.  The tiered solver (core/lockstep_tiered.py) prices
// every link-port touch with the event engine's scalar recurrence
//   start = max(ready, busy); busy = start + ser
// and accumulates the port's queued time in order,
//   qd = qd + (start - ready)
// (the reference's _chain and its np.cumsum of [qd] ++ q).  One ulp anywhere
// can move a flag's set cycle, so each step is one IEEE round-to-nearest
// operation (__dadd_rn / __dsub_rn: nothing contracted or reassociated) and
// fmax, which returns one of its operands exactly.
//
// Segment s holds the touches [offs[s], offs[s + 1]) of port port[s], in the
// port's queue order, each of serialization time ser[s].  busy[port[s]] and
// qd[port[s]] are read once and written once; no two segments of one launch
// may name the same port.
//
// What bounds it: the chain.  Each touch's busy time depends on the one
// before, and the queued total on its own last value, so a segment's time
// is its length times one step's cost however the card is filled; the
// bytes (each ready time read once, each start written once) are ~1% of it.
// On an NVIDIA H100 80GB HBM3 (700 W) a float64 add's latency is 8 SM
// cycles (the queued total's floor), a compare and select 14, fmax 25
// (tools/tiered_kernels.py --latency).  The design keeps device memory and fmax off the chain:
//   - one warp a segment (kWarps segments a CTA);
//   - the warp copies the segment's ready times into shared memory in tiles
//     of kTile, double-buffered: tile k + 1's coalesced cp.async copies (16
//     bytes, 8 at a range's unaligned edge) are in flight while tile k is
//     walked;
//   - lane 0 walks the tile from shared memory with busy and the queued
//     total in registers, reading the ready times kAhead ahead into
//     registers, and writes each start over its ready time in place;
//   - each step is a compare and a select, with ser added to both
//     candidates beforehand (see step below);
//   - the warp then stores the tile of starts, coalesced.
// One lane's stream of five float64 operations a touch, a compare and
// selects then sets the pace: ~33 cycles a touch on that card.
//
// C interface (bound with ctypes): port_chain_launch returns
// cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

using repro_torch::cp_async16;
using repro_torch::cp_async8;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;

constexpr int kWarps = 2;    // segments a CTA, one a warp
constexpr int kTile = 256;   // touches a tile: 2 KB of float64
constexpr int kAhead = 8;    // ready times read ahead of the chain
// room past a tile's end for the walk's read-ahead (read, never used)
constexpr int kPad = 2 * kAhead;

// One touch: start = max(ready, busy), busy = start + ser, queued +=
// start - ready.  The max is a compare and a select, which give fmax's bits
// for every ready and busy time (never NaN), and ser is added to both
// candidates before the select picks one, so that the chain from one busy
// time to the next is one add beside one compare, then a select.
__device__ __forceinline__ void step(double r, double& st_out, double sr, double& b,
                                     double& q) {
  const bool later = r > b;
  const double st = later ? r : b;
  const double rs = __dadd_rn(r, sr);  // off the chain
  const double bs = __dadd_rn(b, sr);
  st_out = st;
  q = __dadd_rn(q, __dsub_rn(st, r));
  b = later ? rs : bs;
}

// Lane 0's walk of touches [j, j1) of one tile: the ready times in t are
// replaced by the starts.  Exactly the scalar recurrence, touch by touch.
__device__ __forceinline__ void walk(double* t, int j, int j1, double sr, double& b,
                                     double& q) {
  double cur[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) cur[i] = t[j + i];
  for (; j + kAhead <= j1; j += kAhead) {
    double nxt[kAhead];  // the next group's ready times, off the chain
#pragma unroll
    for (int i = 0; i < kAhead; ++i) nxt[i] = t[j + kAhead + i];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      step(cur[i], t[j + i], sr, b, q);
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) cur[i] = nxt[i];
  }
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (j + i < j1) {
      step(cur[i], t[j + i], sr, b, q);
    }
  }
}

// The warp's copy of the ready times [base, base + kTile) ∩ [lo, hi) into
// t (t[j] = rdy[base + j]); base is 16-byte aligned.  One commit group.
__device__ __forceinline__ void issue_tile(double* t, const double* __restrict__ rdy,
                                           int64_t base, int64_t lo, int64_t hi, int lane) {
#pragma unroll
  for (int c = lane; c < kTile / 2; c += 32) {
    const int64_t i = base + 2 * c;
    if (i >= lo && i + 1 < hi) {
      cp_async16(t + 2 * c, rdy + i);
    } else {
      if (i >= lo && i < hi) cp_async8(t + 2 * c, rdy + i);
      if (i + 1 >= lo && i + 1 < hi) cp_async8(t + 2 * c + 1, rdy + i + 1);
    }
  }
  cp_async_commit();
}

template <int kW>
__global__ void __launch_bounds__(32 * kW)
port_chain_kernel(const double* __restrict__ rdy, const int64_t* __restrict__ offs,
                  const int64_t* __restrict__ port, const double* __restrict__ ser,
                  double* __restrict__ busy, double* __restrict__ qd,
                  double* __restrict__ starts, int64_t S) {
  __shared__ __align__(16) double tiles[kW][2][kTile + kPad];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kW + w;
  if (s >= S) return;
  const int64_t lo = offs[s], hi = offs[s + 1];
  if (hi <= lo) return;
  // the tiles start at the 16-byte boundary at or before rdy + lo
  const int64_t e0 =
      lo - static_cast<int64_t>((reinterpret_cast<uintptr_t>(rdy + lo) >> 3) & 1);
  const int64_t ntiles = (hi - e0 + kTile - 1) / kTile;
  int64_t p = 0;
  double sr = 0.0, b = 0.0, q = 0.0;
  if (lane == 0) {
    p = port[s];
    sr = ser[s];
    b = busy[p];
    q = qd[p];
  }
  issue_tile(tiles[w][0], rdy, e0, lo, hi, lane);
  for (int64_t k = 0; k < ntiles; ++k) {
    double* cur = tiles[w][k & 1];
    const int64_t base = e0 + k * kTile;
    if (k + 1 < ntiles) {
      issue_tile(tiles[w][(k + 1) & 1], rdy, base + kTile, lo, hi, lane);
    } else {
      cp_async_commit();  // an empty group keeps the count uniform
    }
    cp_async_wait<1>();  // this lane's copies of tile k have landed
    __syncwarp();        // and every lane's
    const int j0 = static_cast<int>(lo > base ? lo - base : 0);
    const int j1 = static_cast<int>(hi - base < kTile ? hi - base : kTile);
    if (lane == 0) walk(cur, j0, j1, sr, b, q);
    __syncwarp();
    for (int j = j0 + lane; j < j1; j += 32) starts[base + j] = cur[j];
    __syncwarp();  // before tile k + 2's copies reuse the buffer
  }
  if (lane == 0) {
    busy[p] = b;
    qd[p] = q;
  }
}

}  // namespace

extern "C" int port_chain_launch(const void* rdy, const void* offs, const void* port,
                                 const void* ser, void* busy, void* qd, void* starts,
                                 int64_t S, void* stream) {
  const int64_t blocks = (S + kWarps - 1) / kWarps;
  port_chain_kernel<kWarps><<<static_cast<unsigned>(blocks), 32 * kWarps, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(rdy), static_cast<const int64_t*>(offs),
      static_cast<const int64_t*>(port), static_cast<const double*>(ser),
      static_cast<double*>(busy), static_cast<double*>(qd), static_cast<double*>(starts), S);
  return static_cast<int>(cudaGetLastError());
}
