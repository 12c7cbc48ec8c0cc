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
// One thread a segment: segment s holds the touches [offs[s], offs[s + 1]) of
// port port[s], in the port's queue order, each of serialization time ser[s].
// The thread reads busy[port[s]] and qd[port[s]], walks its touches, writes
// each touch's start, and writes busy and qd back.  No two segments of one
// launch may name the same port.
//
// Bound by one thread's dependent chain: two adds and a max a touch, with the
// ready times read as they come.  The solver gives one launch every segment
// whose touches' ready times are known (one dependency level).
//
// C interface (bound with ctypes): port_chain_launch returns
// cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <int kBlock>
__global__ void __launch_bounds__(kBlock)
port_chain_kernel(const double* __restrict__ rdy, const int64_t* __restrict__ offs,
                  const int64_t* __restrict__ port, const double* __restrict__ ser,
                  double* __restrict__ busy, double* __restrict__ qd,
                  double* __restrict__ starts, int64_t S) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (s >= S) return;
  const int64_t p = port[s];
  const double sr = ser[s];
  double b = busy[p];
  double q = qd[p];
  const int64_t end = offs[s + 1];
  for (int64_t t = offs[s]; t < end; ++t) {
    const double r = rdy[t];
    const double st = fmax(r, b);
    starts[t] = st;
    q = __dadd_rn(q, __dsub_rn(st, r));
    b = __dadd_rn(st, sr);
  }
  busy[p] = b;
  qd[p] = q;
}

}  // namespace

extern "C" int port_chain_launch(const void* rdy, const void* offs, const void* port,
                                 const void* ser, void* busy, void* qd, void* starts,
                                 int64_t S, void* stream) {
  const int64_t blocks = (S + kThreads - 1) / kThreads;
  port_chain_kernel<kThreads><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(rdy), static_cast<const int64_t*>(offs),
      static_cast<const int64_t*>(port), static_cast<const double*>(ser),
      static_cast<double*>(busy), static_cast<double*>(qd), static_cast<double*>(starts), S);
  return static_cast<int>(cudaGetLastError());
}
