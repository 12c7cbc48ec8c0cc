// An empty kernel: the floor that every launch of the port's kernels pays.
//
// Replaces no TPU kernel.  One block of 32 threads that does nothing; its
// device time per launch, warm, is the least a kernel of this build can take
// on the card, beside which a launch-bound kernel (rmsnorm: about 20 KB a
// call) is read.
//
// C interface (bound with ctypes): empty_launch returns cudaGetLastError()
// after the launch.

#include "common.cuh"

namespace {

template <int kThreads>
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<32><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
