// One Mamba2 decode step for Hopper (sm_90a): everything between the block's
// two projections, in one pass over the float32 state.
//
// Replaces no Pallas kernel: the reference's decode (src/repro/models/ssm.py)
// is plain jnp, and the port's plain version is kernels/mamba_decode.py::
// mamba_decode_ref.
// For every batch row b and head, from the token's projection
// proj[b] = [z | x B C | dt] (d_inner, d_inner + 2 DS, H columns; T = float32
// or bfloat16) and the state h[b, head] (dh x DS float32) and conv window
// conv[b] (K - 1 x d_inner + 2 DS float32):
//   1. the depthwise conv over the window [conv[b], xBC] in float32, its K
//      taps conv_w[K, C], then SiLU, rounded to T (the channels of the head's
//      x and all of B and C: ngroups 1, every head reads them);
//   2. dt = softplus(dt_raw + dt_bias) and decay = exp(-exp(a_log) * dt) in
//      float32;
//   3. h' = h * decay + (dt * x) * B, each multiply and add rounded as the
//      plain path's separate kernels round them (no contraction into FMAs);
//   4. y = h' . C + D * x, rounded to T;
//   5. out = y * silu(z + norm_z), rounded to T after the add, the SiLU and
//      the product, as the plain path's T-typed ops are.
// h is updated in place; the window moved on by one token, [conv[b, 1:],
// xBC], is written to a new tensor (conv_out), since every head's CTA of a
// row reads the window's B and C channels.
//
// Bound on an H100 SXM (3.35 TB/s): a pure stream.  At zamba2-2.7b's decode
// (B 512, 80 heads of 64, DS 64, K 4, bf16) a launch reads and writes the
// 1,342 MB state once and the 64.5 MB window once, and reads 10.7 MB of
// projection: 1.42 GB, 0.425 ms.  About 7 flops a state entry are far below
// the ~20 a byte at which the card would stop being bound by memory.
//
// Design: one CTA of 128 threads a (row, head) tile, B * H CTAs (40,960 on
// that path), consecutive CTAs on consecutive tiles.
//  - The tile is staged in shared memory by one bulk copy (TMA, no tensor
//    map: the tile is dh * DS contiguous floats), which thread 0 issues
//    first, on an mbarrier: the whole tile is in flight while the CTA
//    computes the conv, and it costs no registers.  So registers stay few
//    and 12 or 13 CTAs fit an SM, each with its tile in flight: 83.6% of the
//    byte bound, where a plain copy of the state's size reaches 89%.
//    (Holding the tile in registers, DS / 8 float4 a thread, took 106
//    registers, 4 CTAs an SM, and 54%; PERF.md.)
//  - The conv, dt and decay go through shared memory: thread j takes the
//    channels j, j + 128, ..., of the head's x (dh) and of B and C (2 DS),
//    and thread 0 the head's dt; one barrier.  Head 0's CTA also writes the
//    window's B and C channels, each head's CTA its x channels.
//  - A row of the tile is DS / 4 float4 vectors, one lane each, so
//    32 / (DS / 4) rows share a warp, in DS / 8 passes of 128 / (DS / 4)
//    rows over the tile's 64 (dh <= 64; rows past dh idle).  A lane updates
//    its 4 entries of its row, stores them to h with the streaming hint
//    (st.global.cs: written once, not read again this step), and sums
//    h' * C over them; the DS / 4 lanes of a row add their sums by warp
//    shuffles, and the row's first lane writes the gated output.  Each tile
//    has one owner, so the in-place update cannot race.
//
// C interface (bound with ctypes): mamba_decode_launch returns the launch's
// error (cudaGetLastError() after it), or cudaErrorInvalidValue for
// arguments it does not take.

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHeadDim = 64;  // rows of a tile at most
constexpr int kMaxK = 8;         // conv taps at most
// CTAs an SM the registers must allow (40 registers a thread): at DS 64 the
// 17 KB of shared memory a CTA fits 13.  Measured at the cell's shape
// (PERF.md): 6 and 8 took 0.561 ms, 12 0.508, 16 0.505 (spilling).
constexpr int kCtasPerSm = 12;

// as torch's float softplus (beta 1, threshold 20) and silu
__device__ __forceinline__ float softplus(float x) { return x > 20.f ? x : log1pf(expf(x)); }
__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

template <typename T, int DS>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
mamba_decode_kernel(const T* __restrict__ proj, const float* __restrict__ conv, float* h,
                    const T* __restrict__ conv_w, const float* __restrict__ dt_bias,
                    const float* __restrict__ a_log, const float* __restrict__ d_skip,
                    const T* __restrict__ norm_z, T* __restrict__ y,
                    float* __restrict__ conv_out, int H, int dh, int K, int64_t proj_stride,
                    int64_t conv_stride) {
  constexpr int kLanes = DS / 4;  // lanes a tile row, a float4 each
  constexpr int kRowsPerWarp = 32 / kLanes;
  constexpr int kRowsPerPass = kRowsPerWarp * (kThreads / 32);
  constexpr int kPasses = kMaxHeadDim / kRowsPerPass;
  static_assert(kPasses * kRowsPerPass == kMaxHeadDim, "passes cover the tile");

  const int head = blockIdx.x % H;
  const int64_t b = blockIdx.x / H;
  const int d_inner = H * dh;
  const int C = d_inner + 2 * DS;
  const int lane = threadIdx.x % 32;
  const int col = lane % kLanes;
  const int row0 = (threadIdx.x / 32) * kRowsPerWarp + lane / kLanes;
  float* hp = h + (b * H + head) * static_cast<int64_t>(dh) * DS;

  __shared__ __align__(128) float s_h[kMaxHeadDim * DS];
  __shared__ __align__(8) uint64_t s_full;
  if (threadIdx.x == 0) {  // the whole tile in flight before any other work
    const unsigned bytes = static_cast<unsigned>(dh) * DS * sizeof(float);
    mbar_init(&s_full, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(&s_full, bytes);
    bulk_copy_g2s(s_h, hp, bytes, &s_full);
  }

  __shared__ __align__(16) float s_x[kMaxHeadDim];
  __shared__ __align__(16) float s_b[DS];
  __shared__ __align__(16) float s_c[DS];
  __shared__ float s_dt, s_decay;

  const T* pr = proj + b * proj_stride;
  const T* xbc = pr + d_inner;
  const float* win = conv + b * conv_stride;
  float* wout = conv_out + b * static_cast<int64_t>(K - 1) * C;
  for (int j = threadIdx.x; j < dh + 2 * DS; j += kThreads) {
    const int c = j < dh ? head * dh + j : d_inner + (j - dh);
    const bool owner = j < dh || head == 0;  // the CTA that writes the channel's window
    float acc = 0.f;
    for (int k = 0; k < K - 1; ++k) {
      const float w = __ldg(win + static_cast<int64_t>(k) * C + c);
      acc = fmaf(w, to_f32(conv_w[k * C + c]), acc);
      if (owner && k > 0) wout[static_cast<int64_t>(k - 1) * C + c] = w;
    }
    const float cur = to_f32(xbc[c]);
    acc = fmaf(cur, to_f32(conv_w[(K - 1) * C + c]), acc);
    if (owner) wout[static_cast<int64_t>(K - 2) * C + c] = cur;
    const float v = round_to<T>(silu(acc));
    if (j < dh) {
      s_x[j] = v;
    } else if (j < dh + DS) {
      s_b[j - dh] = v;
    } else {
      s_c[j - dh - DS] = v;
    }
  }
  if (threadIdx.x == 0) {
    const float dt = softplus(to_f32(pr[2 * d_inner + 2 * DS + head]) + dt_bias[head]);
    s_dt = dt;
    s_decay = expf(-expf(a_log[head]) * dt);
  }
  __syncthreads();

  const float dt = s_dt, decay = s_decay, dskip = d_skip[head];
  const float4 bv = reinterpret_cast<const float4*>(s_b)[col];
  const float4 cv = reinterpret_cast<const float4*>(s_c)[col];
  mbar_wait(&s_full, 0);
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = row0 + i * kRowsPerPass;
    float part = 0.f;
    if (r < dh) {
      const float4 hv = reinterpret_cast<const float4*>(s_h + r * DS)[col];
      const float u = __fmul_rn(dt, s_x[r]);
      float4 hn;
      hn.x = __fadd_rn(__fmul_rn(hv.x, decay), __fmul_rn(u, bv.x));
      hn.y = __fadd_rn(__fmul_rn(hv.y, decay), __fmul_rn(u, bv.y));
      hn.z = __fadd_rn(__fmul_rn(hv.z, decay), __fmul_rn(u, bv.z));
      hn.w = __fadd_rn(__fmul_rn(hv.w, decay), __fmul_rn(u, bv.w));
      __stcs(reinterpret_cast<float4*>(hp + r * DS) + col, hn);
      part = fmaf(hn.w, cv.w, fmaf(hn.z, cv.z, fmaf(hn.y, cv.y, hn.x * cv.x)));
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    if (r < dh && col == 0) {
      const int ch = head * dh + r;
      const float yv = round_to<T>(__fadd_rn(part, __fmul_rn(dskip, s_x[r])));
      const float s = round_to<T>(to_f32(pr[ch]) + to_f32(norm_z[ch]));
      y[b * d_inner + ch] = from_f32<T>(yv * round_to<T>(silu(s)));
    }
  }
}

template <typename T, int DS>
cudaError_t launch_ds(const void* proj, const void* conv, void* h, const void* conv_w,
                      const void* dt_bias, const void* a_log, const void* d_skip,
                      const void* norm_z, void* y, void* conv_out, int B, int H, int dh, int K,
                      int64_t proj_stride, int64_t conv_stride, cudaStream_t s) {
  mamba_decode_kernel<T, DS><<<B * H, kThreads, 0, s>>>(
      static_cast<const T*>(proj), static_cast<const float*>(conv), static_cast<float*>(h),
      static_cast<const T*>(conv_w), static_cast<const float*>(dt_bias),
      static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
      static_cast<const T*>(norm_z), static_cast<T*>(y), static_cast<float*>(conv_out), H, dh,
      K, proj_stride, conv_stride);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* proj, const void* conv, void* h, const void* conv_w,
                   const void* dt_bias, const void* a_log, const void* d_skip,
                   const void* norm_z, void* y, void* conv_out, int B, int H, int dh, int ds,
                   int K, int64_t proj_stride, int64_t conv_stride, cudaStream_t s) {
  switch (ds) {
    case 16: return launch_ds<T, 16>(proj, conv, h, conv_w, dt_bias, a_log, d_skip, norm_z, y,
                                     conv_out, B, H, dh, K, proj_stride, conv_stride, s);
    case 32: return launch_ds<T, 32>(proj, conv, h, conv_w, dt_bias, a_log, d_skip, norm_z, y,
                                     conv_out, B, H, dh, K, proj_stride, conv_stride, s);
    case 64: return launch_ds<T, 64>(proj, conv, h, conv_w, dt_bias, a_log, d_skip, norm_z, y,
                                     conv_out, B, H, dh, K, proj_stride, conv_stride, s);
    case 128: return launch_ds<T, 128>(proj, conv, h, conv_w, dt_bias, a_log, d_skip, norm_z,
                                       y, conv_out, B, H, dh, K, proj_stride, conv_stride, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One decode step of B rows and H heads of dh (1..64) x ds (16, 32, 64 or
// 128), K (2..8) conv taps.  proj: [B, 2 H dh + 2 ds + H] of dtype, rows
// proj_stride elements apart; conv: float32 [B, K - 1, H dh + 2 ds], rows
// conv_stride elements apart, each row packed; h: float32 [B, H, dh, ds]
// contiguous and 16-byte aligned, updated in place; conv_w [K, H dh + 2 ds]
// and norm_z [H dh] of dtype; dt_bias, a_log, d_skip float32 [H]; y: [B, H dh]
// of dtype and conv_out float32 [B, K - 1, H dh + 2 ds], both contiguous.
extern "C" int mamba_decode_launch(const void* proj, const void* conv, void* h,
                                   const void* conv_w, const void* dt_bias, const void* a_log,
                                   const void* d_skip, const void* norm_z, void* y,
                                   void* conv_out, int B, int H, int dh, int ds, int K,
                                   long long proj_stride, long long conv_stride, int dtype,
                                   void* stream) {
  if (B <= 0 || H <= 0 || dh <= 0 || dh > kMaxHeadDim || K < 2 || K > kMaxK ||
      static_cast<int64_t>(B) * H > 0x7fffffff ||
      (dtype != kFloat32 && dtype != kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kFloat32
          ? launch<float>(proj, conv, h, conv_w, dt_bias, a_log, d_skip, norm_z, y, conv_out, B,
                          H, dh, ds, K, proj_stride, conv_stride, s)
          : launch<__nv_bfloat16>(proj, conv, h, conv_w, dt_bias, a_log, d_skip, norm_z, y,
                                  conv_out, B, H, dh, ds, K, proj_stride, conv_stride, s);
  return static_cast<int>(err);
}
