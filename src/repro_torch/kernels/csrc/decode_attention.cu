// Flash-decoding attention for Hopper (sm_90a): one query token per sequence
// against a KV cache, grouped-query (GQA).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention_pallas (body _kernel).  q[B, H, D], k and v[B, S, KV, D],
// rep = H / KV query heads share each KV head.  Scores are q.k * D^-0.5 in
// float32; slots >= length are excluded; the softmax is online with float32
// running max m, sum l and accumulator acc per query row; the output is
// acc / max(l, 1e-20) in q's dtype (float32 or bfloat16).  One length applies
// to every batch row, as in the TPU kernel.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads the valid prefix of K
// and V once, 2 * B * length * KV * D * itemsize bytes.  On the gemma3-1b
// serve path (B = 4, KV = 1, D = 256, bf16) at length = 544 that is about
// 2.2 MB, about 0.67 us; the 4 * B * H * length * D flops are far below the
// card's rate.  The kernel is bytes-bound in principle.
//
// Design: one CTA of 128 threads per (kv head, batch row), walking the cache
// in blocks of 128 slots:
//   A. thread j scores slot s0 + j for all rep query rows, reading its K row
//      in 16-byte vectors and the pre-scaled query from shared memory (every
//      lane of a warp reads the same query word: a broadcast);
//   B. one warp per query row folds the block into m and l;
//   C. thread (g, c) owns the 16-byte column vector c of D for all rep rows
//      and adds p * v over the block's slots g, g + G, g + 2G, ... where
//      G = 128 / (D / vector) slot groups share the block (G = 4 at D = 256
//      bf16): a warp reads one slot's V row as contiguous 16-byte vectors.
//      Each thread keeps its rep x vector partial sums in registers; the G
//      partials are summed once, after the last block.
// With 4 CTAs on the card nothing hides a load's latency but the loads a
// thread has in flight, so steps A and C issue kInFlight 16-byte loads before
// they use any of them.  The accumulator is sized by a compile-time bound R on
// rep, so at rep = 4 it does not take 16 rows' registers from those loads.
// Only slots below min(length, S) are read, so the masked tail of a block
// (including a ragged final block when S is not a multiple of 128) contributes
// nothing, exactly as the TPU kernel's -2e38 mask makes exp() underflow to 0.
// The TPU kernel asserts S % block == 0; this kernel takes any S.
// What the design does about the bound: it reads K and V once, both in 16-byte
// vectors, and nothing else.  At B * KV = 4 CTAs it occupies 4 of 132 SMs, so
// it is far from the bound; splitting S across CTAs with a log-sum-exp combine
// pass is the first speed-up and belongs to a later change.
//
// C interface (bound with ctypes): decode_attention_launch returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for arguments
// it does not take.

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockS = kThreads;  // cache slots per block: one per thread in step A
constexpr int kMaxRep = 16;        // query heads per KV head

// 16-byte loads a thread issues before it uses any of them: as many as the
// registers left beside an accumulator of R rows allow without spilling
template <int R> constexpr int kInFlight = R <= 4 ? 16 : (R <= 8 ? 8 : 4);
constexpr float kNegInf = -2.0e38f;

// The elements of one 16-byte vector already loaded, as float32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* out) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) out[i] = to_f32(e[i]);
}

// R: a compile-time bound on rep = H / KV (1, 2, 4, 8 or 16), so the
// accumulator of step C is R x 16 bytes of registers
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                        int S, int D, int length, float scale) {
  constexpr int N = kVec<T>;
  const int rep = H / KV;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int nvec = D / N;                       // 16-byte vectors in a row of D
  const int G = kThreads / nvec;                // slot groups of step C (nvec <= kThreads)
  const int col = tid % nvec;                   // step C: this thread's vector of D
  const int grp = tid / nvec;                   // step C: this thread's slot group

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [rep][D] query * scale
  float* red_s = q_s + rep * D;                 // [G][rep][D] step C partial sums
  float* p_s = red_s + G * rep * D;             // [rep][kBlockS] scores -> probabilities
  float* m_s = p_s + rep * kBlockS;             // [rep] running max
  float* l_s = m_s + rep;                       // [rep] running sum
  float* alpha_s = l_s + rep;                   // [rep] rescale for this block

  // the rep query rows of this KV head are contiguous in q[b]
  const int64_t qo = (static_cast<int64_t>(b) * H + static_cast<int64_t>(g) * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) q_s[i] = to_f32(q[qo + i]) * scale;
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int len = min(length, S);
  const int64_t slot_stride = static_cast<int64_t>(KV) * D;
  const T* kb = k + (static_cast<int64_t>(b) * S * KV + g) * D;
  const T* vb = v + (static_cast<int64_t>(b) * S * KV + g) * D;
  float acc[R][N];  // step C: rows x this thread's vector of D
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[r][i] = 0.f;
  }

  for (int s0 = 0; s0 < len; s0 += kBlockS) {
    const int nvalid = min(kBlockS, len - s0);

    // A. scores of slot s0 + tid for every query row, its K row read
    // F vectors at a time
    if (tid < nvalid) {
      constexpr int F = kInFlight<R>;
      const T* kr = kb + (s0 + tid) * slot_stride;
      float part[R];
#pragma unroll
      for (int r = 0; r < R; ++r) part[r] = 0.f;
      for (int c0 = 0; c0 < nvec; c0 += F) {
        uint4 raw[F];
#pragma unroll
        for (int u = 0; u < F; ++u) {
          if (c0 + u < nvec) raw[u] = *reinterpret_cast<const uint4*>(kr + (c0 + u) * N);
        }
#pragma unroll
        for (int u = 0; u < F; ++u) {
          if (c0 + u < nvec) {
            float kf[N];
            unpack<T>(raw[u], kf);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (r < rep) {
                const float4* q4 = reinterpret_cast<const float4*>(q_s + r * D + (c0 + u) * N);
                float t = 0.f;
#pragma unroll
                for (int i = 0; i < N / 4; ++i) {
                  const float4 qq = q4[i];
                  t += qq.x * kf[4 * i] + qq.y * kf[4 * i + 1] + qq.z * kf[4 * i + 2] +
                       qq.w * kf[4 * i + 3];
                }
                part[r] += t;
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rep) p_s[r * kBlockS + tid] = part[r];
      }
    }
    __syncthreads();

    // B. online softmax: one warp per query row
    for (int r = warp; r < rep; r += kWarps) {
      float* pr = p_s + r * kBlockS;
      float mx = kNegInf;
      for (int j = lane; j < nvalid; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < nvalid; j += 32) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // C. acc = acc * alpha + p @ V over this thread's slots of the block,
    // F V vectors read at a time
    if (grp < G) {
      constexpr int F = kInFlight<R>;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rep) {
          const float alpha = alpha_s[r];
#pragma unroll
          for (int i = 0; i < N; ++i) acc[r][i] *= alpha;
        }
      }
      for (int j0 = grp; j0 < nvalid; j0 += F * G) {
        uint4 raw[F];
#pragma unroll
        for (int u = 0; u < F; ++u) {
          const int j = j0 + u * G;
          if (j < nvalid) {
            raw[u] = *reinterpret_cast<const uint4*>(vb + (s0 + j) * slot_stride + col * N);
          }
        }
#pragma unroll
        for (int u = 0; u < F; ++u) {
          const int j = j0 + u * G;
          if (j < nvalid) {
            float vf[N];
            unpack<T>(raw[u], vf);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (r < rep) {
                const float p = p_s[r * kBlockS + j];
#pragma unroll
                for (int i = 0; i < N; ++i) acc[r][i] += p * vf[i];
              }
            }
          }
        }
      }
    }
    __syncthreads();  // step A of the next block overwrites p_s
  }

  // sum the G slot groups' partials and normalise
  if (grp < G) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rep) {
        float* dst = red_s + (grp * rep + r) * D + col * N;
#pragma unroll
        for (int i = 0; i < N; ++i) dst[i] = acc[r][i];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * D; i += kThreads) {
    float sum = 0.f;
    for (int gi = 0; gi < G; ++gi) sum += red_s[gi * rep * D + i];
    o[qo + i] = from_f32<T>(sum / fmaxf(l_s[i / D], 1e-20f));
  }
}

template <typename T, int R>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
           int S, int D, int length, float scale, cudaStream_t stream) {
  const int rep = H / KV;
  const int G = kThreads / (D / kVec<T>);
  const size_t smem = sizeof(float) * ((1 + static_cast<size_t>(G)) * rep * D +
                                       static_cast<size_t>(rep) * kBlockS + 3 * rep);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_attention_kernel<T, R><<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, S, D, length, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rep(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
               int S, int D, int length, float scale, cudaStream_t stream) {
  const int rep = H / KV;
  if (rep <= 1) return launch<T, 1>(q, k, v, o, B, H, KV, S, D, length, scale, stream);
  if (rep <= 2) return launch<T, 2>(q, k, v, o, B, H, KV, S, D, length, scale, stream);
  if (rep <= 4) return launch<T, 4>(q, k, v, o, B, H, KV, S, D, length, scale, stream);
  if (rep <= 8) return launch<T, 8>(q, k, v, o, B, H, KV, S, D, length, scale, stream);
  return launch<T, kMaxRep>(q, k, v, o, B, H, KV, S, D, length, scale, stream);
}

}  // namespace
// dtype: kFloat32 (0) or kBFloat16 (1).  Requires H % KV == 0, H / KV <= 16,
// D a multiple of the 16-byte vector (4 float32, 8 bf16) and at most 128 such
// vectors (D <= 512 float32, 1024 bf16), length >= 1, and 16-byte aligned,
// contiguous tensors.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       void* o, int B, int H, int KV, int S, int D,
                                       int length, float scale, int dtype,
                                       void* stream) {
  const int vec = dtype == kFloat32 ? kVec<float> : kVec<__nv_bfloat16>;
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxRep || S <= 0 || D <= 0 ||
      D % vec != 0 || D / vec > kThreads || length < 1 || B > 65535 ||
      (dtype != kFloat32 && dtype != kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_rep<float>(q, k, v, o, B, H, KV, S, D, length, scale, s);
  return launch_rep<__nv_bfloat16>(q, k, v, o, B, H, KV, S, D, length, scale, s);
}
