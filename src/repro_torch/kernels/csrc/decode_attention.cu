// Split-S flash-decoding attention for Hopper (sm_90a): one query token per
// sequence against a KV cache, grouped-query (GQA).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention_pallas (body _kernel).  q[B, H, D], k and v[B, S, KV, D],
// rep = H / KV query heads share each KV head.  Scores are q.k * D^-0.5 in
// float32; slots >= length are excluded; the softmax is float32; the output
// is acc / max(l, 1e-20) in q's dtype (float32 or bfloat16), or in float32
// with each row's log-sum-exp M + log(max(l, 1e-20)) beside it (the partial
// output of a slice of S, which a caller joins with other slices' partials).
// One length applies to every batch row, as in the TPU kernel; a length of 0
// (a slice with no valid slot) gives o = 0 and a log-sum-exp of about -2e38.  The TPU kernel walks the
// cache in order on one core, carrying (m, l, acc) in VMEM from one grid step
// to the next; here the cache is cut across CTAs and the carry becomes a
// log-sum-exp combine.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads the valid prefix of K
// and V once, 2 * B * length * KV * D * itemsize bytes: about 2.2 MB and
// 0.67 us on the gemma3-1b serve path (B = 4, KV = 1, D = 256, bf16, length
// 544).  It does rep multiply-adds per element read (4 there, 16 at most),
// far below the ~295 operations a byte at which the card stops being bound
// by memory, so tensor cores would buy nothing and none are used.  What the
// bound asks for is the whole cache in flight at once: by Little's law HBM
// needs about 3 MB in flight, more than the cache, so a design that spreads
// the cache over the card and asks for all of it at the start is bounded by
// one memory round trip, the launch and the combine.
//
// Design: the host's decode_attention_plan cuts [0, length) into `splits`
// chunks of `chunk` slots; one CTA of 256 threads per (split, kv head, batch
// row), within one wave of resident CTAs.  A CTA stages its chunk in blocks
// of `block` slots (one block when the chunk fits, as on the serve path):
//   1. at its start it issues 16-byte cp.async.cg copies of the block's K
//      rows (each padded by one vector in shared memory, so that lanes on
//      neighbouring slots read other banks), of the query rows and of the
//      block's V rows, as three commit groups;
//   2. it waits for K and the query alone and scales the query into float32;
//      lane j of warp w sums slot j's products over the w-th of 8 segments
//      of D, for 4 query rows at a time, and the segments' sums are added in
//      segment order through shared memory: no shuffles, and the rep rows
//      share each K read;
//   3. one warp a query row takes the block's max and sum in float32
//      (online across the blocks of a chunk) while V arrives, the next
//      block's K copies already issued into the freed K buffer;
//   4. it waits for V; thread (slot group, row group, 16-byte column vector)
//      adds p * v over its slots for its RT rows; the slot groups' sums are
//      added in order once, after the last block.
// Combine, in the same launch: each CTA writes float32 (m, l) per row and
// its unnormalised acc[rep, D] to a per-call workspace and adds one to its
// (b, g) arrival counter with an acq_rel atomic (a release of its partials,
// cumulative over the CTA barrier before it); the CTA that arrives last reads
// them with __ldcg (the first 8 partials of each thread already requested
// while it makes the weights) and combines in split order 0 .. splits - 1:
// M = max m_i, o = sum e^(m_i - M) acc_i / max(sum e^(m_i - M) l_i, 1e-20),
// written once in the output's dtype (and, when asked for, the row's
// log-sum-exp M + log(max(sum e^(m_i - M) l_i, 1e-20))).  No block waits for another, so CTAs that are
// not co-resident cannot deadlock and every call gives the same bits; the
// workspace is per call, so calls on two streams may overlap.  With one split
// the CTA normalises and writes o itself, with no workspace.  Only slots
// below min(length, S) are read, so a ragged last chunk (and any S) takes
// nothing from the slots beyond it, as the TPU kernel's -2e38 mask makes
// exp() underflow to 0; the TPU kernel asserts S % block == 0.
//
// What was measured (tools/decode_attention_phases.py: per-phase timestamps
// of an instrumented copy; chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W):
// with a CTA or two an SM the kernel is bound by latency, not by bytes.  It
// waits on one L2 or HBM round trip after another: the first K copies, the
// arrival, the weights, the partials.  Variants with W lanes a slot summing
// by shuffles in step 2, with 128 threads, with step 4 split over slots
// before rows, and with the query kept in its own dtype were slower and were
// not kept.  Device times are in PERF.md.
//
// C interface (bound with ctypes): decode_attention_launch returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for arguments
// it does not take; decode_attention_blocks_per_sm returns the CTAs one SM
// holds (or minus a CUDA error).

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 16;      // query heads per KV head
constexpr int kMaxVecs = 128;    // 16-byte vectors in a row of D
constexpr int kMaxBlock = 128;   // slots staged in shared memory at once
constexpr int kRows = 4;         // step 2: query rows a pass scores
constexpr int kPrefetch = 8;     // combine: partials a thread asks for before the weights
constexpr float kNegInf = -2.0e38f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;         // [B, H, D] in q's dtype, or float32 when lse is given
  float* lse;      // [B, H] float32 log-sum-exp of each row, or null
  float* part_acc;  // [B * KV][splits][rep][D] float32, or null when splits == 1
  float* part_ml;   // [B * KV][splits][rep][2]: m, l
  int* arrivals;    // one counter a (b, g), zeroed before the launch
  int H, KV, S, D;
  int length;       // valid slots, 0 <= length <= S
  int chunk, splits, block;
  float scale;
};

// Step 4's threads: G = kThreads / nvec groups a column vector, GR of them
// row groups of RT rows and GS = G / GR slot groups.
struct PvGrid {
  int G, GR, GS;
  __host__ __device__ PvGrid(int rep, int nvec, int RT)
      : G(kThreads / nvec), GR((rep + RT - 1) / RT), GS(G / GR) {}
};

// Byte offsets of the dynamic shared memory: the K block (rows padded by one
// 16-byte vector) and the V block, after the loop also step 4's partial sums
// and the combine's weights; the scaled query; step 2's partial scores; the
// block's scores; the row stats.
struct Smem {
  long long v, q, qraw, sp, p, stats, total;
  __host__ __device__ Smem(int itemsize, int D, int rep, int block, int splits, int GS) {
    v = static_cast<long long>(block) * (D + 16 / itemsize) * itemsize;
    long long region = v + static_cast<long long>(block) * D * itemsize;
    const long long red = 4LL * GS * rep * D;
    const long long comb = splits > 1 ? 2LL * rep * splits * 4 : 0;
    region = region > red ? region : red;
    region = region > comb ? region : comb;
    q = (region + 15) / 16 * 16;
    qraw = q + 4LL * rep * D;
    sp = qraw + (static_cast<long long>(rep) * D * itemsize + 15) / 16 * 16;
    p = sp + 4LL * kWarps * kRows * 32;
    stats = p + (4LL * rep * block + 15) / 16 * 16;
    total = stats + 4LL * 3 * rep;
  }
};

// Issue one block's rows of K or V (slots s0 .. s0 + n - 1 of this CTA's
// kv head) as 16-byte copies into dst[n][stride], and commit them as one group.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int stride, const T* src, long long slot_stride,
                                      int s0, int n, int nvec) {
  constexpr int N = kVec<T>;
  for (int i = threadIdx.x; i < n * nvec; i += kThreads) {
    const int j = i / nvec, c = i % nvec;
    cp_async16(dst + j * stride + c * N, src + (s0 + j) * slot_stride + c * N);
  }
  cp_async_commit();
}

// RT: query rows a thread accumulates in step 4 (1, 2, 4 or 8); O: the
// output's type (T, or float for a partial output).
template <typename T, typename O, int RT>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Args a) {
  constexpr int N = kVec<T>;
  constexpr int NP = N / 4;  // float4s of a 16-byte vector's floats
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rep = a.H / a.KV, D = a.D, nvec = D / N;
  const PvGrid pv(rep, nvec, RT);
  const Smem lay(sizeof(T), D, rep, a.block, a.splits, pv.GS);

  extern __shared__ __align__(16) unsigned char smem[];
  const int ks = D + N;  // K row stride: lanes on neighbouring slots hit other banks
  T* k_s = reinterpret_cast<T*>(smem);                        // [block][ks]
  T* v_s = reinterpret_cast<T*>(smem + lay.v);                // [block][D]
  float4* q4 = reinterpret_cast<float4*>(smem + lay.q);       // [rep][nvec][NP] scaled
  T* qraw_s = reinterpret_cast<T*>(smem + lay.qraw);          // [rep][D] as given
  float* sp_s = reinterpret_cast<float*>(smem + lay.sp);      // [kWarps][kRows][32]
  float* p_s = reinterpret_cast<float*>(smem + lay.p);        // [rep][block]
  float* m_s = reinterpret_cast<float*>(smem + lay.stats);    // [rep] running max
  float* l_s = m_s + rep;                                     // [rep] running sum
  float* alpha_s = l_s + rep;                                 // [rep] rescale of a block

  const int s_begin = split * a.chunk;
  const int s_end = min(s_begin + a.chunk, a.length);
  const long long slot_stride = static_cast<long long>(a.KV) * D;
  const long long kv0 = (static_cast<long long>(b) * a.S * a.KV + g) * D;
  const T* kg = static_cast<const T*>(a.k) + kv0;
  const T* vg = static_cast<const T*>(a.v) + kv0;

  // 1. the first block's K, the query and the block's V in flight
  stage<T>(k_s, ks, kg, slot_stride, s_begin, min(a.block, s_end - s_begin), nvec);
  // the rep query rows of this KV head are contiguous in q[b]
  const long long qo = (static_cast<long long>(b) * a.H + static_cast<long long>(g) * rep) * D;
  for (int i = tid; i < rep * nvec; i += kThreads) {
    cp_async16(qraw_s + i * N, static_cast<const T*>(a.q) + qo + i * N);
  }
  cp_async_commit();  // a group of its own, waited for with K's
  stage<T>(v_s, D, vg, slot_stride, s_begin, min(a.block, s_end - s_begin), nvec);
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // step 2: lane = slot, warp = a segment of D's vectors
  const int seg = (nvec + kWarps - 1) / kWarps;
  const int c_begin = min(warp * seg, nvec), c_end = min(c_begin + seg, nvec);
  // step 4: thread (sg, rg, col) owns column vector col of rows rg + i GR
  // over the slots sg, sg + GS, ... of each block
  const int col = tid % nvec, rg = tid / nvec % pv.GR, sg = tid / nvec / pv.GR;
  float acc[RT][N];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[i][e] = 0.f;

  for (int s0 = s_begin; s0 < s_end; s0 += a.block) {
    const int n = min(a.block, s_end - s0);
    const int next = s0 + a.block;
    cp_async_wait<1>();  // this block's K (its V may still be in flight)
    __syncthreads();
    if (s0 == s_begin) {  // the query, scaled, as float32
      for (int i = tid; i < rep * nvec; i += kThreads) {
        float f[N];
        load_vec<T>(qraw_s + i * N, f);
#pragma unroll
        for (int h = 0; h < NP; ++h) {
          q4[i * NP + h] = make_float4(f[4 * h] * a.scale, f[4 * h + 1] * a.scale,
                                       f[4 * h + 2] * a.scale, f[4 * h + 3] * a.scale);
        }
      }
      __syncthreads();
    }

    // 2. scores of the block's slots for every query row: lane j of warp w
    // sums slot j's products over the w-th segment of D for kRows rows at a
    // time, with no shuffles; the kWarps segments are added in order
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      for (int r0 = 0; r0 < rep; r0 += kRows) {
        float t[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) t[i] = 0.f;
        if (j < n) {
          for (int c = c_begin; c < c_end; ++c) {
            float kf[N];
            load_vec<T>(k_s + j * ks + c * N, kf);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              if (r0 + i < rep) {
#pragma unroll
                for (int h = 0; h < NP; ++h) {
                  const float4 qq = q4[((r0 + i) * nvec + c) * NP + h];  // the same for the warp
                  t[i] += qq.x * kf[4 * h] + qq.y * kf[4 * h + 1] + qq.z * kf[4 * h + 2] +
                          qq.w * kf[4 * h + 3];
                }
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) sp_s[(warp * kRows + i) * 32 + lane] = t[i];
        __syncthreads();
        for (int o = tid; o < kRows * 32; o += kThreads) {
          const int r = r0 + o / 32, jj = j0 + o % 32;
          if (r < rep && jj < n) {
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) sum += sp_s[w * kRows * 32 + o];
            p_s[r * a.block + jj] = sum;
          }
        }
        __syncthreads();  // the partial scores are free; after the last pass, K too
      }
    }
    if (next < s_end) {
      stage<T>(k_s, ks, kg, slot_stride, next, min(a.block, s_end - next), nvec);
    } else {
      cp_async_commit();  // an empty group keeps the count of pending groups
    }

    // 3. online softmax of the block: one warp a query row
    for (int r = warp; r < rep; r += kWarps) {
      float* pr = p_s + r * a.block;
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(pr[j] - m_new);
        pr[j] = e;
        sum += e;
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
    cp_async_wait<1>();  // this block's V (the next block's K may be in flight)
    __syncthreads();

    // 4. acc = acc * alpha + p @ V for this thread's rows, column vector and slots
    if (sg < pv.GS) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = rg + i * pv.GR;
        if (r < rep) {
          const float alpha = alpha_s[r];
#pragma unroll
          for (int e = 0; e < N; ++e) acc[i][e] *= alpha;
        }
      }
      for (int j = sg; j < n; j += pv.GS) {
        float vf[N];
        load_vec<T>(v_s + j * D + col * N, vf);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int r = rg + i * pv.GR;
          if (r < rep) {
            const float pj = p_s[r * a.block + j];
#pragma unroll
            for (int e = 0; e < N; ++e) acc[i][e] += pj * vf[e];
          }
        }
      }
    }
    __syncthreads();  // the V buffer and the scores are free
    if (next < s_end) {
      stage<T>(v_s, D, vg, slot_stride, next, min(a.block, s_end - next), nvec);
    } else {
      cp_async_commit();
    }
  }
  cp_async_wait<0>();  // only empty groups remain

  // the slot groups' partial sums, added in slot-group order
  float* red = reinterpret_cast<float*>(smem);  // [GS][rep][D]
  if (sg < pv.GS) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = rg + i * pv.GR;
      if (r < rep) {
        float4* dst = reinterpret_cast<float4*>(red + (sg * rep + r) * D + col * N);
#pragma unroll
        for (int h = 0; h < NP; ++h) {
          dst[h] = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                               acc[i][4 * h + 3]);
        }
      }
    }
  }
  __syncthreads();
  const int bg = b * a.KV + g;
  const long long item = static_cast<long long>(bg) * a.splits + split;
  O* og = static_cast<O*>(a.o) + qo;
  float* lse = a.lse == nullptr ? nullptr : a.lse + qo / D;  // [rep] of this (b, g)
  for (int o = tid; o < rep * D / 4; o += kThreads) {  // one float4 of the rep x D sums
    float4 sum = reinterpret_cast<const float4*>(red)[o];
    for (int s = 1; s < pv.GS; ++s) {
      const float4 x = reinterpret_cast<const float4*>(red + s * rep * D)[o];
      sum.x += x.x, sum.y += x.y, sum.z += x.z, sum.w += x.w;
    }
    if (a.splits == 1) {  // the whole cache: normalise and write o
      const int r = o * 4 / D;
      const float den = fmaxf(l_s[r], 1e-20f);
      og[o * 4] = from_f32<O>(sum.x / den);
      og[o * 4 + 1] = from_f32<O>(sum.y / den);
      og[o * 4 + 2] = from_f32<O>(sum.z / den);
      og[o * 4 + 3] = from_f32<O>(sum.w / den);
      if (lse != nullptr && o * 4 % D == 0) lse[r] = m_s[r] + logf(den);
    } else {  // this chunk's partial
      reinterpret_cast<float4*>(a.part_acc + item * rep * D)[o] = sum;
    }
  }
  if (a.splits == 1) return;
  for (int r = tid; r < rep; r += kThreads) {
    reinterpret_cast<float2*>(a.part_ml)[item * rep + r] = make_float2(m_s[r], l_s[r]);
  }
  __shared__ int last;
  __syncthreads();  // every partial of the CTA is written
  if (tid == 0) {
    // arrive: a release of the CTA's partials (cumulative over the barrier)
    // and, for the last to arrive, an acquire of everyone else's
    int before;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
                 : "=r"(before) : "l"(a.arrivals + bg) : "memory");
    last = before == a.splits - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last chunk of (b, g) to arrive combines all of them in split order
  const float4* pa = reinterpret_cast<const float4*>(
      a.part_acc + static_cast<long long>(bg) * a.splits * rep * D);
  const int split_stride = rep * D / 4;
  float4 pre[kPrefetch];  // this thread's first float4 of the first partials, in flight
#pragma unroll
  for (int i = 0; i < kPrefetch; ++i) {
    if (i < a.splits && tid < split_stride) pre[i] = __ldcg(pa + i * split_stride + tid);
  }
  float* w_s = red;                    // [rep][splits] e^(m_i - M)
  float* lw_s = w_s + rep * a.splits;  // [rep][splits] l_i
  const float2* ml = reinterpret_cast<const float2*>(a.part_ml) +
                     static_cast<long long>(bg) * a.splits * rep;
  for (int r = warp; r < rep; r += kWarps) {
    float mx = kNegInf;
    for (int i = lane; i < a.splits; i += 32) {
      const float2 mli = __ldcg(ml + i * rep + r);
      w_s[r * a.splits + i] = mli.x;
      lw_s[r * a.splits + i] = mli.y;
      mx = fmaxf(mx, mli.x);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    for (int i = lane; i < a.splits; i += 32) {
      w_s[r * a.splits + i] = expf(w_s[r * a.splits + i] - mx);
    }
    if (lane == 0) m_s[r] = mx;  // this CTA's own stats were written out above
  }
  __syncthreads();
  for (int o = tid; o < split_stride; o += kThreads) {  // one float4 of o
    const int r = o * 4 / D;
    const float* wr = w_s + r * a.splits;
    const float* lr = lw_s + r * a.splits;
    float l = 0.f;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    int i = 0;
    if (o == tid) {
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        if (u < a.splits) {
          const float w = wr[u];
          l += w * lr[u];
          sum.x += w * pre[u].x, sum.y += w * pre[u].y, sum.z += w * pre[u].z,
              sum.w += w * pre[u].w;
        }
      }
      i = min(kPrefetch, a.splits);
    }
#pragma unroll 8
    for (; i < a.splits; ++i) {
      const float w = wr[i];
      l += w * lr[i];
      const float4 x = __ldcg(pa + static_cast<long long>(i) * split_stride + o);
      sum.x += w * x.x, sum.y += w * x.y, sum.z += w * x.z, sum.w += w * x.w;
    }
    const float den = fmaxf(l, 1e-20f);
    og[o * 4] = from_f32<O>(sum.x / den);
    og[o * 4 + 1] = from_f32<O>(sum.y / den);
    og[o * 4 + 2] = from_f32<O>(sum.z / den);
    og[o * 4 + 3] = from_f32<O>(sum.w / den);
    if (lse != nullptr && o * 4 % D == 0) lse[r] = m_s[r] + logf(den);
  }
}

// Launches (or, with blocks_per_sm, reports the CTAs an SM holds for) the
// instance with RT rows a thread.
template <typename T, typename O, int RT>
int run_rt(const Args& a, int B, cudaStream_t stream, int* blocks_per_sm) {
  auto kernel = decode_attention_kernel<T, O, RT>;
  const int rep = a.H / a.KV;
  const long long smem =
      Smem(sizeof(T), a.D, rep, a.block, a.splits, PvGrid(rep, a.D / kVec<T>, RT).GS).total;
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
  if (a.splits > 1) {
    err = cudaMemsetAsync(a.arrivals, 0, sizeof(int) * B * a.KV, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.splits, a.KV, B), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// RT = the fewest rows a thread (a power of two) that the G = kThreads /
// nvec thread groups of a column vector cover rep with: the threads left
// over split the slots (measured: fewer rows and more row groups are faster
// than fewer row groups and more slot groups)
template <typename T, typename O>
int run_t(const Args& a, int B, cudaStream_t stream, int* blocks_per_sm) {
  const int G = kThreads / (a.D / kVec<T>);
  const int rt = (a.H / a.KV + G - 1) / G;
  if (rt <= 1) return run_rt<T, O, 1>(a, B, stream, blocks_per_sm);
  if (rt <= 2) return run_rt<T, O, 2>(a, B, stream, blocks_per_sm);
  if (rt <= 4) return run_rt<T, O, 4>(a, B, stream, blocks_per_sm);
  return run_rt<T, O, 8>(a, B, stream, blocks_per_sm);
}

int run(Args a, int B, int dtype, void* ws, cudaStream_t stream, int* blocks_per_sm) {
  const int vec = dtype == kFloat32 ? kVec<float> : kVec<__nv_bfloat16>;
  if (B <= 0 || B > 65535 || a.KV <= 0 || a.KV > 65535 || a.H % a.KV != 0 ||
      a.H / a.KV > kMaxRep || a.S <= 0 || a.D <= 0 || a.D % vec != 0 || a.D / vec > kMaxVecs ||
      a.length < 0 || a.length > a.S || a.chunk < 1 || a.splits < 1 || a.block < 1 ||
      a.block > kMaxBlock || static_cast<long long>(a.splits - 1) * a.chunk >= max(a.length, 1) ||
      static_cast<long long>(a.splits) * a.chunk < a.length ||
      (dtype != kFloat32 && dtype != kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.splits > 1 && blocks_per_sm == nullptr) {
    if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const long long items = static_cast<long long>(B) * a.KV * a.splits * (a.H / a.KV);
    a.part_acc = static_cast<float*>(ws);
    a.part_ml = a.part_acc + items * a.D;
    a.arrivals = reinterpret_cast<int*>(a.part_ml + items * 2);
  }
  if (dtype == kFloat32) return run_t<float, float>(a, B, stream, blocks_per_sm);
  if (a.lse != nullptr) return run_t<__nv_bfloat16, float>(a, B, stream, blocks_per_sm);
  return run_t<__nv_bfloat16, __nv_bfloat16>(a, B, stream, blocks_per_sm);
}

}  // namespace

// dtype: kFloat32 (0) or kBFloat16 (1).  Requires H % KV == 0, H / KV <= 16,
// D a multiple of the 16-byte vector (4 float32, 8 bf16) and at most 128 such
// vectors (D <= 512 float32, 1024 bf16), 0 <= length <= S, and 16-byte
// aligned, contiguous tensors.  The plan: `splits` chunks of `chunk` slots
// cover [0, length) with none empty (one split for length 0), staged `block`
// (<= 128) slots at a time.  With lse null, o is in q's dtype; else o is
// float32 and lse [B, H] float32 receives each row's log-sum-exp.
// With splits > 1, ws holds B KV splits rep D float32 partial accumulators,
// then B KV splits rep (m, l) pairs, then one int32 counter a (b, g); the
// launch zeroes the counters.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v, void* o,
                                       void* lse, void* ws, int B, int H, int KV, int S, int D,
                                       int length, int chunk, int splits, int block, float scale,
                                       int dtype, void* stream) {
  const Args a{q, k, v, o, static_cast<float*>(lse), nullptr, nullptr, nullptr, H, KV, S, D,
               length, chunk, splits, block, scale};
  return run(a, B, dtype, ws, static_cast<cudaStream_t>(stream), nullptr);
}

// CTAs of decode_attention_launch's kernel one SM holds for this plan, or
// minus a CUDA error code.
extern "C" int decode_attention_blocks_per_sm(int H, int KV, int D, int dtype, int chunk,
                                              int splits, int block) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, H, KV,
               splits * chunk, D, splits * chunk, chunk, splits, block, 1.f};
  int blocks = 0;
  const int err = run(a, 1, dtype, nullptr, nullptr, &blocks);
  return err != 0 ? -err : blocks;
}
