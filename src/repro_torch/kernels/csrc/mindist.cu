// Batched interval lower bounds of ULISSE (paper Eq. 5), for Hopper.
//
// Replaces repro/kernels/mindist.py::mindist_pallas, and with it the jnp
// computation the reference engine runs on every query
// (repro/core/planner.py::env_lower_bounds_batch / block_lower_bounds_batch
// -> repro/core/bounds.py::interval_mindist).
//
// out[b, e] = valid[e] ? sqrt(seg_len * sum_{i < nseg} gap_i^2) : +inf,
// gap_i = max(0, e_lo - q_hi, q_lo - e_hi), a non-finite gap counts 0.
// Two entries: `ulisse_mindist_sym` takes the envelopes' int32 iSAX symbols
// and looks up their outer breakpoints (beta_lower / beta_upper) itself;
// `ulisse_mindist_paa` takes float32 intervals (raw PAA bounds, block
// unions).
//
// Bound on the card: bytes.  Each envelope's first nseg symbols (or
// floats) of lo and hi are read once and each (b, e) output written once;
// the work is ~4 flops per byte.  Design: one thread per envelope, the
// B query intervals and the breakpoint table in shared memory, the
// envelope's values applied to every query of the batch (up to kMaxBatch
// per launch; the wrapper splits larger batches), coalesced (B, N)
// stores.  Sums are taken in segment order without fused multiply-adds,
// as the plain version writes them.
// The symbol entry (the exact scan's, over every envelope) loads a row's
// first nseg symbols of lo and hi as 16-byte vectors, every load in
// flight before the first is used (mindist_sym_vec_kernel, where w is a
// multiple of 4 and nseg <= 16: the index's rows are 64 bytes at w = 16),
// and keeps the batch's query intervals segment-major in shared memory,
// so a segment's B bounds come in 16-byte reads; the batch is rounded up
// to a power of two at compile time.  It replaced a loop of one 4-byte
// load a segment, whose warp loads touched 32 sectors 64 bytes apart.
// Other shapes take the scalar kernel, as the PAA entry does.  It stages
// the batch's query intervals (2 B nseg floats) in shared memory, opting
// in past 48 KB; where even the card's 227 KB cannot hold them (nseg past
// ~3,500 at B = 8) it reads them from device memory instead (B nseg 8
// bytes, L1/L2-resident: every thread of a warp reads the same word).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBatch = 8;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

// kSmemQ: the query intervals staged in shared memory (else read from
// device memory in place).
template <bool kSym, bool kSmemQ>
__global__ void mindist_kernel(const void* __restrict__ lo_,
                               const void* __restrict__ hi_,
                               const float* __restrict__ breakpoints,
                               int card,
                               const float* __restrict__ q_lo,
                               const float* __restrict__ q_hi, int q_stride,
                               const bool* __restrict__ valid,
                               float* __restrict__ out, long long n, int w,
                               int nseg, int batch, float seg_len) {
  extern __shared__ float smem[];
  const int staged = kSmemQ ? batch * nseg : 0;
  float* sq_lo = smem;                       // [batch * nseg] (kSmemQ)
  float* sq_hi = sq_lo + staged;             // [batch * nseg] (kSmemQ)
  float* beta_lo = sq_hi + staged;           // [card] (symbol entry only)
  float* beta_hi = beta_lo + card;           // [card]
  for (int i = threadIdx.x; i < staged; i += blockDim.x) {
    const int b = i / nseg, s = i % nseg;
    sq_lo[i] = q_lo[b * q_stride + s];
    sq_hi[i] = q_hi[b * q_stride + s];
  }
  if (kSym) {
    for (int s = threadIdx.x; s < card; s += blockDim.x) {
      beta_lo[s] = s == 0 ? -INFINITY : breakpoints[s - 1];
      beta_hi[s] = s == card - 1 ? INFINITY : breakpoints[s];
    }
  }
  __syncthreads();

  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  if (!valid[e]) {
    for (int b = 0; b < batch; ++b) out[b * n + e] = INFINITY;
    return;
  }
  float acc[kMaxBatch];
#pragma unroll
  for (int b = 0; b < kMaxBatch; ++b) acc[b] = 0.f;
  const long long row = e * w;
  for (int s = 0; s < nseg; ++s) {
    float elo, ehi;
    if (kSym) {
      const int* lo = static_cast<const int*>(lo_);
      const int* hi = static_cast<const int*>(hi_);
      const int slo = min(max(__ldg(lo + row + s), 0), card - 1);
      const int shi = min(max(__ldg(hi + row + s), 0), card - 1);
      elo = beta_lo[slo];
      ehi = beta_hi[shi];
    } else {
      elo = __ldg(static_cast<const float*>(lo_) + row + s);
      ehi = __ldg(static_cast<const float*>(hi_) + row + s);
    }
#pragma unroll
    for (int b = 0; b < kMaxBatch; ++b) {
      if (b < batch) {
        const float ql = kSmemQ ? sq_lo[b * nseg + s]
                                : __ldg(q_lo + (long long)b * q_stride + s);
        const float qh = kSmemQ ? sq_hi[b * nseg + s]
                                : __ldg(q_hi + (long long)b * q_stride + s);
        float gap = fmaxf(fmaxf(__fsub_rn(elo, qh), __fsub_rn(ql, ehi)),
                          0.f);
        if (!isfinite(gap)) gap = 0.f;
        acc[b] = __fadd_rn(acc[b], __fmul_rn(gap, gap));
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kMaxBatch; ++b) {
    if (b < batch) out[b * n + e] = sqrtf(__fmul_rn(seg_len, acc[b]));
  }
}

// Component c (a compile-time constant where it is called) of an int4.
__device__ __forceinline__ int lane_of(const int4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// The symbol entry with 16-byte row loads: V int4 of each of lo and hi
// (nseg <= 4 V <= w), kB query slots (batch <= kB).  The query
// intervals sit segment-major, (nseg, kB), zero beyond the batch.
template <int V, int kB>
__global__ void __launch_bounds__(kThreads)
    mindist_sym_vec_kernel(const int* __restrict__ lo,
                           const int* __restrict__ hi,
                           const float* __restrict__ breakpoints, int card,
                           const float* __restrict__ q_lo,
                           const float* __restrict__ q_hi, int q_stride,
                           const bool* __restrict__ valid,
                           float* __restrict__ out, long long n, int w,
                           int nseg, int batch, float seg_len) {
  extern __shared__ float4 smem4[];
  float* sq_lo = reinterpret_cast<float*>(smem4);   // [nseg * kB]
  float* sq_hi = sq_lo + nseg * kB;                  // [nseg * kB]
  float* beta_lo = sq_hi + nseg * kB;                // [card]
  float* beta_hi = beta_lo + card;                   // [card]
  for (int i = threadIdx.x; i < nseg * kB; i += blockDim.x) {
    const int s = i / kB, b = i % kB;
    sq_lo[i] = b < batch ? q_lo[b * q_stride + s] : 0.f;
    sq_hi[i] = b < batch ? q_hi[b * q_stride + s] : 0.f;
  }
  for (int s = threadIdx.x; s < card; s += blockDim.x) {
    beta_lo[s] = s == 0 ? -INFINITY : breakpoints[s - 1];
    beta_hi[s] = s == card - 1 ? INFINITY : breakpoints[s];
  }
  __syncthreads();

  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  if (!valid[e]) {
    for (int b = 0; b < batch; ++b) out[b * n + e] = INFINITY;
    return;
  }
  int4 vlo[V], vhi[V];
  const int4* rlo = reinterpret_cast<const int4*>(lo + e * w);
  const int4* rhi = reinterpret_cast<const int4*>(hi + e * w);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    vlo[v] = __ldg(rlo + v);
    vhi[v] = __ldg(rhi + v);
  }
  float acc[kB];
#pragma unroll
  for (int b = 0; b < kB; ++b) acc[b] = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s = 4 * v + c;
      if (s < nseg) {
        const float elo = beta_lo[min(max(lane_of(vlo[v], c), 0), card - 1)];
        const float ehi = beta_hi[min(max(lane_of(vhi[v], c), 0), card - 1)];
        float ql[kB], qh[kB];
        if (kB % 4 == 0) {
#pragma unroll
          for (int b4 = 0; b4 < kB / 4; ++b4) {
            const float4 l4 = reinterpret_cast<const float4*>(
                sq_lo + s * kB)[b4];
            const float4 h4 = reinterpret_cast<const float4*>(
                sq_hi + s * kB)[b4];
            ql[4 * b4] = l4.x; ql[4 * b4 + 1] = l4.y;
            ql[4 * b4 + 2] = l4.z; ql[4 * b4 + 3] = l4.w;
            qh[4 * b4] = h4.x; qh[4 * b4 + 1] = h4.y;
            qh[4 * b4 + 2] = h4.z; qh[4 * b4 + 3] = h4.w;
          }
        } else {
#pragma unroll
          for (int b = 0; b < kB; ++b) {
            ql[b] = sq_lo[s * kB + b];
            qh[b] = sq_hi[s * kB + b];
          }
        }
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          float gap = fmaxf(fmaxf(__fsub_rn(elo, qh[b]),
                                  __fsub_rn(ql[b], ehi)), 0.f);
          if (!isfinite(gap)) gap = 0.f;
          acc[b] = __fadd_rn(acc[b], __fmul_rn(gap, gap));
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    if (b < batch) out[b * n + e] = sqrtf(__fmul_rn(seg_len, acc[b]));
  }
}

template <int V, int kB>
int launch_sym_vec(const int* lo, const int* hi, const float* breakpoints,
                   int card, const float* q_lo, const float* q_hi,
                   int q_stride, const bool* valid, float* out, long long n,
                   int w, int nseg, int batch, float seg_len,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kB * nseg + 2 * card);
  const long long blocks = (n + kThreads - 1) / kThreads;
  mindist_sym_vec_kernel<V, kB><<<(unsigned)blocks, kThreads, smem, stream>>>(
      lo, hi, breakpoints, card, q_lo, q_hi, q_stride, valid, out, n, w,
      nseg, batch, seg_len);
  return (int)cudaGetLastError();
}

template <int V>
int dispatch_batch(int batch, const int* lo, const int* hi,
                   const float* breakpoints, int card, const float* q_lo,
                   const float* q_hi, int q_stride, const bool* valid,
                   float* out, long long n, int w, int nseg, float seg_len,
                   cudaStream_t stream) {
  if (batch <= 1)
    return launch_sym_vec<V, 1>(lo, hi, breakpoints, card, q_lo, q_hi,
                                q_stride, valid, out, n, w, nseg, batch,
                                seg_len, stream);
  if (batch <= 2)
    return launch_sym_vec<V, 2>(lo, hi, breakpoints, card, q_lo, q_hi,
                                q_stride, valid, out, n, w, nseg, batch,
                                seg_len, stream);
  if (batch <= 4)
    return launch_sym_vec<V, 4>(lo, hi, breakpoints, card, q_lo, q_hi,
                                q_stride, valid, out, n, w, nseg, batch,
                                seg_len, stream);
  return launch_sym_vec<V, kMaxBatch>(lo, hi, breakpoints, card, q_lo, q_hi,
                                      q_stride, valid, out, n, w, nseg,
                                      batch, seg_len, stream);
}

template <bool kSym, bool kSmemQ>
int launch_scalar(const void* lo, const void* hi, const float* breakpoints,
                  int card, const float* q_lo, const float* q_hi,
                  int q_stride, const bool* valid, float* out, long long n,
                  int w, int nseg, int batch, float seg_len,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kSmemQ ? 2 * (size_t)batch * nseg
                                               : 0) +
                                       (kSym ? 2 * (size_t)card : 0));
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        mindist_kernel<kSym, kSmemQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n + kThreads - 1) / kThreads;
  mindist_kernel<kSym, kSmemQ><<<(unsigned)blocks, kThreads, smem, stream>>>(
      lo, hi, breakpoints, card, q_lo, q_hi, q_stride, valid, out, n, w,
      nseg, batch, seg_len);
  return (int)cudaGetLastError();
}

template <bool kSym>
int launch(const void* lo, const void* hi, const float* breakpoints,
           int card, const float* q_lo, const float* q_hi, int q_stride,
           const bool* valid, float* out, long long n, int w, int nseg,
           int batch, float seg_len, cudaStream_t stream) {
  if (batch < 1 || batch > kMaxBatch || nseg < 0 || nseg > w ||
      nseg > q_stride || (kSym && 2 * (size_t)card * sizeof(float) >
                                      kSmemMax))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const size_t staged = sizeof(float) * (2 * (size_t)batch * nseg +
                                         (kSym ? 2 * (size_t)card : 0));
  return (staged <= kSmemMax ? launch_scalar<kSym, true>
                             : launch_scalar<kSym, false>)(
      lo, hi, breakpoints, card, q_lo, q_hi, q_stride, valid, out, n, w,
      nseg, batch, seg_len, stream);
}

}  // namespace

extern "C" int ulisse_mindist_sym(const void* sym_lo, const void* sym_hi,
                                  const void* breakpoints, int card,
                                  const void* q_lo, const void* q_hi,
                                  int q_stride, const void* valid, void* out,
                                  long long n, int w, int nseg, int batch,
                                  float seg_len, void* stream) {
  const bool vec = w % 4 == 0 && nseg >= 1 && nseg <= 16 &&
                   reinterpret_cast<size_t>(sym_lo) % 16 == 0 &&
                   reinterpret_cast<size_t>(sym_hi) % 16 == 0;
  if (vec && batch >= 1 && batch <= kMaxBatch && nseg <= w &&
      nseg <= q_stride) {
    if (n == 0) return (int)cudaGetLastError();
    const int* lo = static_cast<const int*>(sym_lo);
    const int* hi = static_cast<const int*>(sym_hi);
    const float* bp = static_cast<const float*>(breakpoints);
    const float* ql = static_cast<const float*>(q_lo);
    const float* qh = static_cast<const float*>(q_hi);
    const bool* v = static_cast<const bool*>(valid);
    float* o = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch ((nseg + 3) / 4) {
      case 1: return dispatch_batch<1>(batch, lo, hi, bp, card, ql, qh,
                                       q_stride, v, o, n, w, nseg, seg_len,
                                       st);
      case 2: return dispatch_batch<2>(batch, lo, hi, bp, card, ql, qh,
                                       q_stride, v, o, n, w, nseg, seg_len,
                                       st);
      case 3: return dispatch_batch<3>(batch, lo, hi, bp, card, ql, qh,
                                       q_stride, v, o, n, w, nseg, seg_len,
                                       st);
      default: return dispatch_batch<4>(batch, lo, hi, bp, card, ql, qh,
                                        q_stride, v, o, n, w, nseg, seg_len,
                                        st);
    }
  }
  return launch<true>(sym_lo, sym_hi, static_cast<const float*>(breakpoints),
                      card, static_cast<const float*>(q_lo),
                      static_cast<const float*>(q_hi), q_stride,
                      static_cast<const bool*>(valid),
                      static_cast<float*>(out), n, w, nseg, batch, seg_len,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int ulisse_mindist_paa(const void* e_lo, const void* e_hi,
                                  const void* q_lo, const void* q_hi,
                                  int q_stride, const void* valid, void* out,
                                  long long n, int w, int nseg, int batch,
                                  float seg_len, void* stream) {
  return launch<false>(e_lo, e_hi, nullptr, 0,
                       static_cast<const float*>(q_lo),
                       static_cast<const float*>(q_hi), q_stride,
                       static_cast<const bool*>(valid),
                       static_cast<float*>(out), n, w, nseg, batch, seg_len,
                       static_cast<cudaStream_t>(stream));
}
