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
// envelope's values read once into registers segment by segment and
// applied to every query of the batch (up to kMaxBatch per launch; the
// wrapper splits larger batches), coalesced (B, N) stores.  Sums are
// taken in segment order without fused multiply-adds, as the plain
// version writes them.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBatch = 8;

template <bool kSym>
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
  float* sq_lo = smem;                       // [batch * nseg]
  float* sq_hi = sq_lo + batch * nseg;       // [batch * nseg]
  float* beta_lo = sq_hi + batch * nseg;     // [card] (symbol entry only)
  float* beta_hi = beta_lo + card;           // [card]
  for (int i = threadIdx.x; i < batch * nseg; i += blockDim.x) {
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
        float gap = fmaxf(fmaxf(__fsub_rn(elo, sq_hi[b * nseg + s]),
                                __fsub_rn(sq_lo[b * nseg + s], ehi)),
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

template <bool kSym>
int launch(const void* lo, const void* hi, const float* breakpoints,
           int card, const float* q_lo, const float* q_hi, int q_stride,
           const bool* valid, float* out, long long n, int w, int nseg,
           int batch, float seg_len, cudaStream_t stream) {
  if (batch < 1 || batch > kMaxBatch || nseg < 0 || nseg > w ||
      nseg > q_stride)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(float) * (2 * batch * nseg + (kSym ? 2 * card : 0));
  const long long blocks = (n + kThreads - 1) / kThreads;
  mindist_kernel<kSym><<<(unsigned)blocks, kThreads, smem, stream>>>(
      lo, hi, breakpoints, card, q_lo, q_hi, q_stride, valid, out, n, w,
      nseg, batch, seg_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ulisse_mindist_sym(const void* sym_lo, const void* sym_hi,
                                  const void* breakpoints, int card,
                                  const void* q_lo, const void* q_hi,
                                  int q_stride, const void* valid, void* out,
                                  long long n, int w, int nseg, int batch,
                                  float seg_len, void* stream) {
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
