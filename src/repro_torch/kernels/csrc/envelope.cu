// Z-normalized ULISSE envelopes (paper Alg. 2), for Hopper.
//
// Replaces repro/kernels/envelope.py::envelope_znorm_pallas (Pallas body
// _envelope_kernel), the streamed form of the length loop of the JAX
// build (repro/core/envelope.py::build_envelopes_znorm).  For every master
// offset o and length l' in [lmin, lmax] the normalized PAA value of
// segment z is
//     v(o, l', z) = (segsum(o, z) / s - mu(o, l')) / sigma(o, l')
// over the cells with (z+1) * s <= l' and o + l' <= n (these imply that
// the master and the segment lie inside the series), min/max-reduced.
// Two entries over the same arithmetic:
//   ulisse_envelope_znorm          the index build: from the float32
//       prefix sums (S, n+1) of the centered series and of their squares,
//       one block per envelope writes its finished (lo, hi) (w,) — the
//       min/max over its g = gamma + 1 masters and every length, -inf /
//       +inf where no cell touched a segment.  The (S, n_env, g, w) grid
//       of masters and the (lengths, masters) window sums never exist in
//       device memory (at 1M series x 256 each (L, M) operand of the TPU
//       kernel would be ~38 GB);
//   ulisse_envelope_znorm_masters  the TPU kernel's own contract: per
//       master (M, w) bounds from (segmean, s1, s2, offsets), +/-3e38
//       where no cell is valid.
// Arithmetic is the JAX build's, not the Pallas kernel's s1 * (1/l'):
// IEEE divisions (__fdiv_rn) for segsum / s, s1 / l' and s2 / l';
// s2 / l' - mu * mu with __fmul_rn / __fsub_rn so that nvcc cannot
// contract it into an FMA; a correctly rounded square root clamped at
// 1e-8; (segmean - mu) / sigma as __fsub_rn then __fdiv_rn.  The kernel
// therefore gives the bits of the plain PyTorch version
// (kernels/ref.py::envelope_znorm_ref) from the same prefix sums, on the
// card and on the CPU.
// Bound on the card: operations.  At the bench parameters (n = 256,
// lmin 160, lmax 256, s = 16, gamma 48) an envelope reads ~2.4 KB of
// prefix sums and does ~27k valid (master, l', segment) cells of a
// subtract, an IEEE divide, a min and a max.
// Design: a block stages its span of both prefix sums (gamma + lmax + 1
// values each) in shared memory, then walks the lengths in tiles: first
// (mu, sigma) for every (master, length) of the tile into shared memory,
// then every (master, segment) pair runs over the lengths of the tile
// for which its cell is valid — a contiguous range, so no per-cell
// branch — keeping its (lo, hi) in shared memory.  A final pass reduces
// the masters of each segment.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kMaxTile = 64;             // lengths per tile
constexpr int kSmemLimit = 227 * 1024;   // opt-in dynamic shared memory

__device__ __forceinline__ void window_stats(float s1, float s2, float lp,
                                             float* mu, float* sigma) {
  const float m = __fdiv_rn(s1, lp);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, lp), __fmul_rn(m, m)), 0.f);
  *mu = m;
  *sigma = fmaxf(__fsqrt_rn(var), 1e-8f);
}

__device__ __forceinline__ float znorm_value(float segmean, float mu,
                                             float sigma) {
  return __fdiv_rn(__fsub_rn(segmean, mu), sigma);
}

// shared floats of one build block: two prefix-sum spans, segmean and the
// (lo, hi) accumulators of every (master, segment), (mu, sigma) of a tile
size_t build_smem_floats(int span, int g, int w, int tile) {
  return 2 * (size_t)span + 3 * (size_t)g * w + 2 * (size_t)g * tile;
}

__global__ void envelope_build_kernel(
    const float* __restrict__ csum, const float* __restrict__ csum2,
    float* __restrict__ lo_out, float* __restrict__ hi_out, int n, int n_env,
    int lmin, int lmax, int g, int seg_len, int w, int span, int tile) {
  extern __shared__ float smem[];
  float* cs = smem;                       // [span] csum[a .. a + span)
  float* cs2 = cs + span;                 // [span]
  float* segmean = cs2 + span;            // [g * w]
  float* acc_lo = segmean + g * w;        // [g * w]
  float* acc_hi = acc_lo + g * w;         // [g * w]
  float* mu_s = acc_hi + g * w;           // [g * tile]
  float* sg_s = mu_s + g * tile;          // [g * tile]

  const long long env = blockIdx.x;       // series-major: s * n_env + e
  const long long series = env / n_env;
  const int a = (int)(env - series * n_env) * g;
  const float* row = csum + series * (n + 1);
  const float* row2 = csum2 + series * (n + 1);
  const int have = min(span, n + 1 - a);  // prefix positions a .. n
  for (int t = threadIdx.x; t < have; t += blockDim.x) {
    cs[t] = row[a + t];
    cs2[t] = row2[a + t];
  }
  __syncthreads();
  const int pairs = g * w;
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const int j = p / w, z = p - (p / w) * w;
    const int end = j + (z + 1) * seg_len;         // relative to a
    // a segment past the series end is in no valid cell: never read
    segmean[p] = a + end <= n
        ? __fdiv_rn(__fsub_rn(cs[end], cs[end - seg_len]), (float)seg_len)
        : 0.f;
    acc_lo[p] = INFINITY;
    acc_hi[p] = -INFINITY;
  }
  const int n_len = lmax - lmin + 1;
  for (int t0 = 0; t0 < n_len; t0 += tile) {
    const int tn = min(tile, n_len - t0);
    __syncthreads();                     // the previous tile is consumed
    for (int p = threadIdx.x; p < g * tn; p += blockDim.x) {
      const int j = p / tn, t = p - (p / tn) * tn;
      const int lp = lmin + t0 + t;
      if (a + j + lp <= n) {
        window_stats(__fsub_rn(cs[j + lp], cs[j]),
                     __fsub_rn(cs2[j + lp], cs2[j]), (float)lp,
                     &mu_s[j * tile + t], &sg_s[j * tile + t]);
      }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int j = p / w, z = p - (p / w) * w;
      // valid lengths: (z+1) * s <= l' and a + j + l' <= n
      const int first = max(t0, (z + 1) * seg_len - lmin);
      const int last = min(t0 + tn - 1, n - a - j - lmin);
      if (first > last) continue;
      const float sm = segmean[p];
      float lo = acc_lo[p], hi = acc_hi[p];
      for (int t = first - t0; t <= last - t0; ++t) {
        const float v = znorm_value(sm, mu_s[j * tile + t],
                                    sg_s[j * tile + t]);
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
      acc_lo[p] = lo;
      acc_hi[p] = hi;
    }
  }
  __syncthreads();
  for (int z = threadIdx.x; z < w; z += blockDim.x) {
    float lo = INFINITY, hi = -INFINITY;
    for (int j = 0; j < g; ++j) {
      lo = fminf(lo, acc_lo[j * w + z]);
      hi = fmaxf(hi, acc_hi[j * w + z]);
    }
    if (lo > hi) {                       // no cell touched the segment
      lo = -INFINITY;
      hi = INFINITY;
    }
    lo_out[env * w + z] = lo;
    hi_out[env * w + z] = hi;
  }
}

// One thread per (master, segment): the lengths in order, (mu, sigma)
// recomputed per segment (the contract's entry, off the build path).
__global__ void envelope_masters_kernel(
    const float* __restrict__ segmean, const float* __restrict__ s1,
    const float* __restrict__ s2, const int* __restrict__ offsets,
    float* __restrict__ lo_out, float* __restrict__ hi_out, long long m,
    int w, int n_len, int n, int lmin, int seg_len) {
  const long long pairs = m * w;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < pairs; p += (long long)gridDim.x * blockDim.x) {
    const long long mi = p / w;
    const int z = (int)(p - mi * w);
    const int off = offsets[mi];
    const float sm = segmean[p];
    float lo = kBig, hi = -kBig;
    for (int t = 0; t < n_len; ++t) {
      const int lp = lmin + t;
      if ((z + 1) * seg_len > lp || (long long)off + lp > n) continue;
      float mu, sigma;
      window_stats(s1[mi * n_len + t], s2[mi * n_len + t], (float)lp, &mu,
                   &sigma);
      const float v = znorm_value(sm, mu, sigma);
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
    lo_out[p] = lo;
    hi_out[p] = hi;
  }
}

}  // namespace

extern "C" int ulisse_envelope_znorm(const void* csum, const void* csum2,
                                     void* lo, void* hi, long long num_series,
                                     int n, int n_env, int lmin, int lmax,
                                     int gamma, int seg_len, void* stream) {
  const int g = gamma + 1;
  const int w = lmax / seg_len;
  const long long blocks = num_series * n_env;
  if (num_series < 1 || n_env < 1 || gamma < 0 || seg_len < 1 || w < 1 ||
      lmin < seg_len || lmin > lmax || lmin > n || blocks > 0x7fffffffLL ||
      (long long)(n_env - 1) * g + lmin > n)
    return (int)cudaErrorInvalidValue;
  const int span = g + lmax;             // prefix positions a .. a+g-1+lmax
  int tile = min(kMaxTile, lmax - lmin + 1);
  while (tile > 1 && build_smem_floats(span, g, w, tile) * 4 > kSmemLimit)
    tile /= 2;
  const size_t smem = build_smem_floats(span, g, w, tile) * 4;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        envelope_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // one thread per (master, segment) pair, in whole warps
  int threads = ((g * w + 31) / 32) * 32;
  threads = threads < 128 ? 128 : (threads > 1024 ? 1024 : threads);
  envelope_build_kernel<<<(unsigned)blocks, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(csum), static_cast<const float*>(csum2),
      static_cast<float*>(lo), static_cast<float*>(hi), n, n_env, lmin, lmax,
      g, seg_len, w, span, tile);
  return (int)cudaGetLastError();
}

extern "C" int ulisse_envelope_znorm_masters(
    const void* segmean, const void* s1, const void* s2, const void* offsets,
    void* lo, void* hi, long long m, int w, int n_len, int n, int lmin,
    int seg_len, void* stream) {
  if (m < 1 || w < 1 || n_len < 1 || seg_len < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (m * w + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;
  envelope_masters_kernel<<<(unsigned)blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(segmean), static_cast<const float*>(s1),
      static_cast<const float*>(s2), static_cast<const int*>(offsets),
      static_cast<float*>(lo), static_cast<float*>(hi), m, w, n_len, n, lmin,
      seg_len);
  return (int)cudaGetLastError();
}
