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
// correctly rounded quotients for segsum / s, s1 / l' and s2 / l';
// s2 / l' - mu * mu with __fmul_rn / __fsub_rn so that nvcc cannot
// contract it into an FMA; a correctly rounded square root clamped at
// 1e-8; (segmean - mu) / sigma as a subtract then a correctly rounded
// quotient.  The kernel therefore gives the bits of the plain PyTorch
// version (kernels/ref.py::envelope_znorm_ref) from the same prefix
// sums, on the card and on the CPU.  The per-master entry divides with
// __fdiv_rn; the build entry takes every quotient from one reciprocal of
// its divisor by Markstein's correction (znorm.cuh: RN(q0 + rho y) with
// y = RN(1 / d), q0 = RN(a y), rho = a - q0 d exact in one FMA), which is
// the IEEE quotient bit for bit away from under- and overflow and from
// a numerator of -0 (a prefix sum of -0, which centred data never gives).
// Bound on the card: operations.  At the bench parameters (n = 256,
// lmin 160, lmax 256, s = 16, gamma 48) a series holds 97 x 98 / 2 valid
// (master, l') pairs — each a square root, a reciprocal and two
// quotients — and ~54,600 valid (master, l', segment) cells — each a
// subtract, a multiply, two FMAs, a min and a max — against ~2 KB of
// prefix sums read.
// Design of the build entry (it replaced a thread per (master, segment)
// walking the lengths, with two IEEE divides a (master, l') and one a
// cell, whose lanes idled where their valid lengths ended):
//   * a block of kBuildThreads per envelope stages its span of both
//     prefix sums, the segment means of its masters (for kZ segments at
//     a time), and a table of 1 / l' and of the segments l' covers;
//   * a warp takes a master at a time (masters warp, warp + 4, ...), its
//     kZ segment means in registers, and its lanes take 32 consecutive
//     lengths: each lane computes (mu, sigma, 1 / sigma) of its (master,
//     l') once and then its cells, keeping a running (lo, hi) of every
//     segment in registers.  The lanes past the master's last valid
//     length repeat its last length (a duplicate of a valid cell leaves
//     a min and a max unchanged), so no lane needs a mask; the segments
//     no lane's length covers are skipped by a warp-uniform jump
//     (switch on the warp's largest count), the others take one
//     predicate;
//   * the block reduces its 128 lanes' (lo, hi) through shared memory:
//     lanes write their 2 kZ values to a padded table, 32 threads read a
//     column each.
// The staging grows with lmax and the length range (2 (g + lmax) + 2
// (lmax - lmin + 1) floats beside the g kZ means and the reduction): past
// the card's 227 KB (lmax ~26,500 at lmin ~ lmax, ~13,000 over a range of
// 13,000 lengths at g = 49) the same kernel runs unstaged (kStaged =
// false): it reads the prefix sums in place from device memory (a warp's
// lanes read consecutive words; the span is L2-resident), computes 1 / l'
// and the segment count of each length where it needs them, and each
// warp its master's kZ segment means, with the same IEEE operations in
// the same order, so both give the same bits; only the reduction table
// stays in shared memory.
#include <cuda_runtime.h>
#include <math.h>

#include "znorm.cuh"

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kSmemLimit = 227 * 1024;   // opt-in dynamic shared memory
constexpr int kBuildThreads = 128;       // build entry: 4 warps an envelope
constexpr int kZ = 16;                   // segments a pass keeps in registers
constexpr unsigned kFull = 0xffffffffu;

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

// x / d from y = RN(1 / d): the correctly rounded quotient (znorm.cuh).
__device__ __forceinline__ float div_by(float x, float d, float y) {
  return znorm_point(x, 0.f, d, y);
}

// shared floats of one build block: two prefix-sum spans, kZ segment
// means per master, the 1 / l' and segment-count tables, the reduction
size_t build_smem_floats(int span, int g, int n_len) {
  return 2 * (size_t)span + (size_t)g * kZ + 2 * (size_t)n_len +
         (size_t)kBuildThreads * (2 * kZ + 1);
}

// shared floats of one unstaged build block: the reduction
size_t unstaged_smem_floats() {
  return (size_t)kBuildThreads * (2 * kZ + 1);
}

// kStaged: the prefix-sum span, the segment means and the length tables
// in shared memory (else read or computed in place; the same bits).
template <bool kStaged>
__global__ void __launch_bounds__(kBuildThreads)
    envelope_build_kernel(const float* __restrict__ csum,
                          const float* __restrict__ csum2,
                          float* __restrict__ lo_out,
                          float* __restrict__ hi_out, int n, int n_env,
                          int lmin, int lmax, int g, int seg_len, int w,
                          int span) {
  extern __shared__ float smem[];
  const int n_len = lmax - lmin + 1;
  const long long env = blockIdx.x;       // series-major: s * n_env + e
  const long long series = env / n_env;
  const int a = (int)(env - series * n_env) * g;
  const float* row = csum + series * (n + 1);
  const float* row2 = csum2 + series * (n + 1);
  // prefix sums relative to a: staged copies, or the rows in place
  const float* cs = row + a;
  const float* cs2 = row2 + a;
  float* seg = nullptr;                   // [g * kZ] a pass's segment means
  float* rcp = nullptr;                   // [n_len] RN(1 / l')
  int* nseg = nullptr;                    // [n_len] l' / s
  float* red = smem;                      // [threads * (2 kZ + 1)]
  if (kStaged) {
    float* cs_s = smem;                   // [span] csum[a .. a + span)
    float* cs2_s = cs_s + span;           // [span]
    seg = cs2_s + span;
    rcp = seg + g * kZ;
    nseg = reinterpret_cast<int*>(rcp + n_len);
    red = rcp + 2 * n_len;
    const int have = min(span, n + 1 - a);  // prefix positions a .. n
    for (int t = threadIdx.x; t < have; t += blockDim.x) {
      cs_s[t] = row[a + t];
      cs2_s[t] = row2[a + t];
    }
    for (int t = threadIdx.x; t < n_len; t += blockDim.x) {
      rcp[t] = __frcp_rn((float)(lmin + t));
      nseg[t] = (lmin + t) / seg_len;
    }
    cs = cs_s;
    cs2 = cs2_s;
  }
  const float seg_f = (float)seg_len;
  const float seg_y = __frcp_rn(seg_f);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  // segment z's mean of master j (relative to a); a segment past the
  // series end is in no valid cell: never read
  auto seg_mean = [&](int j, int z) {
    const int end = j + (z + 1) * seg_len;
    return z < w && a + end <= n
        ? div_by(__fsub_rn(cs[end], cs[end - seg_len]), seg_f, seg_y)
        : 0.f;
  };

  for (int z0 = 0; z0 < w; z0 += kZ) {
    __syncthreads();                     // staging done / last pass read
    if (kStaged) {
      for (int p = threadIdx.x; p < g * kZ; p += blockDim.x)
        seg[p] = seg_mean(p / kZ, z0 + p % kZ);
      __syncthreads();
    }
    float lo[kZ], hi[kZ];
#pragma unroll
    for (int z = 0; z < kZ; ++z) {
      lo[z] = INFINITY;
      hi[z] = -INFINITY;
    }
    for (int j = warp; j < g; j += warps) {
      // valid lengths l' = lmin + t, t < cj: a + j + l' <= n; cj falls
      // with j, so this warp's later masters are empty too
      const int cj = min(n_len, n - a - j - lmin + 1);
      if (cj <= 0) break;
      float sm[kZ];
#pragma unroll
      for (int z = 0; z < kZ; ++z)
        sm[z] = kStaged ? seg[j * kZ + z] : seg_mean(j, z0 + z);
      const float c0 = cs[j], c20 = cs2[j];
      for (int t0 = 0; t0 < cj; t0 += 32) {
        const int t = min(t0 + lane, cj - 1);
        const int lp = lmin + t;
        const float lpf = (float)lp;
        const float ylp = kStaged ? rcp[t] : __frcp_rn(lpf);
        const float mu = div_by(__fsub_rn(cs[j + lp], c0), lpf, ylp);
        const float m2 = div_by(__fsub_rn(cs2[j + lp], c20), lpf, ylp);
        const float var = fmaxf(__fsub_rn(m2, __fmul_rn(mu, mu)), 0.f);
        const float sigma = fmaxf(__fsqrt_rn(var), 1e-8f);
        const float y = __frcp_rn(sigma);
        // segments z0 + z covered by l': z < zc
        const int zc = min(max((kStaged ? nseg[t] : lp / seg_len) - z0, 0),
                           kZ);
        const int zmax = __reduce_max_sync(kFull, zc);
#define ENV_CELL(z)                                            \
  case (z) + 1: {                                              \
    const float v = znorm_point(sm[z], mu, sigma, y);          \
    if ((z) < zc) {                                            \
      lo[z] = fminf(lo[z], v);                                 \
      hi[z] = fmaxf(hi[z], v);                                 \
    }                                                          \
  }
        switch (zmax) {                  // warp-uniform; falls through
          ENV_CELL(15) ENV_CELL(14) ENV_CELL(13) ENV_CELL(12)
          ENV_CELL(11) ENV_CELL(10) ENV_CELL(9) ENV_CELL(8)
          ENV_CELL(7) ENV_CELL(6) ENV_CELL(5) ENV_CELL(4)
          ENV_CELL(3) ENV_CELL(2) ENV_CELL(1) ENV_CELL(0)
          default: break;
        }
#undef ENV_CELL
      }
    }
    // the block's min / max of every segment: a padded table, a column
    // a thread
    float* mine = red + threadIdx.x * (2 * kZ + 1);
#pragma unroll
    for (int z = 0; z < kZ; ++z) {
      mine[z] = lo[z];
      mine[kZ + z] = hi[z];
    }
    __syncthreads();
    if (threadIdx.x < 2 * kZ) {
      const int c = threadIdx.x;
      float acc = c < kZ ? INFINITY : -INFINITY;
      for (int r = 0; r < (int)blockDim.x; ++r) {
        const float v = red[r * (2 * kZ + 1) + c];
        acc = c < kZ ? fminf(acc, v) : fmaxf(acc, v);
      }
      float hz = __shfl_down_sync(kFull, acc, kZ);
      if (c < kZ && z0 + c < w) {
        float lz = acc;
        if (lz > hz) {                   // no cell touched the segment
          lz = -INFINITY;
          hz = INFINITY;
        }
        lo_out[env * w + z0 + c] = lz;
        hi_out[env * w + z0 + c] = hz;
      }
    }
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
  const size_t staged = build_smem_floats(span, g, lmax - lmin + 1) * 4;
  const bool stage = staged <= (size_t)kSmemLimit;
  const size_t smem = stage ? staged : unstaged_smem_floats() * 4;
  auto kernel = stage ? envelope_build_kernel<true>
                      : envelope_build_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, kBuildThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(csum), static_cast<const float*>(csum2),
      static_cast<float*>(lo), static_cast<float*>(hi), n, n_env, lmin, lmax,
      g, seg_len, w, span);
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
