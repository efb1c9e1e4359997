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
// Two build kernels, picked by the host's plan
// (kernels/envelope.py::envelope_plan):
//   * the one-pass kernel, for w <= kZ = 16 segments (it replaced a
//     thread per (master, segment) walking the lengths, with two IEEE
//     divides a (master, l') and one a cell, whose lanes idled where
//     their valid lengths ended): a block of kBuildThreads per envelope
//     stages its span of both prefix sums, the segment means of its
//     masters and a table of 1 / l' and of the segments l' covers; a warp
//     takes a master at a time (masters warp, warp + 4, ...), its w
//     segment means in registers, and its lanes take 32 consecutive
//     lengths: each lane computes (mu, sigma, 1 / sigma) of its (master,
//     l') once and then its cells, keeping a running (lo, hi) of every
//     segment in registers.  The lanes past the master's last valid
//     length repeat its last length (a duplicate of a valid cell leaves a
//     min and a max unchanged), so no lane needs a mask; the segments no
//     lane's length covers are skipped by a warp-uniform jump (switch on
//     the warp's largest count), the others take one predicate.  The
//     block reduces its 128 lanes' (lo, hi) through a padded table.  The
//     staging grows with lmax and the length range (2 (g + lmax) + 2
//     (lmax - lmin + 1) floats beside the g kZ means and the reduction):
//     past the card's 227 KB it runs unstaged (kStaged = false), reading
//     the prefix sums in place and computing 1 / l', the segment counts
//     and the means where it needs them, with the same IEEE operations in
//     the same order (at 20,480 masters an envelope, 16 segments, it
//     beat every slab plan timed by 2x).  Past 16 segments it makes w /
//     16 passes, each of which recomputes every (master, l')'s statistics and reduces its
//     block through shared memory (at 1,875 segments 118 passes, ~70
//     issue slots a pair for 16 cells of ~6): the plan takes the slab
//     kernel there, and only a forced plan runs these passes;
//   * the slab kernel, for any w.  A thread owns a slab of kSlabZ = 8
//     consecutive segments (lo, hi and the master's segment means in
//     registers); a block's nslab slabs cover 8 nslab segments (grid y
//     takes further groups of them) and its nph phases split the lengths
//     (thread = phase nslab + slab).  The block walks tiles of `tile`
//     lengths and, within a tile, the masters: it computes each (master,
//     l')'s (mu, sigma, 1 / sigma) once, a length a thread, into a
//     double-buffered shared tile beside its length's segment count (1 /
//     l' and that count from a table made once a tile); each thread then
//     sweeps its phase's lengths of the tile across its slab, the stats
//     one broadcast 16-byte read a length, each of znorm_point's four
//     operations across the slab before the next (8 independent chains a
//     lane).  Lengths where a warp's slabs are all fully valid run
//     unmasked; the others mask a cell by the segment count, and lengths
//     before any of the warp's slabs is valid are skipped (the bounds
//     come from l' >= (z + 1) s, a few integer operations a (tile,
//     master)).  Blocks run heaviest first (envelope-major: the
//     envelopes near a series' end have fewer valid lengths).  No
//     reduction runs until the end, where the phases of a slab meet in
//     shared memory.  Prefix sums are read in place (a pair reads two
//     words of each; a tile's are consecutive), so nothing is staged and
//     the same kernel serves any lmax.  The floor is the cells' own
//     issue: each is the subtract, multiply and two FMAs of znorm_point,
//     a min and a max; 8 segments a thread beat 12 and 16 on the card
//     (registers, so warps, over fewer stats reads a cell), and past 32
//     segments the slab kernel beat the one-pass kernel's passes.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "znorm.cuh"

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kSmemLimit = 227 * 1024;   // opt-in dynamic shared memory
constexpr int kBuildThreads = 128;       // one-pass kernel: 4 warps
constexpr int kZ = 16;                   // one-pass kernel: segments a lane
constexpr int kSlabZ = 8;                // slab kernel: segments a thread
constexpr int kSlabMaxWarps = 8;         // slab kernel: warps a block
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

// (mu, sigma, 1 / sigma) of the window of length lp at master j
// (relative to the prefix-sum pointers; c0, c20 = cs[j], cs2[j]), from
// ylp = RN(1 / lp): both build kernels' statistics of a (master, l')
__device__ __forceinline__ float3 pair_stats(const float* cs,
                                             const float* cs2, int j,
                                             float c0, float c20, int lp,
                                             float ylp) {
  const float lpf = (float)lp;
  const float mu = div_by(__fsub_rn(cs[j + lp], c0), lpf, ylp);
  const float m2 = div_by(__fsub_rn(cs2[j + lp], c20), lpf, ylp);
  const float var = fmaxf(__fsub_rn(m2, __fmul_rn(mu, mu)), 0.f);
  const float sigma = fmaxf(__fsqrt_rn(var), 1e-8f);
  return make_float3(mu, sigma, __frcp_rn(sigma));
}

// segment z's mean of master j (relative to the anchor a); a segment
// past w or past the series end is in no valid cell: never read
__device__ __forceinline__ float segment_mean(const float* cs, int a, int j,
                                              int z, int n, int w,
                                              int seg_len, float seg_f,
                                              float seg_y) {
  if (z >= w) return 0.f;
  const int end = j + (z + 1) * seg_len;
  return a + end <= n
      ? div_by(__fsub_rn(cs[end], cs[end - seg_len]), seg_f, seg_y)
      : 0.f;
}

// shared floats of one one-pass block: two prefix-sum spans, kZ segment
// means per master, the 1 / l' and segment-count tables, the reduction
size_t build_smem_floats(int span, int g, int n_len) {
  return 2 * (size_t)span + (size_t)g * kZ + 2 * (size_t)n_len +
         (size_t)kBuildThreads * (2 * kZ + 1);
}

// shared floats of one unstaged one-pass block: the reduction
size_t unstaged_smem_floats() {
  return (size_t)kBuildThreads * (2 * kZ + 1);
}

// shared bytes of one slab block: two stats tiles and the length table,
// or (at the end) every lane's padded (lo, hi)
size_t slab_smem_bytes(int tile, int threads) {
  const size_t tiles = (size_t)tile * (2 * sizeof(float4) + sizeof(float2));
  const size_t red = (size_t)2 * threads * (kSlabZ + 1) * sizeof(float);
  return tiles > red ? tiles : red;
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

// ceil(x / d) for x > 0, else 0
__device__ __forceinline__ int steps_to(int x, int d) {
  return x > 0 ? (x + d - 1) / d : 0;
}

// A lane's cells of one length: znorm_point of each of its slab's
// segment means under s = (mu, sigma, 1 / sigma), folded into lo / hi
// where q < zc.  Each of znorm_point's four operations runs across the
// slab before the next (the same operations on each cell), so that a
// warp has kSlabZ independent chains in flight; one cell after another
// left ptxas a single chain of dependent operations.
__device__ __forceinline__ void slab_cells(const float (&sm)[kSlabZ],
                                           const float4 s, int zc,
                                           float (&lo)[kSlabZ],
                                           float (&hi)[kSlabZ]) {
  float a[kSlabZ], q0[kSlabZ];
#pragma unroll
  for (int q = 0; q < kSlabZ; ++q) a[q] = __fsub_rn(sm[q], s.x);
#pragma unroll
  for (int q = 0; q < kSlabZ; ++q) q0[q] = __fmul_rn(a[q], s.z);
#pragma unroll
  for (int q = 0; q < kSlabZ; ++q) a[q] = __fmaf_rn(-q0[q], s.y, a[q]);
#pragma unroll
  for (int q = 0; q < kSlabZ; ++q) {
    const float v = __fmaf_rn(a[q], s.z, q0[q]);
    if (q < zc) {
      lo[q] = fminf(lo[q], v);
      hi[q] = fmaxf(hi[q], v);
    }
  }
}

// One warp's sweep of a stats tile across its lanes' slabs: lengths
// i = ph + k nph < tn of the tile (k < the lane's steps).
__device__ __forceinline__ void slab_sweep(const float4* __restrict__ st,
                                           int tn, int ph, int nph,
                                           bool active, int zbase,
                                           int rel_any, int rel_full,
                                           const float (&sm)[kSlabZ],
                                           float (&lo)[kSlabZ],
                                           float (&hi)[kSlabZ]) {
  // the lane's steps, the first with a valid cell, the first with all
  // its cells valid (an idle lane: neutral in every bound)
  const int steps = active ? steps_to(tn - ph, nph) : 0;
  const int k_any = active ? steps_to(rel_any - ph, nph) : INT_MAX;
  const int k_full = active ? steps_to(rel_full - ph, nph) : 0;
  const int k_a = __reduce_min_sync(kFull, k_any);
  const int k_t = __reduce_max_sync(kFull, steps);
  // [k_f, k_e): every lane in range and all its cells valid
  const int k_f = max(__reduce_max_sync(kFull, k_full), k_a);
  const int k_e = max(__reduce_min_sync(kFull, active ? steps : INT_MAX),
                      k_f);
  // masked steps: a cell counts where its segment is covered by l' and
  // the lane's length lies in the tile
  auto masked = [&](int k0, int k1) {
    for (int k = k0; k < k1; ++k) {
      const int i = ph + k * nph;
      const float4 s = st[min(i, tn - 1)];
      const int zc = min(max(__float_as_int(s.w) - zbase, 0), kSlabZ);
      slab_cells(sm, s, i < tn ? zc : 0, lo, hi);
    }
  };
  masked(k_a, min(k_f, k_t));
  for (int k = k_f; k < k_e; ++k)
    slab_cells(sm, st[ph + k * nph], kSlabZ, lo, hi);
  masked(max(k_e, k_f), k_t);
}

// The slab kernel (any w): grid (envelopes, segment groups), envelope-
// major; thread tid = phase nslab + slab, slab s of group y owning
// segments (y nslab + s) kSlabZ + q, q < kSlabZ (a slab from w on, or a
// thread past nph phases, idles).
__global__ void __launch_bounds__(kSlabMaxWarps * 32)
    envelope_slab_kernel(const float* __restrict__ csum,
                         const float* __restrict__ csum2,
                         float* __restrict__ lo_out,
                         float* __restrict__ hi_out, int n, int n_env,
                         int num_series, int lmin, int lmax, int g,
                         int seg_len, int w, int tile, int nslab, int nph) {
  extern __shared__ float4 sh[];
  float2* tab = reinterpret_cast<float2*>(sh + 2 * tile);  // (1 / l', l' / s)
  const int n_len = lmax - lmin + 1;
  const int series = (int)(blockIdx.x % (unsigned)num_series);
  const int e = (int)(blockIdx.x / (unsigned)num_series);
  const long long env = (long long)series * n_env + e;
  const int a = e * g;
  const float* cs = csum + (long long)series * (n + 1) + a;
  const float* cs2 = csum2 + (long long)series * (n + 1) + a;
  const int tid = threadIdx.x;
  const int slab = tid % nslab;
  const int zbase = (blockIdx.y * nslab + slab) * kSlabZ;
  const bool active = tid / nslab < nph && zbase < w;
  const int ph = active ? tid / nslab : 0;
  // the first lengths at which the slab has a valid cell and all its
  // (< w) cells valid
  const int l_any = (zbase + 1) * seg_len;
  const int l_full = min(zbase + kSlabZ, w) * seg_len;
  const float seg_f = (float)seg_len;
  const float seg_y = __frcp_rn(seg_f);
  float lo[kSlabZ], hi[kSlabZ], sm[kSlabZ];
#pragma unroll
  for (int q = 0; q < kSlabZ; ++q) {
    lo[q] = INFINITY;
    hi[q] = -INFINITY;
  }
  // master 0 has the most valid lengths (at least one: e < n_env)
  const int c_first = min(n_len, n - a - lmin + 1);
  for (int t0 = 0; t0 < c_first; t0 += tile) {
    for (int i = tid; i < min(tile, c_first - t0); i += blockDim.x) {
      const int lp = lmin + t0 + i;
      tab[i] = make_float2(__frcp_rn((float)lp),
                           __int_as_float(lp / seg_len));
    }
    __syncthreads();                     // the table written, sweeps done
    for (int j = 0; j < g; ++j) {
      // master j's valid lengths t < cj fall with j: block-uniform
      const int cj = min(n_len, n - a - j - lmin + 1);
      if (cj <= t0) break;
      const int tn = min(tile, cj - t0);
      float4* st = sh + (j & 1) * tile;   // master j - 1's may be in use
      // the slab's means first: their loads fly while the stats compute
#pragma unroll
      for (int q = 0; q < kSlabZ; ++q)
        sm[q] = segment_mean(cs, a, j, zbase + q, n, w, seg_len, seg_f,
                             seg_y);
      const float c0 = cs[j], c20 = cs2[j];
      for (int i = tid; i < tn; i += blockDim.x) {
        const float2 tb = tab[i];
        const float3 p = pair_stats(cs, cs2, j, c0, c20, lmin + t0 + i,
                                    tb.x);
        st[i] = make_float4(p.x, p.y, p.z, tb.y);
      }
      __syncthreads();                   // master j's stats written
      slab_sweep(st, tn, ph, nph, active, zbase, l_any - lmin - t0,
                 l_full - lmin - t0, sm, lo, hi);
    }
  }
  __syncthreads();                       // every sweep done
  // the phases of a slab meet: a padded row of (lo, hi) a phase
  float* red = reinterpret_cast<float*>(sh);
  const int stride = nslab * (kSlabZ + 1);
  if (active) {
    float* rl = red + 2 * ph * stride + slab * (kSlabZ + 1);
#pragma unroll
    for (int q = 0; q < kSlabZ; ++q) {
      rl[q] = lo[q];
      rl[stride + q] = hi[q];
    }
  }
  __syncthreads();
  const int z0 = blockIdx.y * nslab * kSlabZ;
  for (int q = tid; q < nslab * kSlabZ && z0 + q < w; q += blockDim.x) {
    const int at = (q / kSlabZ) * (kSlabZ + 1) + q % kSlabZ;
    float l = INFINITY, h = -INFINITY;
    for (int p = 0; p < nph; ++p) {
      l = fminf(l, red[2 * p * stride + at]);
      h = fmaxf(h, red[(2 * p + 1) * stride + at]);
    }
    if (l > h) {                         // no cell touched the segment
      l = -INFINITY;
      h = INFINITY;
    }
    lo_out[env * w + z0 + q] = l;
    hi_out[env * w + z0 + q] = h;
  }
}

int launch_slab(const float* csum, const float* csum2, float* lo, float* hi,
                long long num_series, int n, int n_env, int lmin, int lmax,
                int g, int seg_len, int w, int tile, int warps,
                cudaStream_t stream) {
  // slab slots a phase: the slabs, past a warp's 32 rounded up to whole
  // warps (so that a warp holds one phase); at most the block's threads
  const int threads = warps * 32;
  const int slabs = (w + kSlabZ - 1) / kSlabZ;
  const int nslab = min(slabs <= 32 ? slabs : (slabs + 31) / 32 * 32,
                        threads);
  const int nph = threads / nslab;
  const long long groups = (slabs + nslab - 1) / nslab;
  const size_t smem = slab_smem_bytes(tile, threads);
  if (groups > 65535 || smem > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        envelope_slab_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  envelope_slab_kernel
      <<<dim3((unsigned)(num_series * n_env), (unsigned)groups), threads,
         smem, stream>>>(csum, csum2, lo, hi, n, n_env, (int)num_series,
                         lmin, lmax, g, seg_len, w, tile, nslab, nph);
  return (int)cudaGetLastError();
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

// The build, by the plan (kind, tile, warps): kind 0 the one-pass kernel
// (passes of 16 segments, 4 warps; tile 0), kind 1 the slab kernel
// (`tile` lengths a tile, 1-8 warps a block).  A plan the kernels do not
// take returns cudaErrorInvalidValue.
extern "C" int ulisse_envelope_znorm(const void* csum, const void* csum2,
                                     void* lo, void* hi, long long num_series,
                                     int n, int n_env, int lmin, int lmax,
                                     int gamma, int seg_len, int kind,
                                     int tile, int warps, void* stream) {
  const int g = gamma + 1;
  const int w = lmax / seg_len;
  const long long blocks = num_series * n_env;
  if (num_series < 1 || n_env < 1 || gamma < 0 || seg_len < 1 || w < 1 ||
      lmin < seg_len || lmin > lmax || lmin > n || blocks > 0x7fffffffLL ||
      (long long)(n_env - 1) * g + lmin > n)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cs = static_cast<const float*>(csum);
  const float* cs2 = static_cast<const float*>(csum2);
  float* lo_f = static_cast<float*>(lo);
  float* hi_f = static_cast<float*>(hi);
  if (kind == 1) {
    if (tile < 1 || warps < 1 || warps > kSlabMaxWarps)
      return (int)cudaErrorInvalidValue;
    return launch_slab(cs, cs2, lo_f, hi_f, num_series, n, n_env, lmin, lmax,
                       g, seg_len, w, tile, warps, st);
  }
  if (kind != 0 || tile != 0 || warps != kBuildThreads / 32)
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
  kernel<<<(unsigned)blocks, kBuildThreads, smem, st>>>(
      cs, cs2, lo_f, hi_f, n, n_env, lmin, lmax, g, seg_len, w, span);
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
