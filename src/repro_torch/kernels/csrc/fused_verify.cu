// Fused candidate-window gather + squared ED / LB_Keogh for ULISSE, for
// Hopper.  Two entries over one region gather and one prefix-sum window
// statistic: ulisse_fused_gather_ed and ulisse_fused_gather_lb_keogh.
//
// ulisse_fused_gather_ed
// Replaces repro/kernels/fused_verify.py::fused_gather_ed (Pallas body
// _fused_ed_kernel): the same inputs (the collection's raw data and its
// four hi/lo prefix-sum arrays, per-series centers, (sid, anchor) per
// candidate envelope row, B prepared queries) and the same (B * rows, g)
// float32 output.  Row e = b * rows + r reads the region
// data[sid, anchor : anchor + qlen + g - 1] as ONE flat read clipped to
// the array (a region overrunning its series reads into the next row;
// those windows are garbage and the caller masks them), computes the g
// sliding dots against q_b, and finishes with the dot-product identity
//   znorm: d2 = 2 L - 2 dot / sd,
//   raw:   d2 = wss - 2 dot + sum(q^2),  wss = s2 + 2 c s1 + L c^2,
// window sums from the prefix sums at offsets clipped to [0, n - qlen];
// d2 is clamped at 0.
//
// Bound on the card: bytes at the main path's shapes (regions + the 2g
// prefix-sum positions of each of the four arrays per row, ~12 MB at
// B=8, rows=512, qlen=256, g=49) against ~0.1 GFLOP of float32 dot work.
// Design (simple and exact, not yet fast): one block per (query b, tile
// of kTile envelope rows); q_b and the tile's regions are staged in
// shared memory with coalesced loads; each thread owns kJ consecutive
// offsets of one row and slides over the query kJ points at a time, so
// 2kJ-1 region loads and kJ query loads feed kJ*kJ FMAs.  Neighbouring
// threads own neighbouring rows, and the padded row stride is odd, so
// their shared-memory reads fall in distinct banks.  No tensor cores and
// no TF32: the identity cancels near d = 0, so the dots stay full float32,
// summed in query order for every offset.
//
// ulisse_fused_gather_lb_keogh
// Replaces repro/kernels/fused_verify.py::fused_gather_lb_keogh (Pallas
// body _fused_lb_keogh_kernel): the same gather and window sums, then
//   znorm: mu = s1 / L + center[sid],
//          sd = max(sqrt(max(s2 / L - (s1 / L)^2, 0)), 1e-8),
//   raw:   mu = 0, sd = 1,
//   w_t = (region[j + t] - mu) / sd,
//   lb2 = sum_t max(w_t - hi_t, 0)^2 + max(lo_t - w_t, 0)^2
// against the query's DTW envelope (lo, hi), and writes (lb2, mu, sd),
// each (B * rows, g).  The banded-DP tier (dtw_band.cu) normalizes the
// survivors with these mu and sd, and LB_Keogh <= DTW holds on the card
// only if both kernels see the same normalized values: so w is an IEEE
// subtract then an IEEE divide here and there (no fast math, no
// reciprocal), and s2 / L - mu_c^2 is computed without FMA contraction,
// as the plain version computes it.
// Bound on the card: operations at the main path's shapes (B=8,
// rows=512, qlen=256, g=49: 51M normalized window points, each a
// subtract, a divide and ~6 flops) against ~13 MB of regions, prefix
// sums and outputs.  Design (simple, not yet fast): one block per
// (query b, tile of rows); the envelope and the tile's regions staged in
// shared memory; each thread owns one window offset j of one row, with
// neighbouring threads on neighbouring offsets (coalesced prefix-sum
// reads and output stores), and sums its window in query order.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kJ = 4;           // offsets per thread
constexpr int kMaxThreads = 512;
constexpr int kSmemBudget = 48 * 1024;

// Stage the regions of rows [r0, r0 + tile) of query b into reg_s (row
// stride `stride`, zero beyond `reg`): one flat read per element, clipped
// to the array.
__device__ __forceinline__ void stage_regions(
    const float* __restrict__ data, const int* __restrict__ sids,
    const int* __restrict__ anchors, float* reg_s, long long num_series,
    int n, int rows, int b, int r0, int tile, int stride, int reg) {
  const long long total = num_series * (long long)n;
  for (int idx = threadIdx.x; idx < tile * stride; idx += blockDim.x) {
    const int le = idx / stride, t = idx - le * stride;
    const int r = r0 + le;
    float v = 0.f;
    if (r < rows && t < reg) {
      const long long e = (long long)b * rows + r;
      long long flat = (long long)sids[e] * n + anchors[e] + t;
      flat = flat < 0 ? 0 : (flat >= total ? total - 1 : flat);
      v = data[flat];
    }
    reg_s[idx] = v;
  }
}

// Centered sum s1 and sum of squares s2 of the window at `off` (clipped
// to [0, n - qlen]) of series `sid`, from the hi/lo prefix sums; flat
// positions clipped to [0, last].
__device__ __forceinline__ void window_sums(
    const float* __restrict__ csum, const float* __restrict__ csum2,
    const float* __restrict__ csum_lo, const float* __restrict__ csum2_lo,
    long long sid, int off, int n, int qlen, long long last, float* s1,
    float* s2) {
  off = off < 0 ? 0 : (off > n - qlen ? n - qlen : off);
  long long i0 = sid * (n + 1) + off, i1 = i0 + qlen;
  i0 = i0 < 0 ? 0 : (i0 > last ? last : i0);
  i1 = i1 < 0 ? 0 : (i1 > last ? last : i1);
  *s1 = (csum[i1] - csum[i0]) + (csum_lo[i1] - csum_lo[i0]);
  *s2 = (csum2[i1] - csum2[i0]) + (csum2_lo[i1] - csum2_lo[i0]);
}

__global__ void fused_gather_ed_kernel(
    const float* __restrict__ data, const float* __restrict__ csum,
    const float* __restrict__ csum2, const float* __restrict__ csum_lo,
    const float* __restrict__ csum2_lo, const float* __restrict__ center,
    const int* __restrict__ sids, const int* __restrict__ anchors,
    const float* __restrict__ qs, float* __restrict__ out,
    long long num_series, int n, int rows, int qlen, int g, int znorm,
    int tile, int qlen_pad, int ngrp, int stride) {
  extern __shared__ float smem[];
  float* q_s = smem;                      // [qlen_pad], zero beyond qlen
  float* reg_s = smem + qlen_pad;         // [tile * stride]
  __shared__ float qss_s;

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * tile;
  const int reg = qlen + g - 1;

  for (int t = threadIdx.x; t < qlen_pad; t += blockDim.x)
    q_s[t] = t < qlen ? qs[(long long)b * qlen + t] : 0.f;
  stage_regions(data, sids, anchors, reg_s, num_series, n, rows, b, r0,
                tile, stride, reg);
  __syncthreads();
  if (!znorm && threadIdx.x < 32) {
    float part = 0.f;
    for (int t = threadIdx.x; t < qlen; t += 32) part += q_s[t] * q_s[t];
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_down_sync(0xffffffffu, part, off);
    if (threadIdx.x == 0) qss_s = part;
  }
  __syncthreads();

  const long long np1 = n + 1;
  const long long last = num_series * np1 - 1;
  for (int item = threadIdx.x; item < tile * ngrp; item += blockDim.x) {
    // consecutive threads -> consecutive rows (distinct banks)
    const int le = item % tile, grp = item / tile;
    const int r = r0 + le;
    if (r >= rows) continue;
    const int j0 = grp * kJ;
    const float* base = reg_s + le * stride + j0;
    float acc[kJ];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) acc[jj] = 0.f;
    for (int t0 = 0; t0 < qlen_pad; t0 += kJ) {
      float qv[kJ], rv[2 * kJ - 1];
#pragma unroll
      for (int m = 0; m < kJ; ++m) qv[m] = q_s[t0 + m];
#pragma unroll
      for (int m = 0; m < 2 * kJ - 1; ++m) rv[m] = base[t0 + m];
#pragma unroll
      for (int tt = 0; tt < kJ; ++tt) {
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj)
          acc[jj] = fmaf(rv[tt + jj], qv[tt], acc[jj]);
      }
    }

    const long long e = (long long)b * rows + r;
    const long long sid = sids[e];
    const int anc = anchors[e];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int j = j0 + jj;
      if (j >= g) break;
      float s1, s2;
      window_sums(csum, csum2, csum_lo, csum2_lo, sid, anc + j, n, qlen,
                  last, &s1, &s2);
      const float dot = acc[jj];
      float d2;
      if (znorm) {
        const float mu_c = s1 / qlen;
        const float var = s2 / qlen - mu_c * mu_c;
        const float sd = fmaxf(sqrtf(fmaxf(var, 0.f)), 1e-8f);
        d2 = 2.f * qlen - 2.f * dot / sd;
      } else {
        const float c = center[sid];
        const float wss = s2 + 2.f * c * s1 + qlen * c * c;
        d2 = wss - 2.f * dot + qss_s;
      }
      out[e * g + j] = fmaxf(d2, 0.f);
    }
  }
}

__global__ void fused_gather_lb_keogh_kernel(
    const float* __restrict__ data, const float* __restrict__ csum,
    const float* __restrict__ csum2, const float* __restrict__ csum_lo,
    const float* __restrict__ csum2_lo, const float* __restrict__ center,
    const int* __restrict__ sids, const int* __restrict__ anchors,
    const float* __restrict__ dtw_lo, const float* __restrict__ dtw_hi,
    float* __restrict__ lb_out, float* __restrict__ mu_out,
    float* __restrict__ sd_out, long long num_series, int n, int rows,
    int qlen, int g, int znorm, int tile, int stride) {
  extern __shared__ float smem[];
  float* lo_s = smem;                     // [qlen]
  float* hi_s = smem + qlen;              // [qlen]
  float* reg_s = smem + 2 * qlen;         // [tile * stride]

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * tile;
  for (int t = threadIdx.x; t < qlen; t += blockDim.x) {
    lo_s[t] = dtw_lo[(long long)b * qlen + t];
    hi_s[t] = dtw_hi[(long long)b * qlen + t];
  }
  stage_regions(data, sids, anchors, reg_s, num_series, n, rows, b, r0,
                tile, stride, qlen + g - 1);
  __syncthreads();

  const long long last = num_series * (long long)(n + 1) - 1;
  for (int item = threadIdx.x; item < tile * g; item += blockDim.x) {
    // consecutive threads -> consecutive offsets of one row
    const int le = item / g, j = item - le * g;
    const int r = r0 + le;
    if (r >= rows) continue;
    const long long e = (long long)b * rows + r;
    const long long sid = sids[e];
    float mu = 0.f, sd = 1.f;
    if (znorm) {
      float s1, s2;
      window_sums(csum, csum2, csum_lo, csum2_lo, sid, anchors[e] + j, n,
                  qlen, last, &s1, &s2);
      const float mu_c = s1 / qlen;
      const float var = __fsub_rn(s2 / qlen, __fmul_rn(mu_c, mu_c));
      sd = fmaxf(sqrtf(fmaxf(var, 0.f)), 1e-8f);
      mu = mu_c + center[sid];
    }
    const float* win = reg_s + le * stride + j;
    float acc = 0.f;
    for (int t = 0; t < qlen; ++t) {
      const float w = __fdiv_rn(__fsub_rn(win[t], mu), sd);
      const float over = fmaxf(w - hi_s[t], 0.f);
      const float under = fmaxf(lo_s[t] - w, 0.f);
      acc += over * over + under * under;
    }
    lb_out[e * g + j] = acc;
    mu_out[e * g + j] = mu;
    sd_out[e * g + j] = sd;
  }
}

}  // namespace

extern "C" int ulisse_fused_gather_ed(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* qs, void* out,
    long long num_series, int n, int batch, int rows, int qlen, int g,
    int znorm, void* stream) {
  if (batch < 1 || rows < 1 || g < 1 || qlen < 1 || qlen > n ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int qlen_pad = (qlen + kJ - 1) / kJ * kJ;
  const int ngrp = (g + kJ - 1) / kJ;
  // the slide reads up to (ngrp - 1) * kJ + qlen_pad + kJ - 2 per row
  int stride = ngrp * kJ + qlen_pad - 1;
  if (stride % 2 == 0) ++stride;         // odd: conflict-free row starts
  int tile = 32;
  while (tile > 1 &&
         sizeof(float) * (qlen_pad + (size_t)tile * stride) > kSmemBudget)
    tile /= 2;
  const size_t smem = sizeof(float) * (qlen_pad + (size_t)tile * stride);
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  int threads = tile * ngrp;
  threads = threads > kMaxThreads ? kMaxThreads : (threads + 31) / 32 * 32;
  const dim3 grid((rows + tile - 1) / tile, batch);
  fused_gather_ed_kernel<<<grid, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const float*>(csum),
      static_cast<const float*>(csum2), static_cast<const float*>(csum_lo),
      static_cast<const float*>(csum2_lo), static_cast<const float*>(center),
      static_cast<const int*>(sids), static_cast<const int*>(anchors),
      static_cast<const float*>(qs), static_cast<float*>(out), num_series, n,
      rows, qlen, g, znorm, tile, qlen_pad, ngrp, stride);
  return (int)cudaGetLastError();
}

extern "C" int ulisse_fused_gather_lb_keogh(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* dtw_lo,
    const void* dtw_hi, void* lb, void* mu, void* sd, long long num_series,
    int n, int batch, int rows, int qlen, int g, int znorm, void* stream) {
  if (batch < 1 || rows < 1 || g < 1 || qlen < 1 || qlen > n ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  int stride = qlen + g - 1;
  if (stride % 2 == 0) ++stride;         // odd: conflict-free row starts
  int tile = 32;
  while (tile > 1 &&
         sizeof(float) * (2 * (size_t)qlen + (size_t)tile * stride) >
             kSmemBudget)
    tile /= 2;
  const size_t smem =
      sizeof(float) * (2 * (size_t)qlen + (size_t)tile * stride);
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  int threads = tile * g;
  threads = threads > kMaxThreads ? kMaxThreads : (threads + 31) / 32 * 32;
  const dim3 grid((rows + tile - 1) / tile, batch);
  fused_gather_lb_keogh_kernel<<<grid, threads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const float*>(csum),
      static_cast<const float*>(csum2), static_cast<const float*>(csum_lo),
      static_cast<const float*>(csum2_lo), static_cast<const float*>(center),
      static_cast<const int*>(sids), static_cast<const int*>(anchors),
      static_cast<const float*>(dtw_lo), static_cast<const float*>(dtw_hi),
      static_cast<float*>(lb), static_cast<float*>(mu),
      static_cast<float*>(sd), num_series, n, rows, qlen, g, znorm, tile,
      stride);
  return (int)cudaGetLastError();
}
