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
// each (B * rows, g).
// ulisse_fused_gather_lb_keogh_chunk, the scan's entry over the same
// device function, also takes the chunk's candidate mask ok (B, M = rows
// * g) and the pool's k-th distances kth (B,); it writes lb2 = +inf where
// not ok, lists each survivor (lb2 < kth) of query b in slist[b, :] by a
// warp-aggregated atomicAdd on nsurv[b] (zeroed by the caller; the list's
// order varies from run to run), and writes +inf into the DP's (B, M)
// output at every other position; the DP (dtw_band.cu) fills the
// survivors' positions.  So the scan needs no survivor pack.
// The banded-DP tier normalizes the survivors with these mu and sd, and
// LB_Keogh <= DTW holds on the card only if both kernels see the same
// normalized values: both take w from znorm.cuh, bit-equal to the IEEE
// subtract and divide of the plain version (ulisse_gather_znorm writes
// the kernels' w for that check), and s2 / L - mu_c^2 is computed without
// FMA contraction, as the plain version computes it.
// Bound on the card: operations at the main path's shapes (B=8,
// rows=512, qlen=256, g=49: 51M normalized window points of ~10 flops)
// against ~13 MB of regions, prefix sums and outputs.  Design: one block
// per (query b, tile of 16 rows) of 13 warps, ~2 blocks an SM at that
// shape (~25 warps); the envelope (as (lo, hi) pairs) and the tile's
// regions staged in shared memory; each thread owns kLbJ = 2 consecutive
// window offsets of one row and slides over the region, so one region
// load and one envelope load a query point feed both windows;
// neighbouring threads own neighbouring rows (odd row stride).  A point
// costs ~11 instructions: 4 for the normalization (one reciprocal a
// window replaces the divide), 7 for the bound, each window summed in
// query order.  The tile's results go out through shared memory in
// coalesced stores, where the chunk entry also masks, lists the
// survivors and fills the DP's output.  (Timed on the card against 4
// offsets and 8 rows, and 1 offset and 16 rows: more warps hide the
// statistics' scattered prefix-sum reads.)
#include <cuda_runtime.h>
#include <math.h>

#include "znorm.cuh"

namespace {

constexpr int kJ = 4;           // offsets per thread
constexpr int kMaxThreads = 512;
constexpr int kSmemBudget = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;
constexpr int kLbJ = 2;         // LB_Keogh: window offsets per thread
constexpr int kLbTile = 16;     // LB_Keogh: envelope rows per block
constexpr int kLbMaxThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

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

// Squared LB_Keogh of kLbJ consecutive windows j0 .. j0 + kLbJ - 1 of
// one row against the envelope: the region (padded with zeros) and the
// envelope (padded with (-inf, +inf), which adds 0) in shared memory.
// Window jj is normalized by (mu[jj], sd[jj]) through y[jj] = 1 / sd.
__device__ __forceinline__ void lb_windows(const float* base,
                                           const float2* env, int qlen_pad,
                                           const float (&mu)[kLbJ],
                                           const float (&sd)[kLbJ],
                                           const float (&y)[kLbJ],
                                           float (&acc)[kLbJ]) {
  float rv[2 * kLbJ - 1];       // region[j0 + t0 .. j0 + t0 + 2kLbJ - 2]
#pragma unroll
  for (int m = 0; m < kLbJ - 1; ++m) rv[kLbJ + m] = base[m];
  for (int t0 = 0; t0 < qlen_pad; t0 += kLbJ) {
#pragma unroll
    for (int m = 0; m < kLbJ - 1; ++m) rv[m] = rv[kLbJ + m];
#pragma unroll
    for (int m = kLbJ - 1; m < 2 * kLbJ - 1; ++m) rv[m] = base[t0 + m];
#pragma unroll
    for (int tt = 0; tt < kLbJ; ++tt) {
      const float2 lh = env[t0 + tt];
#pragma unroll
      for (int jj = 0; jj < kLbJ; ++jj) {
        const float w = znorm_point(rv[tt + jj], mu[jj], sd[jj], y[jj]);
        const float over = fmaxf(w - lh.y, 0.f);
        const float under = fmaxf(lh.x - w, 0.f);
        acc[jj] += over * over + under * under;
      }
    }
  }
}

template <bool kChunk>
__global__ void __launch_bounds__(kLbMaxThreads)
    fused_gather_lb_keogh_kernel(
        const float* __restrict__ data, const float* __restrict__ csum,
        const float* __restrict__ csum2, const float* __restrict__ csum_lo,
        const float* __restrict__ csum2_lo, const float* __restrict__ center,
        const int* __restrict__ sids, const int* __restrict__ anchors,
        const float* __restrict__ dtw_lo, const float* __restrict__ dtw_hi,
        float* __restrict__ lb_out, float* __restrict__ mu_out,
        float* __restrict__ sd_out, const bool* __restrict__ ok,
        const float* __restrict__ kth, int* __restrict__ slist,
        int* __restrict__ nsurv, float* __restrict__ dp_out,
        long long num_series, int n, int rows, int qlen, int g, int znorm,
        int tile, int qlen_pad, int ngrp, int stride) {
  extern __shared__ float smem[];
  float2* env_s = reinterpret_cast<float2*>(smem);   // [qlen_pad]
  float* reg_s = smem + 2 * qlen_pad;                // [tile * stride]
  float* res_s = reg_s + tile * stride;              // [3][tile * g]
  const int tg = tile * g;

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * tile;
  for (int t = threadIdx.x; t < qlen_pad; t += blockDim.x)
    env_s[t] = t < qlen ? make_float2(dtw_lo[(long long)b * qlen + t],
                                      dtw_hi[(long long)b * qlen + t])
                        : make_float2(-INFINITY, INFINITY);
  stage_regions(data, sids, anchors, reg_s, num_series, n, rows, b, r0,
                tile, stride, qlen + g - 1);
  __syncthreads();

  const long long last = num_series * (long long)(n + 1) - 1;
  for (int item = threadIdx.x; item < tile * ngrp; item += blockDim.x) {
    // consecutive threads -> consecutive rows (odd stride: other banks)
    const int le = item % tile, grp = item / tile;
    const int r = r0 + le;
    if (r >= rows) continue;
    const long long e = (long long)b * rows + r;
    const long long sid = sids[e];
    const int j0 = grp * kLbJ;
    float mu[kLbJ], sd[kLbJ], y[kLbJ], acc[kLbJ];
#pragma unroll
    for (int jj = 0; jj < kLbJ; ++jj) {
      mu[jj] = 0.f;
      sd[jj] = 1.f;
      if (znorm) {
        float s1, s2;
        window_sums(csum, csum2, csum_lo, csum2_lo, sid,
                    anchors[e] + j0 + jj, n, qlen, last, &s1, &s2);
        const float mu_c = s1 / qlen;
        const float var = __fsub_rn(s2 / qlen, __fmul_rn(mu_c, mu_c));
        sd[jj] = fmaxf(sqrtf(fmaxf(var, 0.f)), 1e-8f);
        mu[jj] = mu_c + center[sid];
      }
      y[jj] = __frcp_rn(sd[jj]);
      acc[jj] = 0.f;
    }
    lb_windows(reg_s + le * stride + j0, env_s, qlen_pad, mu, sd, y, acc);
#pragma unroll
    for (int jj = 0; jj < kLbJ; ++jj) {
      const int j = j0 + jj;
      if (j < g) {
        res_s[le * g + j] = acc[jj];
        res_s[tg + le * g + j] = mu[jj];
        res_s[2 * tg + le * g + j] = sd[jj];
      }
    }
  }
  __syncthreads();

  // the tile's rows are consecutive: (lb2, mu, sd) out in coalesced
  // stores; entry at = (b * rows + r0) * g + idx is position r0 * g + idx
  // of query b's chunk
  const long long at0 = ((long long)b * rows + r0) * g;
  const int count = (rows - r0 < tile ? rows - r0 : tile) * g;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < count; base += blockDim.x) {   // warp-uniform
    const int idx = base + threadIdx.x;
    const bool in = idx < count;
    const long long at = at0 + idx;
    float lb = in ? res_s[idx] : 0.f;
    if (kChunk) {
      if (in && !ok[at]) lb = INFINITY;
      const bool surv = in && lb < kth[b];
      const unsigned mask = __ballot_sync(kFull, surv);
      if (mask) {
        const int leader = __ffs(mask) - 1;
        int slot = 0;
        if (lane == leader) slot = atomicAdd(nsurv + b, __popc(mask));
        slot = __shfl_sync(kFull, slot, leader) +
               __popc(mask & ((1u << lane) - 1u));
        if (surv)
          slist[(long long)b * rows * g + slot] = r0 * g + idx;
      }
      if (in && !surv) dp_out[at] = INFINITY;
    }
    if (in) {
      lb_out[at] = lb;
      mu_out[at] = res_s[tg + idx];
      sd_out[at] = res_s[2 * tg + idx];
    }
  }
}

// The normalized windows w (E * g, qlen) of the LB and DP tiers, from
// (mu, sd) (E, g): a check that znorm.cuh equals the IEEE divide.
__global__ void gather_znorm_kernel(
    const float* __restrict__ data, const int* __restrict__ sids,
    const int* __restrict__ anchors, const float* __restrict__ mu,
    const float* __restrict__ sd, float* __restrict__ out,
    long long num_series, int n, long long num_rows, int qlen, int g) {
  const long long total = num_rows * g * qlen;
  const long long last = num_series * (long long)n - 1;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long w = idx / qlen;                 // window e * g + j
    const int t = (int)(idx - w * qlen);
    const long long e = w / g;
    const int j = (int)(w - e * g);
    long long flat = (long long)sids[e] * n + anchors[e] + j + t;
    flat = flat < 0 ? 0 : (flat > last ? last : flat);
    out[idx] = znorm_point(data[flat], mu[w], sd[w], __frcp_rn(sd[w]));
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

namespace {

template <bool kChunk>
int launch_lb_keogh(const void* data, const void* csum, const void* csum2,
                    const void* csum_lo, const void* csum2_lo,
                    const void* center, const void* sids, const void* anchors,
                    const void* dtw_lo, const void* dtw_hi, void* lb,
                    void* mu, void* sd, const void* ok, const void* kth,
                    void* slist, void* nsurv, void* dp_out,
                    long long num_series, int n, int batch, int rows,
                    int qlen, int g, int znorm, void* stream) {
  if (batch < 1 || rows < 1 || g < 1 || qlen < 1 || qlen > n ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int qlen_pad = (qlen + kLbJ - 1) / kLbJ * kLbJ;
  const int ngrp = (g + kLbJ - 1) / kLbJ;
  // the slide reads up to (ngrp - 1) * kLbJ + qlen_pad + kLbJ - 2 a row
  int stride = ngrp * kLbJ + qlen_pad - 1;
  if (stride % 2 == 0) ++stride;         // odd: conflict-free row starts
  auto smem_for = [&](int t) {
    return sizeof(float) *
           (2 * (size_t)qlen_pad + (size_t)t * stride + 3 * (size_t)t * g);
  };
  int tile = kLbTile;
  while (tile > 1 && smem_for(tile) > kSmemBudget) tile /= 2;
  const size_t smem = smem_for(tile);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > kSmemBudget) {
    const int err = (int)cudaFuncSetAttribute(
        fused_gather_lb_keogh_kernel<kChunk>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  int threads = tile * ngrp;
  threads = threads > kLbMaxThreads ? kLbMaxThreads
                                    : (threads + 31) / 32 * 32;
  const dim3 grid((rows + tile - 1) / tile, batch);
  fused_gather_lb_keogh_kernel<kChunk><<<grid, threads, smem,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const float*>(csum),
      static_cast<const float*>(csum2), static_cast<const float*>(csum_lo),
      static_cast<const float*>(csum2_lo), static_cast<const float*>(center),
      static_cast<const int*>(sids), static_cast<const int*>(anchors),
      static_cast<const float*>(dtw_lo), static_cast<const float*>(dtw_hi),
      static_cast<float*>(lb), static_cast<float*>(mu),
      static_cast<float*>(sd), static_cast<const bool*>(ok),
      static_cast<const float*>(kth), static_cast<int*>(slist),
      static_cast<int*>(nsurv), static_cast<float*>(dp_out), num_series, n,
      rows, qlen, g, znorm, tile, qlen_pad, ngrp, stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ulisse_fused_gather_lb_keogh(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* dtw_lo,
    const void* dtw_hi, void* lb, void* mu, void* sd, long long num_series,
    int n, int batch, int rows, int qlen, int g, int znorm, void* stream) {
  return launch_lb_keogh<false>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, dtw_lo,
      dtw_hi, lb, mu, sd, nullptr, nullptr, nullptr, nullptr, nullptr,
      num_series, n, batch, rows, qlen, g, znorm, stream);
}

extern "C" int ulisse_fused_gather_lb_keogh_chunk(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* dtw_lo,
    const void* dtw_hi, const void* ok, const void* kth, void* lb, void* mu,
    void* sd, void* slist, void* nsurv, void* dp_out, long long num_series,
    int n, int batch, int rows, int qlen, int g, int znorm, void* stream) {
  return launch_lb_keogh<true>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, dtw_lo,
      dtw_hi, lb, mu, sd, ok, kth, slist, nsurv, dp_out, num_series, n,
      batch, rows, qlen, g, znorm, stream);
}

extern "C" int ulisse_gather_znorm(const void* data, const void* sids,
                                   const void* anchors, const void* mu,
                                   const void* sd, void* out,
                                   long long num_series, int n,
                                   long long num_rows, int qlen, int g,
                                   void* stream) {
  if (num_rows < 1 || g < 1 || qlen < 1 || qlen > n)
    return (int)cudaErrorInvalidValue;
  long long blocks = (num_rows * g * qlen + 255) / 256;
  if (blocks > 65536) blocks = 65536;
  gather_znorm_kernel<<<(unsigned)blocks, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(sids),
      static_cast<const int*>(anchors), static_cast<const float*>(mu),
      static_cast<const float*>(sd), static_cast<float*>(out), num_series, n,
      num_rows, qlen, g);
  return (int)cudaGetLastError();
}
