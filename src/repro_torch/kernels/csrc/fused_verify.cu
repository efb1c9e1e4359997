// Fused candidate-window gather + squared ED / LB_Keogh for ULISSE, for
// Hopper.  Two kernels over one region gather and one prefix-sum window
// statistic, each with the TPU kernel's contract entry and the scan's
// chunk entry: ulisse_fused_gather_ed (_chunk) and
// ulisse_fused_gather_lb_keogh (_chunk).
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
// ulisse_fused_gather_ed_chunk, the scan's entry over the same device
// function, takes the whole (B, n_pad) LB-sorted plan (sids, anchors,
// n_master, lbs2) and the chunk's first column, the pool's (B, k) d2 and
// the scan's (B, 6) int32 counters.  It decides `active` (the chunk's
// first bound is finite and below the pool's k-th) and, per row,
// keep = lbs2 < kth & active; candidate (r, j) is ok where
// j < n_master, the window fits the series and the row is kept.  It adds
// [active, kept rows, ok candidates, 0, 0, pruned rows] to the counters
// (one atomic per block and column), computes d2 only for ok candidates,
// and each block writes the kp = min(k, tile * g) least of its
// candidates with d2 < kth, by (d2, position r * g + j), to its row of a
// (B, n_blocks, kp) partials buffer (topk.cuh), for the pool merge
// (pool_merge.cu).  A candidate with d2 >= kth cannot enter a sorted
// pool whose incumbents win ties, so nothing else leaves the block.
// The sharded scan passes gkth (B,), the mesh-wide k-th of its last
// round (nullptr on every local path): active, keep and pruned then cut
// at min(pool k-th, gkth[b]), while the pre-select stays at the pool's
// own k-th (a shard merges every candidate of a kept row that can enter
// its own pool, as the JAX package's sharded scan does).
// ulisse_fused_gather_ed_range is the same entry in its range mode (the
// eps-range scan's step, paper Alg. 5 with bsf := eps): eps2 (B,) in
// place of the pool's k-th, inclusive cuts (keep = lbs2 <= eps2), a query
// active only while its hit buffer never overflowed (ovf[b] == n_chunks),
// and the dense (B, rows * g) d2 of the ok candidates (+inf elsewhere)
// out through the candidate buffer in coalesced stores, for the ordered
// hit append (range_append.cu).
//
// Bound on the card: bytes at the main path's shapes (regions + the 2g
// prefix-sum positions of each of the four arrays per row, ~11 MB at
// B=8, rows=512, qlen=256, g=49) against ~0.1 GFLOP of float32 dot work;
// the kernel is latency-bound.  Design: one block per (query b, tile of
// kEdTile = 8 envelope rows) of 4 warps; one thread per (row, group of
// kEdJ = 8 window offsets).  q_b, the tile's regions and the prefix-sum
// runs the epilogue reads ([anchor, anchor + g) and [anchor + qlen,
// anchor + qlen + g) of each of the four arrays, clipped as the plain
// version clips) are staged with cp.async in two groups: the dot loop
// waits only for the first, the epilogue for the second.  The runs, 8 a
// row in four arrays, are what the kernel waits for most, and each
// costs more in the issuing warp's setup than in bytes, so each is
// copied in 16-byte pieces by threads that share it.  Each thread slides
// over its row's region: 8 new region words and two float4 query loads
// (a broadcast) feed 64 FMAs; neighbouring threads own neighbouring rows
// and the odd row stride puts a warp's region reads in distinct banks.
// The chunk entry stages and computes only what its ok candidates need.
// No tensor cores and no TF32: the identity cancels near d = 0, so the
// dots stay full float32, summed in query order for every offset.
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
// device function, takes the whole (B, n_pad) LB-sorted plan as the ED
// chunk entry does and the cut: the pool's k-th (k-NN, lb2 < kth) or
// eps2 (range, lb2 <= eps2, `active` also reading ovf), and in k-NN the
// optional gkth (B,) of the sharded scan, whose cut is then min(kth,
// gkth[b]) for active, keep and the survivors.  It decides
// active, keep and the ok candidates (chunk_block_rows), adds [active,
// kept rows, survivors, ok candidates, survivors, pruned rows] to the
// counters, writes lb2 = +inf where not ok, lists each survivor of query
// b in slist[b, :] by a warp-aggregated atomicAdd on nsurv[b] (zeroed by
// a memset before the launch; the list's order varies from run to run),
// writes +inf into the DP's (B, M = rows * g) output at every other
// position and each candidate's (sid, off); the DP (dtw_band.cu) fills
// the survivors' positions.  So the scan's DTW step has no torch
// prologue and no survivor pack.
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

#include "topk.cuh"
#include "znorm.cuh"

namespace {

constexpr int kEdJ = 8;         // ED: window offsets per thread
constexpr int kEdTile = 8;      // ED: envelope rows per block (at most)
constexpr int kEdThreads = 512;           // ED: largest block
constexpr int kEdMinThreads = 128;        // ED: smallest block (staging)
constexpr int kEdSmemBudget = 96 * 1024;  // ED: preferred shared memory
constexpr int kStatsWidth = 6;  // the scan's per-query counter columns
constexpr int kSmemBudget = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;
constexpr int kLbJ = 2;         // LB_Keogh: window offsets per thread
constexpr int kLbTile = 16;     // LB_Keogh: envelope rows per block
constexpr int kLbMaxThreads = 512;
constexpr int kLongPoints = 1024;   // long kernels: query points a tile
constexpr unsigned kFull = 0xffffffffu;

// Stage points [t0, t0 + stride) of the regions of rows [r0, r0 + tile)
// into reg_s (row stride `stride`, zero beyond `reg`): one flat read per
// element, clipped to the array.  Tile row le's (sid, anchor) is
// (row_sid[le], row_anc[le]) in shared memory (chunk_block_rows).
__device__ __forceinline__ void stage_regions(
    const float* __restrict__ data, const int* row_sid, const int* row_anc,
    float* reg_s, long long num_series, int n, int rows, int r0, int tile,
    int stride, int reg, int t0 = 0) {
  const long long total = num_series * (long long)n;
  for (int idx = threadIdx.x; idx < tile * stride; idx += blockDim.x) {
    const int le = idx / stride, t = idx - le * stride;
    float v = 0.f;
    if (r0 + le < rows && t0 + t < reg) {
      long long flat = (long long)row_sid[le] * n + row_anc[le] + t0 + t;
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A chunk entry's rows: query b, rows [r0, r0 + tile) of its chunk
// (tile <= 32).  Row r's plan entry is e = b * row_stride + col0 + r (the
// contract entries: row_stride = rows, col0 = 0).  kMode: 0 the contract
// entries, 1 the k-NN chunk entries, 2 the range chunk entries.  Warp 0
// fills row_sid / row_anc / row_jl (offsets j < jl are ok candidates;
// all g in the contract entries) and, in a chunk entry, adds the block's
// counters to stats (active, kept rows, ok candidates in column ok_col,
// pruned rows) and zeroes count_s.  Every thread gets the pool's own k-th
// (kth_out), the cut (cut_out; both +inf in the contract entries) and
// whether any row of the block has work.
//   k-NN:  cut = pool_d2[b, k - 1] (the pool's k-th), or, where gkth is
//          given (the sharded scan's mesh-wide k-th, (B,)), min(pool_d2[b,
//          k - 1], gkth[b]); active = the chunk's first bound is finite
//          and < cut, keep = lb < cut;
//   range: cut = pool_d2[b] (eps2, k = 1), active = the first bound is
//          finite and <= cut and ovf[b] == n_chunks (the hit buffer never
//          overflowed), keep = lb <= cut: inclusive, since lb <= d, so a
//          boundary hit with lb == d == eps survives.
template <int kMode>
__device__ __forceinline__ bool chunk_block_rows(
    const int* __restrict__ sids, const int* __restrict__ anchors,
    const int* __restrict__ n_master, const float* __restrict__ lbs2,
    const float* __restrict__ pool_d2, const float* __restrict__ gkth,
    const int* __restrict__ ovf, int* __restrict__ stats, int n, int rows,
    int qlen, int g, long long row_stride, long long col0, int k,
    int n_chunks, int tile, int ok_col, int* row_sid, int* row_anc,
    int* row_jl, int* count_s, float* kth_out, float* cut_out) {
  constexpr bool kChunk = kMode != 0, kRange = kMode == 2;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * tile;
  const int tid = threadIdx.x;
  float own = INFINITY, kth = INFINITY;
  bool active = true;
  if (kChunk) {
    own = pool_d2[(long long)b * k + k - 1];
    kth = !kRange && gkth != nullptr ? fminf(own, gkth[b]) : own;
    const float first = lbs2[(long long)b * row_stride + col0];
    active = isfinite(first) &&
             (kRange ? first <= kth && ovf[b] == n_chunks : first < kth);
  }
  *kth_out = own;
  *cut_out = kth;
  int jl = 0;
  if (tid < 32) {
    int keep = 0, pruned = 0;
    if (tid < tile) {
      const int r = r0 + tid;
      int sid = 0, anc = 0;
      if (r < rows) {
        const long long e = (long long)b * row_stride + col0 + r;
        sid = sids[e];
        anc = anchors[e];
        if (kChunk) {
          const float lb = lbs2[e];
          keep = active && (kRange ? lb <= kth : lb < kth);
          pruned = active && !keep && isfinite(lb);
          const int fit = n - qlen - anc + 1;     // offsets that fit
          const int nm = n_master[e];
          int lim = nm < fit ? nm : fit;
          lim = lim < g ? lim : g;
          jl = keep && lim > 0 ? lim : 0;
        } else {
          jl = g;
        }
      }
      row_sid[tid] = sid;
      row_anc[tid] = anc;
      row_jl[tid] = jl;
    }
    if (kChunk) {
      const int n_keep = __reduce_add_sync(kFull, keep);
      const int n_ok = __reduce_add_sync(kFull, jl);
      const int n_pruned = __reduce_add_sync(kFull, pruned);
      if (tid == 0) {
        int* st = stats + (long long)b * kStatsWidth;
        if (blockIdx.x == 0 && active) atomicAdd(st + 0, 1);
        if (n_keep) atomicAdd(st + 1, n_keep);
        if (n_ok) atomicAdd(st + ok_col, n_ok);
        if (n_pruned) atomicAdd(st + 5, n_pruned);
        *count_s = 0;
      }
    }
  }
  return __syncthreads_or(jl > 0);
}

// kEdJ sliding dots of one thread: acc[jj] += region[j0 + t + jj] * q[t]
// over t < len (a multiple of kEdJ), in query order.  base points at the
// thread's region word j0 (shared memory, zero-padded past the region),
// q_s at the query (zero-padded past qlen).
__device__ __forceinline__ void ed_slide(const float* base,
                                         const float* q_s, int len,
                                         float (&acc)[kEdJ]) {
  float rv[2 * kEdJ - 1];    // region[j0 + t0 .. j0 + t0 + 2 kEdJ - 2]
#pragma unroll
  for (int m = 0; m < kEdJ - 1; ++m) rv[kEdJ + m] = base[m];
  for (int t0 = 0; t0 < len; t0 += kEdJ) {
#pragma unroll
    for (int m = 0; m < kEdJ - 1; ++m) rv[m] = rv[kEdJ + m];
#pragma unroll
    for (int m = kEdJ - 1; m < 2 * kEdJ - 1; ++m) rv[m] = base[t0 + m];
    const float4 qa = *reinterpret_cast<const float4*>(q_s + t0);
    const float4 qb = *reinterpret_cast<const float4*>(q_s + t0 + 4);
    const float qv[kEdJ] = {qa.x, qa.y, qa.z, qa.w,
                            qb.x, qb.y, qb.z, qb.w};
#pragma unroll
    for (int tt = 0; tt < kEdJ; ++tt) {
#pragma unroll
      for (int jj = 0; jj < kEdJ; ++jj)
        acc[jj] = fmaf(rv[tt + jj], qv[tt], acc[jj]);
    }
  }
}

// The squared ED of a window from its sums s1, s2 and its dot with the
// query: every operation rounded on its own (no contraction), so every
// entry's instantiation gives the same bits.
__device__ __forceinline__ float ed_d2(float s1, float s2, float dot,
                                       int qlen, int znorm, float c,
                                       float qss) {
  const float lq = (float)qlen;
  float d2;
  if (znorm) {
    const float mu_c = __fdiv_rn(s1, lq);
    const float var = __fsub_rn(__fdiv_rn(s2, lq), __fmul_rn(mu_c, mu_c));
    const float sd = fmaxf(__fsqrt_rn(fmaxf(var, 0.f)), 1e-8f);
    d2 = __fsub_rn(2.f * lq, __fdiv_rn(__fmul_rn(2.f, dot), sd));
  } else {
    const float wss = __fadd_rn(__fadd_rn(s2, __fmul_rn(__fmul_rn(2.f, c), s1)),
                                __fmul_rn(__fmul_rn(lq, c), c));
    d2 = __fadd_rn(__fsub_rn(wss, __fmul_rn(2.f, dot)), qss);
  }
  return fmaxf(d2, 0.f);
}

// Stage query points [t0, t0 + len) (zero past qlen) and, for every row
// of the block with work, region points [t0, t0 + stride) (zero past the
// region) with cp.async: warp w takes rows w, w + warps, ...
__device__ __forceinline__ void ed_stage(
    const float* __restrict__ data, const float* __restrict__ qs,
    float* q_s, float* reg_s, const int* row_sid, const int* row_anc,
    const int* row_jl, long long num_series, int n, int qlen, int reg,
    int tile, int stride, int t0, int len) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const float* q = qs + (long long)blockIdx.y * qlen;
  for (int t = tid; t < len; t += blockDim.x) {
    if (t0 + t < qlen)
      cp_async4(q_s + t, q + t0 + t);
    else
      q_s[t] = 0.f;
  }
  const long long total = num_series * (long long)n;
  for (int le = warp; le < tile; le += warps) {
    float* dst = reg_s + le * stride;
    int t1 = 0;
    if (row_jl[le] > 0 && t0 < reg) {
      const int cnt = reg - t0 < stride ? reg - t0 : stride;
      const long long base = (long long)row_sid[le] * n + row_anc[le] + t0;
      const bool clip = base < 0 || base + cnt > total;
      for (int t = lane; t < cnt; t += 32) {
        long long flat = base + t;
        if (clip) flat = flat < 0 ? 0 : (flat >= total ? total - 1 : flat);
        cp_async4(dst + t, data + flat);
      }
      t1 = cnt;
    }
    for (int t = t1 + lane; t < stride; t += 32) dst[t] = 0.f;
  }
}

// The range entries' output of one block: its rows' dense d2, cd_s[le *
// g + j] (+inf wherever not an ok candidate; all +inf where the block has
// no work), out in coalesced stores at positions r0 * g ... of query b's
// (B, rows * g) row.
__device__ __forceinline__ void ed_range_out(const float* cd_s, bool work,
                                             float* __restrict__ out,
                                             int rows, int g, int tile) {
  const int r0 = blockIdx.x * tile;
  const long long at0 = ((long long)blockIdx.y * rows + r0) * g;
  const int count = (rows - r0 < tile ? rows - r0 : tile) * g;
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x)
    out[at0 + idx] = work ? cd_s[idx] : INFINITY;
}

// One block: query b = blockIdx.y, rows [r0, r0 + tile) of its chunk
// (chunk_block_rows; kMode 0 the contract entry, 1 the k-NN chunk entry,
// 2 the range chunk entry).  Entries of the chunk entries only: n_master,
// lbs2, pool_d2 (k-NN: (B, k); range: eps2 (B,), k = 1), ovf and
// n_chunks (range), stats (B, 6); part_* (k-NN: (B, gridDim.x, kp)); out
// (contract: (B * rows, g); range: the dense (B, rows * g) d2, +inf where
// not ok).
template <int kMode>
__global__ void __launch_bounds__(kEdThreads) fused_gather_ed_kernel(
    const float* __restrict__ data, const float* __restrict__ csum,
    const float* __restrict__ csum2, const float* __restrict__ csum_lo,
    const float* __restrict__ csum2_lo, const float* __restrict__ center,
    const int* __restrict__ sids, const int* __restrict__ anchors,
    const int* __restrict__ n_master, const float* __restrict__ lbs2,
    const float* __restrict__ qs, float* __restrict__ out,
    const float* __restrict__ pool_d2, int* __restrict__ stats,
    float* __restrict__ part_d2, int* __restrict__ part_sid,
    int* __restrict__ part_off, int* __restrict__ part_pos,
    long long num_series, int n, int rows, int qlen, int g, int znorm,
    long long row_stride, long long col0, int k, int kp, int tile,
    int qlen_pad, int ngrp, int stride, int run_stride,
    const int* __restrict__ ovf, int n_chunks,
    const float* __restrict__ gkth) {
  constexpr bool kChunk = kMode != 0, kRange = kMode == 2;
  extern __shared__ __align__(16) float ed_smem[];
  float* q_s = ed_smem;                       // [qlen_pad], 0 beyond qlen
  float* run_s = q_s + qlen_pad;              // [tile][8][run_stride]
  float* reg_s = run_s + tile * 8 * run_stride;   // [tile * stride]
  float* cd_s = reg_s + tile * stride;        // chunk: [tile * g] d2
  int* cp_s = reinterpret_cast<int*>(cd_s + tile * g);   // and positions
  __shared__ int row_sid[kEdTile], row_anc[kEdTile], row_jl[kEdTile];
  __shared__ int run_at[kEdTile * 8];         // a run's first offset's slot
  __shared__ float qss_s;
  __shared__ int count_s;

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * tile;
  const int tid = threadIdx.x;
  const int reg = qlen + g - 1;
  // kth: the pool's own k-th, the pre-select's cut (a shard's pool takes
  // every candidate below it, whatever the mesh-wide k-th)
  float kth, cut;
  const bool work = chunk_block_rows<kMode>(
      sids, anchors, n_master, lbs2, pool_d2, gkth, ovf, stats, n, rows,
      qlen, g, row_stride, col0, k, n_chunks, tile, 2, row_sid, row_anc,
      row_jl, &count_s, &kth, &cut);
  const long long at = ((long long)b * gridDim.x + blockIdx.x) * kp;
  const int* rsid = row_sid;
  const int* ranc = row_anc;
  auto sid_off = [=](int p, int* sid, int* off) {
    const int r = p / g;
    *sid = rsid[r - r0];
    *off = ranc[r - r0] + (p - r * g);
  };
  if (!work) {
    if (kMode == 1)
      write_block_topk(cd_s, cp_s, 0, kp, part_d2 + at, part_sid + at,
                       part_off + at, part_pos + at, sid_off);
    if (kRange) ed_range_out(cd_s, false, out, rows, g, tile);
    return;
  }
  if (kRange)   // the dense d2: +inf but at the ok candidates
    for (int idx = tid; idx < tile * g; idx += blockDim.x)
      cd_s[idx] = INFINITY;

  // stage: group 0 the query and the regions, group 1 the prefix sums
  ed_stage(data, qs, q_s, reg_s, row_sid, row_anc, row_jl, num_series, n,
           qlen, reg, tile, stride, 0, qlen_pad);
  cp_async_commit();
  // run `which` = 2 * array + end of row le: arrays csum, csum_lo, csum2,
  // csum2_lo; ends the windows' first and one-past-last positions.  The
  // offsets j < jl read window starts clip(anchor + j, 0, n - qlen), one
  // contiguous span [lo, hi] of each array's row sid: it is copied in
  // 16-byte pieces from the aligned position below lo into
  // run_s[(8 le + which) run_stride ...], and run_at says where lo landed
  // (single words where a piece would leave the array, or the array is
  // not 16-byte aligned, or the span would leave it).  `per` threads
  // share a run, each taking every per-th piece.
  const long long np1 = n + 1;
  const long long len_all = num_series * np1;
  const int nruns = tile * 8;
  const int per = blockDim.x > nruns ? blockDim.x / nruns : 1;
  for (int it = tid; it < nruns * per; it += blockDim.x) {
    const int pr = it % nruns, sub = it / nruns;
    const int le = pr >> 3, which = pr & 7;
    const int jl_r = row_jl[le];
    if (jl_r == 0) continue;
    const int arr = which >> 1;
    const float* src = arr == 0   ? csum
                       : arr == 1 ? csum_lo
                       : arr == 2 ? csum2
                                  : csum2_lo;
    const int anc = row_anc[le];
    const int lo = anc < 0 ? 0 : (anc > n - qlen ? n - qlen : anc);
    int hi = anc + jl_r - 1;
    hi = hi < 0 ? 0 : (hi > n - qlen ? n - qlen : hi);
    const long long start =
        (long long)row_sid[le] * np1 + lo + ((which & 1) ? qlen : 0);
    const int len = hi - lo + 1;
    float* dst = run_s + pr * run_stride;
    if (start >= 0 && start + len <= len_all &&
        (reinterpret_cast<unsigned long long>(src) & 15) == 0) {
      const long long a0 = start & ~3LL;
      const int shift = (int)(start - a0);
      if (sub == 0) run_at[pr] = shift;
      for (int c = 4 * sub; c < shift + len; c += 4 * per) {
        if (a0 + c + 4 <= len_all) {
          cp_async16(dst + c, src + a0 + c);
        } else {
          for (int e = 0; e < 4 && a0 + c + e < len_all; ++e)
            cp_async4(dst + c + e, src + a0 + c + e);
        }
      }
    } else {
      if (sub == 0) run_at[pr] = 0;
      for (int e = sub; e < len; e += per) {
        long long pos = start + e;
        pos = pos < 0 ? 0 : (pos >= len_all ? len_all - 1 : pos);
        cp_async4(dst + e, src + pos);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  if (!znorm && tid < 32) {
    float part = 0.f;
    for (int t = tid; t < qlen; t += 32) part = __fmaf_rn(q_s[t], q_s[t], part);
    for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(kFull, part, o);
    if (tid == 0) qss_s = part;
  }

  // the dots: thread = (row le, offsets j0 .. j0 + kEdJ - 1); consecutive
  // threads -> consecutive rows (odd stride: distinct banks)
  const int le = tid % tile, grp = tid / tile;
  const int j0 = grp * kEdJ;
  const int row_lim = row_jl[le];
  const bool mine = grp < ngrp && j0 < row_lim;
  float acc[kEdJ];
#pragma unroll
  for (int jj = 0; jj < kEdJ; ++jj) acc[jj] = 0.f;
  if (mine) ed_slide(reg_s + le * stride + j0, q_s, qlen_pad, acc);
  cp_async_wait<0>();
  __syncthreads();

  if (mine) {
    const int r = r0 + le;
    const int anc = row_anc[le];
    const int lo = anc < 0 ? 0 : (anc > n - qlen ? n - qlen : anc);
    const float* rs = run_s + le * 8 * run_stride;
    const int* at_r = run_at + le * 8;
    // the value of run w at offset j's (clipped) window start
    auto run = [&](int w, int off) {
      return rs[w * run_stride + at_r[w] + off];
    };
#pragma unroll
    for (int jj = 0; jj < kEdJ; ++jj) {
      const int j = j0 + jj;
      if (j < row_lim) {
        int off = anc + j;
        off = (off < 0 ? 0 : (off > n - qlen ? n - qlen : off)) - lo;
        const float s1 = (run(1, off) - run(0, off)) +
                         (run(3, off) - run(2, off));
        const float s2 = (run(5, off) - run(4, off)) +
                         (run(7, off) - run(6, off));
        const float d2 = ed_d2(s1, s2, acc[jj], qlen, znorm,
                               znorm ? 0.f : center[row_sid[le]], qss_s);
        if (!kChunk) {
          out[((long long)b * rows + r) * g + j] = d2;
        } else if (kRange) {
          cd_s[le * g + j] = d2;
        } else if (d2 < kth) {
          const int slot = atomicAdd(&count_s, 1);
          cd_s[slot] = d2;
          cp_s[slot] = r * g + j;
        }
      }
    }
  }
  if (kChunk) __syncthreads();
  if (kMode == 1)
    write_block_topk(cd_s, cp_s, count_s, kp, part_d2 + at, part_sid + at,
                     part_off + at, part_pos + at, sid_off);
  if (kRange) ed_range_out(cd_s, true, out, rows, g, tile);
}

// The long-row ED kernel: the staged kernel's contract, for queries whose
// region and query do not fit shared memory whole.  Rows as in the staged
// kernel (chunk_block_rows, the same modes); the query and the rows' regions stream through
// shared memory in tiles of `ptile` points (a multiple of kEdJ and of
// 32), and each thread keeps its kEdJ dots in registers across the tiles
// and slides over each tile as the staged kernel slides over the whole
// row, so its dots, summed in the same order, have the same bits.  A
// thread takes the items (row le, offset group) tid, tid + threads, ...
// in rounds (more than one only past kEdThreads items: g > 4,096 at one
// row a block), each round streaming the query again.  The epilogue reads
// the window sums from the prefix sums in place (window_sums), the values
// the staged kernel's runs hold, and sum(q^2) is taken from device memory
// in the staged kernel's order; so d2 has the staged kernel's bits too.
template <int kMode>
__global__ void __launch_bounds__(kEdThreads) fused_gather_ed_long_kernel(
    const float* __restrict__ data, const float* __restrict__ csum,
    const float* __restrict__ csum2, const float* __restrict__ csum_lo,
    const float* __restrict__ csum2_lo, const float* __restrict__ center,
    const int* __restrict__ sids, const int* __restrict__ anchors,
    const int* __restrict__ n_master, const float* __restrict__ lbs2,
    const float* __restrict__ qs, float* __restrict__ out,
    const float* __restrict__ pool_d2, int* __restrict__ stats,
    float* __restrict__ part_d2, int* __restrict__ part_sid,
    int* __restrict__ part_off, int* __restrict__ part_pos,
    long long num_series, int n, int rows, int qlen, int g, int znorm,
    long long row_stride, long long col0, int k, int kp, int tile,
    int qlen_pad, int ngrp, int stride, int ptile,
    const int* __restrict__ ovf, int n_chunks,
    const float* __restrict__ gkth) {
  constexpr bool kChunk = kMode != 0, kRange = kMode == 2;
  extern __shared__ __align__(16) float ed_smem[];
  float* q_s = ed_smem;                       // [ptile]
  float* reg_s = q_s + ptile;                 // [tile * stride]
  float* cd_s = reg_s + tile * stride;        // chunk: [tile * g] d2
  int* cp_s = reinterpret_cast<int*>(cd_s + tile * g);   // and positions
  __shared__ int row_sid[kEdTile], row_anc[kEdTile], row_jl[kEdTile];
  __shared__ float qss_s;
  __shared__ int count_s;

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * tile;
  const int tid = threadIdx.x;
  const int reg = qlen + g - 1;
  // kth: the pool's own k-th, the pre-select's cut (a shard's pool takes
  // every candidate below it, whatever the mesh-wide k-th)
  float kth, cut;
  const bool work = chunk_block_rows<kMode>(
      sids, anchors, n_master, lbs2, pool_d2, gkth, ovf, stats, n, rows,
      qlen, g, row_stride, col0, k, n_chunks, tile, 2, row_sid, row_anc,
      row_jl, &count_s, &kth, &cut);
  const long long at = ((long long)b * gridDim.x + blockIdx.x) * kp;
  const int* rsid = row_sid;
  const int* ranc = row_anc;
  auto sid_off = [=](int p, int* sid, int* off) {
    const int r = p / g;
    *sid = rsid[r - r0];
    *off = ranc[r - r0] + (p - r * g);
  };
  if (!work) {
    if (kMode == 1)
      write_block_topk(cd_s, cp_s, 0, kp, part_d2 + at, part_sid + at,
                       part_off + at, part_pos + at, sid_off);
    if (kRange) ed_range_out(cd_s, false, out, rows, g, tile);
    return;
  }
  if (kRange)   // the dense d2: +inf but at the ok candidates
    for (int idx = tid; idx < tile * g; idx += blockDim.x)
      cd_s[idx] = INFINITY;
  if (!znorm && tid < 32) {
    const float* q = qs + (long long)b * qlen;
    float part = 0.f;
    for (int t = tid; t < qlen; t += 32) part = __fmaf_rn(q[t], q[t], part);
    for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(kFull, part, o);
    if (tid == 0) qss_s = part;
  }

  const long long last = num_series * (long long)(n + 1) - 1;
  for (int base = 0; base < tile * ngrp; base += blockDim.x) {
    const int item = base + tid;
    const int le = item % tile, grp = item / tile;
    const int j0 = grp * kEdJ;
    const int row_lim = row_jl[le];
    const bool mine = item < tile * ngrp && j0 < row_lim;
    float acc[kEdJ];
#pragma unroll
    for (int jj = 0; jj < kEdJ; ++jj) acc[jj] = 0.f;
    for (int t0 = 0; t0 < qlen_pad; t0 += ptile) {
      const int len = qlen_pad - t0 < ptile ? qlen_pad - t0 : ptile;
      __syncthreads();                  // the last tile is consumed
      ed_stage(data, qs, q_s, reg_s, row_sid, row_anc, row_jl, num_series,
               n, qlen, reg, tile, stride, t0, len);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (mine) ed_slide(reg_s + le * stride + j0, q_s, len, acc);
    }
    if (mine) {
      const int r = r0 + le;
      const long long sid = row_sid[le];
#pragma unroll
      for (int jj = 0; jj < kEdJ; ++jj) {
        const int j = j0 + jj;
        if (j < row_lim) {
          float s1, s2;
          window_sums(csum, csum2, csum_lo, csum2_lo, sid, row_anc[le] + j,
                      n, qlen, last, &s1, &s2);
          const float d2 = ed_d2(s1, s2, acc[jj], qlen, znorm,
                                 znorm ? 0.f : center[sid], qss_s);
          if (!kChunk) {
            out[((long long)b * rows + r) * g + j] = d2;
          } else if (kRange) {
            cd_s[le * g + j] = d2;
          } else if (d2 < kth) {
            const int slot = atomicAdd(&count_s, 1);
            cd_s[slot] = d2;
            cp_s[slot] = r * g + j;
          }
        }
      }
    }
  }
  if (kChunk) __syncthreads();
  if (kMode == 1)
    write_block_topk(cd_s, cp_s, count_s, kp, part_d2 + at, part_sid + at,
                     part_off + at, part_pos + at, sid_off);
  if (kRange) ed_range_out(cd_s, true, out, rows, g, tile);
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

// The long-row LB_Keogh kernel's pieces (lb_window_stats, lb_results).
// The staged kernel below writes the same arithmetic out in place: built
// from these helpers it ran ~2% slower at qlen 256 on an H100.
// (mu, sd, 1 / sd) of kLbJ consecutive windows of series sid starting at
// off0, from the prefix sums (raw: 0, 1), and their sums zeroed: the
// plain version's divides and square root, s2 / L - mu_c^2 without
// contraction.
__device__ __forceinline__ void lb_window_stats(
    const float* __restrict__ csum, const float* __restrict__ csum2,
    const float* __restrict__ csum_lo, const float* __restrict__ csum2_lo,
    const float* __restrict__ center, long long sid, int off0, int n,
    int qlen, long long last, int znorm, float (&mu)[kLbJ],
    float (&sd)[kLbJ], float (&y)[kLbJ], float (&acc)[kLbJ]) {
#pragma unroll
  for (int jj = 0; jj < kLbJ; ++jj) {
    mu[jj] = 0.f;
    sd[jj] = 1.f;
    if (znorm) {
      float s1, s2;
      window_sums(csum, csum2, csum_lo, csum2_lo, sid, off0 + jj, n, qlen,
                  last, &s1, &s2);
      const float mu_c = s1 / qlen;
      const float var = __fsub_rn(s2 / qlen, __fmul_rn(mu_c, mu_c));
      sd[jj] = fmaxf(sqrtf(fmaxf(var, 0.f)), 1e-8f);
      mu[jj] = mu_c + center[sid];
    }
    y[jj] = __frcp_rn(sd[jj]);
    acc[jj] = 0.f;
  }
}

// Windows j0 .. j0 + kLbJ - 1 of tile row le into res_s (lb2, mu, sd,
// each [tg]).
__device__ __forceinline__ void lb_results(float* res_s, int tg, int le,
                                           int j0, int g,
                                           const float (&mu)[kLbJ],
                                           const float (&sd)[kLbJ],
                                           const float (&acc)[kLbJ]) {
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

// The LB_Keogh chunk entries' own arguments (the contract entries pass
// row_stride = rows, col0 = 0 and nothing else): the (B, n_pad) plan's
// n_master and lbs2 (sids and anchors are the kernel's), the cut (the
// pool's (B, k) d2 with cut_stride = k, or eps2 (B,) with cut_stride =
// 1), ovf (range), the counters, and the outputs: each query's survivor
// list and count, the DP's (B, rows * g) output, and each candidate's
// (sid, off).
struct LbChunk {
  const int* n_master;
  const float* lbs2;
  const float* cut;
  const float* gkth;
  const int* ovf;
  int* stats;
  int* slist;
  int* nsurv;
  float* dp_out;
  int* cand_sid;
  int* cand_off;
  long long row_stride, col0;
  int cut_stride, n_chunks;
};

// The LB kernels' prologue (chunk_block_rows): every mode reads the
// tile's (sid, anchor) once into row_sid / row_anc, which the staging
// and the window statistics read; the chunk entries also decide active,
// keep and the ok offsets of each row and add the counters [active,
// kept, -, ok, -, pruned].  Every thread calls it.
template <int kMode>
__device__ __forceinline__ void lb_block_rows(
    const int* __restrict__ sids, const int* __restrict__ anchors,
    const LbChunk& c, int n, int rows, int qlen, int g, int tile,
    int* row_sid, int* row_anc, int* row_jl, int* count_s, float* cut) {
  float own;
  chunk_block_rows<kMode>(sids, anchors, c.n_master, c.lbs2, c.cut, c.gkth,
                          c.ovf, c.stats, n, rows, qlen, g, c.row_stride,
                          c.col0, c.cut_stride, c.n_chunks, tile, 3,
                          row_sid, row_anc, row_jl, count_s, &own, cut);
}

// The tile's results (res_s: lb2, mu, sd, each [tile * g]) out.  The
// tile's rows are consecutive: (lb2, mu, sd) out in coalesced stores;
// entry at = (b * rows + r0) * g + idx is position r0 * g + idx of query
// b's chunk.  The chunk entries (kMode 1: k-NN, 2: range) also mask: lb2
// = +inf where not an ok candidate (offset j < row_jl of a kept row);
// list each survivor (ok and lb2 < cut, or <= cut for range) in slist[b,
// :] by a warp-aggregated atomicAdd on nsurv[b] (zeroed before the
// launch; the list's order varies from run to run); write +inf into the
// DP's output at every other position; write every candidate's (sid,
// off); and add the block's survivors (the DPs to run) to the counters'
// true-distance and full-DP columns.
template <int kMode>
__device__ __forceinline__ void lb_write_out(
    const float* res_s, int tg, float* __restrict__ lb_out,
    float* __restrict__ mu_out, float* __restrict__ sd_out,
    const LbChunk& c, const int* row_sid, const int* row_anc,
    const int* row_jl, int* count_s, float cut, int rows, int g,
    int tile) {
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * tile;
  const long long at0 = ((long long)b * rows + r0) * g;
  const int count = (rows - r0 < tile ? rows - r0 : tile) * g;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < count; base += blockDim.x) {   // warp-uniform
    const int idx = base + threadIdx.x;
    const bool in = idx < count;
    const long long at = at0 + idx;
    float lb = in ? res_s[idx] : 0.f;
    if (kMode != 0) {
      bool surv = false;
      if (in) {
        const int le = idx / g, j = idx - le * g;
        if (j >= row_jl[le]) lb = INFINITY;
        else surv = kMode == 2 ? lb <= cut : lb < cut;
        c.cand_sid[at] = row_sid[le];
        c.cand_off[at] = row_anc[le] + j;
      }
      const unsigned mask = __ballot_sync(kFull, surv);
      if (mask) {
        const int leader = __ffs(mask) - 1;
        int slot = 0;
        if (lane == leader) {
          slot = atomicAdd(c.nsurv + b, __popc(mask));
          atomicAdd(count_s, __popc(mask));
        }
        slot = __shfl_sync(kFull, slot, leader) +
               __popc(mask & ((1u << lane) - 1u));
        if (surv)
          c.slist[(long long)b * rows * g + slot] = r0 * g + idx;
      }
      if (in && !surv) c.dp_out[at] = INFINITY;
    }
    if (in) {
      lb_out[at] = lb;
      mu_out[at] = res_s[tg + idx];
      sd_out[at] = res_s[2 * tg + idx];
    }
  }
  if (kMode != 0) {
    __syncthreads();
    if (threadIdx.x == 0 && *count_s) {
      int* st = c.stats + (long long)b * kStatsWidth;
      atomicAdd(st + 2, *count_s);
      atomicAdd(st + 4, *count_s);
    }
  }
}

// kMode 0: the contract entry; 1 and 2: the k-NN and range chunk entries
// (lb_block_rows, lb_write_out).  The chunk entries run the contract's
// arithmetic on every row of the chunk, kept or not, so lb2 (before the
// mask), mu and sd are the contract entry's bits.
template <int kMode>
__global__ void __launch_bounds__(kLbMaxThreads)
    fused_gather_lb_keogh_kernel(
        const float* __restrict__ data, const float* __restrict__ csum,
        const float* __restrict__ csum2, const float* __restrict__ csum_lo,
        const float* __restrict__ csum2_lo, const float* __restrict__ center,
        const int* __restrict__ sids, const int* __restrict__ anchors,
        const float* __restrict__ dtw_lo, const float* __restrict__ dtw_hi,
        float* __restrict__ lb_out, float* __restrict__ mu_out,
        float* __restrict__ sd_out, const LbChunk c, long long num_series,
        int n, int rows, int qlen, int g, int znorm, int tile, int qlen_pad,
        int ngrp, int stride) {
  extern __shared__ float smem[];
  float2* env_s = reinterpret_cast<float2*>(smem);   // [qlen_pad]
  float* reg_s = smem + 2 * qlen_pad;                // [tile * stride]
  float* res_s = reg_s + tile * stride;              // [3][tile * g]
  __shared__ int row_sid[kLbTile], row_anc[kLbTile], row_jl[kLbTile];
  __shared__ int count_s;
  const int tg = tile * g;

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * tile;
  for (int t = threadIdx.x; t < qlen_pad; t += blockDim.x)
    env_s[t] = t < qlen ? make_float2(dtw_lo[(long long)b * qlen + t],
                                      dtw_hi[(long long)b * qlen + t])
                        : make_float2(-INFINITY, INFINITY);
  float cut = INFINITY;
  lb_block_rows<kMode>(sids, anchors, c, n, rows, qlen, g, tile, row_sid,
                       row_anc, row_jl, &count_s, &cut);
  stage_regions(data, row_sid, row_anc, reg_s, num_series, n, rows, r0,
                tile, stride, qlen + g - 1);
  __syncthreads();

  const long long last = num_series * (long long)(n + 1) - 1;
  for (int item = threadIdx.x; item < tile * ngrp; item += blockDim.x) {
    // consecutive threads -> consecutive rows (odd stride: other banks)
    const int le = item % tile, grp = item / tile;
    const int r = r0 + le;
    if (r >= rows) continue;
    const long long sid = row_sid[le];
    const int j0 = grp * kLbJ;
    float mu[kLbJ], sd[kLbJ], y[kLbJ], acc[kLbJ];
#pragma unroll
    for (int jj = 0; jj < kLbJ; ++jj) {
      mu[jj] = 0.f;
      sd[jj] = 1.f;
      if (znorm) {
        float s1, s2;
        window_sums(csum, csum2, csum_lo, csum2_lo, sid,
                    row_anc[le] + j0 + jj, n, qlen, last, &s1, &s2);
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
  lb_write_out<kMode>(res_s, tg, lb_out, mu_out, sd_out, c, row_sid,
                      row_anc, row_jl, &count_s, cut, rows, g, tile);
}

// The long-row LB_Keogh kernel: the staged kernel's contract, for queries
// whose DTW envelope and regions do not fit shared memory whole.  Each
// thread takes the items (row le, window pair grp) tid, tid + threads,
// ... in rounds (more than one only past kLbMaxThreads items); the
// envelope and the tile's regions stream through shared memory in tiles
// of `ptile` points (a multiple of kLbJ), and the thread keeps its
// windows' (mu, sd) and sums in registers across the tiles, sliding over
// each tile as the staged kernel slides over the whole row: the same
// normalized values summed in the same order, so (lb2, mu, sd) have the
// staged kernel's bits.  kMode as the staged kernel's.
template <int kMode>
__global__ void __launch_bounds__(kLbMaxThreads)
    fused_gather_lb_keogh_long_kernel(
        const float* __restrict__ data, const float* __restrict__ csum,
        const float* __restrict__ csum2, const float* __restrict__ csum_lo,
        const float* __restrict__ csum2_lo, const float* __restrict__ center,
        const int* __restrict__ sids, const int* __restrict__ anchors,
        const float* __restrict__ dtw_lo, const float* __restrict__ dtw_hi,
        float* __restrict__ lb_out, float* __restrict__ mu_out,
        float* __restrict__ sd_out, const LbChunk c, long long num_series,
        int n, int rows, int qlen, int g, int znorm, int tile, int qlen_pad,
        int ngrp, int stride, int ptile) {
  extern __shared__ float smem[];
  float2* env_s = reinterpret_cast<float2*>(smem);   // [ptile]
  float* reg_s = smem + 2 * ptile;                   // [tile * stride]
  float* res_s = reg_s + tile * stride;              // [3][tile * g]
  __shared__ int row_sid[kLbTile], row_anc[kLbTile], row_jl[kLbTile];
  __shared__ int count_s;
  const int tg = tile * g;

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * tile;
  float cut = INFINITY;
  lb_block_rows<kMode>(sids, anchors, c, n, rows, qlen, g, tile, row_sid,
                       row_anc, row_jl, &count_s, &cut);
  const long long last = num_series * (long long)(n + 1) - 1;
  for (int base = 0; base < tile * ngrp; base += blockDim.x) {
    const int item = base + threadIdx.x;
    const int le = item % tile, grp = item / tile;
    const int r = r0 + le;
    const bool mine = item < tile * ngrp && r < rows;
    const int j0 = grp * kLbJ;
    float mu[kLbJ], sd[kLbJ], y[kLbJ], acc[kLbJ];
    if (mine)
      lb_window_stats(csum, csum2, csum_lo, csum2_lo, center, row_sid[le],
                      row_anc[le] + j0, n, qlen, last, znorm, mu, sd, y,
                      acc);
    for (int t0 = 0; t0 < qlen_pad; t0 += ptile) {
      const int len = qlen_pad - t0 < ptile ? qlen_pad - t0 : ptile;
      __syncthreads();                  // the last tile is consumed
      for (int t = threadIdx.x; t < len; t += blockDim.x) {
        const long long at = (long long)b * qlen + t0 + t;
        env_s[t] = t0 + t < qlen ? make_float2(dtw_lo[at], dtw_hi[at])
                                 : make_float2(-INFINITY, INFINITY);
      }
      stage_regions(data, row_sid, row_anc, reg_s, num_series, n, rows, r0,
                    tile, stride, qlen + g - 1, t0);
      __syncthreads();
      if (mine)
        lb_windows(reg_s + le * stride + j0, env_s, len, mu, sd, y, acc);
    }
    if (mine) lb_results(res_s, tg, le, j0, g, mu, sd, acc);
  }
  __syncthreads();
  lb_write_out<kMode>(res_s, tg, lb_out, mu_out, sd_out, c, row_sid,
                      row_anc, row_jl, &count_s, cut, rows, g, tile);
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

namespace {

// The ED kernel's block shape: up to kEdTile rows a block, fewer where
// the threads (one per row and offset group) or the shared memory would
// exceed their budgets.
struct EdShape {
  int tile, qlen_pad, ngrp, stride, run_stride, threads;
  size_t smem;
};

EdShape ed_shape(int qlen, int g, bool chunk) {
  EdShape s;
  s.qlen_pad = (qlen + kEdJ - 1) / kEdJ * kEdJ;
  s.ngrp = (g + kEdJ - 1) / kEdJ;
  // the slide reads up to (ngrp - 1) * kEdJ + qlen_pad + kEdJ - 2 a row
  s.stride = s.ngrp * kEdJ + s.qlen_pad - 1;
  if (s.stride % 2 == 0) ++s.stride;     // odd: conflict-free row starts
  // a run of up to g words from up to 3 words below: 16-byte aligned
  s.run_stride = (g + 3 + 3) / 4 * 4;
  auto smem_for = [&](int t) {
    return sizeof(float) *
           ((size_t)s.qlen_pad + 8 * (size_t)t * s.run_stride +
            (size_t)t * s.stride + (chunk ? 2 * (size_t)t * g : 0));
  };
  s.tile = kEdTile;
  while (s.tile > 1 && (s.tile * s.ngrp > kEdThreads ||
                        smem_for(s.tile) > kEdSmemBudget))
    s.tile /= 2;
  s.smem = smem_for(s.tile);
  s.threads = (s.tile * s.ngrp + 31) / 32 * 32;
  if (s.threads < kEdMinThreads) s.threads = kEdMinThreads;
  return s;
}

// The long ED kernel's block shape: a tile of kLongPoints query points
// and the rows' region points it reads; up to kEdTile rows a block, fewer
// where the items or the shared memory would exceed their budgets.  It
// does not grow with qlen (items past kEdThreads take rounds).
EdShape ed_long_shape(int qlen, int g, bool chunk) {
  EdShape s;
  s.qlen_pad = (qlen + kEdJ - 1) / kEdJ * kEdJ;
  s.ngrp = (g + kEdJ - 1) / kEdJ;
  s.stride = s.ngrp * kEdJ + kLongPoints - 1;   // odd
  s.run_stride = 0;
  auto smem_for = [&](int t) {
    return sizeof(float) * ((size_t)kLongPoints + (size_t)t * s.stride +
                            (chunk ? 2 * (size_t)t * g : 0));
  };
  s.tile = kEdTile;
  while (s.tile > 1 && (s.tile * s.ngrp > kEdThreads ||
                        smem_for(s.tile) > kEdSmemBudget))
    s.tile /= 2;
  s.smem = smem_for(s.tile);
  s.threads = (s.tile * s.ngrp + 31) / 32 * 32;
  if (s.threads < kEdMinThreads) s.threads = kEdMinThreads;
  if (s.threads > kEdThreads) s.threads = kEdThreads;
  return s;
}

// kMode: 0 the contract entry, 1 the k-NN chunk entry, 2 the range chunk
// entry (which shares the k-NN entry's block shape: its dense d2 goes out
// through the candidate buffer).
template <int kMode, bool kLong>
int launch_ed(const void* data, const void* csum, const void* csum2,
              const void* csum_lo, const void* csum2_lo, const void* center,
              const void* sids, const void* anchors, const void* n_master,
              const void* lbs2, const void* qs, void* out,
              const void* pool_d2, void* stats, void* part,
              long long num_series, int n, int batch, int rows, int qlen,
              int g, int znorm, long long row_stride, long long col0, int k,
              void* stream, const void* ovf = nullptr, int n_chunks = 0,
              const void* gkth = nullptr) {
  if (batch < 1 || rows < 1 || g < 1 || qlen < 1 || qlen > n ||
      batch > 65535 || k < 1)
    return (int)cudaErrorInvalidValue;
  const EdShape s = kLong ? ed_long_shape(qlen, g, kMode != 0)
                          : ed_shape(qlen, g, kMode != 0);
  if (s.threads > kEdThreads || s.smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  // the two kernels take the same arguments; the last is the staged
  // kernel's run stride or the long kernel's points a tile
  auto kernel = kLong ? fused_gather_ed_long_kernel<kMode>
                      : fused_gather_ed_kernel<kMode>;
  if (s.smem > kSmemBudget) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
    if (err) return err;
  }
  const int n_blocks = (rows + s.tile - 1) / s.tile;
  const int kp = k < s.tile * g ? k : s.tile * g;
  // partials (4, B, n_blocks, kp) int32: d2 (float bits), sid, off, pos
  const long long plane = (long long)batch * n_blocks * kp;
  int* p = static_cast<int*>(part);
  const dim3 grid(n_blocks, batch);
  kernel<<<grid, s.threads, s.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const float*>(csum),
      static_cast<const float*>(csum2), static_cast<const float*>(csum_lo),
      static_cast<const float*>(csum2_lo), static_cast<const float*>(center),
      static_cast<const int*>(sids), static_cast<const int*>(anchors),
      static_cast<const int*>(n_master), static_cast<const float*>(lbs2),
      static_cast<const float*>(qs), static_cast<float*>(out),
      static_cast<const float*>(pool_d2), static_cast<int*>(stats),
      reinterpret_cast<float*>(p), p ? p + plane : nullptr,
      p ? p + 2 * plane : nullptr, p ? p + 3 * plane : nullptr, num_series,
      n, rows, qlen, g, znorm, row_stride, col0, k, kp, s.tile, s.qlen_pad,
      s.ngrp, s.stride, kLong ? kLongPoints : s.run_stride,
      static_cast<const int*>(ovf), n_chunks,
      static_cast<const float*>(gkth));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ulisse_fused_gather_ed(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* qs, void* out,
    long long num_series, int n, int batch, int rows, int qlen, int g,
    int znorm, void* stream) {
  return launch_ed<0, false>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, nullptr,
      nullptr, qs, out, nullptr, nullptr, nullptr, num_series, n, batch, rows,
      qlen, g, znorm, rows, 0, 1, stream);
}

// The long-row kernel behind the same contract (any qlen).
extern "C" int ulisse_fused_gather_ed_long(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* qs, void* out,
    long long num_series, int n, int batch, int rows, int qlen, int g,
    int znorm, void* stream) {
  return launch_ed<0, true>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, nullptr,
      nullptr, qs, out, nullptr, nullptr, nullptr, num_series, n, batch, rows,
      qlen, g, znorm, rows, 0, 1, stream);
}

// Rows a block of the chunk entry takes at (qlen, g): its partials are
// (B, ceil(rows / tile), min(k, tile * g)).  -1 where no block fits (the
// query and its regions do not fit shared memory whole).
extern "C" int ulisse_fused_gather_ed_chunk_tile(int qlen, int g) {
  if (qlen < 1 || g < 1) return -1;
  const EdShape s = ed_shape(qlen, g, true);
  return s.threads > kEdThreads || s.smem > kSmemMax ? -1 : s.tile;
}

// The same for the long-row chunk entry, at any qlen; -1 where no block
// fits (g past 18,688: its candidate buffer and region tile grow with g).
extern "C" int ulisse_fused_gather_ed_chunk_long_tile(int qlen, int g) {
  if (qlen < 1 || g < 1) return -1;
  const EdShape s = ed_long_shape(qlen, g, true);
  return s.smem > kSmemMax ? -1 : s.tile;
}

extern "C" int ulisse_fused_gather_ed_chunk(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* n_master,
    const void* lbs2, const void* qs, const void* pool_d2, const void* gkth,
    void* stats, void* part, long long num_series, int n, int batch,
    int rows, int qlen, int g, int znorm, long long n_pad, long long col0,
    int k, void* stream) {
  if (col0 < 0 || col0 + rows > n_pad) return (int)cudaErrorInvalidValue;
  return launch_ed<1, false>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, n_master,
      lbs2, qs, nullptr, pool_d2, stats, part, num_series, n, batch, rows,
      qlen, g, znorm, n_pad, col0, k, stream, nullptr, 0, gkth);
}

// The long-row kernel behind the chunk entry's contract (any qlen).
extern "C" int ulisse_fused_gather_ed_chunk_long(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* n_master,
    const void* lbs2, const void* qs, const void* pool_d2, const void* gkth,
    void* stats, void* part, long long num_series, int n, int batch,
    int rows, int qlen, int g, int znorm, long long n_pad, long long col0,
    int k, void* stream) {
  if (col0 < 0 || col0 + rows > n_pad) return (int)cudaErrorInvalidValue;
  return launch_ed<1, true>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, n_master,
      lbs2, qs, nullptr, pool_d2, stats, part, num_series, n, batch, rows,
      qlen, g, znorm, n_pad, col0, k, stream, nullptr, 0, gkth);
}

// The range mode of the chunk entry: eps2 (B,) in place of the pool,
// inclusive cuts, `active` also reading ovf (B,) (the hit buffer's first
// unwritten chunk, n_chunks while it never overflowed), and the dense
// (B, rows * g) d2 in `out` (+inf wherever not an ok candidate) in place
// of the partials.  The counters as the k-NN mode's.
extern "C" int ulisse_fused_gather_ed_range(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* n_master,
    const void* lbs2, const void* qs, const void* eps2, const void* ovf,
    void* stats, void* out, long long num_series, int n, int batch,
    int rows, int qlen, int g, int znorm, long long n_pad, long long col0,
    int n_chunks, void* stream) {
  if (col0 < 0 || col0 + rows > n_pad) return (int)cudaErrorInvalidValue;
  return launch_ed<2, false>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, n_master,
      lbs2, qs, out, eps2, stats, nullptr, num_series, n, batch, rows, qlen,
      g, znorm, n_pad, col0, 1, stream, ovf, n_chunks);
}

// The long-row kernel behind the range entry's contract (any qlen).
extern "C" int ulisse_fused_gather_ed_range_long(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* n_master,
    const void* lbs2, const void* qs, const void* eps2, const void* ovf,
    void* stats, void* out, long long num_series, int n, int batch,
    int rows, int qlen, int g, int znorm, long long n_pad, long long col0,
    int n_chunks, void* stream) {
  if (col0 < 0 || col0 + rows > n_pad) return (int)cudaErrorInvalidValue;
  return launch_ed<2, true>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, n_master,
      lbs2, qs, out, eps2, stats, nullptr, num_series, n, batch, rows, qlen,
      g, znorm, n_pad, col0, 1, stream, ovf, n_chunks);
}

namespace {

// The LB_Keogh kernel's block shape: up to kLbTile rows a block, fewer
// where the shared memory would exceed its budget.
struct LbShape {
  int tile, qlen_pad, ngrp, stride, threads;
  size_t smem;
};

LbShape lb_shape(int qlen, int g) {
  LbShape s;
  s.qlen_pad = (qlen + kLbJ - 1) / kLbJ * kLbJ;
  s.ngrp = (g + kLbJ - 1) / kLbJ;
  // the slide reads up to (ngrp - 1) * kLbJ + qlen_pad + kLbJ - 2 a row
  s.stride = s.ngrp * kLbJ + s.qlen_pad - 1;
  if (s.stride % 2 == 0) ++s.stride;     // odd: conflict-free row starts
  auto smem_for = [&](int t) {
    return sizeof(float) *
           (2 * (size_t)s.qlen_pad + (size_t)t * s.stride + 3 * (size_t)t * g);
  };
  s.tile = kLbTile;
  while (s.tile > 1 && smem_for(s.tile) > kSmemBudget) s.tile /= 2;
  s.smem = smem_for(s.tile);
  s.threads = s.tile * s.ngrp;
  s.threads = s.threads > kLbMaxThreads ? kLbMaxThreads
                                        : (s.threads + 31) / 32 * 32;
  return s;
}

// The long LB_Keogh kernel's block shape: a tile of kLongPoints envelope
// points and the rows' region points it reads; up to kLbTile rows a
// block, fewer where the shared memory would exceed its budget.  It does
// not grow with qlen.
LbShape lb_long_shape(int qlen, int g) {
  LbShape s;
  s.qlen_pad = (qlen + kLbJ - 1) / kLbJ * kLbJ;
  s.ngrp = (g + kLbJ - 1) / kLbJ;
  s.stride = s.ngrp * kLbJ + kLongPoints - 1;   // odd
  auto smem_for = [&](int t) {
    return sizeof(float) * (2 * (size_t)kLongPoints + (size_t)t * s.stride +
                            3 * (size_t)t * g);
  };
  s.tile = kLbTile;
  while (s.tile > 1 && smem_for(s.tile) > kSmemBudget) s.tile /= 2;
  s.smem = smem_for(s.tile);
  s.threads = s.tile * s.ngrp;
  s.threads = s.threads > kLbMaxThreads ? kLbMaxThreads
                                        : (s.threads + 31) / 32 * 32;
  return s;
}

// kMode: 0 the contract entry, 1 the k-NN chunk entry, 2 the range chunk
// entry.  The chunk entries zero nsurv before their launch (a memset on
// the stream, not a kernel).
template <int kMode, bool kLong>
int launch_lb_keogh(const void* data, const void* csum, const void* csum2,
                    const void* csum_lo, const void* csum2_lo,
                    const void* center, const void* sids, const void* anchors,
                    const void* dtw_lo, const void* dtw_hi, void* lb,
                    void* mu, void* sd, const LbChunk& c,
                    long long num_series, int n, int batch, int rows,
                    int qlen, int g, int znorm, void* stream) {
  if (batch < 1 || rows < 1 || g < 1 || qlen < 1 || qlen > n ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const LbShape sh = kLong ? lb_long_shape(qlen, g) : lb_shape(qlen, g);
  const int tile = sh.tile, qlen_pad = sh.qlen_pad, ngrp = sh.ngrp;
  const int stride = sh.stride;
  const size_t smem = sh.smem;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const void* kernel =
      kLong ? (const void*)fused_gather_lb_keogh_long_kernel<kMode>
            : (const void*)fused_gather_lb_keogh_kernel<kMode>;
  if (smem > kSmemBudget) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  const dim3 grid((rows + tile - 1) / tile, batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kMode != 0) {
    const int err =
        (int)cudaMemsetAsync(c.nsurv, 0, sizeof(int) * (size_t)batch, st);
    if (err) return err;
  }
  const float* a_data = static_cast<const float*>(data);
  const float* a_cs = static_cast<const float*>(csum);
  const float* a_cs2 = static_cast<const float*>(csum2);
  const float* a_cl = static_cast<const float*>(csum_lo);
  const float* a_cl2 = static_cast<const float*>(csum2_lo);
  const float* a_c = static_cast<const float*>(center);
  const int* a_sids = static_cast<const int*>(sids);
  const int* a_anc = static_cast<const int*>(anchors);
  const float* a_lo = static_cast<const float*>(dtw_lo);
  const float* a_hi = static_cast<const float*>(dtw_hi);
  float* a_lb = static_cast<float*>(lb);
  float* a_mu = static_cast<float*>(mu);
  float* a_sd = static_cast<float*>(sd);
  if (kLong)
    fused_gather_lb_keogh_long_kernel<kMode><<<grid, sh.threads, smem, st>>>(
        a_data, a_cs, a_cs2, a_cl, a_cl2, a_c, a_sids, a_anc, a_lo, a_hi,
        a_lb, a_mu, a_sd, c, num_series, n, rows, qlen, g, znorm, tile,
        qlen_pad, ngrp, stride, kLongPoints);
  else
    fused_gather_lb_keogh_kernel<kMode><<<grid, sh.threads, smem, st>>>(
        a_data, a_cs, a_cs2, a_cl, a_cl2, a_c, a_sids, a_anc, a_lo, a_hi,
        a_lb, a_mu, a_sd, c, num_series, n, rows, qlen, g, znorm, tile,
        qlen_pad, ngrp, stride);
  return (int)cudaGetLastError();
}

// The contract entries' chunk arguments: rows straight from sids/anchors.
LbChunk lb_contract(int rows) {
  LbChunk c = {};
  c.row_stride = rows;
  return c;
}

// The chunk entries' arguments: the plan (B, n_pad), its chunk at col0
// (rows columns), the cut (cut_stride = k: the pool's (B, k) d2; 1:
// eps2), ovf (range), the counters and the outputs.
int lb_chunk(LbChunk* c, const void* n_master, const void* lbs2,
             const void* cut, const void* gkth, const void* ovf,
             void* stats, void* slist,
             void* nsurv, void* dp_out, void* cand_sid, void* cand_off,
             int rows, long long n_pad, long long col0, int cut_stride,
             int n_chunks) {
  if (col0 < 0 || col0 + rows > n_pad || cut_stride < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  c->n_master = static_cast<const int*>(n_master);
  c->lbs2 = static_cast<const float*>(lbs2);
  c->cut = static_cast<const float*>(cut);
  c->gkth = static_cast<const float*>(gkth);
  c->ovf = static_cast<const int*>(ovf);
  c->stats = static_cast<int*>(stats);
  c->slist = static_cast<int*>(slist);
  c->nsurv = static_cast<int*>(nsurv);
  c->dp_out = static_cast<float*>(dp_out);
  c->cand_sid = static_cast<int*>(cand_sid);
  c->cand_off = static_cast<int*>(cand_off);
  c->row_stride = n_pad;
  c->col0 = col0;
  c->cut_stride = cut_stride;
  c->n_chunks = n_chunks;
  return 0;
}

template <bool kLong>
int launch_lb_chunk(const void* data, const void* csum, const void* csum2,
                    const void* csum_lo, const void* csum2_lo,
                    const void* center, const void* sids, const void* anchors,
                    const void* n_master, const void* lbs2,
                    const void* dtw_lo, const void* dtw_hi, const void* cut,
                    const void* gkth, const void* ovf, void* stats, void* lb,
                    void* mu,
                    void* sd, void* slist, void* nsurv, void* dp_out,
                    void* cand_sid, void* cand_off, long long num_series,
                    int n, int batch, int rows, int qlen, int g, int znorm,
                    long long n_pad, long long col0, int k, int range,
                    int n_chunks, void* stream) {
  LbChunk c;
  if (range && gkth != nullptr) return (int)cudaErrorInvalidValue;
  const int err = lb_chunk(&c, n_master, lbs2, cut, gkth, ovf, stats, slist,
                           nsurv, dp_out, cand_sid, cand_off, rows, n_pad,
                           col0, range ? 1 : k, n_chunks);
  if (err) return err;
  return range ? launch_lb_keogh<2, kLong>(
                     data, csum, csum2, csum_lo, csum2_lo, center, sids,
                     anchors, dtw_lo, dtw_hi, lb, mu, sd, c, num_series, n,
                     batch, rows, qlen, g, znorm, stream)
               : launch_lb_keogh<1, kLong>(
                     data, csum, csum2, csum_lo, csum2_lo, center, sids,
                     anchors, dtw_lo, dtw_hi, lb, mu, sd, c, num_series, n,
                     batch, rows, qlen, g, znorm, stream);
}

}  // namespace

extern "C" int ulisse_fused_gather_lb_keogh(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* dtw_lo,
    const void* dtw_hi, void* lb, void* mu, void* sd, long long num_series,
    int n, int batch, int rows, int qlen, int g, int znorm, void* stream) {
  return launch_lb_keogh<0, false>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, dtw_lo,
      dtw_hi, lb, mu, sd, lb_contract(rows), num_series, n, batch, rows,
      qlen, g, znorm, stream);
}

// The long-row kernel behind the same contract (any qlen).
extern "C" int ulisse_fused_gather_lb_keogh_long(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* dtw_lo,
    const void* dtw_hi, void* lb, void* mu, void* sd, long long num_series,
    int n, int batch, int rows, int qlen, int g, int znorm, void* stream) {
  return launch_lb_keogh<0, true>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, dtw_lo,
      dtw_hi, lb, mu, sd, lb_contract(rows), num_series, n, batch, rows,
      qlen, g, znorm, stream);
}

// Rows a block of the LB_Keogh entries takes at (qlen, g); -1 where no
// block fits (the envelope and the regions do not fit shared memory
// whole).
extern "C" int ulisse_fused_gather_lb_keogh_tile(int qlen, int g) {
  if (qlen < 1 || g < 1) return -1;
  const LbShape s = lb_shape(qlen, g);
  return s.smem > kSmemMax ? -1 : s.tile;
}

// The same for the long-row entries, at any qlen; -1 where no block fits
// (g past 13,760: the block's results and region tile grow with g).
extern "C" int ulisse_fused_gather_lb_keogh_long_tile(int qlen, int g) {
  if (qlen < 1 || g < 1) return -1;
  const LbShape s = lb_long_shape(qlen, g);
  return s.smem > kSmemMax ? -1 : s.tile;
}

// The scan's LB_Keogh step over chunk col0 / rows of the (B, n_pad) plan
// (sids, anchors, n_master, lbs2), in either cut: k-NN (range = 0; cut
// the pool's (B, k) d2, strict, or min(its k-th, gkth[b]) where the
// sharded scan's gkth (B,) is given; nullptr otherwise) or range (range = 1; cut eps2 (B,),
// inclusive, `active` also reading ovf: the buffer never overflowed
// while ovf[b] == n_chunks, the whole plan's chunk count; a paged scan's
// one-chunk slab passes its plan's).  It decides active, keep and
// the ok candidates itself, adds [active, kept, survivors, ok,
// survivors, pruned] to stats (B, 6) in place, writes lb2 (+inf where
// not ok), mu, sd (each (B, rows * g)), the survivor list and count,
// the DP's output (+inf at every non-survivor) and each candidate's
// (sid, off) (each (B, rows * g)).
extern "C" int ulisse_fused_gather_lb_keogh_chunk(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* n_master,
    const void* lbs2, const void* dtw_lo, const void* dtw_hi,
    const void* cut, const void* gkth, const void* ovf, void* stats,
    void* lb, void* mu, void* sd, void* slist, void* nsurv, void* dp_out,
    void* cand_sid, void* cand_off, long long num_series, int n, int batch,
    int rows, int qlen, int g, int znorm, long long n_pad, long long col0,
    int k, int range, int n_chunks, void* stream) {
  return launch_lb_chunk<false>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, n_master,
      lbs2, dtw_lo, dtw_hi, cut, gkth, ovf, stats, lb, mu, sd, slist, nsurv,
      dp_out, cand_sid, cand_off, num_series, n, batch, rows, qlen, g, znorm,
      n_pad, col0, k, range, n_chunks, stream);
}

// The long-row kernel behind the chunk entry's contract (any qlen).
extern "C" int ulisse_fused_gather_lb_keogh_chunk_long(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* n_master,
    const void* lbs2, const void* dtw_lo, const void* dtw_hi,
    const void* cut, const void* gkth, const void* ovf, void* stats,
    void* lb, void* mu, void* sd, void* slist, void* nsurv, void* dp_out,
    void* cand_sid, void* cand_off, long long num_series, int n, int batch,
    int rows, int qlen, int g, int znorm, long long n_pad, long long col0,
    int k, int range, int n_chunks, void* stream) {
  return launch_lb_chunk<true>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, n_master,
      lbs2, dtw_lo, dtw_hi, cut, gkth, ovf, stats, lb, mu, sd, slist, nsurv,
      dp_out, cand_sid, cand_off, num_series, n, batch, rows, qlen, g, znorm,
      n_pad, col0, k, range, n_chunks, stream);
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
