// Fused candidate-window gather + squared ED / LB_Keogh for ULISSE, for
// Hopper.  Two kernels over one region gather and one prefix-sum window
// statistic, each with the TPU kernel's contract entry and the scan's
// chunk entry: ulisse_fused_gather_ed (_chunk) and
// ulisse_fused_gather_lb_keogh (_chunk).  Each entry has a long-row
// variant (_long) for queries past its staging, with the same results
// at any qlen and g: the long-row ED variants take blocks of a few rows
// and up to 1,024 offsets of each, one thread a row and 4 offsets (a
// row's offsets past 1,024 split into tiles, a block each: grid z), the
// query and the regions streamed in double-buffered cp.async tiles
// (fused_gather_ed_long_kernel); the long-row LB_Keogh variants take
// blocks of consecutive windows, one a thread.
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
constexpr int kEdLongJ = 4;          // long ED kernel: offsets a thread
constexpr int kEdLongThreads = 256;  // long ED kernel: largest block
constexpr int kEdLongRows = 32;      // long ED kernel: rows a block, at most
constexpr int kLbFlatMaxThreads = 1024;   // long LB_Keogh kernel: windows a
                                          // block (one a thread), at most
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
// An offset-tiled block (the long kernels past one block's g) takes only
// offsets [j_lo, j_lo + gt) of its rows (gt >= 0; -1: all g): row_anc
// then holds anchor + j_lo, the tile's region start, and row_jl the
// tile's ok offsets, clipped to [0, gt).  Ok candidates add up over a
// row's tiles; `active`, kept and pruned rows are counted by its first.
template <int kMode>
__device__ __forceinline__ bool chunk_block_rows(
    const int* __restrict__ sids, const int* __restrict__ anchors,
    const int* __restrict__ n_master, const float* __restrict__ lbs2,
    const float* __restrict__ pool_d2, const float* __restrict__ gkth,
    const int* __restrict__ ovf, int* __restrict__ stats, int n, int rows,
    int qlen, int g, long long row_stride, long long col0, int k,
    int n_chunks, int tile, int ok_col, int* row_sid, int* row_anc,
    int* row_jl, int* count_s, float* kth_out, float* cut_out,
    int j_lo = 0, int gt = -1) {
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
        if (gt >= 0) {            // this block's offset tile
          jl -= j_lo;
          jl = jl < 0 ? 0 : (jl > gt ? gt : jl);
          anc += j_lo;
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
        const bool lead = j_lo == 0;   // a row's first offset tile
        if (blockIdx.x == 0 && lead && active) atomicAdd(st + 0, 1);
        if (n_keep && lead) atomicAdd(st + 1, n_keep);
        if (n_ok) atomicAdd(st + ok_col, n_ok);
        if (n_pruned && lead) atomicAdd(st + 5, n_pruned);
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
// gt + j] (+inf wherever not an ok candidate; all +inf where the block has
// no work), out in coalesced stores at positions r0 * g ... of query b's
// (B, rows * g) row; an offset-tiled block (gt < g) writes offsets
// [j_lo, j_lo + gt) of each of its rows.
__device__ __forceinline__ void ed_range_out(const float* cd_s, bool work,
                                             float* __restrict__ out,
                                             int rows, int g, int tile,
                                             int j_lo = 0, int gt = -1) {
  const int r0 = blockIdx.x * tile;
  const long long at0 = ((long long)blockIdx.y * rows + r0) * g + j_lo;
  if (gt < 0 || gt == g) {
    const int count = (rows - r0 < tile ? rows - r0 : tile) * g;
    for (int idx = threadIdx.x; idx < count; idx += blockDim.x)
      out[at0 + idx] = work ? cd_s[idx] : INFINITY;
    return;
  }
  const int count = (rows - r0 < tile ? rows - r0 : tile) * gt;
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
    const int le = idx / gt;
    out[at0 + (long long)le * g + (idx - le * gt)] =
        work ? cd_s[idx] : INFINITY;
  }
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
    const float* __restrict__ gkth, int /*otile: the long kernel's*/) {
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

// The long-row ED kernel's sliding dots: kEdLongJ = 4 offsets j0 .. j0 + 3
// of one row over `len` query points (a multiple of 8) of a tile:
// acc[jj] = fmaf(region[j0 + t + jj], q[t], acc[jj]) in query order, the
// staged kernel's chain (ed_slide), so the same bits.  base (16-byte
// aligned) points at region word j0 of the row's tile, q at the tile's
// query; the region comes in 16-byte reads (neighbouring threads read
// neighbouring 16 bytes), the query in broadcast 16-byte reads, and the
// next 8 points' words are read while these 8 are summed.  Reads base[0,
// len + 12) and q[0, len + 8).
__device__ __forceinline__ void ed_slide_long(const float* base,
                                              const float* q, int len,
                                              float (&acc)[kEdLongJ]) {
  const float4* r4 = reinterpret_cast<const float4*>(base);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float4 ra = r4[0], rb = r4[1], rc = r4[2], qa = q4[0], qb = q4[1];
#pragma unroll 2
  for (int i = 0; i < len / 4; i += 2) {     // i: float4 index of t0
    const float4 nb = r4[i + 3], nc = r4[i + 4];
    const float4 nqa = q4[i + 2], nqb = q4[i + 3];
    const float rv[12] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y,
                          rb.z, rb.w, rc.x, rc.y, rc.z, rc.w};
    const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
    for (int tt = 0; tt < 8; ++tt) {
#pragma unroll
      for (int jj = 0; jj < kEdLongJ; ++jj)
        acc[jj] = fmaf(rv[tt + jj], qv[tt], acc[jj]);
    }
    ra = rc;
    rb = nb;
    rc = nc;
    qa = nqa;
    qb = nqb;
  }
}

// The long ED kernel's region row stride (floats) at ngrp offset groups a
// row and tiles of ptile points: the words a row's threads read (ngrp
// kEdLongJ + ptile + 8, ed_slide_long), rounded up to 16 bytes, and then
// to s4 16-byte words with s4 = ngrp (mod 8): thread (row le, group grp)
// reads word le s4 + grp + i at step 4 i, = its flat index le ngrp + grp
// + i (mod 8), so the 8 threads of a quarter warp read 8 distinct 16-byte
// bank groups, also across a row's end.
__host__ __device__ inline int ed_long_stride(int ngrp, int ptile) {
  int s4 = (ngrp * kEdLongJ + ptile + 8 + 3) / 4;
  s4 += ((ngrp - s4) % 8 + 8) % 8;
  return 4 * s4;
}

// The Hopper bulk copy (cp.async.bulk, the TMA's one-dimensional form)
// and the shared-memory barrier (mbarrier) that counts its bytes.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that expects `bytes` more of bulk copies in this phase.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      " .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Stage tile t0 (len points; q_s[len, len + 8) is never summed) of the
// query and of the regions of the block's rows with work into one buffer:
// q_s[t] = q[t0 + t] (0 past qlen) and, for row le, reg_s[le stride + u]
// = data[vs + t0 + u] for u < width, vs = the flat start of the row's
// region rounded down to 16 bytes (row_sh[le] words below it), so region
// point p sits at u = p + row_sh[le] - t0.  Thread 0 copies the query's
// 16-byte words and every row that lies inside the array with bulk
// copies counted by `bar` (their words past the region only ever meet
// the query's zero padding, so they need not be the staged kernel's
// zeros); the rest goes through cp.async, word by word where a piece
// holds a point past the region (0 there, as the staged kernel pads) or
// past the array (clipped to it, as the staged kernel reads).  Every
// call arrives on `bar` once.
__device__ __forceinline__ void ed_long_stage(
    const float* __restrict__ data, const float* __restrict__ qs,
    float* q_s, float* reg_s, const int* row_sid, const int* row_anc,
    const int* row_jl, const int* row_sh, long long num_series, int n,
    int qlen, int reg, int tile, int stride, int width, int t0, int len,
    unsigned long long* bar) {
  const int tid = threadIdx.x;
  const float* q = qs + (long long)blockIdx.y * qlen + t0;
  const int valid = qlen - t0 < len ? qlen - t0 : len;
  const int nq = (reinterpret_cast<unsigned long long>(q) & 15) == 0
                     ? valid & ~3 : 0;       // query words by bulk copy
  const long long total = num_series * (long long)n;
  const bool data16 = (reinterpret_cast<unsigned long long>(data) & 15) == 0;
  auto base_of = [&](int le) {
    return (long long)row_sid[le] * n + row_anc[le] - row_sh[le] + t0;
  };
  auto bulk_row = [&](int le) {
    const long long base = base_of(le);
    return data16 && row_jl[le] > 0 && base >= 0 && base + width <= total;
  };
  if (tid == 0) {
    unsigned bytes = 4u * nq;
    for (int le = 0; le < tile; ++le)
      if (bulk_row(le)) bytes += 4u * width;
    // the buffer's last reads and writes (the threads', cp.async's) come
    // before these copies (the caller's barrier)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(bar, bytes);
    if (nq) bulk_copy(q_s, q, 4u * nq, bar);
    for (int le = 0; le < tile; ++le)
      if (bulk_row(le))
        bulk_copy(reg_s + le * stride, data + base_of(le), 4u * width, bar);
  }
  for (int t = nq + tid; t < len; t += blockDim.x) {
    if (t < valid)
      cp_async4(q_s + t, q + t);
    else
      q_s[t] = 0.f;
  }
  for (int le = 0; le < tile; ++le) {
    if (row_jl[le] == 0 || bulk_row(le)) continue;
    float* dst = reg_s + le * stride;
    const long long base = base_of(le);
    const int live = reg - t0 + row_sh[le];   // words below: region points
    for (int u = 4 * tid; u < width; u += 4 * blockDim.x) {
      if (data16 && u + 4 <= live && base + u >= 0 && base + u + 4 <= total) {
        cp_async16(dst + u, data + base + u);
      } else {
        for (int e = 0; e < 4; ++e) {
          if (u + e < live) {
            long long flat = base + u + e;
            flat = flat < 0 ? 0 : (flat >= total ? total - 1 : flat);
            cp_async4(dst + u + e, data + flat);
          } else {
            dst[u + e] = 0.f;
          }
        }
      }
    }
  }
}

// The long-row ED kernel: the staged kernel's contract at any qlen and g.
// Rows as in the staged kernel (chunk_block_rows, the same modes).  Block
// (x, b, z) takes `tile` rows and the offsets [z otile, (z + 1) otile) of
// each (one offset tile: all g where otile >= g), one thread a (row,
// group of kEdLongJ offsets), threads of a row next to each other: a
// warp's region reads are 16-byte words side by side (ed_long_stride).
// A row's words in shared memory start at its region's flat start
// rounded down to 16 bytes, so a row's tile is one bulk copy (the TMA's
// one-dimensional cp.async.bulk, counted by a shared-memory barrier; a
// row at the array's ends goes word by word through cp.async); its
// first group starts up to 3 offsets early (those offsets are none of
// the row's: ngrp covers otile + 3).  The query and the rows' regions
// stream through shared memory in tiles of `ptile` points, double-
// buffered: after one barrier a tile, the next tile's copies fly while
// this one is summed, issued by one thread, so the summing threads
// spend no instructions on them (the 16-byte cp.async pieces they
// replaced cost ~25% of the kernel's time at [15]'s shape).  Each thread keeps its 4 dots in
// registers across the tiles and sums them in query order over the
// zero-padded qlen_pad, as the staged kernel does, so its d2 has the
// staged kernel's bits.  The epilogue reads the window sums from the
// prefix sums in place (window_sums), the values the staged kernel's
// runs hold, and sum(q^2) from device memory in the staged kernel's
// order.  The k-NN entry keeps a block's candidates with d2 < the pool's
// k-th and writes its kp best to the partials list of (row block, offset
// tile), every candidate keyed by its position r g + j in the chunk, so
// the merge is the untiled one's; the range entry writes its part of the
// dense d2.  The host picks (tile, otile, ptile) from (B, rows, g, qlen)
// and the SM count (fused_verify.ed_long_shape).
// Bound on the card: operations (2 qlen flops a window: at [15]'s B = 8,
// 128 rows, g 49, qlen 29,000, 2.9 GFLOP, 0.043 ms at 67 TFLOP/s).  Each
// dot is one in-order chain of qlen FMAs (the staged kernel's bits), so
// the work is 50,176 chains there: at 4 offsets a thread, 416 warps, one
// a scheduler, each bound by its own issue (~5 instructions a point: 4
// FMAs, a quarter of two 16-byte reads) and by shared memory (a warp's
// region and query reads take 2 of its 128-byte cycles a point).  Fewer
// offsets a thread would give more warps but read more shared memory a
// FMA; more would leave schedulers idle.
template <int kMode>
__global__ void __launch_bounds__(kEdLongThreads) fused_gather_ed_long_kernel(
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
    const float* __restrict__ gkth, int otile) {
  constexpr bool kChunk = kMode != 0, kRange = kMode == 2;
  extern __shared__ __align__(16) float ed_smem[];
  float* q_s = ed_smem;                           // [2][ptile + 8]
  float* reg_s = q_s + 2 * (ptile + 8);           // [2][tile * stride]
  float* cd_s = reg_s + 2 * tile * stride;        // chunk: [tile * otile]
  int* cp_s = reinterpret_cast<int*>(cd_s + tile * otile);  // positions
  __shared__ int row_sid[kEdLongRows], row_anc[kEdLongRows],
      row_jl[kEdLongRows], row_sh[kEdLongRows];
  __shared__ __align__(8) unsigned long long bars[2];   // a buffer's
  __shared__ float qss_s;
  __shared__ int count_s;

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * tile;
  const int tid = threadIdx.x;
  // this block's offsets [j_lo, j_lo + gt); row_anc holds anchor + j_lo
  const int j_lo = blockIdx.z * otile;
  const int gt = g - j_lo < otile ? g - j_lo : otile;
  const int reg = qlen + gt - 1;
  // kth: the pool's own k-th, the pre-select's cut (a shard's pool takes
  // every candidate below it, whatever the mesh-wide k-th)
  float kth, cut;
  const bool work = chunk_block_rows<kMode>(
      sids, anchors, n_master, lbs2, pool_d2, gkth, ovf, stats, n, rows,
      qlen, g, row_stride, col0, k, n_chunks, tile, 2, row_sid, row_anc,
      row_jl, &count_s, &kth, &cut, j_lo, gt);
  const long long at =
      (((long long)b * gridDim.x + blockIdx.x) * gridDim.z + blockIdx.z) * kp;
  const int* rsid = row_sid;
  const int* ranc = row_anc;
  auto sid_off = [=](int p, int* sid, int* off) {
    const int r = p / g;
    *sid = rsid[r - r0];
    *off = ranc[r - r0] + (p - r * g) - j_lo;
  };
  if (!work) {
    if (kMode == 1)
      write_block_topk(cd_s, cp_s, 0, kp, part_d2 + at, part_sid + at,
                       part_off + at, part_pos + at, sid_off);
    if (kRange) ed_range_out(cd_s, false, out, rows, g, tile, j_lo, gt);
    return;
  }
  if (kRange)   // the dense d2: +inf but at the ok candidates
    for (int idx = tid; idx < tile * gt; idx += blockDim.x)
      cd_s[idx] = INFINITY;
  if (!znorm && tid < 32) {
    const float* q = qs + (long long)b * qlen;
    float part = 0.f;
    for (int t = tid; t < qlen; t += 32) part = __fmaf_rn(q[t], q[t], part);
    for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(kFull, part, o);
    if (tid == 0) qss_s = part;
  }

  // a row's words in the tiles start at its region's flat start rounded
  // down to 16 bytes, row_sh words below it (so 16-byte copies)
  if (tid < tile)
    row_sh[tid] = (int)(((long long)row_sid[tid] * n + row_anc[tid]) & 3);
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // this thread: row le, the 4 offsets j0 .. j0 + 3 of the block's,
  // j0 = 4 grp - row_sh[le] (the offsets below 0 are none of the row's)
  const int le = tid / ngrp, grp = tid - le * ngrp;
  const int row_lim = le < tile ? row_jl[le] : 0;
  const int j0 = grp * kEdLongJ - (le < tile ? row_sh[le] : 0);
  const bool mine = j0 + kEdLongJ > 0 && j0 < row_lim;
  const int width = ngrp * kEdLongJ + ptile + 8;
  const int n_tiles = (qlen_pad + ptile - 1) / ptile;
  float acc[kEdLongJ];
#pragma unroll
  for (int jj = 0; jj < kEdLongJ; ++jj) acc[jj] = 0.f;
  ed_long_stage(data, qs, q_s, reg_s, row_sid, row_anc, row_jl, row_sh,
                num_series, n, qlen, reg, tile, stride, width, 0,
                qlen_pad < ptile ? qlen_pad : ptile, &bars[0]);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();     // tile `it`'s word copies in place; the other
                         // buffer consumed
    const int t1 = (it + 1) * ptile;
    if (t1 < qlen_pad)
      ed_long_stage(data, qs, q_s + (buf ^ 1) * (ptile + 8),
                    reg_s + (buf ^ 1) * tile * stride, row_sid, row_anc,
                    row_jl, row_sh, num_series, n, qlen, reg, tile, stride,
                    width, t1, qlen_pad - t1 < ptile ? qlen_pad - t1 : ptile,
                    &bars[buf ^ 1]);
    cp_async_commit();
    mbar_wait(&bars[buf], (it >> 1) & 1);   // and its bulk copies
    if (mine) {
      const int len = qlen_pad - it * ptile < ptile ? qlen_pad - it * ptile
                                                    : ptile;
      ed_slide_long(reg_s + buf * tile * stride + le * stride +
                        grp * kEdLongJ,
                    q_s + buf * (ptile + 8), len, acc);
    }
  }
  if (mine) {      // (qss_s is in place: a tile's barrier came after it)
    const int r = r0 + le;
    const long long sid = row_sid[le];
    const long long last = num_series * (long long)(n + 1) - 1;
#pragma unroll
    for (int jj = 0; jj < kEdLongJ; ++jj) {
      const int j = j0 + jj;
      if (j >= 0 && j < row_lim) {
        float s1, s2;
        window_sums(csum, csum2, csum_lo, csum2_lo, sid, row_anc[le] + j, n,
                    qlen, last, &s1, &s2);
        const float d2 = ed_d2(s1, s2, acc[jj], qlen, znorm,
                               znorm ? 0.f : center[sid], qss_s);
        if (!kChunk) {
          out[((long long)b * rows + r) * g + j_lo + j] = d2;
        } else if (kRange) {
          cd_s[le * gt + j] = d2;
        } else if (d2 < kth) {
          const int slot = atomicAdd(&count_s, 1);
          cd_s[slot] = d2;
          cp_s[slot] = r * g + j_lo + j;
        }
      }
    }
  }
  if (kChunk) __syncthreads();
  if (kMode == 1)
    write_block_topk(cd_s, cp_s, count_s, kp, part_d2 + at, part_sid + at,
                     part_off + at, part_pos + at, sid_off);
  if (kRange) ed_range_out(cd_s, true, out, rows, g, tile, j_lo, gt);
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
    int* row_sid, int* row_anc, int* row_jl, int* count_s, float* cut,
    int j_lo = 0, int gt = -1) {
  float own;
  chunk_block_rows<kMode>(sids, anchors, c.n_master, c.lbs2, c.cut, c.gkth,
                          c.ovf, c.stats, n, rows, qlen, g, c.row_stride,
                          c.col0, c.cut_stride, c.n_chunks, tile, 3,
                          row_sid, row_anc, row_jl, count_s, &own, cut, j_lo,
                          gt);
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
// true-distance and full-DP columns.  An offset-tiled block (gt < g:
// res_s holds its rows' offsets [j_lo, j_lo + gt), row_anc their tile's
// region start) writes that part of each of its rows.
template <int kMode>
__device__ __forceinline__ void lb_write_out(
    const float* res_s, int tg, float* __restrict__ lb_out,
    float* __restrict__ mu_out, float* __restrict__ sd_out,
    const LbChunk& c, const int* row_sid, const int* row_anc,
    const int* row_jl, int* count_s, float cut, int rows, int g,
    int tile, int j_lo = 0, int gt = -1) {
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * tile;
  const bool whole = gt < 0 || gt == g;
  if (whole) gt = g;
  const long long at0 = ((long long)b * rows + r0) * g + j_lo;
  const int count = (rows - r0 < tile ? rows - r0 : tile) * gt;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < count; base += blockDim.x) {   // warp-uniform
    const int idx = base + threadIdx.x;
    const bool in = idx < count;
    const int le = idx / gt, j = idx - le * gt;
    // position le * g + j (+ j_lo) of the block's rows
    const int pos = whole ? idx : le * g + j;
    const long long at = at0 + pos;
    float lb = in ? res_s[idx] : 0.f;
    if (kMode != 0) {
      bool surv = false;
      if (in) {
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
          c.slist[(long long)b * rows * g + slot] = r0 * g + j_lo + pos;
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

// The long-row LB_Keogh kernel's window statistics: (mu, sd, 1 / sd) of
// the window of series sid at off from the prefix sums (raw: 0, 1, 1):
// the plain version's divides and square root, s2 / L - mu_c^2 without
// contraction, as the staged kernel computes them.
__device__ __forceinline__ void lb_window_stat(
    const float* __restrict__ csum, const float* __restrict__ csum2,
    const float* __restrict__ csum_lo, const float* __restrict__ csum2_lo,
    const float* __restrict__ center, long long sid, int off, int n,
    int qlen, long long last, int znorm, float* mu, float* sd, float* y) {
  *mu = 0.f;
  *sd = 1.f;
  if (znorm) {
    float s1, s2;
    window_sums(csum, csum2, csum_lo, csum2_lo, sid, off, n, qlen, last,
                &s1, &s2);
    const float mu_c = s1 / qlen;
    const float var = __fsub_rn(s2 / qlen, __fmul_rn(mu_c, mu_c));
    *sd = fmaxf(sqrtf(fmaxf(var, 0.f)), 1e-8f);
    *mu = mu_c + center[sid];
  }
  *y = __frcp_rn(*sd);
}

// The long-row LB_Keogh kernel's block: `items` consecutive windows of
// query b's chunk (window e = r g + j: offset j of row r), of at most
// rmax rows; per row its (sid, anchor), ok offsets (jl), first offset in
// the block (ja) and the block position of that window (first).
struct LbFlatRows {
  int *sid, *anc, *jl, *ja, *first;
};

// Stage tile t0 (ptile points) of the envelope (as (lo, hi) pairs; past
// qlen (-inf, +inf), which adds 0) and of the regions of the block's rows
// that hold an ok window (row le's points [anc + ja + t0, + cnt + ptile
// - 1) at reg_s[le ptile + first]: window (le, j) at block position k
// reads point t of the tile at reg_s[le ptile + k + t]), with cp.async,
// one flat read per point clipped to the array.
__device__ __forceinline__ void lb_flat_stage(
    const float* __restrict__ data, const float* __restrict__ dtw_lo,
    const float* __restrict__ dtw_hi, float* env_s, float* reg_s,
    const LbFlatRows& rw, int nr, long long i0, long long iend, int g,
    long long num_series, int n, int qlen, int t0, int ptile) {
  const int b = blockIdx.y;
  for (int t = threadIdx.x; t < ptile; t += blockDim.x) {
    if (t0 + t < qlen) {
      const long long at = (long long)b * qlen + t0 + t;
      cp_async4(env_s + 2 * t, dtw_lo + at);
      cp_async4(env_s + 2 * t + 1, dtw_hi + at);
    } else {
      env_s[2 * t] = -INFINITY;
      env_s[2 * t + 1] = INFINITY;
    }
  }
  const long long total = num_series * (long long)n;
  for (int le = 0; le < nr; ++le) {
    const int ja = rw.ja[le];
    if (rw.jl[le] <= ja) continue;         // no ok window of the row here
    const long long r = i0 / g + le;
    const int cnt = (int)(min(iend, (r + 1) * g) - (r * g + ja));
    const long long base = (long long)rw.sid[le] * n + rw.anc[le] + ja + t0;
    float* dst = reg_s + le * ptile + rw.first[le];
    for (int u = threadIdx.x; u < cnt + ptile - 1; u += blockDim.x) {
      long long flat = base + u;
      flat = flat < 0 ? 0 : (flat >= total ? total - 1 : flat);
      cp_async4(dst + u, data + flat);
    }
  }
}

// The long-row LB_Keogh kernel: the staged kernel's contract for any qlen
// and g.  Block (x, b) takes the `items` windows [x items, (x + 1)
// items) of query b's rows * g (row-major; a row may span two blocks),
// one a thread; the envelope and the rows' regions stream through shared
// memory in tiles of `ptile` points, double-buffered with cp.async (the
// next tile's copies fly while the current one is summed).  A thread
// sums its window's points in query order in one register, as the
// staged kernel does, so (lb2, mu, sd) have its bits.  The chunk entries
// (kMode 1, 2) decide each row's keep and ok offsets as the staged
// kernel does (a row is counted kept or pruned by the block holding its
// first window; ok windows and survivors add up over blocks) and sum
// only the ok windows: a pruned row's windows cost their statistics
// (mu and sd are written for every window) but no points.  Outputs go
// out straight from the threads in coalesced stores.
template <int kMode>
__global__ void __launch_bounds__(kLbFlatMaxThreads)
    fused_gather_lb_keogh_long_kernel(
        const float* __restrict__ data, const float* __restrict__ csum,
        const float* __restrict__ csum2, const float* __restrict__ csum_lo,
        const float* __restrict__ csum2_lo, const float* __restrict__ center,
        const int* __restrict__ sids, const int* __restrict__ anchors,
        const float* __restrict__ dtw_lo, const float* __restrict__ dtw_hi,
        float* __restrict__ lb_out, float* __restrict__ mu_out,
        float* __restrict__ sd_out, const LbChunk c, long long num_series,
        int n, int rows, int qlen, int g, int znorm, int items, int ptile,
        int rmax) {
  constexpr bool kChunk = kMode != 0, kRange = kMode == 2;
  extern __shared__ __align__(16) float smem[];
  const int rstride = items + rmax * ptile;
  float* env_s = smem;                           // [2][2 ptile]
  float* reg_s = smem + 4 * ptile;               // [2][rstride]
  LbFlatRows rw;
  rw.sid = reinterpret_cast<int*>(reg_s + 2 * rstride);
  rw.anc = rw.sid + rmax;
  rw.jl = rw.anc + rmax;
  rw.ja = rw.jl + rmax;
  rw.first = rw.ja + rmax;
  __shared__ int count_s, ok_s;

  const int b = blockIdx.y, tid = threadIdx.x;
  const long long m = (long long)rows * g;
  const long long i0 = (long long)blockIdx.x * items;
  const long long iend = min(i0 + items, m);
  const long long ra = i0 / g;
  const int nr = (int)((iend - 1) / g - ra + 1);
  float own = INFINITY, cut = INFINITY;
  bool active = true;
  if (kChunk) {
    own = c.cut[(long long)b * c.cut_stride + c.cut_stride - 1];
    cut = !kRange && c.gkth != nullptr ? fminf(own, c.gkth[b]) : own;
    const float first = c.lbs2[(long long)b * c.row_stride + c.col0];
    active = isfinite(first) &&
             (kRange ? first <= cut && c.ovf[b] == c.n_chunks
                     : first < cut);
  }
  if (tid == 0) {
    count_s = 0;
    ok_s = 0;
  }
  __syncthreads();
  int keep = 0, pruned = 0;
  if (tid < nr) {
    const long long r = ra + tid;
    const long long e = (long long)b * c.row_stride + c.col0 + r;
    const int sid = sids[e], anc = anchors[e];
    int jl = g;
    if (kChunk) {
      const float lb = c.lbs2[e];
      const bool kp = active && (kRange ? lb <= cut : lb < cut);
      const int fit = n - qlen - anc + 1;        // offsets that fit
      const int nm = c.n_master[e];
      int lim = nm < fit ? nm : fit;
      lim = lim < g ? lim : g;
      jl = kp && lim > 0 ? lim : 0;
      const int ja = (int)(i0 > r * g ? i0 - r * g : 0);
      const int jb = (int)(iend - r * g < g ? iend - r * g : g);
      keep = kp && ja == 0;                    // a row's first block
      pruned = active && !kp && isfinite(lb) && ja == 0;
      const int n_ok = (jl < jb ? jl : jb) - ja;
      if (n_ok > 0) atomicAdd(&ok_s, n_ok);
    }
    const int ja = (int)(i0 > r * g ? i0 - r * g : 0);
    rw.sid[tid] = sid;
    rw.anc[tid] = anc;
    rw.jl[tid] = jl;
    rw.ja[tid] = ja;
    rw.first[tid] = (int)(r * g + ja - i0);
  }
  if (kChunk) {
    const int n_keep = __syncthreads_count(keep);
    const int n_pruned = __syncthreads_count(pruned);
    if (tid == 0) {
      int* st = c.stats + (long long)b * kStatsWidth;
      if (blockIdx.x == 0 && active) atomicAdd(st + 0, 1);
      if (n_keep) atomicAdd(st + 1, n_keep);
      if (ok_s) atomicAdd(st + 3, ok_s);
      if (n_pruned) atomicAdd(st + 5, n_pruned);
    }
  } else {
    __syncthreads();
  }

  // this thread's window: block position tid, row le, offset j
  const long long pos = i0 + tid;
  const bool in = pos < iend;
  const int le = in ? (int)(pos / g - ra) : 0;
  const int j = in ? (int)(pos - (ra + le) * g) : 0;
  const bool ok = in && j < rw.jl[le];
  const long long sid = rw.sid[le];
  const long long last = num_series * (long long)(n + 1) - 1;
  float mu = 0.f, sd = 1.f, y = 1.f;
  if (in)
    lb_window_stat(csum, csum2, csum_lo, csum2_lo, center, sid,
                   rw.anc[le] + j, n, qlen, last, znorm, &mu, &sd, &y);
  float acc = 0.f;
  if (__syncthreads_or(ok)) {
    const int n_tiles = (qlen + ptile - 1) / ptile;
    lb_flat_stage(data, dtw_lo, dtw_hi, env_s, reg_s, rw, nr, i0, iend, g,
                  num_series, n, qlen, 0, ptile);
    cp_async_commit();
    const int base = le * ptile + tid;
    for (int it = 0; it < n_tiles; ++it) {
      const int buf = it & 1;
      if (it + 1 < n_tiles)
        lb_flat_stage(data, dtw_lo, dtw_hi, env_s + (buf ^ 1) * 2 * ptile,
                      reg_s + (buf ^ 1) * rstride, rw, nr, i0, iend, g,
                      num_series, n, qlen, (it + 1) * ptile, ptile);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();                   // tile `it` is in place
      if (ok) {
        const float* x = reg_s + buf * rstride + base;
        const float4* env = reinterpret_cast<const float4*>(
            env_s + buf * 2 * ptile);
        // the tile's points up to qlen, in multiples of 8 (the envelope's
        // (-inf, +inf) past qlen adds 0)
        const int len = min(ptile, qlen - it * ptile);
        const int len8 = (len + 7) & ~7;
        for (int t = 0; t < len8; t += 8) {
#pragma unroll
          for (int tt = 0; tt < 8; ++tt) {
            const float4 lh2 = env[(t + tt) >> 1];   // two points' (lo, hi)
            const float lo = tt & 1 ? lh2.z : lh2.x;
            const float hi = tt & 1 ? lh2.w : lh2.y;
            const float w = znorm_point(x[t + tt], mu, sd, y);
            // lo <= hi: w - hi and lo - w are not both positive, so the
            // square of the larger is the staged kernel's over^2 + under^2
            const float d = fmaxf(fmaxf(__fsub_rn(w, hi), __fsub_rn(lo, w)),
                                  0.f);
            acc = __fadd_rn(acc, __fmul_rn(d, d));
          }
        }
      }
      __syncthreads();                   // buffer `buf` may be restaged
    }
  }

  // out: lb2 (+inf where not ok), mu, sd; the chunk entries also each
  // window's (sid, off), the survivors listed by a warp-aggregated
  // atomicAdd on nsurv[b] (the list's order varies from run to run), and
  // +inf into the DP's output at every other window
  const long long at = (long long)b * m + pos;
  bool surv = false;
  if (in) {
    float lb = acc;
    if (kChunk) {
      if (!ok) lb = INFINITY;
      surv = ok && (kRange ? lb <= cut : lb < cut);
      c.cand_sid[at] = (int)sid;
      c.cand_off[at] = rw.anc[le] + j;
      if (!surv) c.dp_out[at] = INFINITY;
    }
    lb_out[at] = lb;
    mu_out[at] = mu;
    sd_out[at] = sd;
  }
  if (kChunk) {
    const int lane = tid & 31;
    const unsigned mask = __ballot_sync(kFull, surv);
    if (mask) {
      const int leader = __ffs(mask) - 1;
      int slot = 0;
      if (lane == leader) {
        slot = atomicAdd(c.nsurv + b, __popc(mask));
        atomicAdd(&count_s, __popc(mask));
      }
      slot = __shfl_sync(kFull, slot, leader) +
             __popc(mask & ((1u << lane) - 1u));
      if (surv) c.slist[(long long)b * m + slot] = (int)pos;
    }
    __syncthreads();
    if (tid == 0 && count_s) {
      int* st = c.stats + (long long)b * kStatsWidth;
      atomicAdd(st + 2, count_s);
      atomicAdd(st + 4, count_s);
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

namespace {

// The ED kernel's block shape: up to kEdTile rows a block, fewer where
// the threads (one per row and offset group) or the shared memory would
// exceed their budgets.
struct EdShape {
  int tile, qlen_pad, ngrp, stride, run_stride, threads;
  int otile, n_otiles;   // offsets a block takes, offset tiles a row
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
  s.otile = g;
  s.n_otiles = 1;
  return s;
}

// The long ED kernel's block shape from the host's plan
// (fused_verify.ed_long_shape): `tile` rows, otile offsets a row (all g
// where otile >= g) and tiles of ptile query points (a multiple of 8);
// one thread a (row, group of kEdLongJ offsets).  threads = 0 where the
// plan is not one the kernel takes.
EdShape ed_long_shape(int qlen, int g, int tile, int otile, int ptile) {
  EdShape s = {};
  if (tile < 1 || tile > kEdLongRows || otile < 1 || ptile < 8 ||
      ptile % 8 != 0 || ptile > (1 << 16))
    return s;
  s.tile = tile;
  s.otile = otile < g ? otile : g;
  s.n_otiles = (g + s.otile - 1) / s.otile;
  s.qlen_pad = (qlen + kEdJ - 1) / kEdJ * kEdJ;   // the staged kernel's
  // a row's offsets start up to 3 words into its first group
  s.ngrp = (s.otile + 3 + kEdLongJ - 1) / kEdLongJ;
  s.stride = ed_long_stride(s.ngrp, ptile);
  s.run_stride = ptile;          // the kernel's points a tile
  s.threads = (tile * s.ngrp + 31) / 32 * 32;
  // two query tiles, two region tiles, (chunk) the candidates' d2 and
  // positions
  s.smem = sizeof(float) * (2 * ((size_t)ptile + 8) +
                            2 * (size_t)tile * s.stride +
                            2 * (size_t)tile * s.otile);
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
              const void* gkth = nullptr, int tile = 0, int otile = 0,
              int ptile = 0) {
  if (batch < 1 || rows < 1 || g < 1 || qlen < 1 || qlen > n ||
      batch > 65535 || k < 1)
    return (int)cudaErrorInvalidValue;
  const EdShape s = kLong ? ed_long_shape(qlen, g, tile, otile, ptile)
                          : ed_shape(qlen, g, kMode != 0);
  if (s.threads < 1 || s.n_otiles > 65535) return (int)cudaErrorInvalidValue;
  if (s.threads > (kLong ? kEdLongThreads : kEdThreads) ||
      s.smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  // the two kernels take the same arguments; run_stride is the staged
  // kernel's run stride or the long kernel's points a tile
  auto kernel = kLong ? fused_gather_ed_long_kernel<kMode>
                      : fused_gather_ed_kernel<kMode>;
  if (s.smem > kSmemBudget) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
    if (err) return err;
  }
  const int n_blocks = (rows + s.tile - 1) / s.tile;
  const int kp = k < s.tile * s.otile ? k : s.tile * s.otile;
  // partials (4, B, n_blocks, n_otiles, kp) int32: d2 (float bits), sid,
  // off, pos
  const long long plane = (long long)batch * n_blocks * s.n_otiles * kp;
  int* p = static_cast<int*>(part);
  const dim3 grid(n_blocks, batch, s.n_otiles);
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
      s.ngrp, s.stride, s.run_stride,
      static_cast<const int*>(ovf), n_chunks,
      static_cast<const float*>(gkth), s.otile);
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

// The long-row kernel behind the same contract (any qlen and g; blocks
// of `tile` rows and otile offsets a row, tiles of ptile query points:
// fused_verify.ed_long_shape).
extern "C" int ulisse_fused_gather_ed_long(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* qs, void* out,
    long long num_series, int n, int batch, int rows, int qlen, int g,
    int znorm, int tile, int otile, int ptile, void* stream) {
  return launch_ed<0, true>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, nullptr,
      nullptr, qs, out, nullptr, nullptr, nullptr, num_series, n, batch, rows,
      qlen, g, znorm, rows, 0, 1, stream, nullptr, 0, nullptr, tile, otile,
      ptile);
}

// Rows a block of the chunk entry takes at (qlen, g): its partials are
// (B, ceil(rows / tile), min(k, tile * g)).  -1 where no block fits (the
// query and its regions do not fit shared memory whole).
extern "C" int ulisse_fused_gather_ed_chunk_tile(int qlen, int g) {
  if (qlen < 1 || g < 1) return -1;
  const EdShape s = ed_shape(qlen, g, true);
  return s.threads > kEdThreads || s.smem > kSmemMax ? -1 : s.tile;
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

// The long-row kernel behind the chunk entry's contract (any qlen and g;
// tile, otile and ptile as ulisse_fused_gather_ed_long's): its partials
// are (B, ceil(rows / tile) * ceil(g / otile), min(k, tile * otile)).
extern "C" int ulisse_fused_gather_ed_chunk_long(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* n_master,
    const void* lbs2, const void* qs, const void* pool_d2, const void* gkth,
    void* stats, void* part, long long num_series, int n, int batch,
    int rows, int qlen, int g, int znorm, long long n_pad, long long col0,
    int k, int tile, int otile, int ptile, void* stream) {
  if (col0 < 0 || col0 + rows > n_pad) return (int)cudaErrorInvalidValue;
  return launch_ed<1, true>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, n_master,
      lbs2, qs, nullptr, pool_d2, stats, part, num_series, n, batch, rows,
      qlen, g, znorm, n_pad, col0, k, stream, nullptr, 0, gkth, tile, otile,
      ptile);
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

// The long-row kernel behind the range entry's contract (any qlen and g;
// tile, otile and ptile as ulisse_fused_gather_ed_long's).
extern "C" int ulisse_fused_gather_ed_range_long(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* n_master,
    const void* lbs2, const void* qs, const void* eps2, const void* ovf,
    void* stats, void* out, long long num_series, int n, int batch,
    int rows, int qlen, int g, int znorm, long long n_pad, long long col0,
    int n_chunks, int tile, int otile, int ptile, void* stream) {
  if (col0 < 0 || col0 + rows > n_pad) return (int)cudaErrorInvalidValue;
  return launch_ed<2, true>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, n_master,
      lbs2, qs, out, eps2, stats, nullptr, num_series, n, batch, rows, qlen,
      g, znorm, n_pad, col0, 1, stream, ovf, n_chunks, nullptr, tile, otile,
      ptile);
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

// The long LB_Keogh kernel's rows a block of `items` windows spans, and
// its shared memory at ptile points a tile: two (lo, hi) tiles, two
// region buffers of items + rmax ptile floats, five ints a row.
int lb_flat_rmax(int g, int items) { return (items + g - 2) / g + 1; }

size_t lb_flat_smem(int g, int items, int ptile) {
  const size_t rmax = lb_flat_rmax(g, items);
  return sizeof(float) * (4 * (size_t)ptile + 2 * (items + rmax * ptile) +
                          5 * rmax);
}

// kMode: 0 the contract entry, 1 the k-NN chunk entry, 2 the range chunk
// entry.  The chunk entries zero nsurv before their launch (a memset on
// the stream, not a kernel).  The long kernel's blocks take `items`
// windows and tiles of `ptile` points (fused_verify.lb_long_shape).
template <int kMode, bool kLong>
int launch_lb_keogh(const void* data, const void* csum, const void* csum2,
                    const void* csum_lo, const void* csum2_lo,
                    const void* center, const void* sids, const void* anchors,
                    const void* dtw_lo, const void* dtw_hi, void* lb,
                    void* mu, void* sd, const LbChunk& c,
                    long long num_series, int n, int batch, int rows,
                    int qlen, int g, int znorm, void* stream, int items = 0,
                    int ptile = 0) {
  if (batch < 1 || rows < 1 || g < 1 || qlen < 1 || qlen > n ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const void* kernel =
      kLong ? (const void*)fused_gather_lb_keogh_long_kernel<kMode>
            : (const void*)fused_gather_lb_keogh_kernel<kMode>;
  LbShape sh = {};
  size_t smem;
  dim3 grid, block;
  if (kLong) {
    if (items < 1 || items > kLbFlatMaxThreads || ptile < 32 ||
        ptile % 32 != 0)
      return (int)cudaErrorInvalidValue;
    const long long blocks = ((long long)rows * g + items - 1) / items;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    smem = lb_flat_smem(g, items, ptile);
    grid = dim3((unsigned)blocks, batch);
    block = dim3((items + 31) / 32 * 32);
  } else {
    sh = lb_shape(qlen, g);
    smem = sh.smem;
    grid = dim3((rows + sh.tile - 1) / sh.tile, batch);
    block = dim3(sh.threads);
  }
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > kSmemBudget) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
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
    fused_gather_lb_keogh_long_kernel<kMode><<<grid, block, smem, st>>>(
        a_data, a_cs, a_cs2, a_cl, a_cl2, a_c, a_sids, a_anc, a_lo, a_hi,
        a_lb, a_mu, a_sd, c, num_series, n, rows, qlen, g, znorm, items,
        ptile, lb_flat_rmax(g, items));
  else
    fused_gather_lb_keogh_kernel<kMode><<<grid, block, smem, st>>>(
        a_data, a_cs, a_cs2, a_cl, a_cl2, a_c, a_sids, a_anc, a_lo, a_hi,
        a_lb, a_mu, a_sd, c, num_series, n, rows, qlen, g, znorm, sh.tile,
        sh.qlen_pad, sh.ngrp, sh.stride);
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
                    int n_chunks, void* stream, int items = 0,
                    int ptile = 0) {
  LbChunk c;
  if (range && gkth != nullptr) return (int)cudaErrorInvalidValue;
  const int err = lb_chunk(&c, n_master, lbs2, cut, gkth, ovf, stats, slist,
                           nsurv, dp_out, cand_sid, cand_off, rows, n_pad,
                           col0, range ? 1 : k, n_chunks);
  if (err) return err;
  return range ? launch_lb_keogh<2, kLong>(
                     data, csum, csum2, csum_lo, csum2_lo, center, sids,
                     anchors, dtw_lo, dtw_hi, lb, mu, sd, c, num_series, n,
                     batch, rows, qlen, g, znorm, stream, items, ptile)
               : launch_lb_keogh<1, kLong>(
                     data, csum, csum2, csum_lo, csum2_lo, center, sids,
                     anchors, dtw_lo, dtw_hi, lb, mu, sd, c, num_series, n,
                     batch, rows, qlen, g, znorm, stream, items, ptile);
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

// The long-row kernel behind the same contract (any qlen and g; blocks
// of `items` windows, tiles of `ptile` points: fused_verify.
// lb_long_shape).
extern "C" int ulisse_fused_gather_lb_keogh_long(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* dtw_lo,
    const void* dtw_hi, void* lb, void* mu, void* sd, long long num_series,
    int n, int batch, int rows, int qlen, int g, int znorm, int items,
    int ptile, void* stream) {
  return launch_lb_keogh<0, true>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, dtw_lo,
      dtw_hi, lb, mu, sd, lb_contract(rows), num_series, n, batch, rows,
      qlen, g, znorm, stream, items, ptile);
}

// Rows a block of the LB_Keogh entries takes at (qlen, g); -1 where no
// block fits (the envelope and the regions do not fit shared memory
// whole).
extern "C" int ulisse_fused_gather_lb_keogh_tile(int qlen, int g) {
  if (qlen < 1 || g < 1) return -1;
  const LbShape s = lb_shape(qlen, g);
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

// The long-row kernel behind the chunk entry's contract (any qlen and g;
// items and ptile as ulisse_fused_gather_lb_keogh_long's).
extern "C" int ulisse_fused_gather_lb_keogh_chunk_long(
    const void* data, const void* csum, const void* csum2,
    const void* csum_lo, const void* csum2_lo, const void* center,
    const void* sids, const void* anchors, const void* n_master,
    const void* lbs2, const void* dtw_lo, const void* dtw_hi,
    const void* cut, const void* gkth, const void* ovf, void* stats,
    void* lb, void* mu, void* sd, void* slist, void* nsurv, void* dp_out,
    void* cand_sid, void* cand_off, long long num_series, int n, int batch,
    int rows, int qlen, int g, int znorm, long long n_pad, long long col0,
    int k, int range, int n_chunks, int items, int ptile, void* stream) {
  return launch_lb_chunk<true>(
      data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors, n_master,
      lbs2, dtw_lo, dtw_hi, cut, gkth, ovf, stats, lb, mu, sd, slist, nsurv,
      dp_out, cand_sid, cand_off, num_series, n, batch, rows, qlen, g, znorm,
      n_pad, col0, k, range, n_chunks, stream, items, ptile);
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
