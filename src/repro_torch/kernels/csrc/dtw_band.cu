// Squared Sakoe-Chiba banded DTW for ULISSE, for Hopper.
//
// Replaces repro/kernels/dtw_band.py::dtw_band_pallas (Pallas body
// _dtw_band_kernel), and with it the jnp DP the reference search runs on
// the LB_Keogh survivors of every scan chunk
// (repro/core/executor.py::_survivor_bucket -> core/dtw.py::dtw_band).
// Two entries over one device function:
//   ulisse_dtw_band       q (l,) against candidates (N, l) -> (N,);
//   ulisse_dtw_survivors  the survivors of one scan chunk of B queries in
//                         one launch: the LB_Keogh chunk entry
//                         (fused_verify.cu) listed query b's survivors'
//                         candidate positions in slist[b, :nsurv[b]] (in
//                         any order) and wrote +inf at every other
//                         position of out (B, M); this entry gathers each
//                         survivor's window data[sid, clip(off, 0, n - l)
//                         : + l] (flat read clipped to the array),
//                         normalizes it with that candidate's (mu, sd)
//                         when znorm, and writes its DTW^2 against q_b at
//                         its position.  nsurv stays on the device.
//
// The DP: D[i,j] = (q_i - c_j)^2 + min(D[i-1,j], D[i-1,j-1], D[i,j-1]) for
// |i - j| <= r, D[-1,-1] = 0, answer D[l-1,l-1].  A band wider than the
// row changes nothing, so r is capped at rr = min(r, l - 1).
//
// Design: an anti-diagonal wavefront, one warp per candidate.  The cells
// of diagonal t = i + j depend only on diagonals t-1 (up and left) and
// t-2 (diag).  Index the band's W = 2rr + 1 cells by slot k = i - j + rr:
// on diagonal t exactly the slots of t + rr's parity are live.  Lane L
// owns the 2C consecutive slots 2CL .. 2CL + 2C - 1 in registers (C the
// least power of two with 64C >= W, a template parameter: C = 1 at the
// path's r = 16 and r = 25), as C (even, odd) pairs a[c], b[c].  A step
// updates one slot of each pair, so every lane works every step:
//   even slots: a[c] = d + min(a[c], b[c], b[c-1]), b[-1] one shuffle up;
//   odd slots:  b[c] = d + min(b[c], a[c], a[c+1]), a[C] one shuffle down.
// Each cell is one IEEE add of its cost to the min of its three
// neighbours (no contraction), so the result is the row recurrence's in
// float32, bit for bit.  The critical path is 2l - 1 steps of a shuffle,
// a min and an add (~30 cycles), against l rows of a 5-step warp scan in
// the row-order design it replaced.  Along a slot i and j both advance
// by one every two steps, so an (even, odd) step pair reads C + 1 query
// and C window values from shared memory, padded by 32C sentinels on
// each side (query +1e30, window -1e30: any cell off the series costs
// +inf, without a branch); slots past the band add +inf to their cost.
// Bound on the card: operations (~5 flops a band cell, l floats of
// window per candidate); a warp runs ~8 instructions a step for up to
// 64C cells.  The survivors entry launches one wave of the card and
// walks the flat list of all B queries' survivors, so a chunk takes
// about one candidate's critical path whatever the queries' split; the
// function entry launches a warp per candidate, uncapped.
// Rounding: the plain version (kernels/ref.py::wavefront_dtw) runs the
// same recurrence in the same float32 operations.  The survivors'
// normalization is the LB kernel's (znorm.cuh), so the DP sees the very
// values the lower bound saw.
//
// Wide entries (ulisse_dtw_band_wide, ulisse_dtw_survivors_wide) take
// any band and any l: the wrappers send them every shape the warp
// entries do not take (W > 1024, or l > 6144, where a warp's padded
// staging no longer leaves room for a full block).  Three kernels
// behind them; the wrapper chooses (`dtw_band.wide_plan`):
// * A full band (rr = l - 1) of up to 1,024 rows: the strip kernel
//   (strip_dtw), a warp a candidate, lane L holding rows [LH, LH + H)
//   and sweeping the columns one step behind lane L - 1.  The
//   anti-diagonal order would compute twice the matrix's cells there
//   (the band's corners off the series); rows compute each cell once.
// * Any other band up to 7,680 slots: the warp entries' register
//   wavefront, split across the S warps of a block.  The band's slots
//   are renumbered k = i - j + rp with rp = rr rounded up to even (slot
//   0 lies off the band when rr is odd), so diagonal 0 is an even step.
//   Warp s owns the 60C slots [60Cs, 60C(s + 1)) in lanes 1 .. 30 (2C a
//   lane, as in wave_dtw), and its lanes 0 and 31 mirror its
//   neighbours' edge lanes (halos of 2C slots) or lie off the band
//   (+inf throughout), so no lane tests for the warp's edge.  An
//   anti-diagonal step spoils one more slot at each end of a warp's
//   range, so a warp runs 2C diagonals (C step pairs) on its own and
//   then exchanges its edge lanes' 2C values with its neighbours
//   through a double-buffered slot of shared memory: one
//   __syncthreads() per 2C diagonals, none when S = 1.  A warp whose
//   owned slots hold no cell inside the series for a whole period skips
//   its arithmetic (its slots are +inf before the series starts, and
//   after it ends no cell inside the series reads them).  q and the
//   window are not staged: each lane keeps its C query and C window
//   values in registers, and a step pair shifts both by one with a
//   shuffle from the neighbouring lane (the period body is unrolled C
//   times, so the shift renames registers instead of moving them);
//   only lane 31's new query value and lane 0's new window value come
//   from outside the warp, read by a shuffle from a 32-value window of
//   each stream that slides every 32 - C pairs (its next 32 values
//   loaded one slide ahead).  So any l runs at warp
//   speed, with no buffer that grows with l; a pair costs ~8C + 12
//   instructions for 2C cells.
// * Past 7,680 slots (rr > 3,839): the block kernel, a block per
//   candidate, the band's slots in a buffer the block shares (slot k at
//   st[k + 1], st[0] = st[W + 1] = +inf), one __syncthreads() a
//   diagonal, the query and the window beside it in shared memory where
//   the 2rr + 3 + 2l floats fit, else in a global scratch slice per
//   block.
// Each cell is the same IEEE add of its cost to the min of its three
// neighbours, so every wide kernel and the warp entries give the same
// bits wherever they apply; in the strip and segmented kernels the min
// is one DPX instruction (min3).  Bound: operations.
#include <cuda_runtime.h>
#include <math.h>

#include "znorm.cuh"

namespace {

constexpr int kWarps = 8;                 // candidates in flight a block
constexpr int kMaxPairs = 16;             // C: W <= 64 * kMaxPairs = 1024
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPadQ = 1e30f;            // query sentinel
constexpr float kPadW = -1e30f;           // window sentinel: (q - w)^2 = inf
constexpr int kWideThreads = 256;         // wide entries: largest block

// The even-slot step of pair u: a[c] = d + min(a[c], b[c], b[c-1]), the
// lane's b[-1] being its left neighbour's b[C-1] (one shuffle up).
template <int C>
__device__ __forceinline__ void even_step(const float* qa, const float* wa,
                                          int u, float (&a)[C],
                                          const float (&b)[C],
                                          const float (&pa)[C], int lane) {
  float up = __shfl_up_sync(kFull, b[C - 1], 1);
  if (lane == 0) up = INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float diff = __fsub_rn(qa[u + c], wa[u - c]);
    const float d = __fmaf_rn(diff, diff, pa[c]);
    const float m = fminf(a[c], b[c]);
    a[c] = __fadd_rn(d, fminf(m, c == 0 ? up : b[c - 1]));
  }
}

// The odd-slot step of pair u: b[c] = d + min(b[c], a[c], a[c+1]), the
// lane's a[C] being its right neighbour's a[0] (one shuffle down).
template <int C>
__device__ __forceinline__ void odd_step(const float* qa, const float* wa,
                                         int u, const float (&a)[C],
                                         float (&b)[C], const float (&pb)[C],
                                         int lane) {
  float left = __shfl_down_sync(kFull, a[0], 1);
  if (lane == 31) left = INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float diff = __fsub_rn(qa[u + c + 1], wa[u - c]);
    const float d = __fmaf_rn(diff, diff, pb[c]);
    const float m = fminf(b[c], a[c]);
    b[c] = __fadd_rn(d, fminf(m, c == C - 1 ? left : a[c + 1]));
  }
}

// DTW^2 of q against w, both (l,) in shared memory with 32C sentinels on
// each side (q[-32C .. l + 32C)); rr = min(r, l - 1), 2rr + 1 <= 64C.
// Every lane of the warp calls it; all get the result.
template <int C>
__device__ float wave_dtw(const float* q, const float* w, int l, int rr) {
  const int lane = threadIdx.x & 31;
  const int band = 2 * rr + 1;
  float a[C], b[C], pa[C], pb[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int ka = 2 * C * lane + 2 * c, kb = ka + 1;
    // D[-1,-1] = 0 sits in slot rr on diagonal -2; all else starts +inf
    a[c] = ka == rr ? 0.f : INFINITY;
    b[c] = kb == rr ? 0.f : INFINITY;
    pa[c] = ka < band ? 0.f : INFINITY;
    pb[c] = kb < band ? 0.f : INFINITY;
  }
  // The pair u: the even-slot step on diagonal t = 2u + rr, the odd-slot
  // step on 2u + rr + 1.  Slot k = 2CL + 2c (+1) holds cell
  // i = u + CL + c (+1), j = u + rr - CL - c on its step.
  const float* qa = q + C * lane;
  const float* wa = w + rr - C * lane;
  // diagonals 0 .. 2l - 2: the first pair starts on diagonal -1 when rr
  // is odd, the last ends on 2l - 1 when rr is even
  int u = -((rr + 1) >> 1);
  const int u_end = (2 * l - 2 - rr) >> 1;
  if (rr & 1) odd_step<C>(qa, wa, u++, a, b, pb, lane);
#pragma unroll 2
  for (; u < u_end; ++u) {
    even_step<C>(qa, wa, u, a, b, pa, lane);
    odd_step<C>(qa, wa, u, a, b, pb, lane);
  }
  even_step<C>(qa, wa, u_end, a, b, pa, lane);
  if (rr & 1) odd_step<C>(qa, wa, u_end, a, b, pb, lane);
  // cell (l-1, l-1) sits in slot rr
  float v = INFINITY;
  const int s = rr % (2 * C);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (s == 2 * c) v = a[c];
    if (s == 2 * c + 1) v = b[c];
  }
  return __shfl_sync(kFull, v, rr / (2 * C));
}

// Fill the 32C sentinels on both sides of a padded (l,) array.
template <int C>
__device__ void fill_pads(float* x, int l, float pad) {
  for (int t = threadIdx.x & 31; t < 32 * C; t += 32) {
    x[-32 * C + t] = pad;
    x[l + t] = pad;
  }
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
    dtw_band_kernel(const float* __restrict__ q,
                    const float* __restrict__ cands, float* __restrict__ out,
                    long long num, int l, int rr, int span) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q_s = smem + 32 * C;                          // [l], padded
  float* w_s = smem + (long long)(1 + warp) * span + 32 * C;
  if (warp == 0) fill_pads<C>(q_s, l, kPadQ);
  for (int t = threadIdx.x; t < l; t += blockDim.x) q_s[t] = q[t];
  fill_pads<C>(w_s, l, kPadW);
  __syncthreads();
  const int warps = blockDim.x >> 5;
  for (long long cand = (long long)blockIdx.x * warps + warp; cand < num;
       cand += (long long)gridDim.x * warps) {
    for (int t = lane; t < l; t += 32) w_s[t] = cands[cand * l + t];
    __syncwarp();
    const float v = wave_dtw<C>(q_s, w_s, l, rr);
    if (lane == 0) out[cand] = v;
    __syncwarp();
  }
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
    dtw_survivors_kernel(const float* __restrict__ data,
                         const float* __restrict__ qs,
                         const int* __restrict__ slist,
                         const int* __restrict__ nsurv,
                         const int* __restrict__ cand_sid,
                         const int* __restrict__ cand_off,
                         const float* __restrict__ mu,
                         const float* __restrict__ sd,
                         float* __restrict__ out, long long num_series, int n,
                         int batch, int m, int l, int rr, int znorm,
                         int span) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q_s = smem + (long long)(2 * warp) * span + 32 * C;
  float* w_s = q_s + span;
  fill_pads<C>(q_s, l, kPadQ);
  fill_pads<C>(w_s, l, kPadW);
  // the flat list of every query's survivors: item p of query b is
  // number base_b + p
  long long total = 0;
  for (int b = 0; b < batch; ++b) total += min(nsurv[b], m);
  const long long stride = (long long)gridDim.x * (blockDim.x >> 5);
  const long long last = num_series * (long long)n - 1;
  int b = 0, staged = -1;
  long long base = 0;
  for (long long f = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
       f < total; f += stride) {
    while (f >= base + min(nsurv[b], m)) base += min(nsurv[b++], m);
    if (b != staged) {                       // warp-uniform
      __syncwarp();
      for (int t = lane; t < l; t += 32) q_s[t] = qs[(long long)b * l + t];
      staged = b;
    }
    const long long row0 = (long long)b * m;
    const long long e = row0 + slist[row0 + (f - base)];
    int off = cand_off[e];
    off = off < 0 ? 0 : (off > n - l ? n - l : off);
    const long long start = (long long)cand_sid[e] * n + off;
    const float mu_e = mu[e], sd_e = sd[e];
    const float y = __frcp_rn(sd_e);
    for (int t = lane; t < l; t += 32) {
      long long flat = start + t;
      flat = flat < 0 ? 0 : (flat > last ? last : flat);
      const float x = data[flat];
      w_s[t] = znorm ? znorm_point(x, mu_e, sd_e, y) : x;
    }
    __syncwarp();
    const float v = wave_dtw<C>(q_s, w_s, l, rr);
    if (lane == 0) out[e] = v;
    __syncwarp();
  }
}

// The block kernel's DP (the wide entries past kSegMaxSlots) of q
// against w (both (l,), any memory) over the state st[0 .. 2rr + 2], run
// by the whole block; every thread gets the
// result.  The caller orders its staging of q and w before the call
// (the barrier after the state's reset covers it) and the read of the
// result before it restages.
__device__ float wide_dtw(const float* q, const float* w, float* st, int l,
                          int rr) {
  const int band = 2 * rr + 1;
  for (int k = threadIdx.x; k < band + 2; k += blockDim.x)
    st[k] = k == rr + 1 ? 0.f : INFINITY;   // D[-1,-1] = 0 in slot rr
  __syncthreads();
  for (int t = 0; t <= 2 * l - 2; ++t) {
    // slot k holds cell i = (t + k - rr) / 2, j = (t - k + rr) / 2: the
    // live slots with 0 <= i, j < l
    int lo = max(max(rr - t, t + rr - 2 * l + 2), 0);
    const int hi = min(min(t + rr, 2 * l - 2 - t + rr), band - 1);
    lo += (lo + t + rr) & 1;
    for (int k = lo + 2 * (int)threadIdx.x; k <= hi;
         k += 2 * (int)blockDim.x) {
      const float diff = __fsub_rn(q[(t + k - rr) >> 1], w[(t - k + rr) >> 1]);
      const float m = fminf(st[k + 1], st[k]);
      st[k + 1] = __fadd_rn(__fmul_rn(diff, diff), fminf(m, st[k + 2]));
    }
    __syncthreads();
  }
  return st[rr + 1];
}

// The block kernel's buffer: the state (2rr + 3 floats), q and w (l each).
long long wide_floats(int l, int rr) { return 2LL * rr + 3 + 2LL * l; }

__global__ void __launch_bounds__(kWideThreads)
    dtw_band_wide_kernel(const float* __restrict__ q,
                         const float* __restrict__ cands,
                         float* __restrict__ out, long long num,
                         float* scratch, int l, int rr, long long per_block) {
  extern __shared__ float smem[];
  float* st = scratch ? scratch + blockIdx.x * per_block : smem;
  float* q_s = st + 2 * rr + 3;
  float* w_s = q_s + l;
  for (int t = threadIdx.x; t < l; t += blockDim.x) q_s[t] = q[t];
  for (long long cand = blockIdx.x; cand < num; cand += gridDim.x) {
    __syncthreads();                     // the last result has been read
    for (int t = threadIdx.x; t < l; t += blockDim.x)
      w_s[t] = cands[cand * l + t];
    const float v = wide_dtw(q_s, w_s, st, l, rr);
    if (threadIdx.x == 0) out[cand] = v;
  }
}

__global__ void __launch_bounds__(kWideThreads)
    dtw_survivors_wide_kernel(const float* __restrict__ data,
                              const float* __restrict__ qs,
                              const int* __restrict__ slist,
                              const int* __restrict__ nsurv,
                              const int* __restrict__ cand_sid,
                              const int* __restrict__ cand_off,
                              const float* __restrict__ mu,
                              const float* __restrict__ sd,
                              float* __restrict__ out, long long num_series,
                              int n, int batch, int m, int znorm,
                              float* scratch, int l, int rr,
                              long long per_block) {
  extern __shared__ float smem[];
  float* st = scratch ? scratch + blockIdx.x * per_block : smem;
  float* q_s = st + 2 * rr + 3;
  float* w_s = q_s + l;
  // the flat list of every query's survivors, as in dtw_survivors_kernel
  long long total = 0;
  for (int b = 0; b < batch; ++b) total += min(nsurv[b], m);
  const long long last = num_series * (long long)n - 1;
  int b = 0, staged = -1;
  long long base = 0;
  for (long long f = blockIdx.x; f < total; f += gridDim.x) {
    while (f >= base + min(nsurv[b], m)) base += min(nsurv[b++], m);
    __syncthreads();                     // the last result has been read
    if (b != staged) {                   // block-uniform
      for (int t = threadIdx.x; t < l; t += blockDim.x)
        q_s[t] = qs[(long long)b * l + t];
      staged = b;
    }
    const long long row0 = (long long)b * m;
    const long long e = row0 + slist[row0 + (f - base)];
    int off = cand_off[e];
    off = off < 0 ? 0 : (off > n - l ? n - l : off);
    const long long start = (long long)cand_sid[e] * n + off;
    const float mu_e = mu[e], sd_e = sd[e];
    const float y = __frcp_rn(sd_e);
    for (int t = threadIdx.x; t < l; t += blockDim.x) {
      long long flat = start + t;
      flat = flat < 0 ? 0 : (flat > last ? last : flat);
      const float x = data[flat];
      w_s[t] = znorm ? znorm_point(x, mu_e, sd_e, y) : x;
    }
    const float v = wide_dtw(q_s, w_s, st, l, rr);
    if (threadIdx.x == 0) out[e] = v;
  }
}

// ---- the segmented wide entries ----------------------------------------

constexpr int kSegLanes = 30;     // owned lanes of a warp of a split band

// The most warps a block of the segmented entries takes at C pairs a
// lane (its registers: ~6C a thread).
__host__ __device__ constexpr int seg_max_warps(int C) {
  return C >= 16 ? 8 : (C >= 8 ? 16 : 32);
}

// The streams the segmented DP reads: the query, a candidate row, and a
// survivor's window normalized as the LB kernel normalized it; off the
// series each gives the warp entries' sentinels.
//
// Before the series q and w take the warp entries' sentinels (any cell
// with i < 0 or j < 0 costs +inf); past its end both take kPadQ, so a
// cell with i, j >= l costs 0 and one with a single index past the end
// +inf.  Then every step past the last diagonal keeps cell (l - 1,
// l - 1)'s value in its slot: D[l + k][l + k] = 0 + min(D[l + k - 1][l
// + k - 1], ...) with the other two no smaller, so the DP may run whole
// periods of C step pairs and read the answer after them.  Such cells
// are read by no cell inside the series.
struct QSrc {
  const float* q;
  int l;
  __device__ float operator()(int x) const {
    return (unsigned)x < (unsigned)l ? q[x] : kPadQ;
  }
};

struct WSrc {
  const float* w;
  int l;
  __device__ float operator()(int x) const {
    return (unsigned)x < (unsigned)l ? w[x] : (x < 0 ? kPadW : kPadQ);
  }
};

struct WZSrc {
  const float* data;
  long long start, last;
  float mu, sd, y;
  int l, znorm;
  __device__ float operator()(int x) const {
    if ((unsigned)x >= (unsigned)l) return x < 0 ? kPadW : kPadQ;
    long long flat = start + x;
    flat = flat < 0 ? 0 : (flat > last ? last : flat);
    const float v = data[flat];
    return znorm ? znorm_point(v, mu, sd, y) : v;
  }
};

// A warp's stream of src(x) at x, x + 1, ... (one a step pair): a window
// of 32 values, one a lane, read by a shuffle.  align(x, span) keeps
// reads x .. x + span - 1 inside the window, sliding it when they would
// leave (two shuffles) and loading the 32 values past it, which the next
// slide consumes (so the load is hidden behind the pairs between).
template <class Src>
struct Stream {
  int base;
  float cur, nxt;
  __device__ void init(const Src& s, int x, int lane) {
    base = x;
    cur = s(x + lane);
    nxt = s(x + 32 + lane);
  }
  __device__ void align(const Src& s, int x, int span, int lane) {
    const int d = x - base;                   // warp-uniform, <= 32
    if (d + span <= 32) return;
    const int from = (lane + d) & 31;
    const float lo = __shfl_sync(kFull, cur, from);
    const float hi = __shfl_sync(kFull, nxt, from);
    cur = lane + d < 32 ? lo : hi;
    base = x;
    nxt = s(x + 32 + lane);
  }
  __device__ float at(int x) const {
    return __shfl_sync(kFull, cur, x - base);
  }
};

// The min of three DP values.  Every value the wide entries hold lies
// in [+0, +inf] (a square, a sum of such, or +inf; never -0 or NaN), and
// on those the order of the IEEE bit patterns as signed integers is the
// float order: so Hopper's three-way integer min (one DPX instruction,
// VIMNMX3) gives fminf(fminf(x, y), z) exactly.
__device__ __forceinline__ float min3(float x, float y, float z) {
  return __int_as_float(
      __vimin3_s32(__float_as_int(x), __float_as_int(y), __float_as_int(z)));
}

// Pairs p .. p + C - 1 of a period over a lane's registers: its C (even,
// odd) slot pairs a, b with their band pads pa, pb, and its C query and
// window values qp, wp (logical q[c] = q[u + kb + c], w[c] = w[u + rp -
// kb - c] at pair u, kb the lane's first pair's half-slot).  Each pair:
// the even slots (diagonal 2u + rp), then the odd slots (2u + rp + 1),
// then the shift of q and w by one.  Lane 31's next query value q[u +
// kb + C] and lane 0's next window value w[u + 1 + rp - kb] come from
// the streams; every other lane takes its neighbour's.  Lanes 0 and 31
// are halos or lie off the band, so the values they shuffle in from
// past the warp's edge are never read by a live cell.  The loop is
// unrolled whole, so the rotation (pair V reads logical q[c] at
// qp[(c + V) mod C]) only renames registers.
template <int C, class QS, class WS>
__device__ __forceinline__ void seg_period(
    float (&a)[C], float (&b)[C], const float (&pa)[C], const float (&pb)[C],
    float (&qp)[C], float (&wp)[C], const Stream<QS>& qst,
    const Stream<WS>& wst, int xq, int xw, int lane) {
  constexpr int M = C - 1;
#pragma unroll
  for (int V = 0; V < C; ++V) {
    const float qfar = qst.at(xq + V);
    const float wfar = wst.at(xw + V);
    const float up = __shfl_up_sync(kFull, b[C - 1], 1);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float diff = __fsub_rn(qp[(c + V) & M], wp[(c - V) & M]);
      const float d = __fmaf_rn(diff, diff, pa[c]);
      a[c] = __fadd_rn(d, min3(a[c], b[c], c == 0 ? up : b[(c + M) & M]));
    }
    float qn = __shfl_down_sync(kFull, qp[V & M], 1);
    if (lane == 31) qn = qfar;
    const float left = __shfl_down_sync(kFull, a[0], 1);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float qv = c == C - 1 ? qn : qp[(c + 1 + V) & M];
      const float diff = __fsub_rn(qv, wp[(c - V) & M]);
      const float d = __fmaf_rn(diff, diff, pb[c]);
      b[c] = __fadd_rn(d, min3(b[c], a[c], c == C - 1 ? left
                                                       : a[(c + 1) & M]));
    }
    float wn = __shfl_up_sync(kFull, wp[(M - V) & M], 1);
    if (lane == 0) wn = wfar;
    qp[V & M] = qn;
    wp[(M - V) & M] = wn;
  }
}

// DTW^2 of the streams q and w (length l, rr = min(r, l - 1)) over the
// block's nseg warps, C pairs a lane; xch holds 2 x nseg x 2 x 2C floats
// of shared memory.  The lane holding cell (l - 1, l - 1) returns it and
// sets *own; every thread of the block must call it.
template <int C, class QS, class WS>
__device__ float seg_dtw(const QS& qs, const WS& ws, int l, int rr,
                         int nseg, float* xch, bool* own) {
  const int lane = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const int off = rr & 1, rp = rr + off;   // slot k = i - j + rp
  const int top = off + 2 * rr;            // the band: slots off .. top
  // lane 0's first pair (half-slot) and the lane's own; warp s owns the
  // slots of lanes 1 .. 30, [60Cs, 60C(s + 1)): lanes 0 and 31 mirror
  // its neighbours', or lie off the band (+inf throughout)
  const int kb0 = kSegLanes * C * seg - C;
  const int kb = kb0 + C * lane;
  const int own_lo = 2 * (kb0 + C), own_hi = 2 * (kb0 + 31 * C) - 1;
  float a[C], b[C], pa[C], pb[C], qp[C], wp[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int ka = 2 * (kb + c), kb1 = ka + 1;
    // D[-1,-1] = 0 sits in slot rp on diagonal -2; all else starts +inf
    a[c] = ka == rp ? 0.f : INFINITY;
    b[c] = INFINITY;
    pa[c] = ka >= off && ka <= top ? 0.f : INFINITY;
    pb[c] = kb1 >= off && kb1 <= top ? 0.f : INFINITY;
  }
  const int u0 = -(rp >> 1);       // the pair whose even step is diagonal 0
  const int last = l - 1;          // ... and diagonal 2l - 2
  Stream<QS> qst;
  Stream<WS> wst;
  bool fresh = true;               // q, w and the streams need a load
  for (int p = 0, par = 0; p <= last; p += C, par ^= 1) {
    // the period's diagonals t0 .. t1: does an owned slot hold a cell
    // inside the series (0 <= i, j < l) on one of them?
    const int t0 = 2 * p, t1 = t0 + 2 * C - 1;
    const int lo = max(max(off, rp - t1), t0 + rp - 2 * l + 2);
    const int hi = min(min(top, t1 + rp), 2 * l - 2 - t0 + rp);
    const bool live = lo <= hi && lo <= own_hi && hi >= own_lo;
    const int u = u0 + p;
    const int xq = u + kb0 + 32 * C, xw = u + 1 + rp - kb0;
    if (!live) {
      fresh = true;
    } else {
      if (fresh) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          qp[c] = qs(u + kb + c);
          wp[c] = ws(u + rp - kb - c);
        }
        qst.init(qs, xq, lane);
        wst.init(ws, xw, lane);
        fresh = false;
      } else {
        qst.align(qs, xq, C, lane);
        wst.align(ws, xw, C, lane);
      }
      seg_period<C>(a, b, pa, pb, qp, wp, qst, wst, xq, xw, lane);
    }
    if (nseg > 1 && p + C <= last) {
      // lanes 1 and 30 publish; lanes 0 and 31 take their neighbours'
      float* xb = xch + par * nseg * 4 * C;
      if (lane == 1 || lane == kSegLanes) {
        float* dst = xb + (2 * seg + (lane == 1 ? 0 : 1)) * 2 * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dst[c] = a[c];
          dst[C + c] = b[c];
        }
      }
      __syncthreads();
      if ((lane == 0 && seg > 0) || (lane == 31 && seg < nseg - 1)) {
        const float* src =
            xb + (lane == 0 ? 2 * (seg - 1) + 1 : 2 * (seg + 1)) * 2 * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          a[c] = src[c];
          b[c] = src[C + c];
        }
      }
    }
  }
  // cell (l - 1, l - 1) sits in the even slot rp
  const int hs = rp >> 1;
  const int s_own = hs / (kSegLanes * C);
  const int rel = hs - kSegLanes * C * s_own;
  const int lane_own = rel / C + 1;
  *own = seg == s_own && lane == lane_own;
  float v = INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (rel % C == c) v = a[c];
  return v;
}

// ---- the full-band strip entries -----------------------------------------

constexpr int kStripWarps = 4;    // candidates (a warp each) a block

// DTW^2 of the streams q and w at a full band (rr = l - 1: every cell of
// the l x l matrix) in one warp, l <= 32H: lane L owns rows [LH, LH + H)
// and holds their query values and their cells of the last column in
// registers.  On step s lane L takes column j = s - L (a skewed
// pipeline): cell (i, j) needs (i - 1, j), the row above (this step, in
// the lane's registers, or for the lane's first row lane L - 1's last
// row, which it took on step s - 1: one shuffle), (i, j - 1) and (i - 1,
// j - 1) (the lane's registers of the last column); w[j] passes down the
// lanes with one more shuffle, lane 0 reading it from its stream.  Every
// cell is in the band and none is computed twice; a step costs ~4H + 8
// instructions for H cells.  Rows past l take kPadQ and columns before
// 0 kPadW: +inf, read by no cell of the matrix.  The lane holding cell
// (l - 1, l - 1) returns it and sets *own.
template <int H, class QS, class WS>
__device__ float strip_dtw(const QS& qs, const WS& ws, int l, bool* own) {
  const int lane = threadIdx.x & 31;
  float qr[H], d[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    qr[h] = qs(lane * H + h);
    d[h] = INFINITY;                    // D[i][-1]
  }
  float up_prev = lane == 0 ? 0.f : INFINITY;   // D[LH - 1][-1]
  float bot = INFINITY, w_in = kPadW;
  const int l_own = (l - 1) / H;        // the lane of row l - 1
  Stream<WS> wst;
  wst.init(ws, 0, lane);
  for (int s = 0; s < l_own + l; ++s) {
    float up = __shfl_up_sync(kFull, bot, 1);     // D[LH - 1][j]
    float w = __shfl_up_sync(kFull, w_in, 1);     // w[j]
    wst.align(ws, s, 1, lane);
    const float w0 = wst.at(s);
    if (lane == 0) {
      up = INFINITY;                    // row -1 past column -1
      w = w0;
    }
    float diag = up_prev;
    up_prev = up;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float diff = __fsub_rn(qr[h], w);
      const float left = d[h];
      d[h] = __fadd_rn(__fmul_rn(diff, diff), min3(left, up, diag));
      up = d[h];
      diag = left;
    }
    bot = d[H - 1];
    w_in = w;
  }
  *own = lane == l_own;
  const int row = l - 1 - l_own * H;
  float v = INFINITY;
#pragma unroll
  for (int h = 0; h < H; ++h)
    if (row == h) v = d[h];
  return v;
}

template <int H>
__global__ void __launch_bounds__(32 * kStripWarps)
    dtw_band_strip_kernel(const float* __restrict__ q,
                          const float* __restrict__ cands,
                          float* __restrict__ out, long long num, int l) {
  const QSrc qs{q, l};
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long cand = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
       cand < num; cand += warps) {
    bool own;
    const float v = strip_dtw<H>(qs, WSrc{cands + cand * l, l}, l, &own);
    if (own) out[cand] = v;
  }
}

template <int H>
__global__ void __launch_bounds__(32 * kStripWarps)
    dtw_survivors_strip_kernel(const float* __restrict__ data,
                               const float* __restrict__ qs,
                               const int* __restrict__ slist,
                               const int* __restrict__ nsurv,
                               const int* __restrict__ cand_sid,
                               const int* __restrict__ cand_off,
                               const float* __restrict__ mu,
                               const float* __restrict__ sd,
                               float* __restrict__ out,
                               long long num_series, int n, int batch, int m,
                               int l, int znorm) {
  // the flat list of every query's survivors, as in dtw_survivors_kernel
  long long total = 0;
  for (int b = 0; b < batch; ++b) total += min(nsurv[b], m);
  const long long last = num_series * (long long)n - 1;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  int b = 0;
  long long base = 0;
  for (long long f = (long long)blockIdx.x * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       f < total; f += warps) {
    while (f >= base + min(nsurv[b], m)) base += min(nsurv[b++], m);
    const long long row0 = (long long)b * m;
    const long long e = row0 + slist[row0 + (f - base)];
    int off = cand_off[e];
    off = off < 0 ? 0 : (off > n - l ? n - l : off);
    const float mu_e = mu[e], sd_e = sd[e];
    const WZSrc ws{data, (long long)cand_sid[e] * n + off, last, mu_e, sd_e,
                   __frcp_rn(sd_e), l, znorm};
    bool own;
    const float v = strip_dtw<H>(QSrc{qs + (long long)b * l, l}, ws, l,
                                 &own);
    if (own) out[e] = v;
  }
}

template <int C>
__global__ void __launch_bounds__(32 * seg_max_warps(C))
    dtw_band_seg_kernel(const float* __restrict__ q,
                        const float* __restrict__ cands,
                        float* __restrict__ out, long long num, int l,
                        int rr) {
  extern __shared__ float xch[];
  const int nseg = blockDim.x >> 5;
  const QSrc qs{q, l};
  for (long long cand = blockIdx.x; cand < num; cand += gridDim.x) {
    bool own;
    const float v = seg_dtw<C>(qs, WSrc{cands + cand * l, l}, l, rr, nseg,
                               xch, &own);
    if (own) out[cand] = v;
    __syncthreads();                 // the exchange slots are free again
  }
}

template <int C>
__global__ void __launch_bounds__(32 * seg_max_warps(C))
    dtw_survivors_seg_kernel(const float* __restrict__ data,
                             const float* __restrict__ qs,
                             const int* __restrict__ slist,
                             const int* __restrict__ nsurv,
                             const int* __restrict__ cand_sid,
                             const int* __restrict__ cand_off,
                             const float* __restrict__ mu,
                             const float* __restrict__ sd,
                             float* __restrict__ out, long long num_series,
                             int n, int batch, int m, int l, int rr,
                             int znorm) {
  extern __shared__ float xch[];
  const int nseg = blockDim.x >> 5;
  // the flat list of every query's survivors, as in dtw_survivors_kernel
  long long total = 0;
  for (int b = 0; b < batch; ++b) total += min(nsurv[b], m);
  const long long last = num_series * (long long)n - 1;
  int b = 0;
  long long base = 0;
  for (long long f = blockIdx.x; f < total; f += gridDim.x) {
    while (f >= base + min(nsurv[b], m)) base += min(nsurv[b++], m);
    const long long row0 = (long long)b * m;
    const long long e = row0 + slist[row0 + (f - base)];
    int off = cand_off[e];
    off = off < 0 ? 0 : (off > n - l ? n - l : off);
    const float mu_e = mu[e], sd_e = sd[e];
    const WZSrc ws{data, (long long)cand_sid[e] * n + off, last, mu_e, sd_e,
                   __frcp_rn(sd_e), l, znorm};
    bool own;
    const float v = seg_dtw<C>(QSrc{qs + (long long)b * l, l}, ws, l, rr,
                               nseg, xch, &own);
    if (own) out[e] = v;
    __syncthreads();
  }
}

// The pairs a lane holds for a band of W cells (0 when W > 64 * kMaxPairs).
int pairs_for(int band) {
  for (int c = 1; c <= kMaxPairs; c *= 2)
    if (64 * c >= band) return c;
  return 0;
}

// Warps a block, from the padded arrays each warp stages (`per_warp`
// floats) beside `shared` floats of the block, within the opt-in shared
// memory; 0 when not even one fits.
int warps_for(long long per_warp, long long shared) {
  const long long fit = (kSmemMax / 4 - shared) / per_warp;
  return fit < 1 ? 0 : (fit > kWarps ? kWarps : (int)fit);
}

// Blocks of one full wave of the card for a kernel of `threads` threads
// and `smem` bytes of shared memory (SM count cached per device).
long long wave_blocks(int threads, size_t smem) {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& count = sms[dev & 63];
  if (count == 0)
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  long long per_sm = 2048 / threads;
  const long long by_smem = (kSmemMax + 1024) / ((long long)smem + 1024);
  if (by_smem < per_sm) per_sm = by_smem;
  return (long long)(count > 0 ? count : 1) * (per_sm > 0 ? per_sm : 1);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= kSmemDefault) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <template <int> class Launch, typename... Args>
int dispatch(int pairs, Args... args) {
  switch (pairs) {
    case 1: return Launch<1>::run(args...);
    case 2: return Launch<2>::run(args...);
    case 4: return Launch<4>::run(args...);
    case 8: return Launch<8>::run(args...);
    case 16: return Launch<16>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int C>
struct BandLaunch {
  static int run(cudaStream_t stream, const float* q, const float* cands,
                 float* out, long long num, int l, int rr) {
    const int span = l + 64 * C;
    const int warps = warps_for(span, span);
    if (warps < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * (size_t)(1 + warps) * span;
    const int err = set_smem(dtw_band_kernel<C>, smem);
    if (err) return err;
    long long blocks = (num + warps - 1) / warps;
    if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
    dtw_band_kernel<C><<<(unsigned)blocks, warps * 32, smem, stream>>>(
        q, cands, out, num, l, rr, span);
    return (int)cudaGetLastError();
  }
};

template <int C>
struct SurvivorsLaunch {
  static int run(cudaStream_t stream, const float* data, const float* qs,
                 const int* slist, const int* nsurv, const int* cand_sid,
                 const int* cand_off, const float* mu, const float* sd,
                 float* out, long long num_series, int n, int batch, int m,
                 int l, int rr, int znorm) {
    const int span = l + 64 * C;
    const int warps = warps_for(2LL * span, 0);
    if (warps < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * (size_t)(2 * warps) * span;
    const int err = set_smem(dtw_survivors_kernel<C>, smem);
    if (err) return err;
    long long blocks = ((long long)batch * m + warps - 1) / warps;
    const long long wave = wave_blocks(warps * 32, smem);
    if (blocks > wave) blocks = wave;
    dtw_survivors_kernel<C><<<(unsigned)blocks, warps * 32, smem, stream>>>(
        data, qs, slist, nsurv, cand_sid, cand_off, mu, sd, out, num_series,
        n, batch, m, l, rr, znorm, span);
    return (int)cudaGetLastError();
  }
};

// The block kernel's launch: a block of up to kWideThreads threads per
// candidate in flight, one wave of the card (or `scratch_blocks` blocks
// of the global scratch where the buffer does not fit shared memory),
// each block walking candidates blockIdx.x, + gridDim.x, ...
template <typename Kernel, typename... Args>
int launch_wide(Kernel kernel, cudaStream_t stream, float* scratch,
                int scratch_blocks, long long work, int l, int rr,
                Args... args) {
  const long long floats = wide_floats(l, rr);
  const bool in_smem = floats * 4 <= kSmemMax;
  if (!in_smem && (scratch == nullptr || scratch_blocks < 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = in_smem ? (size_t)floats * 4 : 0;
  const int err = set_smem(kernel, smem);
  if (err) return err;
  int threads = (rr + 1 + 31) / 32 * 32;   // the live slots of a diagonal
  if (threads > kWideThreads) threads = kWideThreads;
  long long blocks = in_smem ? wave_blocks(threads, smem) : scratch_blocks;
  if (blocks > work) blocks = work;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      args..., in_smem ? nullptr : scratch, l, rr, floats);
  return (int)cudaGetLastError();
}

// Whether `segs` warps of C pairs a lane take a band of rr: every band
// slot owned (60C a warp), every warp owning one, within the block's
// most warps.
bool seg_takes(int C, int segs, int rr) {
  const int slots = (rr & 1) + 2 * rr + 1;
  return segs >= 1 && segs <= seg_max_warps(C) &&
         2 * kSegLanes * C * segs >= slots &&
         2 * kSegLanes * C * (segs - 1) < slots;
}

// A segmented kernel's launch: `segs` warps a block, one candidate a
// block at a time, as many blocks as the card holds at once (at most
// `work`); the exchange slots in shared memory.
template <typename Kernel, typename... Args>
int launch_seg(Kernel kernel, cudaStream_t stream, int C, int segs,
               long long work, Args... args) {
  const int threads = 32 * segs;
  const size_t smem = sizeof(float) * 2 * segs * 4 * C;
  int per_sm = 0, dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (long long)per_sm * (sms > 0 ? sms : 1);
  if (blocks > work) blocks = work;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The strip kernels' launch: kStripWarps candidates a block, as many
// blocks as the card holds at once (at most one a kStripWarps of
// `work`), each warp walking candidates.
template <typename Kernel, typename... Args>
int launch_strip(Kernel kernel, cudaStream_t stream, long long work,
                 Args... args) {
  const int threads = 32 * kStripWarps;
  int per_sm = 0, dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, 0);
  if (err) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (long long)per_sm * (sms > 0 ? sms : 1);
  const long long need = (work + kStripWarps - 1) / kStripWarps;
  if (blocks > need) blocks = need;
  kernel<<<(unsigned)blocks, threads, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Whether the strip kernel of H rows a lane takes (l, rr): a full band
// of at most 32H rows.
bool strip_takes(int H, int l, int rr) { return rr >= l - 1 && l <= 32 * H; }

template <int H>
struct StripBandLaunch {
  static int run(cudaStream_t stream, const float* q, const float* cands,
                 float* out, long long num, int l, int rr) {
    if (!strip_takes(H, l, rr)) return (int)cudaErrorInvalidValue;
    return launch_strip(dtw_band_strip_kernel<H>, stream, num, q, cands,
                        out, num, l);
  }
};

template <int H>
struct StripSurvivorsLaunch {
  static int run(cudaStream_t stream, const float* data, const float* qs,
                 const int* slist, const int* nsurv, const int* cand_sid,
                 const int* cand_off, const float* mu, const float* sd,
                 float* out, long long num_series, int n, int batch, int m,
                 int l, int rr, int znorm) {
    if (!strip_takes(H, l, rr)) return (int)cudaErrorInvalidValue;
    return launch_strip(dtw_survivors_strip_kernel<H>, stream,
                        (long long)batch * m, data, qs, slist, nsurv,
                        cand_sid, cand_off, mu, sd, out, num_series, n,
                        batch, m, l, znorm);
  }
};

// H rows a lane of the strip kernels: a multiple of 4 up to 32.
template <template <int> class Launch, typename... Args>
int dispatch_rows(int rows, Args... args) {
  switch (rows) {
    case 4: return Launch<4>::run(args...);
    case 8: return Launch<8>::run(args...);
    case 12: return Launch<12>::run(args...);
    case 16: return Launch<16>::run(args...);
    case 20: return Launch<20>::run(args...);
    case 24: return Launch<24>::run(args...);
    case 28: return Launch<28>::run(args...);
    case 32: return Launch<32>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int C>
struct SegBandLaunch {
  static int run(cudaStream_t stream, int segs, const float* q,
                 const float* cands, float* out, long long num, int l,
                 int rr) {
    if (!seg_takes(C, segs, rr)) return (int)cudaErrorInvalidValue;
    return launch_seg(dtw_band_seg_kernel<C>, stream, C, segs, num, q,
                      cands, out, num, l, rr);
  }
};

template <int C>
struct SegSurvivorsLaunch {
  static int run(cudaStream_t stream, int segs, const float* data,
                 const float* qs, const int* slist, const int* nsurv,
                 const int* cand_sid, const int* cand_off, const float* mu,
                 const float* sd, float* out, long long num_series, int n,
                 int batch, int m, int l, int rr, int znorm) {
    if (!seg_takes(C, segs, rr)) return (int)cudaErrorInvalidValue;
    return launch_seg(dtw_survivors_seg_kernel<C>, stream, C, segs,
                      (long long)batch * m, data, qs, slist, nsurv,
                      cand_sid, cand_off, mu, sd, out, num_series, n, batch,
                      m, l, rr, znorm);
  }
};

}  // namespace

extern "C" int ulisse_dtw_band(const void* q, const void* cands, void* out,
                               long long num, int l, int r, void* stream) {
  if (num < 1 || l < 1 || r < 0) return (int)cudaErrorInvalidValue;
  const int rr = r < l - 1 ? r : l - 1;
  return dispatch<BandLaunch>(
      pairs_for(2 * rr + 1), static_cast<cudaStream_t>(stream),
      static_cast<const float*>(q), static_cast<const float*>(cands),
      static_cast<float*>(out), num, l, rr);
}

extern "C" int ulisse_dtw_survivors(
    const void* data, const void* qs, const void* slist, const void* nsurv,
    const void* cand_sid, const void* cand_off, const void* mu,
    const void* sd, void* out, long long num_series, int n, int batch, int m,
    int l, int r, int znorm, void* stream) {
  if (batch < 1 || m < 1 || l < 1 || l > n || r < 0)
    return (int)cudaErrorInvalidValue;
  const int rr = r < l - 1 ? r : l - 1;
  return dispatch<SurvivorsLaunch>(
      pairs_for(2 * rr + 1), static_cast<cudaStream_t>(stream),
      static_cast<const float*>(data), static_cast<const float*>(qs),
      static_cast<const int*>(slist), static_cast<const int*>(nsurv),
      static_cast<const int*>(cand_sid), static_cast<const int*>(cand_off),
      static_cast<const float*>(mu), static_cast<const float*>(sd),
      static_cast<float*>(out), num_series, n, batch, m, l, rr, znorm);
}

// Floats of global scratch a block of the wide entries needs at (l, r):
// 0 where its buffer fits shared memory (the wrapper then passes none).
extern "C" long long ulisse_dtw_wide_scratch(int l, int r) {
  if (l < 1 || r < 0) return -1;
  const int rr = r < l - 1 ? r : l - 1;
  const long long floats = wide_floats(l, rr);
  return floats * 4 <= kSmemMax ? 0 : floats;
}

// The wide entries (dtw_band.wide_plan): segs >= 1 the segmented kernel
// (pairs C a lane, segs warps a candidate), segs = -1 the strip kernel
// (a full band; pairs the rows H a lane), segs = 0 the block kernel
// (scratch: scratch_blocks slices of ulisse_dtw_wide_scratch floats, or
// none where its buffer fits shared memory).
extern "C" int ulisse_dtw_band_wide(const void* q, const void* cands,
                                    void* out, void* scratch,
                                    int scratch_blocks, long long num, int l,
                                    int r, int pairs, int segs,
                                    void* stream) {
  if (num < 1 || l < 1 || r < 0 || segs < -1)
    return (int)cudaErrorInvalidValue;
  const int rr = r < l - 1 ? r : l - 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (segs < 0)
    return dispatch_rows<StripBandLaunch>(pairs, st,
                                          static_cast<const float*>(q),
                                          static_cast<const float*>(cands),
                                          static_cast<float*>(out), num, l,
                                          rr);
  if (segs > 0)
    return dispatch<SegBandLaunch>(pairs, st, segs,
                                   static_cast<const float*>(q),
                                   static_cast<const float*>(cands),
                                   static_cast<float*>(out), num, l, rr);
  return launch_wide(dtw_band_wide_kernel, st, static_cast<float*>(scratch),
                     scratch_blocks, num, l, rr,
                     static_cast<const float*>(q),
                     static_cast<const float*>(cands),
                     static_cast<float*>(out), num);
}

extern "C" int ulisse_dtw_survivors_wide(
    const void* data, const void* qs, const void* slist, const void* nsurv,
    const void* cand_sid, const void* cand_off, const void* mu,
    const void* sd, void* out, void* scratch, int scratch_blocks,
    long long num_series, int n, int batch, int m, int l, int r, int znorm,
    int pairs, int segs, void* stream) {
  if (batch < 1 || m < 1 || l < 1 || l > n || r < 0 || segs < -1)
    return (int)cudaErrorInvalidValue;
  const int rr = r < l - 1 ? r : l - 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a_data = static_cast<const float*>(data);
  const float* a_qs = static_cast<const float*>(qs);
  const int* a_slist = static_cast<const int*>(slist);
  const int* a_nsurv = static_cast<const int*>(nsurv);
  const int* a_sid = static_cast<const int*>(cand_sid);
  const int* a_off = static_cast<const int*>(cand_off);
  const float* a_mu = static_cast<const float*>(mu);
  const float* a_sd = static_cast<const float*>(sd);
  float* a_out = static_cast<float*>(out);
  if (segs < 0)
    return dispatch_rows<StripSurvivorsLaunch>(
        pairs, st, a_data, a_qs, a_slist, a_nsurv, a_sid, a_off, a_mu, a_sd,
        a_out, num_series, n, batch, m, l, rr, znorm);
  if (segs > 0)
    return dispatch<SegSurvivorsLaunch>(
        pairs, st, segs, a_data, a_qs, a_slist, a_nsurv, a_sid, a_off, a_mu,
        a_sd, a_out, num_series, n, batch, m, l, rr, znorm);
  return launch_wide(dtw_survivors_wide_kernel, st,
                     static_cast<float*>(scratch), scratch_blocks,
                     (long long)batch * m, l, rr, a_data, a_qs, a_slist,
                     a_nsurv, a_sid, a_off, a_mu, a_sd, a_out, num_series, n,
                     batch, m, znorm);
}
