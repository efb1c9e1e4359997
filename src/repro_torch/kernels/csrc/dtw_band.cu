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
// staging no longer leaves room for a full block).  The same wavefront,
// a block per candidate: the band's W slots sit in a buffer the block
// shares (slot k at st[k + 1], st[0] = st[W + 1] = +inf); diagonal t
// updates the slots of t + rr's parity whose cell lies inside the
// series, each thread every blockDim-th of them, reading only slots of
// the other parity and its own, so one __syncthreads() a diagonal orders
// the steps.  A slot whose cell lies off the series is not written: it
// still holds +inf (i < 0 or j < 0 from the start) or a value that only
// cells off the series read (i >= l or j >= l), so every cell inside the
// series reads what the warp entries' sentinels give it.  The query and
// the (normalized) window sit beside the state; the buffer of 2rr + 3 +
// 2l floats lives in shared memory where it fits (l up to ~14,500 at a
// full band), else in a global scratch slice per block.  Each cell is
// the same IEEE add of its cost to the min of its three neighbours, so
// the wide and warp entries give the same bits wherever both apply.
// Bound: operations, as above; a diagonal costs a block barrier, so the
// wide entries trade the warp's shuffle for ~2l barriers a candidate.
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

// The wide entries' DP of q against w (both (l,), any memory) over the
// state st[0 .. 2rr + 2], run by the whole block; every thread gets the
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

// The wide entries' buffer: the state (2rr + 3 floats), q and w (l each).
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

// The wide entries' launch: a block of up to kWideThreads threads per
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

extern "C" int ulisse_dtw_band_wide(const void* q, const void* cands,
                                    void* out, void* scratch,
                                    int scratch_blocks, long long num, int l,
                                    int r, void* stream) {
  if (num < 1 || l < 1 || r < 0) return (int)cudaErrorInvalidValue;
  const int rr = r < l - 1 ? r : l - 1;
  return launch_wide(dtw_band_wide_kernel, static_cast<cudaStream_t>(stream),
                     static_cast<float*>(scratch), scratch_blocks, num, l, rr,
                     static_cast<const float*>(q),
                     static_cast<const float*>(cands),
                     static_cast<float*>(out), num);
}

extern "C" int ulisse_dtw_survivors_wide(
    const void* data, const void* qs, const void* slist, const void* nsurv,
    const void* cand_sid, const void* cand_off, const void* mu,
    const void* sd, void* out, void* scratch, int scratch_blocks,
    long long num_series, int n, int batch, int m, int l, int r, int znorm,
    void* stream) {
  if (batch < 1 || m < 1 || l < 1 || l > n || r < 0)
    return (int)cudaErrorInvalidValue;
  const int rr = r < l - 1 ? r : l - 1;
  return launch_wide(
      dtw_survivors_wide_kernel, static_cast<cudaStream_t>(stream),
      static_cast<float*>(scratch), scratch_blocks, (long long)batch * m, l,
      rr, static_cast<const float*>(data), static_cast<const float*>(qs),
      static_cast<const int*>(slist), static_cast<const int*>(nsurv),
      static_cast<const int*>(cand_sid), static_cast<const int*>(cand_off),
      static_cast<const float*>(mu), static_cast<const float*>(sd),
      static_cast<float*>(out), num_series, n, batch, m, znorm);
}
