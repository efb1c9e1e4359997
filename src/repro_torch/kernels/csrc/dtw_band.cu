// Squared Sakoe-Chiba banded DTW for ULISSE, for Hopper.
//
// Replaces repro/kernels/dtw_band.py::dtw_band_pallas (Pallas body
// _dtw_band_kernel), and with it the jnp DP the reference search runs on
// the LB_Keogh survivors of every scan chunk
// (repro/core/executor.py::_survivor_bucket -> core/dtw.py::dtw_band).
// Two entries over one device function:
//   ulisse_dtw_band       q (l,) against candidates (N, l) -> (N,);
//   ulisse_dtw_survivors  the survivors of one scan chunk of B queries in
//                         one launch: slot p < nsurv[b] gathers candidate
//                         sidx[b, p]'s window data[sid, clip(off, 0,
//                         n - l) : + l] (flat read clipped to the array),
//                         normalizes it with that candidate's (mu, sd)
//                         from the LB_Keogh kernel when znorm, and writes
//                         its DTW^2 against q_b; slots >= nsurv[b] get
//                         +inf.  nsurv stays on the device: no host sync.
//
// The DP: D[i,j] = (q_i - c_j)^2 + min(D[i-1,j], D[i-1,j-1], D[i,j-1]) for
// |i - j| <= r, D[-1,-1] = 0, answer D[l-1,l-1].  A band wider than the
// row changes nothing, so r is capped at l - 1 and the band has
// W = 2r + 1 <= 2l - 1 cells.
// Design: one warp per candidate, rows in order.  Lane L owns the C
// consecutive band cells k = L*C .. L*C + C - 1 of every row (C the least
// power of two with 32*C >= W, a template parameter, so the band lives in
// registers: C = 2 at the path's r = 16 and r = 25).  Between rows the band
// shifts by one column, so up = prev[k+1] (one shuffle from the next lane
// for the lane's last cell) and diag = prev[k].  The in-row left
// dependency x_k = d_k + min(M_k, x_{k-1}) is a composition of maps
// x -> min(A, x + S); each lane composes its C cells, a 5-step warp scan
// composes the lanes, and each lane then runs its cells serially from its
// left neighbour's result.  Cells outside the series cost +inf.  The
// window is staged in shared memory per warp, the query per block.
// Bound on the card: operations (l * W cells of ~5 flops per candidate;
// the window read is l floats); the serial depth l per candidate is why
// many candidates run at once.
// Rounding: the DP sums in row order like a plain recurrence; the plain
// version (the cumsum/cummin closed form) rounds differently, within the
// stated tolerance.  The survivors' normalization is the LB kernel's
// (x - mu) / sd, an IEEE subtract then an IEEE divide, so the DP sees the
// very values the lower bound saw.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;               // candidates per block
constexpr int kMaxCells = 32;           // band cells per lane: W <= 1024
constexpr int kSmemBudget = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// DTW^2 of q (l,) against w (l,), both in shared memory; rr = min(r, l-1)
// and 2*rr + 1 <= 32*C.  Every lane of the warp calls it; all get the
// result.
template <int C>
__device__ float band_dtw(const float* q, const float* w, int l, int rr) {
  const int lane = threadIdx.x & 31;
  const int band = 2 * rr + 1;
  float prev[C];                 // row i-1; row -1 is 0 at D[-1,-1] (k = rr)
#pragma unroll
  for (int c = 0; c < C; ++c) prev[c] = lane * C + c == rr ? 0.f : INFINITY;
  for (int i = 0; i < l; ++i) {
    const float qi = q[i];
    float right = __shfl_down_sync(kFull, prev[0], 1);
    if (lane == 31) right = INFINITY;
    float d[C], m[C];
    float a = INFINITY, s = 0.f;    // the lane's map x -> min(a, x + s)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = lane * C + c;
      const int j = i - rr + k;
      m[c] = fminf(c + 1 < C ? prev[c + 1] : right, prev[c]);
      if (k < band && j >= 0 && j < l) {
        const float diff = qi - w[j];
        d[c] = diff * diff;
      } else {
        d[c] = INFINITY;
      }
      a = fminf(d[c] + m[c], a + d[c]);
      s += d[c];
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {     // compose lanes 0..lane
      const float ao = __shfl_up_sync(kFull, a, off);
      const float so = __shfl_up_sync(kFull, s, off);
      if (lane >= off) {
        a = fminf(a, ao + s);
        s += so;
      }
    }
    float x = __shfl_up_sync(kFull, a, 1);   // the left neighbour's cell
    if (lane == 0) x = INFINITY;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      x = d[c] + fminf(m[c], x);
      prev[c] = x;
    }
  }
  float v = INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c == rr % C) v = prev[c];
  return __shfl_sync(kFull, v, rr / C);      // cell (l-1, l-1) at k = rr
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
    dtw_band_kernel(const float* __restrict__ q,
                    const float* __restrict__ cands, float* __restrict__ out,
                    long long num, int l, int rr) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q_s = smem;                               // [l]
  float* w_s = smem + (long long)(1 + warp) * l;   // [l] per warp
  for (int t = threadIdx.x; t < l; t += blockDim.x) q_s[t] = q[t];
  __syncthreads();
  const int warps = blockDim.x >> 5;
  for (long long cand = (long long)blockIdx.x * warps + warp; cand < num;
       cand += (long long)gridDim.x * warps) {
    for (int t = lane; t < l; t += 32) w_s[t] = cands[cand * l + t];
    __syncwarp();
    const float v = band_dtw<C>(q_s, w_s, l, rr);
    if (lane == 0) out[cand] = v;
    __syncwarp();
  }
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
    dtw_survivors_kernel(const float* __restrict__ data,
                         const float* __restrict__ qs,
                         const int* __restrict__ sidx,
                         const int* __restrict__ nsurv,
                         const int* __restrict__ cand_sid,
                         const int* __restrict__ cand_off,
                         const float* __restrict__ mu,
                         const float* __restrict__ sd,
                         float* __restrict__ out, long long num_series, int n,
                         int m, int l, int rr, int znorm) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.y;
  float* q_s = smem;                               // [l]
  float* w_s = smem + (long long)(1 + warp) * l;   // [l] per warp
  for (int t = threadIdx.x; t < l; t += blockDim.x)
    q_s[t] = qs[(long long)b * l + t];
  __syncthreads();
  const long long row0 = (long long)b * m;
  const int ns = min(nsurv[b], m);
  for (int p = ns + blockIdx.x * blockDim.x + threadIdx.x; p < m;
       p += gridDim.x * blockDim.x)
    out[row0 + p] = INFINITY;
  const long long total = num_series * (long long)n;
  for (int p = blockIdx.x * warps + warp; p < ns; p += gridDim.x * warps) {
    const long long e = row0 + sidx[row0 + p];
    int off = cand_off[e];
    off = off < 0 ? 0 : (off > n - l ? n - l : off);
    const long long base = (long long)cand_sid[e] * n + off;
    const float mu_e = mu[e], sd_e = sd[e];
    for (int t = lane; t < l; t += 32) {
      long long flat = base + t;
      flat = flat < 0 ? 0 : (flat >= total ? total - 1 : flat);
      const float v = data[flat];
      w_s[t] = znorm ? __fdiv_rn(__fsub_rn(v, mu_e), sd_e) : v;
    }
    __syncwarp();
    const float v = band_dtw<C>(q_s, w_s, l, rr);
    if (lane == 0) out[row0 + p] = v;
    __syncwarp();
  }
}

// The per-lane cell count for a band of W cells (0 when W > 32*kMaxCells)
// and the warps per block that fit l floats each, plus the query, in
// the shared-memory budget.
int cells_for(int band) {
  for (int c = 1; c <= kMaxCells; c *= 2)
    if (32 * c >= band) return c;
  return 0;
}

int warps_for(int l) {
  const long long fit = (long long)kSmemBudget / (4LL * l) - 1;
  return fit < 1 ? 0 : (fit > kWarps ? kWarps : (int)fit);
}

template <template <int> class Launch, typename... Args>
int dispatch(int cells, Args... args) {
  switch (cells) {
    case 1: return Launch<1>::run(args...);
    case 2: return Launch<2>::run(args...);
    case 4: return Launch<4>::run(args...);
    case 8: return Launch<8>::run(args...);
    case 16: return Launch<16>::run(args...);
    case 32: return Launch<32>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int C>
struct BandLaunch {
  static int run(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                 const float* q, const float* cands, float* out,
                 long long num, int l, int rr) {
    dtw_band_kernel<C><<<grid, threads, smem, stream>>>(q, cands, out, num,
                                                        l, rr);
    return (int)cudaGetLastError();
  }
};

template <int C>
struct SurvivorsLaunch {
  static int run(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                 const float* data, const float* qs, const int* sidx,
                 const int* nsurv, const int* cand_sid, const int* cand_off,
                 const float* mu, const float* sd, float* out,
                 long long num_series, int n, int m, int l, int rr,
                 int znorm) {
    dtw_survivors_kernel<C><<<grid, threads, smem, stream>>>(
        data, qs, sidx, nsurv, cand_sid, cand_off, mu, sd, out, num_series,
        n, m, l, rr, znorm);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" int ulisse_dtw_band(const void* q, const void* cands, void* out,
                               long long num, int l, int r, void* stream) {
  if (num < 1 || l < 1 || r < 0) return (int)cudaErrorInvalidValue;
  const int rr = r < l - 1 ? r : l - 1;
  const int warps = warps_for(l);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  long long blocks = (num + warps - 1) / warps;
  if (blocks > 4096) blocks = 4096;
  return dispatch<BandLaunch>(
      cells_for(2 * rr + 1), dim3((unsigned)blocks), warps * 32,
      sizeof(float) * (size_t)(1 + warps) * l,
      static_cast<cudaStream_t>(stream), static_cast<const float*>(q),
      static_cast<const float*>(cands), static_cast<float*>(out), num, l,
      rr);
}

extern "C" int ulisse_dtw_survivors(
    const void* data, const void* qs, const void* sidx, const void* nsurv,
    const void* cand_sid, const void* cand_off, const void* mu,
    const void* sd, void* out, long long num_series, int n, int batch, int m,
    int l, int r, int znorm, void* stream) {
  if (batch < 1 || batch > 65535 || m < 1 || l < 1 || l > n || r < 0)
    return (int)cudaErrorInvalidValue;
  const int rr = r < l - 1 ? r : l - 1;
  const int warps = warps_for(l);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  int blocks = (m + warps - 1) / warps;
  if (blocks > 128) blocks = 128;
  return dispatch<SurvivorsLaunch>(
      cells_for(2 * rr + 1), dim3(blocks, batch), warps * 32,
      sizeof(float) * (size_t)(1 + warps) * l,
      static_cast<cudaStream_t>(stream), static_cast<const float*>(data),
      static_cast<const float*>(qs), static_cast<const int*>(sidx),
      static_cast<const int*>(nsurv), static_cast<const int*>(cand_sid),
      static_cast<const int*>(cand_off), static_cast<const float*>(mu),
      static_cast<const float*>(sd), static_cast<float*>(out), num_series, n,
      m, l, rr, znorm);
}
