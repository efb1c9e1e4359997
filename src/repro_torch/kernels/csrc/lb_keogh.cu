// Squared LB_Keogh of windows against one query envelope, for Hopper.
//
// Replaces repro/kernels/lb_keogh.py::lb_keogh_pallas (Pallas body
// _lb_keogh_kernel): (N, L) windows, already Z-normalized where the index
// is, against the query's DTW envelope (lo, hi) (L,) -> (N,)
//     sum_t max(w_t - hi_t, 0)^2 + max(lo_t - w_t, 0)^2   (paper Eq. 6).
// The host backend filters each chunk's DTW candidates with it
// (repro/core/executor.py::lb_keogh_batch); the banded DP then reads the
// very normalized windows this kernel read, so LB_Keogh <= DTW holds.
// Bound on the card: bytes.  A 512-envelope host chunk at qlen 256 is
// 25,088 windows, 25.7 MB read once, against ~7 flops a point.
// Design: one warp per window, 16-byte loads (consecutive lanes on
// consecutive float4s of the row), the envelope in shared memory, a
// warp reduction of the per-lane sums.  Any L: an envelope longer than
// the 48 KB of staging goes to lb_keogh_tiled_kernel, which streams it in
// tiles of L (a multiple of 128 floats, so every lane meets the row's
// points in the single-tile order); path shapes keep the single tile.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;               // windows in flight per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 48 * 1024 / 8;    // envelope points a tile (x 2)

__device__ __forceinline__ float gap2(float v, float lo, float hi) {
  const float over = fmaxf(v - hi, 0.f);
  const float under = fmaxf(lo - v, 0.f);
  return over * over + under * under;
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    lb_keogh_kernel(const float* __restrict__ env_lo,
                    const float* __restrict__ env_hi,
                    const float* __restrict__ windows,
                    float* __restrict__ out, long long num, int l) {
  extern __shared__ float smem[];
  float* lo_s = smem;                   // [l]
  float* hi_s = smem + l;               // [l]
  for (int t = threadIdx.x; t < l; t += blockDim.x) {
    lo_s[t] = env_lo[t];
    hi_s[t] = env_hi[t];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (long long row = (long long)blockIdx.x * warps + warp; row < num;
       row += (long long)gridDim.x * warps) {
    const float* w = windows + row * l;
    float acc = 0.f;
    if (kVec) {
      const float4* w4 = reinterpret_cast<const float4*>(w);
      for (int t4 = lane; t4 < (l >> 2); t4 += 32) {
        const float4 v = w4[t4];
        const float4 lo = reinterpret_cast<const float4*>(lo_s)[t4];
        const float4 hi = reinterpret_cast<const float4*>(hi_s)[t4];
        acc += (gap2(v.x, lo.x, hi.x) + gap2(v.y, lo.y, hi.y))
               + (gap2(v.z, lo.z, hi.z) + gap2(v.w, lo.w, hi.w));
      }
    } else {
      for (int t = lane; t < l; t += 32) acc += gap2(w[t], lo_s[t], hi_s[t]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) out[row] = acc;
  }
}

// An envelope longer than the staging: the block walks its rows a warp
// each, kWarps at a time, and streams (lo, hi) through shared memory in
// tiles of `tile` points (all warps in step); each warp keeps its row's
// sum in registers across the tiles.
template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    lb_keogh_tiled_kernel(const float* __restrict__ env_lo,
                          const float* __restrict__ env_hi,
                          const float* __restrict__ windows,
                          float* __restrict__ out, long long num, int l,
                          int tile) {
  extern __shared__ float smem[];
  float* lo_s = smem;                   // [tile]
  float* hi_s = smem + tile;            // [tile]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (long long row0 = (long long)blockIdx.x * warps; row0 < num;
       row0 += (long long)gridDim.x * warps) {
    const long long row = row0 + warp;
    const bool live = row < num;
    float acc = 0.f;
    for (int t0 = 0; t0 < l; t0 += tile) {
      const int tn = min(tile, l - t0);
      __syncthreads();                  // the last tile is consumed
      for (int t = threadIdx.x; t < tn; t += blockDim.x) {
        lo_s[t] = env_lo[t0 + t];
        hi_s[t] = env_hi[t0 + t];
      }
      __syncthreads();
      if (!live) continue;
      const float* w = windows + row * l + t0;
      if (kVec) {
        const float4* w4 = reinterpret_cast<const float4*>(w);
        for (int t4 = lane; t4 < (tn >> 2); t4 += 32) {
          const float4 v = w4[t4];
          const float4 lo = reinterpret_cast<const float4*>(lo_s)[t4];
          const float4 hi = reinterpret_cast<const float4*>(hi_s)[t4];
          acc += (gap2(v.x, lo.x, hi.x) + gap2(v.y, lo.y, hi.y))
                 + (gap2(v.z, lo.z, hi.z) + gap2(v.w, lo.w, hi.w));
        }
      } else {
        for (int t = lane; t < tn; t += 32)
          acc += gap2(w[t], lo_s[t], hi_s[t]);
      }
    }
    if (!live) continue;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) out[row] = acc;
  }
}

}  // namespace

extern "C" int ulisse_lb_keogh(const void* env_lo, const void* env_hi,
                               const void* windows, void* out, long long num,
                               int l, void* stream) {
  if (num < 1 || l < 1) return (int)cudaErrorInvalidValue;
  const bool tiled = l > kTile;
  const size_t smem = sizeof(float) * 2 * (size_t)(tiled ? kTile : l);
  long long blocks = (num + kWarps - 1) / kWarps;
  if (blocks > 132 * 64) blocks = 132 * 64;
  const bool vec = (l % 4 == 0) &&
                   (reinterpret_cast<size_t>(windows) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lo = static_cast<const float*>(env_lo);
  const float* hi = static_cast<const float*>(env_hi);
  const float* w = static_cast<const float*>(windows);
  float* o = static_cast<float*>(out);
  if (tiled) {
    if (vec)
      lb_keogh_tiled_kernel<true><<<(unsigned)blocks, kWarps * 32, smem, s>>>(
          lo, hi, w, o, num, l, kTile);
    else
      lb_keogh_tiled_kernel<false><<<(unsigned)blocks, kWarps * 32, smem,
                                     s>>>(lo, hi, w, o, num, l, kTile);
    return (int)cudaGetLastError();
  }
  if (vec)
    lb_keogh_kernel<true><<<(unsigned)blocks, kWarps * 32, smem, s>>>(
        lo, hi, w, o, num, l);
  else
    lb_keogh_kernel<false><<<(unsigned)blocks, kWarps * 32, smem, s>>>(
        lo, hi, w, o, num, l);
  return (int)cudaGetLastError();
}
