// Batched squared Euclidean distance of windows against queries, for
// Hopper.
//
// Replaces repro/kernels/batch_ed.py::batch_ed_pallas (Pallas body
// _batch_ed_kernel): (N, L) windows x (Qb, L) queries -> (N, Qb) squared
// ED by the dot identity, the window statistics taken in the same pass.
// The host backend verifies each chunk's candidate windows with it
// (Qb = 1, repro/core/executor.py::ed_batch).
//   znorm (queries already Z-normalized):
//     mu = sum(w) * (1/L), sd = max(sqrt(max(sum(w^2) * (1/L) - mu^2, 0)),
//     1e-8), d2 = 2L - 2 dot / sd;
//   raw: d2 = sum(w^2) - 2 dot + sum(q^2);
// clamped at 0.
// Bound on the card: bytes.  A 512-envelope host chunk at qlen 256 is
// 25,088 windows, 25.7 MB read once, against 2 (Qb + 1) flops a point.
// Design: one warp per window, 16-byte loads (consecutive lanes on
// consecutive float4s of the row), the queries staged in shared memory,
// the Qb dots, sum(w) and sum(w^2) accumulated in registers in one pass
// and reduced across the warp.  Full float32 FMAs, no TF32 and no tensor
// cores: the identity cancels near d = 0, so the dots keep every bit
// they can (the TPU kernel's MXU product would need TF32 here).
// Queries beyond 8 are taken in groups of 8, re-reading the window from
// L1/L2.
// Any L and Qb: the wrapper launches the queries in groups whose
// Qb (L + 1) floats fit the 48 KB of staging (one launch a group, each
// writing its columns of the (N, Qb) output); a single query longer than
// the staging goes to batch_ed_tiled_kernel, which streams it through
// the staging in tiles of L (a multiple of 128 floats: every lane meets
// the row's points in the same order as a single tile would, so the
// sums round the same).  Path shapes (L <= 256, Qb = 1) keep the
// single-tile kernel.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;               // windows in flight per block
constexpr int kGroup = 8;               // queries per register group
constexpr int kSmemFloats = 48 * 1024 / 4;
// the tiled kernel's L tile: a multiple of 128 floats, + sum(q^2)
constexpr int kTile = (kSmemFloats - 1) / 128 * 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The squared ED of one (window, query) pair from the warp-reduced sums.
__device__ __forceinline__ float ed_finish(float dot, float sw, float sw2,
                                          float qss, float lf, float inv_l,
                                          int znorm) {
  float sd = 1.f;
  if (znorm) {
    const float mu = __fmul_rn(sw, inv_l);
    const float var = fmaxf(
        __fsub_rn(__fmul_rn(sw2, inv_l), __fmul_rn(mu, mu)), 0.f);
    sd = fmaxf(__fsqrt_rn(var), 1e-8f);
  }
  const float two_dot = 2.f * dot;
  const float d2 = znorm ? __fsub_rn(2.f * lf, __fdiv_rn(two_dot, sd))
                         : __fadd_rn(__fsub_rn(sw2, two_dot), qss);
  return fmaxf(d2, 0.f);
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    batch_ed_kernel(const float* __restrict__ windows,
                    const float* __restrict__ queries,
                    float* __restrict__ out, long long num, int l, int qb,
                    int ldo, int znorm) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // [qb * l]
  float* qss = smem + (long long)qb * l;  // [qb] sum(q^2)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int t = threadIdx.x; t < qb * l; t += blockDim.x) q_s[t] = queries[t];
  __syncthreads();
  for (int q = warp; q < qb; q += warps) {
    float s = 0.f;
    for (int t = lane; t < l; t += 32) s = fmaf(q_s[q * l + t], q_s[q * l + t], s);
    s = warp_sum(s);
    if (lane == 0) qss[q] = s;
  }
  __syncthreads();
  const float lf = (float)l;
  const float inv_l = __fdiv_rn(1.f, lf);
  for (long long row = (long long)blockIdx.x * warps + warp; row < num;
       row += (long long)gridDim.x * warps) {
    const float* w = windows + row * l;
    for (int q0 = 0; q0 < qb; q0 += kGroup) {
      const int nq = min(kGroup, qb - q0);
      float dot[kGroup], sw = 0.f, sw2 = 0.f;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) dot[k] = 0.f;
      if (kVec) {
        const float4* w4 = reinterpret_cast<const float4*>(w);
        for (int t4 = lane; t4 < (l >> 2); t4 += 32) {
          const float4 v = w4[t4];
          sw += (v.x + v.y) + (v.z + v.w);
          sw2 = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z,
                                                   fmaf(v.w, v.w, sw2))));
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            if (k < nq) {
              const float4 c = reinterpret_cast<const float4*>(
                  q_s + (q0 + k) * l)[t4];
              dot[k] = fmaf(v.x, c.x, fmaf(v.y, c.y, fmaf(v.z, c.z,
                                                          fmaf(v.w, c.w,
                                                               dot[k]))));
            }
          }
        }
      } else {
        for (int t = lane; t < l; t += 32) {
          const float v = w[t];
          sw += v;
          sw2 = fmaf(v, v, sw2);
#pragma unroll
          for (int k = 0; k < kGroup; ++k)
            if (k < nq) dot[k] = fmaf(v, q_s[(q0 + k) * l + t], dot[k]);
        }
      }
      sw = warp_sum(sw);
      sw2 = warp_sum(sw2);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) dot[k] = warp_sum(dot[k]);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (k < nq && lane == k)
          out[row * ldo + q0 + k] =
              ed_finish(dot[k], sw, sw2, qss[q0 + k], lf, inv_l, znorm);
      }
    }
  }
}

// One query longer than the staging: the block walks its rows a warp
// each, kWarps at a time, and streams the query through shared memory in
// tiles of `tile` points (all warps in step); each warp keeps its row's
// sums in registers across the tiles.  sum(q^2) is taken from device
// memory in the single-tile kernel's order.
template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    batch_ed_tiled_kernel(const float* __restrict__ windows,
                          const float* __restrict__ query,
                          float* __restrict__ out, long long num, int l,
                          int ldo, int znorm, int tile) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // [tile]
  float* qss = smem + tile;             // [1] sum(q^2)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  if (warp == 0) {
    float s = 0.f;
    for (int t = lane; t < l; t += 32) s = fmaf(query[t], query[t], s);
    s = warp_sum(s);
    if (lane == 0) *qss = s;
  }
  const float lf = (float)l;
  const float inv_l = __fdiv_rn(1.f, lf);
  for (long long row0 = (long long)blockIdx.x * warps; row0 < num;
       row0 += (long long)gridDim.x * warps) {
    const long long row = row0 + warp;
    const bool live = row < num;
    float dot = 0.f, sw = 0.f, sw2 = 0.f;
    for (int t0 = 0; t0 < l; t0 += tile) {
      const int tn = min(tile, l - t0);
      __syncthreads();                  // the last tile is consumed
      for (int t = threadIdx.x; t < tn; t += blockDim.x)
        q_s[t] = query[t0 + t];
      __syncthreads();
      if (!live) continue;
      const float* w = windows + row * l + t0;
      if (kVec) {
        const float4* w4 = reinterpret_cast<const float4*>(w);
        const float4* c4 = reinterpret_cast<const float4*>(q_s);
        for (int t4 = lane; t4 < (tn >> 2); t4 += 32) {
          const float4 v = w4[t4];
          const float4 c = c4[t4];
          sw += (v.x + v.y) + (v.z + v.w);
          sw2 = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z,
                                                   fmaf(v.w, v.w, sw2))));
          dot = fmaf(v.x, c.x, fmaf(v.y, c.y, fmaf(v.z, c.z,
                                                   fmaf(v.w, c.w, dot))));
        }
      } else {
        for (int t = lane; t < tn; t += 32) {
          const float v = w[t];
          sw += v;
          sw2 = fmaf(v, v, sw2);
          dot = fmaf(v, q_s[t], dot);
        }
      }
    }
    if (!live) continue;
    sw = warp_sum(sw);
    sw2 = warp_sum(sw2);
    dot = warp_sum(dot);
    if (lane == 0)
      out[row * ldo] = ed_finish(dot, sw, sw2, *qss, lf, inv_l, znorm);
  }
}

}  // namespace

extern "C" int ulisse_batch_ed(const void* windows, const void* queries,
                               void* out, long long num, int l, int qb,
                               int ldo, int znorm, void* stream) {
  const size_t floats = (size_t)qb * l + qb;
  // several queries must fit the staging whole; one may be tiled
  if (num < 1 || l < 1 || qb < 1 || ldo < qb ||
      (qb > 1 && floats > (size_t)kSmemFloats))
    return (int)cudaErrorInvalidValue;
  long long blocks = (num + kWarps - 1) / kWarps;
  if (blocks > 132 * 64) blocks = 132 * 64;
  const bool vec = (l % 4 == 0) &&
                   (reinterpret_cast<size_t>(windows) % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(windows);
  const float* q = static_cast<const float*>(queries);
  float* o = static_cast<float*>(out);
  if (floats > (size_t)kSmemFloats) {
    const size_t smem = sizeof(float) * (kTile + 1);
    if (vec)
      batch_ed_tiled_kernel<true><<<(unsigned)blocks, kWarps * 32, smem, s>>>(
          w, q, o, num, l, ldo, znorm, kTile);
    else
      batch_ed_tiled_kernel<false><<<(unsigned)blocks, kWarps * 32, smem,
                                     s>>>(w, q, o, num, l, ldo, znorm, kTile);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * floats;
  if (vec)
    batch_ed_kernel<true><<<(unsigned)blocks, kWarps * 32, smem, s>>>(
        w, q, o, num, l, qb, ldo, znorm);
  else
    batch_ed_kernel<false><<<(unsigned)blocks, kWarps * 32, smem, s>>>(
        w, q, o, num, l, qb, ldo, znorm);
  return (int)cudaGetLastError();
}
