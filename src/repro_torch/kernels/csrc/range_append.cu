// The eps-range scan's ordered hit append, for Hopper.
//
// ulisse_range_append
// Replaces the hit append of the reference's range scan
// (repro/core/executor.py::_device_range_core: a cumsum of the hit mask
// and a searchsorted gather into the buffer; not a Pallas kernel).  The
// inputs are one scan step's dense (B, M = rows * g) d2 (+inf wherever
// no distance was verified: from the ED chunk entry's range mode, or the
// DP's output behind the LB_Keogh chunk entry), the plan's sids/anchors
// (B, n_pad) (position p of the chunk at column col0 is row col0 + p / g,
// offset anchor + p % g) and eps2 (B,); and, in place, the hit buffer
// (d2, sid, off) (B, cap), its fill counts cnt (B,) and ovf (B,), the
// first chunk whose hits were not written (n_chunks while none).  A hit
// is a finite d2 <= eps2[b] (inclusive: a boundary hit with d == eps
// stays).  If cnt + hits > cap, none of the step's hits is written and
// ovf[b] becomes this chunk, i (once); else hit h, counted in position
// order, goes to slot cnt + h and cnt grows by the hits.  So the buffer
// holds the reference's rows in the reference's order: chunk by chunk,
// row-major over (row, offset), and the host replays chunks [ovf,
// n_chunks) after an overflow.
//
// Bound on the card: bytes.  A step reads each query's d2 row (100 KB at
// rows 512, g 49) and writes 12 bytes a hit (plus a hit's plan entries):
// ~0.8 MB at B = 8, ~0.25 us at 3.35 TB/s; at that size the kernel is
// latency-bound.  Design: one block of 1,024 threads a query.  A first
// pass counts the hits (__syncthreads_count, a tile of 1,024 positions a
// step); only when they fit does a second pass rank them in position
// order: a warp ballot and popc give a hit its rank in its warp, the 32
// warps' counts in shared memory its warp's offset, and a running total
// the tile's.  No atomics, so the buffer is the same from run to run.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool is_hit(float v, float eps2) {
  return isfinite(v) && v <= eps2;
}

__global__ void __launch_bounds__(kThreads) range_append_kernel(
    const float* __restrict__ d2, const int* __restrict__ sids,
    const int* __restrict__ anchors, const float* __restrict__ eps2,
    float* __restrict__ buf_d2, int* __restrict__ buf_sid,
    int* __restrict__ buf_off, int* __restrict__ cnt, int* __restrict__ ovf,
    int m, long long n_pad, long long col0, int g, int cap, int chunk_i,
    int n_chunks) {
  __shared__ int warp_hits[kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float e = eps2[b];
  const float* row = d2 + (long long)b * m;
  int nh = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int p = base + tid;
    nh += __syncthreads_count(p < m && is_hit(row[p], e));
  }
  if (nh == 0) return;
  const int c = cnt[b];
  if (c + nh > cap) {            // all or nothing: this chunk overflows
    if (tid == 0 && ovf[b] == n_chunks) ovf[b] = chunk_i;
    return;
  }
  const long long plan = (long long)b * n_pad + col0;
  const long long out = (long long)b * cap;
  int done = c;                  // the slot of this tile's first hit
  for (int base = 0; base < m; base += kThreads) {
    const int p = base + tid;
    const float v = p < m ? row[p] : INFINITY;
    const bool hit = is_hit(v, e);
    const unsigned mask = __ballot_sync(kFull, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int x = warp_hits[w];
      before += w < warp ? x : 0;
      total += x;
    }
    if (hit) {
      const int slot = done + before + __popc(mask & ((1u << lane) - 1u));
      const int r = p / g;
      buf_d2[out + slot] = v;
      buf_sid[out + slot] = sids[plan + r];
      buf_off[out + slot] = anchors[plan + r] + (p - r * g);
    }
    done += total;
    __syncthreads();             // warp_hits is the next tile's
  }
  if (tid == 0) cnt[b] = c + nh;
}

}  // namespace

extern "C" int ulisse_range_append(const void* d2, const void* sids,
                                   const void* anchors, const void* eps2,
                                   void* buf_d2, void* buf_sid,
                                   void* buf_off, void* cnt, void* ovf,
                                   int batch, int m, long long n_pad,
                                   long long col0, int g, int cap,
                                   int chunk_i, int n_chunks, void* stream) {
  if (batch < 1 || m < 1 || g < 1 || cap < 1 || col0 < 0 ||
      col0 + (m + g - 1) / g > n_pad)
    return (int)cudaErrorInvalidValue;
  range_append_kernel<<<batch, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d2), static_cast<const int*>(sids),
      static_cast<const int*>(anchors), static_cast<const float*>(eps2),
      static_cast<float*>(buf_d2), static_cast<int*>(buf_sid),
      static_cast<int*>(buf_off), static_cast<int*>(cnt),
      static_cast<int*>(ovf), m, n_pad, col0, g, cap, chunk_i, n_chunks);
  return (int)cudaGetLastError();
}
