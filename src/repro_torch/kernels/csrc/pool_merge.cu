// The scan's k-best pool merge for ULISSE, for Hopper.
//
// Replaces the stable-sort merge of the scan (the counterpart of
// repro/core/executor.py::_pool_merge, lax.top_k over [pool |
// candidates] with incumbents first on ties; not a Pallas kernel): the
// new (B, k) pool equals a stable sort of [pool | candidates] by d2,
// truncated to k, in all three of (d2, sid, off).  Candidates are
// ordered by (d2, position) after every incumbent of the same d2, and
// the pool is sorted (every merge leaves it so), so a candidate with
// d2 >= kth = pool[k - 1] cannot enter it: only the incumbents and the
// candidates below kth are ranked.
//
// ulisse_pool_merge_partials merges a (B, P) row of partials (the ED
// chunk entry's (B, n_blocks, kp), each block's kp least candidates):
// one block a query gathers the live entries (every incumbent, and the
// candidates below kth) in shared memory; each counts the live keys
// below its own, and its rank is its slot in the new pool, written in
// place once every entry has been read.
// ulisse_pool_merge_dense merges a dense, position-indexed (B, M) row
// (the DTW branch's DP output, +inf at every non-survivor): a first
// kernel keeps each slice's kp = min(k, slice) least candidates below
// kth as partials (topk.cuh, as the ED chunk entry does), then the same
// merge.
//
// Bound on the card: bytes (the pool, the partials or the dense row read
// once, the pool written once: ~0.8 MB for the dense row at B = 8,
// M = 25,088), a few microseconds; the merge is latency-bound, and its
// work grows with the live entries (k plus the candidates below kth),
// which the main path keeps to a few tens a query: one pass over the
// union, then a rank loop over the live entries in shared memory.
#include <cuda_runtime.h>
#include <math.h>

#include "topk.cuh"

namespace {

constexpr int kMergeThreads = 256;
constexpr int kLiveCap = 2048;       // live entries held in shared memory
constexpr int kSliceThreads = 256;
constexpr int kMaxSlice = 2048;      // dense positions a block
constexpr unsigned kDead = 0xffffffffu;

// The merge of query b = blockIdx.x: pool (B, k) in place, partials
// (B, nparts) of (d2, sid, off, pos), scratch tmp_* (B, k).  The live
// entries (every incumbent, and the partials below kth) are gathered in
// shared memory, and each one counts the live keys below its own: its
// rank is its slot in the new pool.  A union with more live entries than
// shared memory holds (a large k over a pool not yet full) is ranked
// instead by streaming the union through shared memory in tiles, through
// the scratch.
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(
    float* __restrict__ pool_d2, int* __restrict__ pool_sid,
    int* __restrict__ pool_off, const float* __restrict__ part_d2,
    const int* __restrict__ part_sid, const int* __restrict__ part_off,
    const int* __restrict__ part_pos, float* __restrict__ tmp_d2,
    int* __restrict__ tmp_sid, int* __restrict__ tmp_off, int k,
    long long nparts) {
  __shared__ float ld[kLiveCap];
  __shared__ unsigned lt[kLiveCap];
  __shared__ int lsid[kLiveCap], loff[kLiveCap];
  __shared__ int n_live;
  const int b = blockIdx.x;
  const long long pb = (long long)b * k, cb = (long long)b * nparts;
  const float kth = pool_d2[pb + k - 1];
  const long long total = k + nparts;

  // entry y of the union: incumbent y < k (tie key y), else partial
  // y - k (tie key k + position); dead where it cannot enter the pool
  auto key = [&](long long y, float* d, unsigned* tie) {
    if (y < k) {
      *d = pool_d2[pb + y];
      *tie = (unsigned)y;
    } else {
      const float v = part_d2[cb + y - k];
      const bool live = v < kth;
      *d = live ? v : INFINITY;
      *tie = live ? (unsigned)k + (unsigned)part_pos[cb + y - k] : kDead;
    }
  };

  if (threadIdx.x == 0) n_live = 0;
  __syncthreads();
  for (long long e = threadIdx.x; e < total; e += blockDim.x) {
    float d;
    unsigned tie;
    key(e, &d, &tie);
    if (tie == kDead) continue;
    const int slot = atomicAdd(&n_live, 1);
    if (slot < kLiveCap) {
      ld[slot] = d;
      lt[slot] = tie;
      lsid[slot] = e < k ? pool_sid[pb + e] : part_sid[cb + e - k];
      loff[slot] = e < k ? pool_off[pb + e] : part_off[cb + e - k];
    }
  }
  __syncthreads();
  const int live = n_live;
  if (live <= kLiveCap) {
    // every read of the pool is done: write the new pool in place
    for (int i = threadIdx.x; i < live; i += blockDim.x) {
      const float d = ld[i];
      const unsigned tie = lt[i];
      int rank = 0;
      for (int x = 0; x < live && rank < k; ++x)
        rank += key_less(ld[x], lt[x], d, tie);
      if (rank < k) {
        pool_d2[pb + rank] = d;
        pool_sid[pb + rank] = lsid[i];
        pool_off[pb + rank] = loff[i];
      }
    }
    return;
  }
  float* td = ld;                       // tiles of the union's keys
  unsigned* tt = lt;
  for (long long e0 = 0; e0 < total; e0 += blockDim.x) {
    const long long e = e0 + threadIdx.x;
    float d = INFINITY;
    unsigned tie = kDead;
    if (e < total) key(e, &d, &tie);
    const bool mine = tie != kDead;
    int rank = 0;
    for (long long t0 = 0; t0 < total; t0 += kLiveCap) {
      const int nt = (int)(total - t0 < kLiveCap ? total - t0 : kLiveCap);
      __syncthreads();
      for (int x = threadIdx.x; x < nt; x += blockDim.x)
        key(t0 + x, td + x, tt + x);
      __syncthreads();
      if (mine)
        for (int x = 0; x < nt && rank < k; ++x)
          rank += key_less(td[x], tt[x], d, tie);
    }
    if (mine && rank < k) {
      tmp_d2[pb + rank] = d;
      tmp_sid[pb + rank] = e < k ? pool_sid[pb + e] : part_sid[cb + e - k];
      tmp_off[pb + rank] = e < k ? pool_off[pb + e] : part_off[cb + e - k];
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < k; x += blockDim.x) {
    pool_d2[pb + x] = tmp_d2[pb + x];
    pool_sid[pb + x] = tmp_sid[pb + x];
    pool_off[pb + x] = tmp_off[pb + x];
  }
}

// Slice blockIdx.x of the dense row of query b = blockIdx.y: its kp
// least candidates below kth, as partials (B, gridDim.x, kp).
__global__ void __launch_bounds__(kSliceThreads) slice_topk_kernel(
    const float* __restrict__ d2, const int* __restrict__ cand_sid,
    const int* __restrict__ cand_off, const float* __restrict__ pool_d2,
    float* __restrict__ part_d2, int* __restrict__ part_sid,
    int* __restrict__ part_off, int* __restrict__ part_pos, int m, int k,
    int slice, int kp) {
  __shared__ float cd[kMaxSlice];
  __shared__ int cp[kMaxSlice];
  __shared__ int count;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * slice;
  const int end = s0 + slice < m ? s0 + slice : m;
  const float kth = pool_d2[(long long)b * k + k - 1];
  const float* row = d2 + (long long)b * m;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  for (int p = s0 + threadIdx.x; p < end; p += blockDim.x) {
    const float v = row[p];
    if (v < kth) {
      const int s = atomicAdd(&count, 1);
      cd[s] = v;
      cp[s] = p;
    }
  }
  __syncthreads();
  const int* rs = cand_sid + (long long)b * m;
  const int* ro = cand_off + (long long)b * m;
  const long long at = ((long long)b * gridDim.x + blockIdx.x) * kp;
  write_block_topk(cd, cp, count, kp, part_d2 + at, part_sid + at,
                   part_off + at, part_pos + at,
                   [=](int p, int* sid, int* off) {
                     *sid = rs[p];
                     *off = ro[p];
                   });
}

int launch_merge(void* pool_d2, void* pool_sid, void* pool_off,
                 const int* part, void* tmp, int batch, int k,
                 long long nparts, cudaStream_t stream) {
  // partials (4, B, nparts) int32: d2 (float bits), sid, off, pos;
  // scratch (3, B, k) int32: d2 (float bits), sid, off
  const long long plane = (long long)batch * nparts;
  int* t = static_cast<int*>(tmp);
  const long long tplane = (long long)batch * k;
  merge_kernel<<<batch, kMergeThreads, 0, stream>>>(
      static_cast<float*>(pool_d2), static_cast<int*>(pool_sid),
      static_cast<int*>(pool_off), reinterpret_cast<const float*>(part),
      part + plane, part + 2 * plane, part + 3 * plane,
      reinterpret_cast<float*>(t), t + tplane, t + 2 * tplane, k, nparts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ulisse_pool_merge_partials(void* pool_d2, void* pool_sid,
                                          void* pool_off, const void* part,
                                          void* tmp, int batch, int k,
                                          long long nparts, void* stream) {
  if (batch < 1 || k < 1 || nparts < 0 ||
      (long long)k + nparts >= (long long)kDead)
    return (int)cudaErrorInvalidValue;
  return launch_merge(pool_d2, pool_sid, pool_off,
                      static_cast<const int*>(part), tmp, batch, k, nparts,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int ulisse_pool_merge_dense(void* pool_d2, void* pool_sid,
                                       void* pool_off, const void* d2,
                                       const void* cand_sid,
                                       const void* cand_off, void* part,
                                       void* tmp, int batch, int k, int m,
                                       int slice, void* stream) {
  if (batch < 1 || batch > 65535 || k < 1 || m < 1 || slice < 1 ||
      slice > kMaxSlice)
    return (int)cudaErrorInvalidValue;
  const int n_slices = (m + slice - 1) / slice;
  const int kp = k < slice ? k : slice;
  const long long nparts = (long long)n_slices * kp;
  if ((long long)k + nparts + m >= (long long)kDead)
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)batch * nparts;
  int* p = static_cast<int*>(part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  slice_topk_kernel<<<dim3(n_slices, batch), kSliceThreads, 0, s>>>(
      static_cast<const float*>(d2), static_cast<const int*>(cand_sid),
      static_cast<const int*>(cand_off), static_cast<const float*>(pool_d2),
      reinterpret_cast<float*>(p), p + plane, p + 2 * plane, p + 3 * plane, m,
      k, slice, kp);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_merge(pool_d2, pool_sid, pool_off, p, tmp, batch, k, nparts,
                      s);
}
