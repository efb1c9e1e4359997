// The k-best selection shared by the ED chunk entry (fused_verify.cu)
// and the pool merge (pool_merge.cu).
//
// Candidates are ordered by (d2, position); a position is unique within
// one query's chunk, so no two keys are equal and every candidate has a
// distinct rank.  A block keeps the kp least of the candidates it
// collected in shared memory and writes them, sorted, to its row of a
// (B, n_blocks, kp) partials buffer; the pool merge then picks the k
// least of [pool | partials].  Slots of a row beyond the block's count
// hold the empty entry (+inf, -1, -1, kNoPos), which never enters a pool:
// incumbents come first on ties, and a pool always holds k incumbents.
#pragma once

#include <math.h>

constexpr int kNoPos = 0x7fffffff;

// Does candidate (d, p) precede (d0, p0)?
__device__ __forceinline__ bool key_less(float d, unsigned p, float d0,
                                         unsigned p0) {
  return d < d0 || (d == d0 && p < p0);
}

// Write the kp least of the block's `count` candidates (cd, cp in shared
// memory) in ascending (d2, position) order to out_*[0 .. kp), and the
// empty entry to the slots beyond `count`.  sid_off(p, &sid, &off) gives
// a candidate's series id and window offset.  Every thread of the block
// calls it; it reads shared memory only.
template <typename SidOff>
__device__ __forceinline__ void write_block_topk(
    const float* cd, const int* cp, int count, int kp, float* out_d2,
    int* out_sid, int* out_off, int* out_pos, SidOff sid_off) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const float d = cd[i];
    const unsigned p = (unsigned)cp[i];
    int rank = 0;
    for (int x = 0; x < count && rank < kp; ++x)
      rank += key_less(cd[x], (unsigned)cp[x], d, p);
    if (rank < kp) {
      int sid, off;
      sid_off(cp[i], &sid, &off);
      out_d2[rank] = d;
      out_sid[rank] = sid;
      out_off[rank] = off;
      out_pos[rank] = cp[i];
    }
  }
  for (int s = count + threadIdx.x; s < kp; s += blockDim.x) {
    out_d2[s] = INFINITY;
    out_sid[s] = -1;
    out_off[s] = -1;
    out_pos[s] = kNoPos;
  }
}
