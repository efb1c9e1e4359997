// Batched interval lower bounds of ULISSE (paper Eq. 5), for Hopper.
//
// Replaces repro/kernels/mindist.py::mindist_pallas, and with it the jnp
// computation the reference engine runs on every query
// (repro/core/planner.py::env_lower_bounds_batch / block_lower_bounds_batch
// -> repro/core/bounds.py::interval_mindist).
//
// out[b, e] = valid[e] ? sqrt(seg_len * sum_{i < nseg} gap_i^2) : +inf,
// gap_i = max(0, e_lo - q_hi, q_lo - e_hi), a non-finite gap counts 0.
// Two entries: `ulisse_mindist_sym` takes the envelopes' int32 iSAX symbols
// and looks up their outer breakpoints (beta_lower / beta_upper) itself;
// `ulisse_mindist_paa` takes float32 intervals (raw PAA bounds, block
// unions).  Each pair's sum is taken in segment order with
// __fadd_rn(acc, __fmul_rn(gap, gap)) and finished with sqrtf(__fmul_rn(
// seg_len, acc)), as the plain version writes it: every kernel gives its
// bits.
//
// Bound on the card: bytes.  Each envelope's first nseg symbols (or
// floats) of lo and hi are read once and each (b, e) output written once;
// the work is ~4 flops per byte.  Two kernels, the host's plan
// (mindist.mindist_plan) choosing:
// - mindist_vec_kernel, wherever w is a multiple of 4, nseg <= 16 and the
//   rows are 16-byte aligned (the exact scan's symbols at w = 16, a
//   batch's block unions, the envelopes' PAA bounds under
//   use_paa_bounds): one thread an envelope, loading its first nseg
//   values of lo and hi as 16-byte vectors, every load in flight before
//   the first is used, the batch's query intervals segment-major in
//   shared memory (a segment's B bounds in 16-byte reads; the batch
//   rounded up to a power of two at compile time).  The PAA entry runs
//   it at least as fast as the tile kernel there (timed on the card).
// - mindist_tile_kernel, every other shape (the long queries' hundreds
//   or thousands of segments): a block takes te envelopes and the batch's
//   queries (up to kMaxBatch a launch; the wrapper splits larger
//   batches), one thread an (envelope, group of kQB queries): kQB the
//   most queries a thread that still gives every SM 8 warps, te halved
//   until the blocks cover the SMs.  The envelopes' segment runs stream
//   through shared memory in tiles of st segments, double-buffered with
//   one barrier a tile: a row's run is copied in 16-byte cp.async pieces
//   from its flat start rounded down to 16 bytes, a warp's pieces along
//   the rows (rows an odd number of 16-byte words apart), and a thread
//   reads its row 4 segments from two 16-byte words, shifted by the
//   row's start (funnel4; one word where w is a multiple of 4), the next
//   words while it sums these 4; the query intervals stream with them,
//   segment-major, so a thread's kQB bounds of a segment come in one
//   broadcast read.  Any nseg runs: nothing is staged whole, and shared
//   memory is opted into past 48 KB where a plan needs it.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBatch = 8;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The tile kernel's row stride in floats at st segments a tile (a power
// of two >= 4): an odd number of 16-byte words, at least one past st.
__host__ __device__ inline int tile_stride(int st) {
  return (st / 4) % 2 ? st + 8 : st + 4;
}

__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

// The tile kernel's staging of segments [s0, s0 + cnt) (cnt <= st) into
// one buffer: the te envelope rows of lo and of hi (rstride floats a
// row), each row's run copied with cp.async in 16-byte pieces from its
// flat start rounded down to 16 bytes (row_shift words below it), and
// the batch's query intervals segment-major (sq[s bp + b], 0 past the
// batch), 4 bytes a word.  vec16: lo and hi 16-byte aligned; else the
// rows go 4 bytes a segment with no shift.  A row's pieces are items
// side by side (st / 2 a row: a power of two, at least the st / 4 + 1
// pieces a shifted run takes), so a warp's reads run along the rows;
// st and bp are powers of two too (shifts, no divides).
__device__ __forceinline__ int row_shift(long long e, int w, int s0,
                                         bool vec16) {
  return vec16 ? (int)((e * w + s0) & 3) : 0;
}

__device__ __forceinline__ void tile_stage(
    const float* __restrict__ lo, const float* __restrict__ hi,
    const float* __restrict__ q_lo, const float* __restrict__ q_hi,
    int q_stride, float* e_lo, float* e_hi, float* sq_lo, float* sq_hi,
    long long e0, long long n, int w, int batch, int bp, int te,
    int rstride, int s0, int cnt, int st, bool vec16) {
  const int tid = threadIdx.x;
  const long long len = n * w;
  // items a row: 16-byte pieces (up to st / 4 + 1, rounded up to a power
  // of two) or words
  const int lp = vec16 ? ilog2(st / 4) + 1 : ilog2(st);
  for (int idx = tid; idx < (2 * te) << lp; idx += blockDim.x) {
    const int r2 = idx >> lp, c = idx & ((1 << lp) - 1);
    const int arr = r2 >= te, r = r2 - arr * te;
    const long long e = e0 + r;
    if (e >= n) continue;
    const float* a = arr ? hi : lo;
    float* dst = (arr ? e_hi : e_lo) + r * rstride;
    if (vec16) {
      const int sh = row_shift(e, w, s0, true);
      if (4 * c >= cnt + sh) continue;
      const long long at = e * w + s0 - sh + 4 * c;
      if (at + 4 <= len) {
        cp_async16(dst + 4 * c, a + at);
      } else {
        for (int k = 0; k < 4 && at + k < len; ++k)
          cp_async4(dst + 4 * c + k, a + at + k);
      }
    } else if (c < cnt) {
      cp_async4(dst + c, a + e * w + s0 + c);
    }
  }
  const int lb = ilog2(bp);
  for (int idx = tid; idx < cnt << lb; idx += blockDim.x) {
    const int s = idx >> lb, b = idx & (bp - 1);
    if (b < batch) {
      cp_async4(sq_lo + idx, q_lo + (long long)b * q_stride + s0 + s);
      cp_async4(sq_hi + idx, q_hi + (long long)b * q_stride + s0 + s);
    } else {
      sq_lo[idx] = 0.f;
      sq_hi[idx] = 0.f;
    }
  }
}

// The 4 words starting at word sh (0..3) of the 8 words x:y.
__device__ __forceinline__ float4 funnel4(const float4& x, const float4& y,
                                          int sh) {
  const bool p1 = sh & 1, p2 = sh & 2;
  float4 v;
  v.x = p2 ? (p1 ? x.w : x.z) : (p1 ? x.y : x.x);
  v.y = p2 ? (p1 ? y.x : x.w) : (p1 ? x.z : x.y);
  v.z = p2 ? (p1 ? y.y : y.x) : (p1 ? x.w : x.z);
  v.w = p2 ? (p1 ? y.z : y.y) : (p1 ? y.x : x.w);
  return v;
}

// kN consecutive floats of shared memory (kN-aligned) into v.
template <int kN>
__device__ __forceinline__ void load_run(const float* p, float (&v)[kN]) {
  if constexpr (kN % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kN / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  } else if constexpr (kN == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = p[i];
  }
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// One segment of a thread's kQB pairs: the envelope's (lo, hi) (symbols
// looked up in the breakpoint table) against the queries' intervals at
// q_lo / q_hi (kQB floats each), summed into acc in segment order.
template <bool kSym, int kQB>
__device__ __forceinline__ void tile_segment(float elo, float ehi,
                                             const float* beta_lo,
                                             const float* beta_hi, int card,
                                             const float* q_lo,
                                             const float* q_hi,
                                             float (&acc)[kQB]) {
  if (kSym) {
    elo = beta_lo[min(max(__float_as_int(elo), 0), card - 1)];
    ehi = beta_hi[min(max(__float_as_int(ehi), 0), card - 1)];
  }
  float ql[kQB], qh[kQB];
  load_run<kQB>(q_lo, ql);
  load_run<kQB>(q_hi, qh);
#pragma unroll
  for (int i = 0; i < kQB; ++i) {
    float gap = fmaxf(fmaxf(__fsub_rn(elo, qh[i]), __fsub_rn(ql[i], ehi)),
                      0.f);
    if (!isfinite(gap)) gap = 0.f;
    acc[i] = __fadd_rn(acc[i], __fmul_rn(gap, gap));
  }
}

// The tile kernel (see the top of the file): block x takes envelopes
// [x te, (x + 1) te); thread tid the envelope el = tid % te and the queries
// [bg kQB, (bg + 1) kQB), bg = tid / te, of the batch rounded up to bp.
// A tile's copies land in one buffer while the other is summed, one
// barrier a tile.  A thread reads its row 4 segments at a time from two
// 16-byte words (funnel4 by its row's shift; kShift false: rows 16-byte
// aligned, one word), the next words while it sums these 4 segments.
template <bool kSym, int kQB, bool kShift>
__global__ void __launch_bounds__(kThreads)
    mindist_tile_kernel(const void* __restrict__ lo_,
                        const void* __restrict__ hi_,
                        const float* __restrict__ breakpoints, int card,
                        const float* __restrict__ q_lo,
                        const float* __restrict__ q_hi, int q_stride,
                        const bool* __restrict__ valid,
                        float* __restrict__ out, long long n, int w,
                        int nseg, int batch, int bp, int te, int st,
                        float seg_len, int vec16) {
  extern __shared__ __align__(16) float smem[];
  const int rstride = tile_stride(st);
  const int n_tiles = (nseg + st - 1) / st;
  const int nbuf = n_tiles > 1 ? 2 : 1;
  const int e_words = 2 * te * rstride, q_words = 2 * st * bp;
  float* e_s = smem;                        // [nbuf][lo, hi][te * rstride]
  float* q_s = e_s + nbuf * e_words;        // [nbuf][lo, hi][st * bp]
  float* beta_lo = q_s + nbuf * q_words;    // [card] (symbol entry only)
  float* beta_hi = beta_lo + card;          // [card]
  const float* lo = static_cast<const float*>(lo_);
  const float* hi = static_cast<const float*>(hi_);
  const long long e0 = (long long)blockIdx.x * te;
  const int tid = threadIdx.x;
  const int el = tid % te, bg = tid / te;
  const long long e = e0 + el;
  const bool live = bg * kQB < bp && e < n;
  const bool ok = live && valid[e];
  if (kSym) {
    for (int s = tid; s < card; s += blockDim.x) {
      beta_lo[s] = s == 0 ? -INFINITY : breakpoints[s - 1];
      beta_hi[s] = s == card - 1 ? INFINITY : breakpoints[s];
    }
  }
  tile_stage(lo, hi, q_lo, q_hi, q_stride, e_s, e_s + te * rstride, q_s,
             q_s + st * bp, e0, n, w, batch, bp, te, rstride, 0,
             nseg < st ? nseg : st, st, vec16);
  cp_async_commit();
  float acc[kQB];
#pragma unroll
  for (int i = 0; i < kQB; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, s0 = it * st;
    cp_async_wait_all();
    __syncthreads();     // tile `it` in place; the other buffer consumed
    if (s0 + st < nseg) {
      float* eb = e_s + (buf ^ 1) * e_words;
      float* qb = q_s + (buf ^ 1) * q_words;
      tile_stage(lo, hi, q_lo, q_hi, q_stride, eb, eb + te * rstride, qb,
                 qb + st * bp, e0, n, w, batch, bp, te, rstride, s0 + st,
                 nseg - s0 - st < st ? nseg - s0 - st : st, st, vec16);
    }
    cp_async_commit();
    if (ok) {
      const float* rlo = e_s + buf * e_words + el * rstride;
      const float* rhi = rlo + te * rstride;
      const float* qlo = q_s + buf * q_words + bg * kQB;
      const float* qhi = qlo + st * bp;
      const int cnt = nseg - s0 < st ? nseg - s0 : st;
      const int sh = kShift ? row_shift(e, w, s0, vec16) : 0;
      // (a row holds st + 4 words at least: the reads of the last group
      // and the one ahead stay in the row)
      float4 la = *reinterpret_cast<const float4*>(rlo);
      float4 ha = *reinterpret_cast<const float4*>(rhi);
      float4 lb = la, hb = ha;
      if (kShift) {
        lb = *reinterpret_cast<const float4*>(rlo + 4);
        hb = *reinterpret_cast<const float4*>(rhi + 4);
      }
      const int full = cnt & ~3;
      for (int s4 = 0; s4 < full; s4 += 4) {
        // the next group's words, read while this group is summed
        float4 nl = lb, nh = hb;
        if (kShift && s4 + 8 < st + 4) {
          nl = *reinterpret_cast<const float4*>(rlo + s4 + 8);
          nh = *reinterpret_cast<const float4*>(rhi + s4 + 8);
        } else if (!kShift) {
          nl = *reinterpret_cast<const float4*>(rlo + s4 + 4);
          nh = *reinterpret_cast<const float4*>(rhi + s4 + 4);
        }
        const float4 l4 = kShift ? funnel4(la, lb, sh) : la;
        const float4 h4 = kShift ? funnel4(ha, hb, sh) : ha;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          tile_segment<kSym, kQB>(comp(l4, c), comp(h4, c), beta_lo,
                                  beta_hi, card, qlo + (s4 + c) * bp,
                                  qhi + (s4 + c) * bp, acc);
        if (kShift) {
          la = lb;
          ha = hb;
          lb = nl;
          hb = nh;
        } else {
          la = nl;
          ha = nh;
        }
      }
      const float4 l4 = kShift ? funnel4(la, lb, sh) : la;
      const float4 h4 = kShift ? funnel4(ha, hb, sh) : ha;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (full + c < cnt)
          tile_segment<kSym, kQB>(comp(l4, c), comp(h4, c), beta_lo,
                                  beta_hi, card, qlo + (full + c) * bp,
                                  qhi + (full + c) * bp, acc);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < kQB; ++i) {
      const int b = bg * kQB + i;
      if (b < batch)
        out[b * n + e] = ok ? sqrtf(__fmul_rn(seg_len, acc[i])) : INFINITY;
    }
  }
}

// Component c (a compile-time constant where it is called) of an int4.
__device__ __forceinline__ int lane_of(const int4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// The vector kernel: 16-byte row loads, V int4 of each of lo and hi
// (nseg <= 4 V <= w; the PAA entry's floats read as their bits), kB
// query slots (batch <= kB).  The query intervals sit segment-major,
// (nseg, kB), zero beyond the batch.
template <bool kSym, int V, int kB>
__global__ void __launch_bounds__(kThreads)
    mindist_vec_kernel(const int* __restrict__ lo,
                       const int* __restrict__ hi,
                       const float* __restrict__ breakpoints, int card,
                       const float* __restrict__ q_lo,
                       const float* __restrict__ q_hi, int q_stride,
                       const bool* __restrict__ valid,
                       float* __restrict__ out, long long n, int w,
                       int nseg, int batch, float seg_len) {
  extern __shared__ float4 smem4[];
  float* sq_lo = reinterpret_cast<float*>(smem4);   // [nseg * kB]
  float* sq_hi = sq_lo + nseg * kB;                  // [nseg * kB]
  float* beta_lo = sq_hi + nseg * kB;                // [card]
  float* beta_hi = beta_lo + card;                   // [card]
  for (int i = threadIdx.x; i < nseg * kB; i += blockDim.x) {
    const int s = i / kB, b = i % kB;
    sq_lo[i] = b < batch ? q_lo[b * q_stride + s] : 0.f;
    sq_hi[i] = b < batch ? q_hi[b * q_stride + s] : 0.f;
  }
  for (int s = threadIdx.x; kSym && s < card; s += blockDim.x) {
    beta_lo[s] = s == 0 ? -INFINITY : breakpoints[s - 1];
    beta_hi[s] = s == card - 1 ? INFINITY : breakpoints[s];
  }
  __syncthreads();

  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  if (!valid[e]) {
    for (int b = 0; b < batch; ++b) out[b * n + e] = INFINITY;
    return;
  }
  int4 vlo[V], vhi[V];
  const int4* rlo = reinterpret_cast<const int4*>(lo + e * w);
  const int4* rhi = reinterpret_cast<const int4*>(hi + e * w);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    vlo[v] = __ldg(rlo + v);
    vhi[v] = __ldg(rhi + v);
  }
  float acc[kB];
#pragma unroll
  for (int b = 0; b < kB; ++b) acc[b] = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s = 4 * v + c;
      if (s < nseg) {
        const float elo =
            kSym ? beta_lo[min(max(lane_of(vlo[v], c), 0), card - 1)]
                 : __int_as_float(lane_of(vlo[v], c));
        const float ehi =
            kSym ? beta_hi[min(max(lane_of(vhi[v], c), 0), card - 1)]
                 : __int_as_float(lane_of(vhi[v], c));
        float ql[kB], qh[kB];
        if (kB % 4 == 0) {
#pragma unroll
          for (int b4 = 0; b4 < kB / 4; ++b4) {
            const float4 l4 = reinterpret_cast<const float4*>(
                sq_lo + s * kB)[b4];
            const float4 h4 = reinterpret_cast<const float4*>(
                sq_hi + s * kB)[b4];
            ql[4 * b4] = l4.x; ql[4 * b4 + 1] = l4.y;
            ql[4 * b4 + 2] = l4.z; ql[4 * b4 + 3] = l4.w;
            qh[4 * b4] = h4.x; qh[4 * b4 + 1] = h4.y;
            qh[4 * b4 + 2] = h4.z; qh[4 * b4 + 3] = h4.w;
          }
        } else {
#pragma unroll
          for (int b = 0; b < kB; ++b) {
            ql[b] = sq_lo[s * kB + b];
            qh[b] = sq_hi[s * kB + b];
          }
        }
#pragma unroll
        for (int b = 0; b < kB; ++b) {
          float gap = fmaxf(fmaxf(__fsub_rn(elo, qh[b]),
                                  __fsub_rn(ql[b], ehi)), 0.f);
          if (!isfinite(gap)) gap = 0.f;
          acc[b] = __fadd_rn(acc[b], __fmul_rn(gap, gap));
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    if (b < batch) out[b * n + e] = sqrtf(__fmul_rn(seg_len, acc[b]));
  }
}

template <bool kSym, int V, int kB>
int launch_vec(const int* lo, const int* hi, const float* breakpoints,
               int card, const float* q_lo, const float* q_hi, int q_stride,
               const bool* valid, float* out, long long n, int w, int nseg,
               int batch, float seg_len, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kB * nseg + 2 * card);
  const long long blocks = (n + kThreads - 1) / kThreads;
  mindist_vec_kernel<kSym, V, kB><<<(unsigned)blocks, kThreads, smem,
                                    stream>>>(
      lo, hi, breakpoints, card, q_lo, q_hi, q_stride, valid, out, n, w,
      nseg, batch, seg_len);
  return (int)cudaGetLastError();
}

template <bool kSym, int V>
int dispatch_batch(int batch, const int* lo, const int* hi,
                   const float* breakpoints, int card, const float* q_lo,
                   const float* q_hi, int q_stride, const bool* valid,
                   float* out, long long n, int w, int nseg, float seg_len,
                   cudaStream_t stream) {
  if (batch <= 1)
    return launch_vec<kSym, V, 1>(lo, hi, breakpoints, card, q_lo, q_hi,
                                  q_stride, valid, out, n, w, nseg, batch,
                                  seg_len, stream);
  if (batch <= 2)
    return launch_vec<kSym, V, 2>(lo, hi, breakpoints, card, q_lo, q_hi,
                                  q_stride, valid, out, n, w, nseg, batch,
                                  seg_len, stream);
  if (batch <= 4)
    return launch_vec<kSym, V, 4>(lo, hi, breakpoints, card, q_lo, q_hi,
                                  q_stride, valid, out, n, w, nseg, batch,
                                  seg_len, stream);
  return launch_vec<kSym, V, kMaxBatch>(lo, hi, breakpoints, card, q_lo,
                                        q_hi, q_stride, valid, out, n, w,
                                        nseg, batch, seg_len, stream);
}

template <bool kSym, int kQB, bool kShift>
int launch_tile(const void* lo, const void* hi, const float* breakpoints,
                int card, const float* q_lo, const float* q_hi,
                int q_stride, const bool* valid, float* out, long long n,
                int w, int nseg, int batch, int bp, int te, int st,
                float seg_len, bool vec16, cudaStream_t stream) {
  // one or two buffers of the te rows of lo and hi and the query tile,
  // and the breakpoint table (mindist_tile_kernel)
  const int nbuf = nseg > st ? 2 : 1;
  const size_t smem =
      sizeof(float) * (nbuf * (2 * (size_t)te * tile_stride(st) +
                               2 * (size_t)st * bp) +
                       (kSym ? 2 * (size_t)card : 0));
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        mindist_tile_kernel<kSym, kQB, kShift>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n + te - 1) / te;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int threads = (te * (bp / kQB) + 31) / 32 * 32;
  mindist_tile_kernel<kSym, kQB, kShift><<<(unsigned)blocks, threads, smem,
                                           stream>>>(
      lo, hi, breakpoints, card, q_lo, q_hi, q_stride, valid, out, n, w,
      nseg, batch, bp, te, st, seg_len, (int)vec16);
  return (int)cudaGetLastError();
}

// The tile kernel at qb queries a thread: rows that all start on 16-byte
// boundaries (w a multiple of 4) read one word a group, others two.
template <bool kSym, int kQB>
int launch_tile_qb(const void* lo, const void* hi, const float* breakpoints,
                   int card, const float* q_lo, const float* q_hi,
                   int q_stride, const bool* valid, float* out, long long n,
                   int w, int nseg, int batch, int bp, int te, int st,
                   float seg_len, bool vec16, cudaStream_t stream) {
  return (vec16 && w % 4 != 0 ? launch_tile<kSym, kQB, true>
                              : launch_tile<kSym, kQB, false>)(
      lo, hi, breakpoints, card, q_lo, q_hi, q_stride, valid, out, n, w,
      nseg, batch, bp, te, st, seg_len, vec16, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

// The plan (mindist.mindist_plan): vec = 1 the vector kernel (w a
// multiple of 4, nseg <= 16, rows 16-byte aligned); else the tile
// kernel at qb queries a thread (1, 2, 4 or 8, at most the batch rounded
// up to a power of two, bp), te envelopes a block (a power of two, te bp
// / qb <= kThreads) and st segments a tile (a power of two, 4 to 256).
template <bool kSym>
int launch(const void* lo, const void* hi, const float* breakpoints,
           int card, const float* q_lo, const float* q_hi, int q_stride,
           const bool* valid, float* out, long long n, int w, int nseg,
           int batch, float seg_len, int vec, int qb, int te, int st,
           cudaStream_t stream) {
  if (batch < 1 || batch > kMaxBatch || nseg < 1 || nseg > w ||
      nseg > q_stride || (kSym && (card < 1 || 2 * (size_t)card *
                                                    sizeof(float) >
                                                kSmemMax)))
    return (int)cudaErrorInvalidValue;
  if (vec) {
    if (w % 4 != 0 || !aligned16(lo) || !aligned16(hi) || nseg > 16)
      return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const int* l = static_cast<const int*>(lo);
    const int* h = static_cast<const int*>(hi);
    switch ((nseg + 3) / 4) {
      case 1: return dispatch_batch<kSym, 1>(batch, l, h, breakpoints, card,
                                             q_lo, q_hi, q_stride, valid,
                                             out, n, w, nseg, seg_len,
                                             stream);
      case 2: return dispatch_batch<kSym, 2>(batch, l, h, breakpoints, card,
                                             q_lo, q_hi, q_stride, valid,
                                             out, n, w, nseg, seg_len,
                                             stream);
      case 3: return dispatch_batch<kSym, 3>(batch, l, h, breakpoints, card,
                                             q_lo, q_hi, q_stride, valid,
                                             out, n, w, nseg, seg_len,
                                             stream);
      default: return dispatch_batch<kSym, 4>(batch, l, h, breakpoints,
                                              card, q_lo, q_hi, q_stride,
                                              valid, out, n, w, nseg,
                                              seg_len, stream);
    }
  }
  int bp = 1;
  while (bp < batch) bp *= 2;
  if ((qb != 1 && qb != 2 && qb != 4 && qb != 8) || qb > bp || te < 1 ||
      (te & (te - 1)) != 0 || (long long)te * (bp / qb) > kThreads ||
      st < 4 || (st & (st - 1)) != 0 || st > 256)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const bool vec16 = aligned16(lo) && aligned16(hi);
  switch (qb) {
    case 1: return launch_tile_qb<kSym, 1>(lo, hi, breakpoints, card, q_lo,
                                        q_hi, q_stride, valid, out, n, w,
                                        nseg, batch, bp, te, st, seg_len,
                                        vec16, stream);
    case 2: return launch_tile_qb<kSym, 2>(lo, hi, breakpoints, card, q_lo,
                                        q_hi, q_stride, valid, out, n, w,
                                        nseg, batch, bp, te, st, seg_len,
                                        vec16, stream);
    case 4: return launch_tile_qb<kSym, 4>(lo, hi, breakpoints, card, q_lo,
                                        q_hi, q_stride, valid, out, n, w,
                                        nseg, batch, bp, te, st, seg_len,
                                        vec16, stream);
    default: return launch_tile_qb<kSym, 8>(lo, hi, breakpoints, card, q_lo,
                                         q_hi, q_stride, valid, out, n, w,
                                         nseg, batch, bp, te, st, seg_len,
                                         vec16, stream);
  }
}

}  // namespace

extern "C" int ulisse_mindist_sym(const void* sym_lo, const void* sym_hi,
                                  const void* breakpoints, int card,
                                  const void* q_lo, const void* q_hi,
                                  int q_stride, const void* valid, void* out,
                                  long long n, int w, int nseg, int batch,
                                  float seg_len, int vec, int qb, int te,
                                  int st, void* stream) {
  return launch<true>(sym_lo, sym_hi, static_cast<const float*>(breakpoints),
                      card, static_cast<const float*>(q_lo),
                      static_cast<const float*>(q_hi), q_stride,
                      static_cast<const bool*>(valid),
                      static_cast<float*>(out), n, w, nseg, batch, seg_len,
                      vec, qb, te, st, static_cast<cudaStream_t>(stream));
}

extern "C" int ulisse_mindist_paa(const void* e_lo, const void* e_hi,
                                  const void* q_lo, const void* q_hi,
                                  int q_stride, const void* valid, void* out,
                                  long long n, int w, int nseg, int batch,
                                  float seg_len, int vec, int qb, int te,
                                  int st, void* stream) {
  return launch<false>(e_lo, e_hi, nullptr, 0,
                       static_cast<const float*>(q_lo),
                       static_cast<const float*>(q_hi), q_stride,
                       static_cast<const bool*>(valid),
                       static_cast<float*>(out), n, w, nseg, batch, seg_len,
                       vec, qb, te, st, static_cast<cudaStream_t>(stream));
}
