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
// 25,088 windows, 25.7 MB read once, against 2 (Qb + 1) flops a point:
// 0.0077 ms at 3.35 TB/s.
// Design: a bandwidth kernel with nothing ahead of its first load.
//   * A row is read by 8 lanes (a quarter warp: 4 rows a warp, 32 a block
//     of 8 warps), each lane 64 bytes a step (4 float4, or 16 floats where
//     L is not a multiple of 4 or a row not 16-byte aligned), the group's
//     lanes on consecutive addresses; a step covers 128 points of the row.
//     The next step's loads are issued before the current step is used,
//     so a lane keeps two steps in flight: with the card's 64 warps an
//     SM, up to 256 KB.
//   * The grid is one wave of the card (8 blocks an SM at most, fewer
//     where the rows run out: at N = 25,088 each warp takes one set of 4
//     rows), each warp walking row sets warp, warp + warps, ...
//   * One query (the host path's) is read in place (__ldg: every group
//     of a warp reads the same query words, which stay in L1), so no
//     block stages anything or waits at a barrier.  Several queries are
//     staged once a block in shared memory where their Qb L 4 bytes fit
//     48 KB (kSmemQ: each 16-byte element of a row meets Qb query
//     loads, which the read-only path served slower than shared memory
//     does: on an H100, Qb = 8, L 256, 0.0310 ms read in place against
//     0.0220 staged), else read in place too.  sum(q^2) is summed in the
//     same pass.
//   * The kernel is templated on the query group (1, 2, 4 or 8 queries in
//     registers, the batch rounded up), and only the live queries' dots
//     are computed and reduced: 3 shuffle steps a value across the 8 lanes
//     (4 rows a shuffle), (Qb + 2) values (+ Qb for raw).  A batch past 8
//     takes the rows again in groups of 8, in the same launch.
//   * Full float32 FMAs, no TF32 and no tensor cores: the identity
//     cancels near d = 0, so the dots keep every bit they can (the TPU
//     kernel's MXU product would need TF32 here).
// It replaced one warp a window with the queries staged in shared memory
// by each of ~3,100 blocks behind two barriers, 50 shuffles a window at
// Qb = 1 (8 dot registers reduced whatever Qb), and a separate kernel
// for rows past the staging.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kLanes = 8;               // lanes a row
constexpr int kRowsPerBlock = kThreads / kLanes;
constexpr int kStepFloats = 128;        // row points a step (kLanes x 16)
constexpr int kBlocksPerSm = 2048 / kThreads;
constexpr size_t kSmemQBytes = 48 * 1024;  // queries staged up to this
constexpr unsigned kFull = 0xffffffffu;

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

// Streaming loads for the windows (read once, evict first); the queries
// through the read-only path (kept).
__device__ __forceinline__ float4 load_w(const float4* p) { return __ldcs(p); }
__device__ __forceinline__ float load_w(const float* p) { return __ldcs(p); }

__device__ __forceinline__ float vsum(float4 v) {
  return (v.x + v.y) + (v.z + v.w);
}
__device__ __forceinline__ float vsum(float v) { return v; }

// acc + sum of a .* b, one FMA a component
__device__ __forceinline__ float vdot(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}
__device__ __forceinline__ float vdot(float a, float b, float acc) {
  return fmaf(a, b, acc);
}

// sum over the 8 lanes of a group (all 32 lanes take part)
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The squared ED of one (window, query) pair from the group's sums.
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

// kQ: queries a register group; V: floats a load (4: L % 4 == 0 and both
// arrays 16-byte aligned); kSmemQ: the queries staged in shared memory.
// Element e of a row (in units of V) is loaded by lane e % 8 of its group
// at step e / (8 kU).
template <int kQ, int V, bool kSmemQ>
__global__ void __launch_bounds__(kThreads)
    batch_ed_kernel(const float* __restrict__ windows,
                    const float* __restrict__ queries,
                    float* __restrict__ out, long long num, int l, int qb,
                    int ldo, int znorm) {
  using T = typename Vec<V>::T;
  constexpr int kU = 16 / V;             // loads a lane a step
  extern __shared__ __align__(16) float q_smem[];   // [qb * l] (kSmemQ)
  if (kSmemQ) {
    for (int i = threadIdx.x; i < qb * l; i += blockDim.x)
      q_smem[i] = queries[i];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kLanes - 1), grp = lane >> 3;
  const int nv = l / V;                  // elements a row
  const int steps = (l + kStepFloats - 1) / kStepFloats;
  const float lf = (float)l;
  const float inv_l = __fdiv_rn(1.f, lf);
  const T* q4 = reinterpret_cast<const T*>(kSmemQ ? q_smem : queries);
  const long long set_stride = (long long)gridDim.x * kRowsPerBlock;
  for (long long set = (long long)blockIdx.x * kRowsPerBlock +
                       (threadIdx.x >> 5) * 4;
       set < num; set += set_stride) {      // warp-uniform
    const long long row = set + grp;
    const bool live = row < num;
    const T* w4 = reinterpret_cast<const T*>(windows) +
                  (live ? row : 0) * (long long)nv;
    for (int q0 = 0; q0 < qb; q0 += kQ) {
      const int nq = qb - q0 < kQ ? qb - q0 : kQ;
      float dot[kQ], qs2[kQ], sw = 0.f, sw2 = 0.f;
#pragma unroll
      for (int k = 0; k < kQ; ++k) dot[k] = qs2[k] = 0.f;
      T cur[kU], nxt[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = u * kLanes + sub;
        cur[u] = live && e < nv ? load_w(w4 + e) : T{};
      }
      for (int st = 0; st < steps; ++st) {
        // the next step's loads go out before this step is used
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int e = ((st + 1) * kU + u) * kLanes + sub;
          nxt[u] = live && e < nv ? load_w(w4 + e) : T{};
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int e = (st * kU + u) * kLanes + sub;
          const T v = cur[u];
          sw += vsum(v);
          sw2 = vdot(v, v, sw2);
          if (e < nv) {
#pragma unroll
            for (int k = 0; k < kQ; ++k) {
              if (k < nq) {
                const long long at = (long long)(q0 + k) * nv + e;
                const T c = kSmemQ ? q4[at] : __ldg(q4 + at);
                dot[k] = vdot(v, c, dot[k]);
                if (!znorm) qs2[k] = vdot(c, c, qs2[k]);
              }
            }
          }
          cur[u] = nxt[u];
        }
      }
      sw = group_sum(sw);
      sw2 = group_sum(sw2);
      float mine = 0.f;
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        if (k < nq) {
          const float d = group_sum(dot[k]);
          const float qss = znorm ? 0.f : group_sum(qs2[k]);
          if (sub == k) mine = ed_finish(d, sw, sw2, qss, lf, inv_l, znorm);
        }
      }
      if (live && sub < nq) out[row * ldo + q0 + sub] = mine;
    }
  }
}

template <int kQ, int V>
int launch(const float* w, const float* q, float* o, long long num, int l,
           int qb, int ldo, int znorm, cudaStream_t stream) {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& count = sms[dev & 63];
  if (count == 0)
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (num + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long wave = (long long)(count > 0 ? count : 1) * kBlocksPerSm;
  if (blocks > wave) blocks = wave;
  const size_t q_bytes = sizeof(float) * (size_t)qb * l;
  const bool smem_q = kQ > 1 && q_bytes <= kSmemQBytes;
  auto kernel = smem_q ? batch_ed_kernel<kQ, V, true>
                       : batch_ed_kernel<kQ, V, false>;
  kernel<<<(unsigned)blocks, kThreads, smem_q ? q_bytes : 0, stream>>>(
      w, q, o, num, l, qb, ldo, znorm);
  return (int)cudaGetLastError();
}

template <int V>
int dispatch(const float* w, const float* q, float* o, long long num, int l,
             int qb, int ldo, int znorm, cudaStream_t stream) {
  if (qb <= 1) return launch<1, V>(w, q, o, num, l, qb, ldo, znorm, stream);
  if (qb <= 2) return launch<2, V>(w, q, o, num, l, qb, ldo, znorm, stream);
  if (qb <= 4) return launch<4, V>(w, q, o, num, l, qb, ldo, znorm, stream);
  return launch<8, V>(w, q, o, num, l, qb, ldo, znorm, stream);
}

}  // namespace

extern "C" int ulisse_batch_ed(const void* windows, const void* queries,
                               void* out, long long num, int l, int qb,
                               int ldo, int znorm, void* stream) {
  if (num < 1 || l < 1 || qb < 1 || ldo < qb)
    return (int)cudaErrorInvalidValue;
  const bool vec = l % 4 == 0 &&
                   reinterpret_cast<size_t>(windows) % 16 == 0 &&
                   reinterpret_cast<size_t>(queries) % 16 == 0;
  const float* w = static_cast<const float*>(windows);
  const float* q = static_cast<const float*>(queries);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? dispatch<4>(w, q, o, num, l, qb, ldo, znorm, s)
             : dispatch<1>(w, q, o, num, l, qb, ldo, znorm, s);
}
