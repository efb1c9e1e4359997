// The window normalization shared by the LB_Keogh tier
// (fused_verify.cu) and the banded DP over its survivors (dtw_band.cu).
//
// LB_Keogh <= DTW holds on the card only if both kernels see the very
// same normalized values, and the plain versions divide: so w must equal
// __fdiv_rn(__fsub_rn(x, mu), sd) bit for bit.  The IEEE divide is a
// ~15-instruction sequence per point; this is four, from one correctly
// rounded reciprocal y = __frcp_rn(sd) per window (Markstein's
// correction: with y within half an ulp of 1/sd and q0 = RN(a * y)
// within an ulp of a / sd, the residual rho = a - q0 * sd is exact in
// one FMA and RN(q0 + rho * y) is the correctly rounded quotient, away
// from under- and overflow).  chip_smoke.py counts the window points
// where it differs from the divide on the card (required: none).
#pragma once

__device__ __forceinline__ float znorm_point(float x, float mu, float sd,
                                             float y) {
  const float a = __fsub_rn(x, mu);
  const float q0 = __fmul_rn(a, y);
  const float rho = __fmaf_rn(-q0, sd, a);
  return __fmaf_rn(rho, y, q0);
}
