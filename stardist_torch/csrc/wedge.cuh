// The wedge lookup shared by the pair kernel (pair_overlap.cu) and the raster
// kernel (raster_tiles.cu): which of the R wedges of a star polygon holds the
// offset u = (ur, uc) of a point from the polygon's centre.
//
// Ray k points along (sin phi_k, cos phi_k) in (row, column), phi_k =
// 2 pi k / R, and wedge k lies between rays k and k + 1. Both kernels decide
// the wedge by the signs of the cross products cr_k = ur*cos(phi_k) -
// uc*sin(phi_k) (cross_ray) over the wedges' rays, each product rounded on
// its own. The estimate below only picks three wedges about theta =
// atan2(ur, uc); each kernel then evaluates its own predicate on them and
// states in its header why a window with exactly one match is exact.
#pragma once

#include <cuda_runtime.h>

// |u| range in which the estimate's window is exact (see the kernels'
// headers): every product is off by at most 2^-24 of itself plus 2^-150,
// which is below 2^-89 |u|, and nothing overflows
constexpr float U_LO = 0x1p-60f;
constexpr float U_HI = 0x1p64f;

// ur * cos(phi) - uc * sin(phi), each product rounded on its own
__device__ __forceinline__ float cross_ray(float ur, float uc, float s, float c) {
  return __fsub_rn(__fmul_rn(ur, c), __fmul_rn(uc, s));
}

// theta = atan2(ur, uc) in [-pi, pi] to within 0.004 rad, for u != 0: the
// arctangent of z = min / max of |ur|, |uc| as pi/4 z + 0.273 z (1 - z),
// moved to theta's octant
__device__ __forceinline__ float theta_estimate(float ur, float uc) {
  const float ar = fabsf(ur), ac = fabsf(uc);
  const float z = __fdividef(fminf(ar, ac), fmaxf(ar, ac));
  float a = z * (0.78539816f + 0.273f * (1.0f - z));
  if (ar > ac) a = 1.57079633f - a;
  if (uc < 0.0f) a = 3.14159265f - a;
  return ur < 0.0f ? -a : a;
}

// The wedge k0 in [0, R) of theta's estimate, rscale = R / (2 pi): within
// one of theta's wedge, since 0.004 rad is less than a wedge (at least
// 2 pi / 128 = 0.049 rad)
__device__ __forceinline__ int wedge_estimate(float ur, float uc, int R, float rscale) {
  float t = theta_estimate(ur, uc) * rscale;
  if (t < 0.0f) t += (float)R;
  int k0 = (int)t;
  if (k0 >= R) k0 -= R;
  return k0;
}
