// The barycentric inside test of a star polyhedron, shared by the lattice
// kernel (lattice_overlap.cu) and the 3D raster kernel (raster_polyhedra.cu).
//
// A polyhedron's face k is staged as three float4, the rows of the inverse
// of its matrix [A B C] (vertices relative to the centre as columns), with
// the face's valid flag (a non-degenerate face) in the first row's w. A
// point at offset u from the centre is inside the face's tetrahedron when
// its barycentric coordinates b_r = (m_r0 * u0 + m_r1 * u1) + m_r2 * u2 are
// all >= LO and (b0 + b1) + b2 <= HI; inside the polyhedron when inside
// some valid face's tetrahedron (ops/polyhedron.py::points_in_polyhedra).
//
// Bitwise agreement with that plain version: each product and sum is rounded
// on its own (__fmul_rn / __fadd_rn, and the including files are built with
// -fmad=false), as its separate elementwise passes are; a fused multiply-add
// would move a point within one rounding of a face to the other side. LO and
// HI are the f32 values PyTorch compares an f32 tensor with when given the
// Python floats -1e-7 and 1 + 1e-7 (it rounds the scalar to the tensor's
// type): f32(-1e-7) and f32(1 + 1e-7) = 1 + 2^-23.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 3;                          // float4 per staged face
constexpr int FACE_BYTES = ROWS * 16;
constexpr float LO = -0x1.ad7f2ap-24f;           // f32(-1e-7)
constexpr float HI = 0x1.000002p+0f;             // f32(1 + 1e-7)

__device__ __forceinline__ float dot(float4 r, float u0, float u1, float u2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r.x, u0), __fmul_rn(r.y, u1)), __fmul_rn(r.z, u2));
}

// u, the point's offset from the centre, inside some valid face's
// tetrahedron: every face is tested and the verdicts ORed, with no branch
__device__ __forceinline__ bool inside(const float4* __restrict__ f, int F, float u0,
                                       float u1, float u2) {
  bool hit = false;
#pragma unroll 4
  for (int k = 0; k < F; ++k) {
    const float4 r0 = f[ROWS * k], r1 = f[ROWS * k + 1], r2 = f[ROWS * k + 2];
    const float b0 = dot(r0, u0, u1, u2);
    const float b1 = dot(r1, u0, u1, u2);
    const float b2 = dot(r2, u0, u1, u2);
    hit |= (r0.w != 0.0f) & (b0 >= LO) & (b1 >= LO) & (b2 >= LO) &
           (__fadd_rn(__fadd_rn(b0, b1), b2) <= HI);
  }
  return hit;
}

// polyhedron n's faces into dst (ROWS float4 a face), face k by the thread
// whose `first` is k modulo `step`; inv (N, F, 3, 3) f32, valid (N, F)
__device__ __forceinline__ void stage(float4* __restrict__ dst, const float* __restrict__ inv,
                                      const uint8_t* __restrict__ valid, int64_t n, int F,
                                      int first, int step) {
  const float* m = inv + (size_t)n * F * 9;
  const uint8_t* v = valid + (size_t)n * F;
  for (int k = first; k < F; k += step) {
    const float* a = m + 9 * k;
    const float ok = __ldg(v + k) ? 1.0f : 0.0f;
    dst[ROWS * k] = make_float4(__ldg(a), __ldg(a + 1), __ldg(a + 2), ok);
    dst[ROWS * k + 1] = make_float4(__ldg(a + 3), __ldg(a + 4), __ldg(a + 5), 0.0f);
    dst[ROWS * k + 2] = make_float4(__ldg(a + 6), __ldg(a + 7), __ldg(a + 8), 0.0f);
  }
}

}  // namespace
