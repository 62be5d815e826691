// Exact lattice counts of star-polyhedron pairs, the overlap test of the 3D
// NMS (ops/nms.py::_lattice_overlap): for each pair (i, j) of a flat list, the
// integer lattice over the pair's bbox intersection (per axis plo + stride * k,
// k < S, up to phi) is tested against polyhedron i, and the points inside i
// against polyhedron j. out[p] = (points inside i, points inside both); the
// second count, times the stride product, is the pair's common volume.
//
// Replaces no Pallas kernel: the reference counts these points in plain jnp
// (stardist_tpu/ops/nms.py::_overlap_block_3d). It is here because the port's
// plain version (ops/lattice_overlap.py::lattice_counts_plain) was the port's
// largest cost: it gathers every point's face inverses into device memory, a
// block of 8 faces at a time, and runs a dozen elementwise passes over the
// (points, 8) temporaries, so its time goes to moving bytes.
//
// What bounds it on the H100: f32 arithmetic outside the tensor cores. A
// point costs F face tests per polyhedron (9 products, 8 sums and 5
// comparisons each); a pair's inputs are its two polyhedra's F x 10 values,
// read from L2 as a rule (a polyhedron's pairs lie near one another in the
// list), and 9 values of its lattice. The design:
// - a warp per pair, the pairs walked grid-stride by a persistent grid;
// - the warp stages its pair's two face sets in dynamic shared memory, three
//   float4 a face (the inverse's rows; the face's valid flag in the first
//   row's w), sized from F at launch; the lanes test the same face at the same
//   time, so each read is a broadcast;
// - lanes take the lattice points round-robin; a point is tested against j
//   only when it is inside i;
// - a polyhedron's test runs every face, unrolled, and ORs the verdicts with
//   no branch (the faces' order is free): on the H100 a test that leaves at
//   the first face that passes took 46.2 ms against 11.9 ms for the 124,353
//   exact pairs of a 64x256x256 3D_demo call at S = 12, as the lanes of a
//   warp leave at different faces and the loop loses its unrolling;
// - a warp reduction gives each count: nothing but the (P, 2) counts is
//   written to device memory, and S and F are run-time values.
//
// Bitwise agreement with the plain version:
// - lattice coordinates plo + stride * k (integers, exact in f32), per axis
//   the k < S whose coordinate is <= phi, as the plain version's mask (a
//   prefix of k: the coordinates do not decrease);
// - u = q - p and b_r = (m_r0 * u0 + m_r1 * u1) + m_r2 * u2, each product
//   and sum rounded on its own (__fmul_rn / __fadd_rn, and the file is built
//   with -fmad=false): the plain version runs them as separate elementwise
//   passes, and a fused multiply-add would move a point within one rounding
//   of a face to the other side;
// - the test b0 >= lo, b1 >= lo, b2 >= lo, (b0 + b1) + b2 <= hi on a valid
//   face, with lo and hi the f32 values PyTorch compares an f32 tensor with
//   when given the Python floats -1e-7 and 1 + 1e-7 (it rounds the scalar to
//   the tensor's type): f32(-1e-7) and f32(1 + 1e-7) = 1 + 2^-23. The test,
//   the staging of the faces and these constants are barycentric.cuh's,
//   shared with the 3D raster kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "barycentric.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int SMEM_MAX = 232448;                 // a block's shared memory on the H100
constexpr int F_MAX = SMEM_MAX / (WARPS * 2 * FACE_BYTES);
constexpr int S_MAX = 1290;                      // S^3 lattice points fit an int

// lattice points along one axis: the k < S with lo + st * k <= hi
__device__ __forceinline__ int axis_points(float lo, float st, float hi, int S) {
  int n = 0;
  while (n < S && __fadd_rn(lo, __fmul_rn(st, (float)n)) <= hi) ++n;
  return n;
}

__global__ void __launch_bounds__(THREADS)
lattice_kernel(const float* __restrict__ points, const float* __restrict__ inv,
               const uint8_t* __restrict__ valid, const int64_t* __restrict__ pi,
               const int64_t* __restrict__ pj, const float* __restrict__ plo,
               const float* __restrict__ phi, const float* __restrict__ stride,
               int* __restrict__ out, int P, int F, int S) {
  extern __shared__ float4 faces[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float4* fa = faces + (size_t)warp * 2 * ROWS * F;
  float4* fb = fa + ROWS * F;
  // warp-uniform loop: every lane reaches the syncs and the reductions
  for (int p = blockIdx.x * WARPS + warp; p < P; p += gridDim.x * WARPS) {
    const int64_t a = pi[p], b = pj[p];
    __syncwarp();                      // the previous pair's faces are read
    stage(fa, inv, valid, a, F, lane, 32);
    stage(fb, inv, valid, b, F, lane, 32);
    __syncwarp();
    float lo[3], st[3];
    int n[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      lo[ax] = plo[3 * p + ax];
      st[ax] = stride[3 * p + ax];
      n[ax] = axis_points(lo[ax], st[ax], phi[3 * p + ax], S);
    }
    const float ca0 = points[3 * a], ca1 = points[3 * a + 1], ca2 = points[3 * a + 2];
    const float cb0 = points[3 * b], cb1 = points[3 * b + 1], cb2 = points[3 * b + 2];
    const int nyx = n[1] * n[2];
    const int total = n[0] * nyx;
    int in_a = 0, in_ab = 0;
    for (int t = lane; t < total; t += 32) {
      const int iz = t / nyx;
      const int r = t - iz * nyx;
      const int iy = r / n[2];
      const int ix = r - iy * n[2];
      const float q0 = __fadd_rn(lo[0], __fmul_rn(st[0], (float)iz));
      const float q1 = __fadd_rn(lo[1], __fmul_rn(st[1], (float)iy));
      const float q2 = __fadd_rn(lo[2], __fmul_rn(st[2], (float)ix));
      if (inside(fa, F, __fsub_rn(q0, ca0), __fsub_rn(q1, ca1), __fsub_rn(q2, ca2))) {
        ++in_a;
        if (inside(fb, F, __fsub_rn(q0, cb0), __fsub_rn(q1, cb1), __fsub_rn(q2, cb2))) ++in_ab;
      }
    }
    in_a = __reduce_add_sync(0xffffffffu, in_a);
    in_ab = __reduce_add_sync(0xffffffffu, in_ab);
    if (lane == 0) {
      out[2 * p] = in_a;
      out[2 * p + 1] = in_ab;
    }
  }
}

}  // namespace

// points (N, 3), inv (N, F, 3, 3) f32; valid (N, F) bool; i, j (P,) int64
// rows of those; plo, phi, stride (P, 3) f32; out (P, 2) int32. 1 <= S <=
// 1290 (S^3 fits an int), 1 <= F <= F_MAX (two face sets a warp fit a block's
// shared memory). Returns cudaGetLastError() after the launch.
extern "C" int lattice_counts_i32(const void* points, const void* inv, const void* valid,
                                  const void* i, const void* j, const void* plo,
                                  const void* phi, const void* stride, void* out, int P,
                                  int F, int S, void* stream) {
  if (P <= 0 || F < 1 || F > F_MAX || S < 1 || S > S_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int smem = WARPS * 2 * FACE_BYTES * F;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lattice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lattice_kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = n_sm * (per_sm > 0 ? per_sm : 1);
  const int needed = (P + WARPS - 1) / WARPS;
  lattice_kernel<<<needed < blocks ? needed : blocks, THREADS, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(inv),
      static_cast<const uint8_t*>(valid), static_cast<const int64_t*>(i),
      static_cast<const int64_t*>(j), static_cast<const float*>(plo),
      static_cast<const float*>(phi), static_cast<const float*>(stride),
      static_cast<int*>(out), P, F, S);
  return (int)cudaGetLastError();
}
