// Label rasterization of star polyhedra: per voxel, the largest packed value
// (order << 32) | label among the polyhedra whose cube covers the voxel and
// that contain it, 0 where none does; with a count, the number of drawn
// polyhedra that contain it.
//
// Replaces no Pallas kernel: the reference draws 3D labels in plain jnp
// (stardist_tpu/ops/rasterize.py::_raster3d_impl). It is here because the
// port's plain version (ops/rasterize.py::rasterize_polyhedra on CPU tensors)
// was the port's largest cost on the card: per chunk of polyhedra it builds
// the (n, window^3, 3) voxel set of their cubes, runs a dozen elementwise
// passes over it per block of 8 faces, then two masked selections (each a
// host sync) and a scatter-max, so its time goes to moving bytes and to the
// host's issue.
//
// The cube is the plain version's: side `window` = 2 ceil(max dist) + 4
// (ceil in f64, as the wrapper's Python computes it), capped at
// 2 max(D, H, W) + 4, from round(p) - window / 2 (round half to even, as
// torch.round), over every polyhedron with an order value above 0.
//
// What bounds it on the H100: f32 arithmetic outside the tensor cores. A
// voxel of a polyhedron's cube costs F face tests (9 products, 8 sums and 5
// comparisons each); the inputs are the polyhedra's N x F face rows, the
// output one atomic per voxel inside. The design:
// - a block per polyhedron, walked grid-stride by a persistent grid; the
//   block stages its polyhedron's faces in dynamic shared memory, sized from
//   F at launch: three float4 a face in "full" mode (barycentric.cuh: the
//   inverse's rows, the valid flag in the first row's w), one in "kernel"
//   mode (the face plane's inner normal and threshold); the threads test the
//   same face at the same time, so each read is a broadcast;
// - the threads take the voxels of the cube, clipped to the volume,
//   round-robin (the plain version masks the voxels outside the volume);
// - the "full" test runs every face and ORs the verdicts with no branch, as
//   the lattice kernel's does (csrc/lattice_overlap.cu, which measured a
//   test that leaves at the first passing face 3.9x slower); "kernel" ANDs
//   every plane's verdict the same way; "bbox" compares the voxel with the
//   polyhedron's box;
// - a voxel inside does a 64-bit atomicMax of the packed value into the
//   int64 image, zero-filled by the caller (signed, as the plain version's
//   scatter-max from 0), and with a count an atomicAdd into the int32
//   count. A max and a sum do not depend on the order of the writes, so the
//   image and the count are the plain version's whatever the schedule;
// - the window comes from the largest dist, read by the kernel from a
//   one-element tensor on the card: no host sync.
//
// Bitwise agreement with the plain version: the voxel's coordinates are
// integers, exact in f32; its offset u = q - p is one rounded difference per
// axis (__fsub_rn); "full" is barycentric.cuh's test, whose roundings are
// the plain version's (this file is built with -fmad=false); "kernel"
// tests (n0 * u0 + n1 * u1) + n2 * u2 <= w, each product and sum rounded on
// its own, the order of the plain version's torch.sum over three values,
// with n and w = offset + 1e-6 formed by the wrapper as the plain version
// forms them (ops/raster_polyhedra.py::kernel_planes); "bbox" compares the
// coordinates with the box the wrapper forms, as the plain version does.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "barycentric.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448;                 // a block's shared memory on the H100
constexpr int F_MAX = SMEM_MAX / FACE_BYTES;     // faces a block stages in "full" mode
constexpr float CENTRE_MAX = 0x1p40f;            // a rounded centre beyond: no voxel
enum Mode { FULL = 0, KERNEL = 1, BBOX = 2 };

// "kernel" mode: u on the inner side of every face plane (the normal in
// x, y, z and the threshold in w): every plane tested, the verdicts ANDed
// with no branch
__device__ __forceinline__ bool in_planes(const float4* __restrict__ f, int F, float u0,
                                          float u1, float u2) {
  bool in = true;
#pragma unroll 4
  for (int k = 0; k < F; ++k) {
    const float4 r = f[k];
    in &= dot(r, u0, u1, u2) <= r.w;
  }
  return in;
}

// The cube's extent [lo, lo + n) along one axis about centre p, clipped to
// [0, size); false where it is empty
__device__ __forceinline__ bool clip(float p, int window, int size, int& lo, int& n) {
  // a NaN centre goes to a bound (fminf / fmaxf), whose cube misses the volume
  const float r = fminf(fmaxf(rintf(p), -CENTRE_MAX), CENTRE_MAX);
  const long long s = (long long)r - window / 2;
  const long long a = s > 0 ? s : 0;
  const long long b = s + window < size ? s + window : size;
  lo = (int)a;
  n = (int)(b - a);
  return b > a;
}

// The voxels of one polyhedron's clipped cube, round-robin over the block's
// threads, each tested and, where inside, written; I indexes the cube
template <int MODE, typename I>
__device__ __forceinline__ void draw(const float4* __restrict__ faces, const float* box, int F,
                                     float p0, float p1, float p2, const int* lo, I nz, I ny,
                                     I nx, int H, int W, long long v, long long* img, int* cnt) {
  const I nyx = ny * nx, total = nz * nyx;
  for (I t = threadIdx.x; t < total; t += THREADS) {
    const I iz = t / nyx, r = t - iz * nyx;
    const I iy = r / nx, ix = r - iy * nx;
    const int z = lo[0] + (int)iz, y = lo[1] + (int)iy, x = lo[2] + (int)ix;
    const float q0 = (float)z, q1 = (float)y, q2 = (float)x;
    bool in;
    if (MODE == BBOX) {
      in = (q0 >= box[0]) & (q1 >= box[1]) & (q2 >= box[2]) & (q0 <= box[3]) &
           (q1 <= box[4]) & (q2 <= box[5]);
    } else {
      const float u0 = __fsub_rn(q0, p0), u1 = __fsub_rn(q1, p1), u2 = __fsub_rn(q2, p2);
      in = MODE == FULL ? inside(faces, F, u0, u1, u2) : in_planes(faces, F, u0, u1, u2);
    }
    if (in) {
      const long long idx = ((long long)z * H + y) * W + x;
      atomicMax(img + idx, v);
      if (cnt != nullptr) atomicAdd(cnt + idx, 1);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
raster3d_kernel(const float* __restrict__ points, const float* __restrict__ tab,
                const uint8_t* __restrict__ valid, const long long* __restrict__ orders,
                const long long* __restrict__ packed, const float* __restrict__ dmax,
                long long* img, int* cnt, int N, int F, int D, int H, int W) {
  extern __shared__ float4 faces[];
  // the splat window of the plain version (ops/raster_tiles.py::tile_window);
  // none below -2, where the plain version's is empty
  const double cd = ceil((double)*dmax);
  if (!(cd > -2.0)) return;
  const int side_max = max(D, max(H, W));
  const int window = cd < (double)side_max ? 2 * (int)cd + 4 : 2 * side_max + 4;
  const int size[3] = {D, H, W};
  float box[6];
  // block-uniform loop: every thread reaches the syncs
  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    if (orders[n] <= 0) continue;
    const float p[3] = {points[3 * n], points[3 * n + 1], points[3 * n + 2]};
    int lo[3], len[3];
    bool any = true;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) any &= clip(p[ax], window, size[ax], lo[ax], len[ax]);
    if (!any) continue;
    if (MODE == BBOX) {
#pragma unroll
      for (int k = 0; k < 6; ++k) box[k] = __ldg(tab + 6 * (size_t)n + k);
    } else {
      __syncthreads();                 // the previous polyhedron's faces are read
      if (MODE == FULL) {
        stage(faces, tab, valid, n, F, threadIdx.x, THREADS);
      } else {
        const float4* planes = reinterpret_cast<const float4*>(tab) + (size_t)n * F;
        for (int k = threadIdx.x; k < F; k += THREADS) faces[k] = __ldg(planes + k);
      }
      __syncthreads();
    }
    const long long v = packed[n];
    if ((long long)len[0] * len[1] * len[2] <= INT_MAX)
      draw<MODE, int>(faces, box, F, p[0], p[1], p[2], lo, len[0], len[1], len[2], H, W, v,
                      img, cnt);
    else
      draw<MODE, long long>(faces, box, F, p[0], p[1], p[2], lo, len[0], len[1], len[2], H, W,
                            v, img, cnt);
  }
}

template <int MODE>
int launch(const void* const* a, void* img, void* cnt, int N, int F, int D, int H, int W,
           cudaStream_t s) {
  const int smem = MODE == FULL ? F * FACE_BYTES : MODE == KERNEL ? F * 16 : 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(raster3d_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, n_sm = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, raster3d_kernel<MODE>, THREADS,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = n_sm * (per_sm > 0 ? per_sm : 1);
  raster3d_kernel<MODE><<<N < blocks ? N : blocks, THREADS, smem, s>>>(
      static_cast<const float*>(a[0]), static_cast<const float*>(a[1]),
      static_cast<const uint8_t*>(a[2]), static_cast<const long long*>(a[3]),
      static_cast<const long long*>(a[4]), static_cast<const float*>(a[5]),
      static_cast<long long*>(img), static_cast<int*>(cnt), N, F, D, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// points (N, 3) f32 centres; tab, by mode: 0 "full" (N, F, 3, 3) f32 face
// inverses with valid (N, F) bool, 1 "kernel" (N, F, 4) f32 planes (inner
// normal, threshold), 2 "bbox" (N, 6) f32 boxes (lo, hi; F unused); orders
// (N,) i64 (<= 0: not drawn); packed (N,) i64, the values written; dmax (1,)
// f32, the largest dist; img (D, H, W) i64 and cnt (D, H, W) i32 or null,
// zero-filled by the caller. N >= 1, D, H, W >= 1, 1 <= F <= F_MAX in modes 0
// and 1. Returns cudaGetLastError() after the launch.
extern "C" int raster_polyhedra(const void* points, const void* tab, const void* valid,
                                const void* orders, const void* packed, const void* dmax,
                                void* img, void* cnt, int N, int F, int D, int H, int W,
                                int mode, void* stream) {
  if (N <= 0 || D <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if (mode != BBOX && (F < 1 || F > F_MAX)) return (int)cudaErrorInvalidValue;
  if (mode == FULL && valid == nullptr) return (int)cudaErrorInvalidValue;
  const void* a[6] = {points, tab, valid, orders, packed, dmax};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == FULL) return launch<FULL>(a, img, cnt, N, F, D, H, W, s);
  if (mode == KERNEL) return launch<KERNEL>(a, img, cnt, N, F, D, H, W, s);
  if (mode == BBOX) return launch<BBOX>(a, img, cnt, N, F, D, H, W, s);
  return (int)cudaErrorInvalidValue;
}
