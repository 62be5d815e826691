// Label rasterization of star polygons: per pixel, the largest packed value
// (order << 32) | (label + 1) among the polygons whose splat window covers
// the pixel and that contain it; 0 where none does.
//
// Replaces the Pallas TPU kernel stardist_tpu/ops/raster_pallas.py::_kernel
// (:80, launched by _raster_tiles_call :129, wrapper rasterize_polygons_tiles
// :166). It computes the same function: the same splat window (side
// `window` from round(p) - window / 2), the same inside test (the centre
// pixel, or wedge r by two cross-product signs and the edge test
// cross_p * cross_c >= 0) and "largest order value wins".
//
// Design: one block per polygon. The block stages the polygon's 4R wedge
// vertex features and the (4, R) wedge table in shared memory, its threads
// walk the window's pixels that lie inside the image, and every inside
// pixel takes an atomicMax of the 64-bit packed value into a zero-filled
// image. The TPU kernel inverts this loop (one grid step per (8, 128) image
// tile over host-binned candidate lists) only because scatters are slow
// there; on Hopper a 64-bit atomicMax to device memory is cheap, so there is
// no binning pass, no host sync, no per-tile candidate cap and no declined
// case (the packing is 64-bit, so order values and labels have no 16-bit
// limit). Survivors of an NMS overlap little, so few atomics meet on one
// pixel; a pixel that already holds a value >= ours skips its atomic.
//
// What bounds it on the H100: not memory. The inputs are 4R + 6 words per
// polygon, read once into shared memory, and each pixel costs at most one
// 8-byte atomic; the work is each window pixel's walk over the R wedges
// (2 products + 1 subtraction per side test) until it is found inside, a
// few GFLOP for a whole 4096^2 field. On an H100 80GB HBM3 (700 W) such a
// field of 7,000 polygons (window 38) takes ~0.44 ms with the memset, far
// below the f32 issue rate, so the walk's divergence between threads and
// the per-pixel integer division, rather than the flops, are the likely
// limit (no profiler counters were available to confirm it).
//
// Bitwise agreement with the plain PyTorch version (ops/raster_tiles.py):
// the features (d * sin, d * cos) and the wedge table come from the
// wrapper (numpy's f64 trig cast to f32, one f32 product each); every
// product and difference here is rounded on its own (__fmul_rn / __fsub_rn,
// and the file is built with -fmad=false), as the plain version's separate
// torch ops are.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RMAX = 128;

__global__ void __launch_bounds__(THREADS)
raster_kernel(const float* __restrict__ feats, const float* __restrict__ centres,
              const int* __restrict__ origin, const unsigned long long* __restrict__ vals,
              const float* __restrict__ trig, unsigned long long* img,
              int R, int H, int W, int window) {
  __shared__ float f_s[4 * RMAX];  // d*s0 | d*c0 | d1*s1 | d1*c1 of this polygon
  __shared__ float t_s[4 * RMAX];  // sin phi_r | cos phi_r | sin phi_r+1 | cos phi_r+1
  const int n = blockIdx.x;
  const unsigned long long v = vals[n];
  // window clipped to the image; both exits are uniform across the block
  const int r0 = origin[2 * n], c0 = origin[2 * n + 1];
  const int rlo = max(r0, 0), rhi = min(r0 + window, H);
  const int clo = max(c0, 0), chi = min(c0 + window, W);
  const int wr = rhi - rlo, wc = chi - clo;
  if (v == 0ull || wr <= 0 || wc <= 0) return;
  for (int t = threadIdx.x; t < 4 * R; t += blockDim.x) {
    f_s[t] = feats[(size_t)n * 4 * R + t];
    t_s[t] = trig[t];
  }
  __syncthreads();
  const float pr = centres[2 * n], pc = centres[2 * n + 1];
  for (int t = threadIdx.x; t < wr * wc; t += blockDim.x) {
    const int row = rlo + t / wc;
    const int col = clo + t % wc;
    const float ur = __fsub_rn((float)row, pr);
    const float uc = __fsub_rn((float)col, pc);
    bool inside = (ur == 0.0f && uc == 0.0f);
    // a pixel may pass the sign test of two wedges (on a line through the
    // centre, within a rounding); it is inside if any of them accepts it
    for (int r = 0; r < R && !inside; ++r) {
      const float lo = __fsub_rn(__fmul_rn(t_s[R + r], ur), __fmul_rn(t_s[r], uc));
      const float hi = __fsub_rn(__fmul_rn(t_s[3 * R + r], ur), __fmul_rn(t_s[2 * R + r], uc));
      if (lo >= 0.0f && hi < 0.0f) {
        const float v0r = f_s[r], v0c = f_s[R + r];
        const float er = __fsub_rn(f_s[2 * R + r], v0r);
        const float ec = __fsub_rn(f_s[3 * R + r], v0c);
        const float cross_p = __fsub_rn(__fmul_rn(er, __fsub_rn(uc, v0c)),
                                        __fmul_rn(ec, __fsub_rn(ur, v0r)));
        const float cross_c = __fsub_rn(__fmul_rn(ec, v0r), __fmul_rn(er, v0c));
        inside = __fmul_rn(cross_p, cross_c) >= 0.0f;
      }
    }
    if (inside) {
      unsigned long long* p = img + (size_t)row * W + col;
      if (*p < v) atomicMax(p, v);
    }
  }
}

}  // namespace

// feats (N, 4R) f32; centres (N, 2) f32; origin (N, 2) i32 (the window's
// top-left pixel); vals (N,) u64 packed values, 0 = not drawn; trig (4, R)
// f32; img (H, W) u64, zero-filled by the caller. 3 <= R <= 128, N >= 1.
// Returns cudaGetLastError() after the launch.
extern "C" int raster_tiles_u64(const void* feats, const void* centres, const void* origin,
                                const void* vals, const void* trig, void* img, int N, int R,
                                int H, int W, int window, void* stream) {
  if (N <= 0 || R < 3 || R > RMAX || H <= 0 || W <= 0 || window <= 0)
    return (int)cudaErrorInvalidValue;
  raster_kernel<<<N, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const float*>(centres),
      static_cast<const int*>(origin), static_cast<const unsigned long long*>(vals),
      static_cast<const float*>(trig), static_cast<unsigned long long*>(img), R, H, W, window);
  return (int)cudaGetLastError();
}
