// Sampled overlap of star-polygon pairs: for each pair, the fraction of an
// S x S midpoint grid over the pair's bbox intersection that lies inside
// both polygons. The exact overlap test of the 2D NMS (S = 8 coarse, then
// S = 16 for the pairs the coarse grid leaves undecided).
//
// Replaces the Pallas TPU kernels of stardist_tpu/ops/pair_overlap.py:
// _pair_kernel (one pair per 128-lane row) and _pair_kernel2 (two S = 8
// pairs per row, a TPU lane-packing trick with no counterpart here).
//
// What bounds it on the H100: arithmetic. Per sample and polygon the wedge
// search walks all R rays (2 products + 1 subtraction each) and the rest is
// a handful of flops; the inputs are 2R + 8 floats per pair, read once. The
// design keeps everything on chip:
// - one warp per pair; each lane takes S*S/32 samples (2 at S = 8, 8 at
//   S = 16), and a warp shuffle reduction counts the samples inside both;
// - the two dist rows of each warp's pair and the (4, R) trig table sit in
//   shared memory, read by all 32 lanes (broadcast);
// - the wedge is selected by cross-product signs, cr_k >= 0 && cr_{k+1} < 0
//   with cr_k = ur*cos(phi_k) - uc*sin(phi_k), as the TPU kernel does (no
//   atan2). At the polygon's exact center no wedge matches, the wedge
//   vertices stay 0 and the side test passes, as on the TPU.
//
// Bitwise agreement with the plain PyTorch version (ops/pair_overlap.py):
// - the trig table is numpy's f64 sin/cos cast to f32, passed in; no
//   sinf/cosf here;
// - sample coordinates are plo + (((i / S) + 0.5) / S) * ext, in that order;
// - every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
//   __fsub_rn, and the file is built with -fmad=false): a fused
//   multiply-add in er*(uc-v0c) - ec*(ur-v0r) would flip samples lying
//   within one rounding of an edge, and near the NMS threshold such a flip
//   changes a decision;
// - the result is a count of 0/1 samples divided by S*S (a power of two),
//   exact in f32 whatever the summation order.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int RMAX = 128;

__device__ __forceinline__ float cross_ray(float ur, float uc, float c, float s) {
  return __fsub_rn(__fmul_rn(ur, c), __fmul_rn(uc, s));
}

// Inside test of sample (qr, qc) against the star polygon with dists d[R]
// about (pr, pc). trig = [sin phi_k | cos phi_k | sin phi_k+1 | cos phi_k+1].
__device__ bool inside(const float* d, float pr, float pc, float qr, float qc,
                       const float* trig, int R) {
  const float* s0 = trig;
  const float* c0 = trig + R;
  const float* s1 = trig + 2 * R;
  const float* c1 = trig + 3 * R;
  const float ur = __fsub_rn(qr, pr);
  const float uc = __fsub_rn(qc, pc);
  const float cr0 = cross_ray(ur, uc, c0[0], s0[0]);
  float prev = cr0;
  float v0r = 0.0f, v0c = 0.0f, v1r = 0.0f, v1c = 0.0f;
  for (int k = 0; k < R; ++k) {
    const float nxt = (k == R - 1) ? cr0 : cross_ray(ur, uc, c0[k + 1], s0[k + 1]);
    if (prev >= 0.0f && nxt < 0.0f) {
      // the plain version sums w * (d * trig) over all k with w in {0, 1};
      // adding the selected terms only gives the same values
      const float a = d[k];
      const float b = d[k + 1 == R ? 0 : k + 1];
      v0r = __fadd_rn(v0r, __fmul_rn(a, s0[k]));
      v0c = __fadd_rn(v0c, __fmul_rn(a, c0[k]));
      v1r = __fadd_rn(v1r, __fmul_rn(b, s1[k]));
      v1c = __fadd_rn(v1c, __fmul_rn(b, c1[k]));
    }
    prev = nxt;
  }
  const float er = __fsub_rn(v1r, v0r);
  const float ec = __fsub_rn(v1c, v0c);
  const float cross_p = __fsub_rn(__fmul_rn(er, __fsub_rn(uc, v0c)),
                                  __fmul_rn(ec, __fsub_rn(ur, v0r)));
  const float cross_c = __fsub_rn(__fmul_rn(ec, v0r), __fmul_rn(er, v0c));
  return __fmul_rn(cross_p, cross_c) >= 0.0f;
}

template <int S>
__global__ void __launch_bounds__(WARPS * 32)
pair_kernel(const float* __restrict__ d_r, const float* __restrict__ p_r,
            const float* __restrict__ d_c, const float* __restrict__ p_c,
            const float* __restrict__ plo, const float* __restrict__ ext,
            const float* __restrict__ trig, float* __restrict__ out, int P, int R) {
  __shared__ float trig_s[4 * RMAX];
  __shared__ float d_s[WARPS][2][RMAX];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.x * WARPS + warp;
  for (int t = threadIdx.x; t < 4 * R; t += blockDim.x) trig_s[t] = trig[t];
  if (p < P) {
    for (int k = lane; k < R; k += 32) {
      d_s[warp][0][k] = d_r[(size_t)p * R + k];
      d_s[warp][1][k] = d_c[(size_t)p * R + k];
    }
  }
  __syncthreads();
  if (p >= P) return;

  const float prr = p_r[2 * p], prc = p_r[2 * p + 1];
  const float pcr = p_c[2 * p], pcc = p_c[2 * p + 1];
  const float lor = plo[2 * p], loc = plo[2 * p + 1];
  const float exr = ext[2 * p], exc = ext[2 * p + 1];
  int count = 0;
  for (int i = lane; i < S * S; i += 32) {
    const float gr = __fdiv_rn(__fadd_rn((float)(i / S), 0.5f), (float)S);
    const float gc = __fdiv_rn(__fadd_rn((float)(i % S), 0.5f), (float)S);
    const float qr = __fadd_rn(lor, __fmul_rn(gr, exr));
    const float qc = __fadd_rn(loc, __fmul_rn(gc, exc));
    const bool in_r = inside(d_s[warp][0], prr, prc, qr, qc, trig_s, R);
    const bool in_c = inside(d_s[warp][1], pcr, pcc, qr, qc, trig_s, R);
    count += (in_r && in_c) ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0) out[p] = __fdiv_rn((float)count, (float)(S * S));
}

}  // namespace

// d_r, d_c (P, R); p_r, p_c, plo, ext (P, 2); trig (4, R); out (P,), all f32.
// S in {8, 16}, 3 <= R <= 128. Returns cudaGetLastError() after the launch.
extern "C" int pair_frac_f32(const void* d_r, const void* p_r, const void* d_c,
                             const void* p_c, const void* plo, const void* ext,
                             const void* trig, void* out, int P, int R, int S,
                             void* stream) {
  if (P <= 0 || R < 3 || R > RMAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((P + WARPS - 1) / WARPS);
  const dim3 block(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a[7] = {static_cast<const float*>(d_r), static_cast<const float*>(p_r),
                       static_cast<const float*>(d_c), static_cast<const float*>(p_c),
                       static_cast<const float*>(plo), static_cast<const float*>(ext),
                       static_cast<const float*>(trig)};
  float* o = static_cast<float*>(out);
  if (S == 8)
    pair_kernel<8><<<grid, block, 0, s>>>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], o, P, R);
  else if (S == 16)
    pair_kernel<16><<<grid, block, 0, s>>>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], o, P, R);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
