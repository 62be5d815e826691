// Sampled overlap of star-polygon pairs: for each pair, the fraction of an
// S x S midpoint grid over the pair's bbox intersection that lies inside
// both polygons. The exact overlap test of the 2D NMS (S = 8 coarse, then
// the fine grid, S = the NMS's ``samples``, 16 by default, for the pairs the
// coarse grid leaves undecided); any S >= 1, as the TPU kernel.
//
// Replaces the Pallas TPU kernels of stardist_tpu/ops/pair_overlap.py:
// _pair_kernel (one pair per 128-lane row) and _pair_kernel2 (two S = 8
// pairs per row), whose inside test is _inside_body.
//
// What bounds it on the H100: arithmetic (f32, outside the tensor cores).
// The inputs are 2R + 8 floats per pair, read once; per sample and polygon
// the function needs one wedge of the R. The design:
// - a wedge lookup, not a walk over all R rays: a polynomial arctangent of
//   the sample's offset u = q - p (within 0.004 rad, where a wedge is at
//   least 2 pi / 128 = 0.049 rad; wedge.cuh, shared with the raster
//   kernel) gives the wedge k0 to within one, and the walk's own predicate
//   is evaluated on the window k0 - 1, k0, k0 + 1 only (below);
// - a persistent grid: each block stages the trig table once, as float4
//   (sin phi_k, cos phi_k, sin phi_k+1, cos phi_k+1), and its warps walk
//   the pairs grid-stride; a pair takes lanes_per_pair(S) lanes (16 at
//   S = 8, two pairs per warp; 32 at S >= 12), about four samples a lane
//   up to S = 11 and ceil(S^2 / 32) above, and a butterfly of shuffles
//   sums the lanes' counts; S = 8 and S = 16, which the cascade launches on
//   every 2D call, are compiled with S fixed, any other S runs one
//   instantiation with S given at run time;
// - the dist rows are read straight through L1 (two entries per sample);
// - a sample outside the first polygon skips the second test.
//
// The wedge rule is the TPU kernel's: wedge k matches when cr_k >= 0 and
// cr_k+1 < 0, cr_k = ur*cos(phi_k) - uc*sin(phi_k) (cr_R = cr_0), and the
// vertices are summed over the matching wedges. Exactness of the lookup:
// with |u| in [2^-60, 2^64) the rounded cr_k has the sign of
// |u| sin(theta - phi_k), theta = atan2(ur, uc), for every ray but those
// within ~2^-23 rad of theta or of theta + pi (each product is off by at
// most 2^-24 of itself, plus 2^-150, which is below 2^-89 |u|). At most one
// ray is that close to each (the rays are at least 2 pi / 128 apart), and
// its neighbours have sure signs: around theta + pi they run (-, ?, +),
// which matches nowhere; around theta (+, ?, -), which matches exactly once.
// So the walk finds exactly one wedge, and the window's predicate is the
// walk's: a window with exactly one match holds the walk's wedge. The walk
// itself stays for two exact guards: |u| outside that range (u = 0 among
// them: there no wedge matches, the vertices stay 0 and the side test
// passes, as on the TPU), and a window without exactly one match (a miss
// of the estimate).
//
// Bitwise agreement with the plain PyTorch version (ops/pair_overlap.py):
// - the trig table is numpy's f64 sin/cos cast to f32, passed in; no
//   sinf/cosf here (the arctangent only picks the window);
// - sample coordinates are plo + (((i / S) + 0.5) * f32(1 / S)) * ext, in
//   that order, with 1 / S rounded to f32 once: what the TPU kernel's
//   (i // S + 0.5) / S computes where XLA compiles it (the division by a
//   constant becomes a product with its rounded reciprocal; the same bits
//   as a division at S = 8 and 16, powers of two); the plain version makes
//   its grid so in numpy on the host;
// - every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
//   __fsub_rn, and the file is built with -fmad=false): a fused
//   multiply-add in er*(uc-v0c) - ec*(ur-v0r) would flip samples lying
//   within one rounding of an edge, and near the NMS threshold such a flip
//   changes a decision;
// - the vertex sums are 0.0f plus the one matching wedge's terms, as the
//   walk forms them;
// - the result is an integer count of 0/1 samples times f32(1 / S^2), as
//   XLA computes the TPU kernel's sum / (S * S), the same whatever the
//   summation order.
#include <cuda_runtime.h>

#include "wedge.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RMAX = 128;
constexpr int MAX_DEVICES = 64;

// tab[k] = (sin phi_k, cos phi_k, sin phi_k+1, cos phi_k+1)
__device__ __forceinline__ float cross_ray(float ur, float uc, float4 t) {
  return ::cross_ray(ur, uc, t.x, t.y);
}

// wedge k's vertex terms added to the running sums v = (v0r, v0c, v1r, v1c)
__device__ __forceinline__ void add_wedge(float4& v, const float* __restrict__ d, int k,
                                          int R, float4 t) {
  const float a = __ldg(d + k);
  const float b = __ldg(d + (k + 1 == R ? 0 : k + 1));
  v.x = __fadd_rn(v.x, __fmul_rn(a, t.x));
  v.y = __fadd_rn(v.y, __fmul_rn(a, t.y));
  v.z = __fadd_rn(v.z, __fmul_rn(b, t.z));
  v.w = __fadd_rn(v.w, __fmul_rn(b, t.w));
}

// the side test of u against the wedge's edge v0 -> v1
__device__ __forceinline__ bool side(float ur, float uc, float4 v) {
  const float er = __fsub_rn(v.z, v.x);
  const float ec = __fsub_rn(v.w, v.y);
  const float cross_p = __fsub_rn(__fmul_rn(er, __fsub_rn(uc, v.y)),
                                  __fmul_rn(ec, __fsub_rn(ur, v.x)));
  const float cross_c = __fsub_rn(__fmul_rn(ec, v.x), __fmul_rn(er, v.y));
  return __fmul_rn(cross_p, cross_c) >= 0.0f;
}

// The guards' path: the walk over all R wedges, summing every match in
// ascending k (the TPU kernel's _inside_body).
__device__ __noinline__ bool inside_walk(const float* __restrict__ d, float ur, float uc,
                                         const float4* tab, int R) {
  const float cr0 = cross_ray(ur, uc, tab[0]);
  float prev = cr0;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = 0; k < R; ++k) {
    const float nxt = (k == R - 1) ? cr0 : cross_ray(ur, uc, tab[k + 1]);
    if (prev >= 0.0f && nxt < 0.0f) add_wedge(v, d, k, R, tab[k]);
    prev = nxt;
  }
  return side(ur, uc, v);
}

// Inside test of sample (qr, qc) against the star polygon with dists d[R]
// about (pr, pc); rscale = R / (2 pi).
__device__ __forceinline__ bool inside(const float* __restrict__ d, float pr, float pc,
                                       float qr, float qc, const float4* tab, int R,
                                       float rscale) {
  const float ur = __fsub_rn(qr, pr);
  const float uc = __fsub_rn(qc, pc);
  const float m = fmaxf(fabsf(ur), fabsf(uc));
  if (!(m >= U_LO && m < U_HI)) return inside_walk(d, ur, uc, tab, R);
  const int k0 = wedge_estimate(ur, uc, R, rscale);  // theta's wedge, to within one
  const int ka = k0 == 0 ? R - 1 : k0 - 1;
  const int kc = k0 == R - 1 ? 0 : k0 + 1;
  const int kd = kc == R - 1 ? 0 : kc + 1;
  const float4 ta = tab[ka], tb = tab[k0], tc = tab[kc];
  const float ca = cross_ray(ur, uc, ta);
  const float cb = cross_ray(ur, uc, tb);
  const float cc = cross_ray(ur, uc, tc);
  const float cd = cross_ray(ur, uc, tab[kd]);
  const bool ma = ca >= 0.0f && cb < 0.0f;
  const bool mb = cb >= 0.0f && cc < 0.0f;
  const bool mc = cc >= 0.0f && cd < 0.0f;
  if ((int)ma + (int)mb + (int)mc != 1) return inside_walk(d, ur, uc, tab, R);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  add_wedge(v, d, ma ? ka : mb ? k0 : kc, R, ma ? ta : mb ? tb : tc);
  return side(ur, uc, v);
}

// Lanes per pair: the power of two nearest above a quarter of the grid's
// samples, at most 32 (16 at S = 8, two pairs a warp; 32 at S = 16; 4 at
// S = 3, eight pairs a warp).
__host__ __device__ constexpr int lanes_per_pair(int S) {
  int L = 1;
  while (L < 32 && 4 * L < S * S) L <<= 1;
  return L;
}

// SC = 8 or 16: the grid fixed at compile time (the cascade's two grids,
// launched on every 2D NMS call); SC = 0: any S >= 1, given at run time.
template <int SC>
__global__ void __launch_bounds__(THREADS)
pair_kernel(const float* __restrict__ d_r, const float* __restrict__ p_r,
            const float* __restrict__ d_c, const float* __restrict__ p_c,
            const float* __restrict__ plo, const float* __restrict__ ext,
            const float* __restrict__ trig, float* __restrict__ out, int P, int R,
            float rscale, int S_run) {
  const int S = SC ? SC : S_run;
  const int n = S * S;                   // samples per pair
  const int L = lanes_per_pair(S);       // lanes per pair
  const int G = 32 / L;                  // pairs per warp step
  const int NS = (n + L - 1) / L;        // samples per lane
  // f32 1 / S and 1 / S^2, rounded once (exact at S = 8 and 16)
  const float inv_s = SC ? 1.0f / SC : __frcp_rn((float)S);
  const float inv_n = SC ? 1.0f / (SC * SC) : __frcp_rn((float)n);
  __shared__ float4 tab[RMAX];
  for (int k = threadIdx.x; k < R; k += THREADS)
    tab[k] = make_float4(trig[k], trig[R + k], trig[2 * R + k], trig[3 * R + k]);
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int sub = lane / L;
  const int gl = lane % L;
  const int stride = gridDim.x * WARPS * G;
  // warp-uniform loop: every lane reaches the shuffles
  for (int base = (blockIdx.x * WARPS + threadIdx.x / 32) * G; base < P; base += stride) {
    const int p = base + sub;
    int count = 0;
    if (p < P) {
      const float prr = __ldg(p_r + 2 * p), prc = __ldg(p_r + 2 * p + 1);
      const float pcr = __ldg(p_c + 2 * p), pcc = __ldg(p_c + 2 * p + 1);
      const float lor = __ldg(plo + 2 * p), loc = __ldg(plo + 2 * p + 1);
      const float exr = __ldg(ext + 2 * p), exc = __ldg(ext + 2 * p + 1);
      const float* dr = d_r + (size_t)p * R;
      const float* dc = d_c + (size_t)p * R;
#pragma unroll 1
      for (int j = 0; j < NS; ++j) {
        const int i = gl + j * L;
        if (n % L != 0 && i >= n) break;   // only where L does not divide S * S
        const int row = i / S;
        const int col = i - row * S;
        const float gr = __fmul_rn(__fadd_rn((float)row, 0.5f), inv_s);
        const float gc = __fmul_rn(__fadd_rn((float)col, 0.5f), inv_s);
        const float qr = __fadd_rn(lor, __fmul_rn(gr, exr));
        const float qc = __fadd_rn(loc, __fmul_rn(gc, exc));
        if (inside(dr, prr, prc, qr, qc, tab, R, rscale) &&
            inside(dc, pcr, pcc, qr, qc, tab, R, rscale))
          ++count;
      }
    }
    for (int off = L / 2; off > 0; off >>= 1)
      count += __shfl_xor_sync(0xffffffffu, count, off);
    if (gl == 0 && p < P) out[p] = __fmul_rn((float)count, inv_n);
  }
}

// Blocks of the persistent grid: as many as fit on the card at once.
template <int SC>
cudaError_t resident_blocks(int* blocks) {
  static int cached[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pair_kernel<SC>, THREADS, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < MAX_DEVICES) cached[dev] = *blocks;
  return cudaSuccess;
}

template <int SC>
int launch(const float* const* a, float* o, int P, int R, int S, cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = resident_blocks<SC>(&blocks);
  if (err != cudaSuccess) return (int)err;
  const int per_block = WARPS * (32 / lanes_per_pair(S));
  const int needed = (P + per_block - 1) / per_block;
  const float rscale = (float)(R / 6.283185307179586);
  pair_kernel<SC><<<needed < blocks ? needed : blocks, THREADS, 0, s>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], o, P, R, rscale, S);
  return (int)cudaGetLastError();
}

}  // namespace

// d_r, d_c (P, R); p_r, p_c, plo, ext (P, 2); trig (4, R); out (P,), all f32.
// 1 <= S <= 46340 (S * S fits an int), 3 <= R <= 128. Returns
// cudaGetLastError() after the launch.
extern "C" int pair_frac_f32(const void* d_r, const void* p_r, const void* d_c,
                             const void* p_c, const void* plo, const void* ext,
                             const void* trig, void* out, int P, int R, int S,
                             void* stream) {
  if (P <= 0 || R < 3 || R > RMAX || S < 1 || S > 46340) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a[7] = {static_cast<const float*>(d_r), static_cast<const float*>(p_r),
                       static_cast<const float*>(d_c), static_cast<const float*>(p_c),
                       static_cast<const float*>(plo), static_cast<const float*>(ext),
                       static_cast<const float*>(trig)};
  float* o = static_cast<float*>(out);
  if (S == 8) return launch<8>(a, o, P, R, S, s);
  if (S == 16) return launch<16>(a, o, P, R, S, s);
  return launch<0>(a, o, P, R, S, s);
}
