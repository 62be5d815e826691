// Label rasterization of star polygons: per pixel, the largest packed value
// of (order, label + 1) among the polygons whose splat window covers the
// pixel and that contain it; 0 where none does.
//
// Replaces the Pallas TPU kernel stardist_tpu/ops/raster_pallas.py::_kernel
// (:80, launched by _raster_tiles_call :129, wrapper rasterize_polygons_tiles
// :166). It computes the same function: the same splat window (side
// `window` = 2 ceil(max dist) + 4, capped at 2 max(H, W) + 4, from round(p)
// - window / 2), the same inside test (the centre pixel, or wedge r by two
// cross-product signs and the edge test cross_p * cross_c >= 0) and "largest
// order value wins".
//
// What bounds it on the H100: the f32 work of one inside test per pixel of
// each polygon's box (its reach about its centre), and the label image's
// bytes on a sparse field. The design:
// - a wedge lookup, not a walk over all R wedges: the polynomial arctangent
//   of wedge.cuh (shared with the pair kernel) gives the wedge k0 of the
//   pixel's offset u to within one, and the walk's own predicate is
//   evaluated on the window k0 - 1, k0, k0 + 1 only (below);
// - each polygon tests its own box of pixels, not the whole splat window
//   (which is sized by the largest polygon of the field): the rows and
//   columns within reach * (1 + 2^-6) + 1 of its centre (reach = its largest
//   |dist|), clipped to its window and the image, unless the polygon is
//   not well-formed (below), which takes the whole window;
// - a persistent grid sized by occupancy; each block stages the wedge and
//   feature tables once, as float4, and its warps take polygons grid-stride.
//   A warp forms its polygon's edges (v0, e = v1 - v0, cross_c per wedge,
//   one rounded product each) from the dist row in shared memory, then lays
//   its lanes over the box: a power-of-two number of lanes per row (the
//   box's width rounded up, at most 32) and 32 / that many rows a step, so
//   no pixel needs an integer division;
// - the packed value is (order << 16) | (label + 1) in 32 bits with a 32-bit
//   atomicMax on an int32 image when the caller knows both fields fit in 16
//   bits, else (order << 32) | (label + 1) in 64 bits; both orders are
//   lexicographic on (order, label + 1), so ties resolve alike. The
//   atomic's result is unused, so the SM does not wait for it (reading the
//   pixel first, to skip atomics that cannot win, made the kernel slower:
//   examples/torch_raster_ablation.py);
// - the window comes from the largest dist, read by the kernel from a
//   one-element tensor on the card: no host sync.
//
// The wedge rule. Wedge k matches when lo_k >= 0 and hi_k < 0, lo_k and hi_k
// the cross products (wedge.cuh::cross_ray) of u with the rows k of the
// wedge table's two halves: (sin, cos) of phi_k = 2 pi k / R and of
// phi_k+1, numpy's f64 trig cast to f32. For k < R - 1 the second half's row
// k equals the first half's row k + 1 bit for bit; at k = R - 1 it is
// (sin, cos) of the f64 value R * (2 pi / R), whose sine is not 0 but
// -2.45e-16 at most R (-1.13e-15 at R = 75, +6.43e-16 at R = 25, 41, 50, 79,
// 82, 95, 100). So the last wedge ends at a ray psi just below or just
// above ray 0: where it ends below, offsets within that sliver of ray 0
// match no wedge (not inside); where it ends above, they match wedges R - 1
// and 0, and the walk ORs the two edge tests. The pair kernel instead
// chains cr_R = cr_0; the two rules part only within 1.2e-15 rad of ray 0.
//
// Exactness of the lookup: with |u| in [2^-60, 2^64) a rounded cross product
// has the sign of |u| sin(theta - phi), theta = atan2(ur, uc), for every
// ray phi but those within ~2^-22 rad of theta or of theta + pi (each
// product is off by at most 2^-24 of itself, plus 2^-150 < 2^-89 |u|).
// Around theta + pi the signs run from - to +, which no wedge matches (with
// rays 0 and psi both uncertain there: R - 1, psi, 0, 1 read -, ?, ?, +, and
// (psi, 0) is no wedge). So every wedge the walk matches has a ray within
// 2^-22 rad of theta or holds theta, and lies within one wedge of the
// estimate's (0.004 + 2^-22 rad < 2 pi / 128): the window holds every match
// of the walk, and a window with exactly one match gives the walk's answer
// (its OR of one edge test). A window with none or two (the sliver at
// psi; a miss) takes the walk, and so does |u| outside the range; u = 0 is
// the centre pixel, inside. The walk stays inside the kernel.
//
// The box. Let L be the line through a wedge's computed v0 along its
// computed e, h = dist(0, L) and q = h / reach. With fl(cross_c) = Y(1 +
// tiny) + err, |err| <= 2^-22.4 |e| |v0|, Y = e x (0 - v0) = +-|e| h, the
// wedge is well-formed when |fl(cross_c)| >= 2^-60 and |fl(cross_c)| >=
// 2^-10 |e| reach: then q >= 2^-10.5 and cross_c has Y's sign. For u that
// matches the wedge (within 2^-21 rad of its cone) at t = |u| beyond L, the
// ray through u meets L at t0 <= reach (1 + 2^-9.5) (L meets the rays at an
// angle whose sine is at least q), dist(u, L) = h (t / t0 - 1), and
// fl(cross_p) has the sign of e x (u - v0) once dist(u, L) > 2^-22.4
// |u - v0|, which holds for t > reach (1 + 2^-8.4); there cross_p and
// cross_c differ in sign, their product is at least 2^-130 in size, and the
// pixel is outside. So a polygon whose wedges are all well-formed draws no
// pixel beyond reach (1 + 2^-8.4) of its centre, inside its box. A polygon
// with a dist of 0, or adjacent dists more than ~2^10 sin(2 pi / R) times
// apart (~200 at R = 32), or a non-finite dist is not well-formed and tests
// its whole window, as the plain version does. (Non-finite dists: the plain version raises; the
// kernel caps the window at 2 max(H, W) + 4.)
//
// Bitwise agreement with the plain PyTorch version (ops/raster_tiles.py):
// the feature table (sin, cos of phi_k and phi_k + 2 pi / R) and the wedge
// table come from the wrapper (numpy's f64 trig cast to f32); the vertices
// are one f32 product each, d[k] * table, as the plain version forms them;
// every product and difference is rounded on its own (__fmul_rn /
// __fsub_rn, and the file is built with -fmad=false), as the plain
// version's separate torch ops are; the window origin is round-half-even
// (__float2int_rn), as torch.round.
#include <cuda_runtime.h>

#include "wedge.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RMAX = 128;
constexpr int MAX_DEVICES = 64;
constexpr float CC_MIN = 0x1p-60f;            // well-formed: |cross_c| at least this
constexpr float BOX_Q = 0x1p-10f;             // and at least this * |e| * reach
constexpr float BOX_GROW = 1.0f + 0x1p-6f;    // box half-side reach * BOX_GROW + 1

// wedge k's predicate on the wedge table's row t = (sin phi_k, cos phi_k,
// sin phi_k+1, cos phi_k+1)
__device__ __forceinline__ bool in_wedge(float ur, float uc, float4 t) {
  return cross_ray(ur, uc, t.x, t.y) >= 0.0f && cross_ray(ur, uc, t.z, t.w) < 0.0f;
}

// the edge test of u against wedge k's edge e = (v0r, v0c, er, ec), cross_c
__device__ __forceinline__ bool side(float ur, float uc, float4 e, float cross_c) {
  const float cross_p = __fsub_rn(__fmul_rn(e.z, __fsub_rn(uc, e.y)),
                                  __fmul_rn(e.w, __fsub_rn(ur, e.x)));
  return __fmul_rn(cross_p, cross_c) >= 0.0f;
}

// The guards' path: the walk over all R wedges, inside if any matching
// wedge's edge test passes (the TPU kernel's loop)
__device__ __noinline__ bool inside_walk(float ur, float uc, const float4* tab,
                                         const float4* edge, const float* cc, int R) {
  for (int k = 0; k < R; ++k)
    if (in_wedge(ur, uc, tab[k]) && side(ur, uc, edge[k], cc[k])) return true;
  return false;
}

// Inside test of offset u = (ur, uc) from the centre; rscale = R / (2 pi)
__device__ __forceinline__ bool inside(float ur, float uc, const float4* tab,
                                       const float4* edge, const float* cc, int R,
                                       float rscale) {
  if (ur == 0.0f && uc == 0.0f) return true;
  const float m = fmaxf(fabsf(ur), fabsf(uc));
  if (!(m >= U_LO && m < U_HI)) return inside_walk(ur, uc, tab, edge, cc, R);
  const int kb = wedge_estimate(ur, uc, R, rscale);
  const int ka = kb == 0 ? R - 1 : kb - 1;
  const int kc = kb == R - 1 ? 0 : kb + 1;
  const bool ma = in_wedge(ur, uc, tab[ka]);
  const bool mb = in_wedge(ur, uc, tab[kb]);
  const bool mc = in_wedge(ur, uc, tab[kc]);
  if ((int)ma + (int)mb + (int)mc != 1) return inside_walk(ur, uc, tab, edge, cc, R);
  const int k = ma ? ka : mb ? kb : kc;
  return side(ur, uc, edge[k], cc[k]);
}

template <typename T>
__device__ __forceinline__ T pack(long long order, long long low);
template <>
__device__ __forceinline__ unsigned int pack(long long order, long long low) {
  return ((unsigned int)order << 16) | (unsigned int)low;
}
template <>
__device__ __forceinline__ unsigned long long pack(long long order, long long low) {
  return ((unsigned long long)order << 32) | (unsigned long long)low;
}

// [lo, hi) of the box's rows (or columns) about centre p, within [lo, hi)
__device__ __forceinline__ void clip_box(float p, float half, int& lo, int& hi) {
  const float a = fminf(fmaxf(ceilf(__fsub_rn(p, half)), (float)lo), (float)hi);
  const float b = fmaxf(fminf(__fadd_rn(floorf(__fadd_rn(p, half)), 1.0f), (float)hi), a);
  lo = (int)a;
  hi = (int)b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
raster_kernel(const float* __restrict__ dist, const float* __restrict__ centres,
              const long long* __restrict__ orders, const long long* __restrict__ labels,
              const float* __restrict__ dmax, const float* __restrict__ ftab_g,
              const float* __restrict__ wtab_g, T* img, int N, int R, int H, int W,
              float rscale) {
  __shared__ float4 tab[RMAX];           // the wedge table
  __shared__ float4 ftab[RMAX];          // sin phi_k, cos phi_k, sin phi_k+1, cos phi_k+1
  __shared__ float4 edge_s[WARPS][RMAX]; // per warp: v0r, v0c, er, ec of its polygon
  __shared__ float cc_s[WARPS][RMAX];    // per warp: cross_c
  for (int k = threadIdx.x; k < R; k += THREADS) {
    tab[k] = make_float4(wtab_g[k], wtab_g[R + k], wtab_g[2 * R + k], wtab_g[3 * R + k]);
    ftab[k] = make_float4(ftab_g[k], ftab_g[R + k], ftab_g[2 * R + k], ftab_g[3 * R + k]);
  }
  __syncthreads();
  // the splat window of the ported tile kernel (ops/raster_tiles.py::tile_window)
  const float cd = ceilf(*dmax);
  const int side_max = max(H, W);
  const int window = cd < (float)side_max ? 2 * (int)cd + 4 : 2 * side_max + 4;
  if (window <= 0) return;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4* edge = edge_s[warp];
  float* cc = cc_s[warp];
  // warp-uniform loop: every lane reaches the shuffles and votes
  for (int n = blockIdx.x * WARPS + warp; n < N; n += gridDim.x * WARPS) {
    const long long order = orders[n];
    if (order <= 0) continue;
    const float pr = centres[2 * n], pc = centres[2 * n + 1];
    const int r0 = __float2int_rn(pr) - window / 2, c0 = __float2int_rn(pc) - window / 2;
    int rlo = max(r0, 0), rhi = min(r0 + window, H);
    int clo = max(c0, 0), chi = min(c0 + window, W);
    if (rlo >= rhi || clo >= chi) continue;

    const float* d = dist + (size_t)n * R;
    float reach = 0.0f;
    for (int k = lane; k < R; k += 32) {
      const float a = d[k], b = d[k + 1 == R ? 0 : k + 1];
      const float4 f = ftab[k];
      const float v0r = __fmul_rn(a, f.x), v0c = __fmul_rn(a, f.y);
      const float er = __fsub_rn(__fmul_rn(b, f.z), v0r);
      const float ec = __fsub_rn(__fmul_rn(b, f.w), v0c);
      edge[k] = make_float4(v0r, v0c, er, ec);
      cc[k] = __fsub_rn(__fmul_rn(ec, v0r), __fmul_rn(er, v0c));
      reach = fmaxf(reach, fabsf(a));
    }
    reach = warp_max(reach);
    bool ok = true;
    for (int k = lane; k < R; k += 32) {
      const float4 e = edge[k];
      const float c = fabsf(cc[k]);
      ok = ok && c >= CC_MIN && c >= BOX_Q * reach * sqrtf(e.z * e.z + e.w * e.w);
    }
    ok = __all_sync(0xffffffffu, ok);
    __syncwarp();  // the edges, written by their lanes, read by every lane
    if (ok) {
      const float half = __fadd_rn(__fmul_rn(reach, BOX_GROW), 1.0f);
      clip_box(pr, half, rlo, rhi);
      clip_box(pc, half, clo, chi);
    }
    const int bw = chi - clo;
    // lanes per row: the box's width rounded up to a power of two, at most 32
    const int shift = bw >= 32 ? 5 : 32 - __clz(max(bw, 1) - 1);
    const int lpr = 1 << shift, rps = 32 >> shift;
    const long long low = labels != nullptr ? labels[n] + 1 : order;
    const T v = pack<T>(order, low);
    for (int row = rlo + (lane >> shift); row < rhi; row += rps) {
      const float ur = __fsub_rn((float)row, pr);
      for (int col = clo + (lane & (lpr - 1)); col < chi; col += lpr) {
        const float uc = __fsub_rn((float)col, pc);
        if (inside(ur, uc, tab, edge, cc, R, rscale)) atomicMax(img + (size_t)row * W + col, v);
      }
    }
    __syncwarp();  // every lane is done with this polygon's edges
  }
}

// Blocks of the persistent grid: as many as fit on the card at once.
template <typename T>
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, raster_kernel<T>, THREADS, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < MAX_DEVICES) cached[dev] = *blocks;
  return cudaSuccess;
}

template <typename T>
int launch(const void* const* a, void* img, int N, int R, int H, int W, cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = resident_blocks<T>(&blocks);
  if (err != cudaSuccess) return (int)err;
  const int needed = (N + WARPS - 1) / WARPS;
  const float rscale = (float)(R / 6.283185307179586);
  raster_kernel<T><<<needed < blocks ? needed : blocks, THREADS, 0, s>>>(
      static_cast<const float*>(a[0]), static_cast<const float*>(a[1]),
      static_cast<const long long*>(a[2]), static_cast<const long long*>(a[3]),
      static_cast<const float*>(a[4]), static_cast<const float*>(a[5]),
      static_cast<const float*>(a[6]), static_cast<T*>(img), N, R, H, W, rscale);
  return (int)cudaGetLastError();
}

}  // namespace

// dist (N, R) f32; centres (N, 2) f32; orders (N,) i64 (<= 0: not drawn);
// labels (N,) i64 or null (then the low field is the order value); dmax (1,)
// f32, the largest dist; ftab, wtab (4, R) f32, the feature and wedge
// tables; img (H, W), zero-filled by the caller: u32 (bits = 32, both
// fields < 2^16) or u64 (bits = 64). 3 <= R <= 128, N >= 1. Returns
// cudaGetLastError() after the launch.
extern "C" int raster_labels(const void* dist, const void* centres, const void* orders,
                             const void* labels, const void* dmax, const void* ftab,
                             const void* wtab, void* img, int N, int R, int H, int W,
                             int bits, void* stream) {
  if (N <= 0 || R < 3 || R > RMAX || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const void* a[7] = {dist, centres, orders, labels, dmax, ftab, wtab};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 32) return launch<unsigned int>(a, img, N, R, H, W, s);
  if (bits == 64) return launch<unsigned long long>(a, img, N, R, H, W, s);
  return (int)cudaErrorInvalidValue;
}
