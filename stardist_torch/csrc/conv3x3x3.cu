// 3x3x3 SAME convolution + bias + activation, bf16 in/out, f32 accumulation,
// channels-last (D, H, W, C) activations — an implicit GEMM on the tensor
// cores, the 3D sibling of conv3x3.cu.
//
// Replaces the Pallas TPU kernel of stardist_tpu/ops/conv_pallas.py:
// _conv3d_kernel (called by _conv3d_hcw_call, wrapper conv3d_hcw), which
// runs every conv of the 3D U-Net.
//
//   y[z, r, x, co] = act(b[co] + sum_{dz,dy,dx,c} w[dz, dy, dx, c, co]
//                                   * x[z+dz-1, r+dy-1, x+dx-1, c])
//
// GEMM view: M = output voxels, N = Cout, K = 27*C ordered (dz, dy, dx, c),
// which is the DHWIO weight tensor (3, 3, 3, C, Cout) read as a (27C, Cout)
// matrix. (The TPU kernel orders K as (dy, dz, dx, c) for its VMEM shift
// ring; nothing here needs that order.)
//
// What bounds it on the H100: the 3D U-Net's layers have small K and N
// (C, Cout in 8..128), so each staged byte of activation feeds few MACs; a
// simple kernel is bound by shared-memory traffic and tensor-core issue of
// the 16x16x16 wmma tiles, not by device memory. This first version is the
// simple, correct form:
// - one block = 128 consecutive output voxels of one (z, row) x a BN-wide
//   Cout tile (BN = 16, 32 or 64); 8 warps, each owning 16 voxels x BN;
// - the K loop walks C in chunks of 16 channels and, inside a chunk, the
//   three input planes dz = 0..2; each step stages one plane's 3-row halo
//   tile (3 x 130 px x 16 ch) and the (9 x 16 x BN) weight slice of that dz
//   in shared memory with 16-byte loads, zero-filling the SAME halo (every
//   face, ragged D, H and W) and channels past C. Streaming the weights per
//   dz keeps a stage at 31 KB (the whole 27-tap slice would be 55 KB at
//   BN = 64), so the kernel stays in static shared memory; planes outside
//   the volume are skipped (their taps read only zeros);
// - the 9 (dy, dx) taps of a plane are 9 shifted views of the same staged
//   tile, so no im2col buffer exists anywhere;
// - nvcuda::wmma bf16 16x16x16 fragments with f32 accumulators; the
//   epilogue goes through shared memory and fuses bias, relu/elu and the
//   bf16 rounding.
// TMA, wgmma, a ring of stages and keeping all 27 taps' weights resident are
// later work.
//
// Requirements checked by the Python wrapper: C % 8 == 0, Cout % 8 == 0,
// contiguous tensors (16-byte aligned rows).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;      // output voxels per block (one row segment)
constexpr int KC = 16;       // input channels per K chunk
constexpr int THREADS = 256; // 8 warps x 16 voxels = BM

enum { ACT_LINEAR = 0, ACT_RELU = 1, ACT_ELU = 2 };

template <int BN, int ACT>
__global__ void __launch_bounds__(THREADS)
conv3x3x3_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ y,
                 int D, int H, int W, int C, int Cout, int n_co_tiles) {
  constexpr int IN_ELEMS = 3 * (BM + 2) * KC;
  constexpr int W_ELEMS = 9 * KC * BN;
  constexpr int STAGE_BYTES = (IN_ELEMS + W_ELEMS) * 2;
  constexpr int EPI_BYTES = BM * BN * 4;
  constexpr int SMEM = STAGE_BYTES > EPI_BYTES ? STAGE_BYTES : EPI_BYTES;
  static_assert(SMEM <= 48 * 1024, "static shared memory limit");
  static_assert((IN_ELEMS * 2) % 32 == 0, "wmma pointer alignment");
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* in_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [3][BM+2][KC]
  __nv_bfloat16* w_s = in_s + IN_ELEMS;                            // [9][KC][BN]
  float* out_s = reinterpret_cast<float*>(smem);                    // [BM][BN], after the K loop

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int x0 = blockIdx.x * BM;
  const int row = blockIdx.y;
  const int z = blockIdx.z / n_co_tiles;
  const int co0 = (blockIdx.z % n_co_tiles) * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int i = 0; i < BN / 16; ++i) wmma::fill_fragment(acc[i], 0.0f);

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const size_t plane = (size_t)H * W;
  for (int c0 = 0; c0 < C; c0 += KC) {
    for (int dz = 0; dz < 3; ++dz) {
      const int zz = z + dz - 1;
      if (zz < 0 || zz >= D) continue;   // uniform over the block
      // halo tile of plane zz: rows row-1..row+1, pixels x0-1..x0+BM,
      // channels c0..c0+15
      for (int t = tid; t < 3 * (BM + 2) * 2; t += THREADS) {
        const int g = t & 1;
        const int px = (t >> 1) % (BM + 2);
        const int r = (t >> 1) / (BM + 2);
        const int yy = row + r - 1;
        const int xx = x0 + px - 1;
        const int c = c0 + g * 8;
        uint4 v = zero;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W && c < C)
          v = *reinterpret_cast<const uint4*>(
              x + ((size_t)zz * plane + (size_t)yy * W + xx) * C + c);
        *reinterpret_cast<uint4*>(in_s + (r * (BM + 2) + px) * KC + g * 8) = v;
      }
      // weight slice of plane dz: 9 taps x channels c0..c0+15 x Cout co0..co0+BN-1
      for (int t = tid; t < 9 * KC * (BN / 8); t += THREADS) {
        const int ng = t % (BN / 8);
        const int k = (t / (BN / 8)) % KC;
        const int tap = t / (BN / 8) / KC;
        const int c = c0 + k;
        const int co = co0 + ng * 8;
        uint4 v = zero;
        if (c < C && co < Cout)
          v = *reinterpret_cast<const uint4*>(
              w + (size_t)((dz * 9 + tap) * C + c) * Cout + co);
        *reinterpret_cast<uint4*>(w_s + (tap * KC + k) * BN + ng * 8) = v;
      }
      __syncthreads();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3;
        const int dx = tap % 3;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, in_s + (dy * (BM + 2) + warp * 16 + dx) * KC, KC);
#pragma unroll
        for (int nb = 0; nb < BN / 16; ++nb) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, w_s + tap * KC * BN + nb * 16, BN);
          wmma::mma_sync(acc[nb], a, b, acc[nb]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int nb = 0; nb < BN / 16; ++nb)
    wmma::store_matrix_sync(out_s + warp * 16 * BN + nb * 16, acc[nb], BN,
                            wmma::mem_row_major);
  __syncthreads();
  const size_t out_row = ((size_t)z * H + row) * W;
  for (int t = tid; t < BM * BN; t += THREADS) {
    const int m = t / BN;
    const int n = t % BN;
    const int xx = x0 + m;
    const int co = co0 + n;
    if (xx < W && co < Cout) {
      float v = out_s[t] + bias[co];
      if (ACT == ACT_RELU) v = fmaxf(v, 0.0f);
      if (ACT == ACT_ELU) v = v > 0.0f ? v : expm1f(v);
      y[(out_row + xx) * Cout + co] = __float2bfloat16_rn(v);
    }
  }
}

template <int BN>
cudaError_t launch_bn(const __nv_bfloat16* x, const __nv_bfloat16* w,
                      const float* b, __nv_bfloat16* y, int D, int H, int W,
                      int C, int Cout, int act, cudaStream_t stream) {
  const int n_co_tiles = (Cout + BN - 1) / BN;
  if ((long long)D * n_co_tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid((W + BM - 1) / BM, H, D * n_co_tiles);
  dim3 block(THREADS);
  switch (act) {
    case ACT_LINEAR:
      conv3x3x3_kernel<BN, ACT_LINEAR><<<grid, block, 0, stream>>>(
          x, w, b, y, D, H, W, C, Cout, n_co_tiles);
      break;
    case ACT_RELU:
      conv3x3x3_kernel<BN, ACT_RELU><<<grid, block, 0, stream>>>(
          x, w, b, y, D, H, W, C, Cout, n_co_tiles);
      break;
    case ACT_ELU:
      conv3x3x3_kernel<BN, ACT_ELU><<<grid, block, 0, stream>>>(
          x, w, b, y, D, H, W, C, Cout, n_co_tiles);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x (D, H, W, C) bf16, w (3, 3, 3, C, Cout) bf16, bias (Cout,) f32 ->
// y (D, H, W, Cout) bf16. act: 0 linear, 1 relu, 2 elu. Returns
// cudaGetLastError() after the launch.
extern "C" int conv3x3x3_bf16_dhwc(const void* x, const void* w, const void* bias,
                                   void* y, int D, int H, int W, int C, int Cout,
                                   int act, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || C % 8 || Cout % 8 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const float* bb = static_cast<const float*>(bias);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Cout <= 16)
    err = launch_bn<16>(xb, wb, bb, yb, D, H, W, C, Cout, act, s);
  else if (Cout <= 32)
    err = launch_bn<32>(xb, wb, bb, yb, D, H, W, C, Cout, act, s);
  else
    err = launch_bn<64>(xb, wb, bb, yb, D, H, W, C, Cout, act, s);
  return (int)err;
}
