// 3x3x3 SAME convolution + bias + activation on channels-last (D, H, W, C)
// bf16 activations: the 3D entry point of the Hopper conv kernel in
// conv_sm90.cuh, which runs it as three 2D convs over the input planes
// z - 1, z, z + 1 summed into one accumulator (TMA ring, wgmma, resident or
// streamed weights; see there for the design and what bounds it).
//
// Replaces the Pallas TPU kernel of stardist_tpu/ops/conv_pallas.py:
// _conv3d_kernel (:574, called by _conv3d_hcw_call, wrapper conv3d_hcw),
// which runs every conv of the 3D U-Net.
#include "conv_sm90.cuh"

// x (D, H, W, C) bf16; wimg, bias packed by ops/conv.py::pack_weights for
// (kc, bn); y: voxel (z, r, x), channel co at ((z * H + r) * W + x) * ldy + co.
// The plan (kc, bn, resident, stages, th, tw) comes from
// ops/conv.py::conv_plan. act: 0 linear, 1 relu, 2 elu. Returns
// cudaGetLastError() after the launch.
extern "C" int conv3x3x3_bf16_dhwc(const void* x, const void* wimg, const void* bias, void* y,
                                   int D, int H, int W, int C, int cout, int ldy, int act,
                                   int kc, int bn, int resident, int stages, int th, int tw,
                                   void* stream) {
  return conv_sm90::run_conv(x, wimg, bias, y, D, H, W, C, cout, ldy, 3, act, kc, bn, resident,
                             stages, th, tw, stream);
}
