// 3x3 SAME convolution + bias + activation on channels-last (H, W, C) bf16
// activations: the 2D entry point of the Hopper conv kernel in
// conv_sm90.cuh (TMA ring, wgmma, resident or streamed weights; see there
// for the design and what bounds it).
//
// Replaces the Pallas TPU kernels of stardist_tpu/ops/conv_pallas.py:
// _conv_kernel_v3 (:393, halo in kernel, whole-row tiles), _conv_kernel
// (:70, padded input, shift ring) and _conv_kernel_v2 (:188, dy taps stacked
// in M). All three compute the same op for conv2d_hcw; on Hopper one kernel
// does.
#include "conv_sm90.cuh"

// x (H, W, C) bf16; wimg, bias packed by ops/conv.py::pack_weights for
// (kc, bn); y: pixel (r, x), channel co at (r * W + x) * ldy + co. The plan
// (kc, bn, resident, stages, th, tw) comes from ops/conv.py::conv_plan.
// act: 0 linear, 1 relu, 2 elu. Returns cudaGetLastError() after the launch.
extern "C" int conv3x3_bf16_hwc(const void* x, const void* wimg, const void* bias, void* y,
                                int H, int W, int C, int cout, int ldy, int act, int kc, int bn,
                                int resident, int stages, int th, int tw, void* stream) {
  return conv_sm90::run_conv(x, wimg, bias, y, 1, H, W, C, cout, ldy, 1, act, kc, bn, resident,
                             stages, th, tw, stream);
}
