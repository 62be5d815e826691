// SAME 3x3 (2D) and 3x3x3 (3D) convolution + bias + activation for Hopper
// (sm_90a): bf16 in and out, f32 accumulation, channels-last activations.
// One kernel serves both ranks; conv3x3.cu and conv3x3x3.cu are its entry
// points. It replaces the Pallas TPU kernels of
// stardist_tpu/ops/conv_pallas.py: _conv_kernel_v3 (:393), _conv_kernel
// (:70), _conv_kernel_v2 (:188) in 2D and _conv3d_kernel (:574) in 3D.
//
//   y[z, r, x, co] = act(b[co] + sum_{dz,dy,dx,c} w[dz, dy, dx, c, co]
//                                   * x[z+dz-1, r+dy-1, x+dx-1, c])
//
// An implicit GEMM: M = output pixels, N = Cout, K = taps * C. A 3D conv is
// three 2D convs over the input planes z-1, z, z+1 summed into one
// accumulator, so both ranks run the same stage: one input plane's halo
// tile of one K chunk of KC channels, and the 9 (dy, dx) taps as 9 shifted
// views of it (no im2col anywhere).
//
// What bounds it on the H100: the layers of the StarDist U-Nets have K and N
// of 8..256, so at C, Cout <= 64 a layer is bound by device memory (the
// activations, read and written once) and above it by the bf16 tensor cores.
// The design moves each byte once from device memory and keeps the tensor
// cores fed from shared memory:
// - persistent grid: one block per SM (two at N <= 64) walks output tiles
//   of TILE_M = 128 pixels (th x tw pixels of one plane, chosen per layer by
//   the host-side planner in ops/conv.py), each block computing all Cout
//   (N <= 256, two n128 wgmmas at 256), so no halo is staged twice for Cout
//   tiles;
// - warp specialisation: one producer warp issues TMA loads
//   (cp.async.bulk.tensor, 4-D map over (C, W, H, D)) of each stage's halo
//   box (KC, tw + 2, th + 2, 1) into a ring of shared-memory stages tracked
//   by full/empty mbarriers; TMA fills out-of-bounds elements (negative
//   coordinates included) with zeros, which is the SAME padding at every
//   edge and face and the ragged tile at every border;
// - resident weights: the host packs the weights once per layer into the
//   exact image the wgmma B operand wants (ops/conv.py::pack_weights: per
//   k16 step, 8x8 core matrices, K-major, no swizzle) and a block loads the
//   whole image with one bulk copy at its start; where it does not fit
//   beside the ring, each stage carries its chunk's weight slice instead
//   (streamed from L2);
// - two consumer warpgroups (64 output pixels each) run wgmma.mma_async
//   m64nNk16 with f32 accumulators in registers; A comes from registers
//   (ldmatrix from the shifted view: a tap's view starts at any pixel, which
//   a shared-memory A descriptor cannot address inside a swizzled tile), B
//   from shared memory by descriptor. The halo box is stored with the TMA
//   swizzle that matches its row of KC channels (128/64/32 B, none at
//   KC = 8), so the eight rows an ldmatrix reads fall in distinct banks;
// - epilogue: bias, relu/elu and the bf16 rounding in registers. At
//   N = 64 and 128 the tile is staged in shared memory as slabs of SW = 64
//   (or 32, 16, 8) channels, each written by one TMA store (a second 4-D
//   map over the output; TMA drops the rows and columns past the image's
//   edge) that runs while the next tile's MMAs start; the slabs carry the
//   swizzle of their row width, so the staging writes are free of bank
//   conflicts. At N <= 32 and N = 256 each thread stores its channel pairs
//   straight from the registers: measured on the H100, the staged store
//   made the N = 32 layers 10-20% slower (and N = 256 spilled registers),
//   while it made the N = 64 / 128 layers 10-25% faster.
// - C = 8 (the C_in = 1 first layer, padded to 8 by the wrapper) takes
//   KC = 8: one k16 step covers two taps, so no zero channels are added
//   beyond those 8.
// Deterministic and independent of position: a pixel's sum runs over the
// chunks, planes, taps and k16 steps in one fixed order, whatever tile or
// block holds it; KC depends only on (C, Cout), not on the spatial size.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_sm90 {

constexpr int TILE_M = 128;                   // output pixels per tile
constexpr int CONSUMERS = 2;                  // consumer warpgroups (m64 each)
constexpr int THREADS = CONSUMERS * 128 + 32; // + the producer warp
constexpr int MAX_STAGES = 8;
constexpr int SMEM_SM = 233472;               // shared memory of one SM
constexpr int SMEM_RESERVED = 1024;           // taken by the system from each block
constexpr int SMEM_SLACK = 1024;              // to align the stages to 1024 B
constexpr int BAR_BYTES = 256;                // full[8], empty[8], the weight barrier

enum { ACT_LINEAR = 0, ACT_RELU = 1, ACT_ELU = 2 };

struct Params {
  const __nv_bfloat16* wimg;  // packed weights, ops/conv.py::pack_weights
  const float* bias;          // (BN,) f32, zero-padded
  __nv_bfloat16* y;           // pixel (z, r, x), channel co at ((z*H + r)*W + x)*ldy + co
  int ldy;                    // channels per output pixel in memory
  int D, H, W;                // spatial size of input and output; D = 1 in 2D
  int cout;                   // channels written, a multiple of 8, <= BN
  int sw;                     // channels of one staged output slab (64, 32, 16 or 8)
  int planes;                 // input planes per output plane: 1 (2D) or 3 (3D)
  int n_chunks;               // C / KC
  int th, tw;                 // tile rows and columns, th * tw = TILE_M
  int n_tiles;
  int stages;                 // ring depth, <= MAX_STAGES
  int resident;               // 1: all weights in shared memory; 0: one slice per stage
  int act;
};

__host__ __device__ constexpr int steps_per_stage(int kc) { return (9 * kc + 15) / 16; }
// whether a wgmma width writes its output tile through shared memory and TMA
__host__ __device__ constexpr bool staged_store(int bn) { return bn == 64 || bn == 128; }
// Blocks resident on one SM. A tile's MMAs, epilogue and barrier waits run
// one after the other in its block; at N <= 64 the MMAs are short, so two
// blocks per SM (each with half the shared memory and at most 85 registers a
// thread) overlap one tile's epilogue and waits with another's MMAs
// (measured on the H100: the N = 32 layers 20-30% faster, the N = 64 ones
// 25-35%).
__host__ __device__ constexpr int blocks_per_sm(int bn) { return bn <= 64 ? 2 : 1; }
__host__ __device__ constexpr int smem_limit(int bn) {
  return SMEM_SM / blocks_per_sm(bn) - SMEM_RESERVED;
}
__host__ __device__ constexpr uint32_t align1024(uint32_t b) { return (b + 1023u) & ~1023u; }

// Shared-memory layout, computed alike here and in ops/conv.py::conv_plan.
struct Layout {
  uint32_t halo_bytes, halo_al, wslice, stage_bytes, w_bytes, out_bytes, smem;
  __host__ __device__ Layout(int kc, int bn, const Params& p) {
    halo_bytes = (uint32_t)(kc * 2 * (p.tw + 2) * (p.th + 2));
    halo_al = align1024(halo_bytes);
    wslice = (uint32_t)(steps_per_stage(kc) * bn * 32);
    stage_bytes = halo_al + (p.resident ? 0u : align1024(wslice));
    w_bytes = p.resident ? (uint32_t)(p.n_chunks * p.planes) * wslice : 0u;
    out_bytes = staged_store(bn) ? (uint32_t)(TILE_M * bn * 2) : 0u;   // the staged output tile
    smem = SMEM_SLACK + align1024(w_bytes) + out_bytes + p.stages * stage_bytes + BAR_BYTES;
  }
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait that never ends (a copy that faulted) traps after ~2^26 polls
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++polls == (1u << 26)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until the bulk stores of this thread have read their shared memory
// (READ_ONLY) or are complete.
template <bool READ_ONLY>
__device__ __forceinline__ void tma_store_wait() {
  if constexpr (READ_ONLY)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Barrier of the consumer warpgroups alone (the producer warp never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(CONSUMERS * 128) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator register across a
// wgmma wait.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r) :: "memory"); }

// B descriptor, no swizzle, K-major: 8x8 core matrices of 128 contiguous
// bytes; the two of one k16 step lie 128 B apart (leading byte offset), the
// next 8 rows of N 256 B further (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// The TMA swizzle of a halo box whose pixel rows are KC * 2 bytes: the
// 16-byte chunk index (address bits 4..6) XOR the 128-byte line index
// (bits 7..9), over as many bits as the row has chunks.
__host__ __device__ constexpr uint32_t swizzle_mask(int row_elems) {
  return row_elems == 64 ? 7u : row_elems == 32 ? 3u : row_elems == 16 ? 1u : 0u;
}
template <int KC>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & swizzle_mask(KC)) << 4);
}

// wgmma m64nNk16, f32 += bf16 x bf16, A from registers, B by descriptor.
__device__ __forceinline__ void wgmma_m64n16k16(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32k16(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc_b) {
  if constexpr (N == 16) wgmma_m64n16k16(d, a, desc_b);
  else if constexpr (N == 32) wgmma_m64n32k16(d, a, desc_b);
  else if constexpr (N == 64) wgmma_m64n64k16(d, a, desc_b);
  else wgmma_m64n128k16(d, a, desc_b);
}

// ---- the kernel -------------------------------------------------------------

// Byte offset (before the swizzle) in a stage's halo tile of the row that
// this lane gives ldmatrix for k16 step s. k8 unit q of the stage is tap
// q / (KC / 8), channels 8 * (q % (KC / 8)) of the chunk; lanes 0-15 address
// the step's first k8 unit, lanes 16-31 its second (hi). With KC = 8 a step
// spans two taps; the tenth (past tap 8) has zero weights and reads tap 8
// again.
template <int KC>
__device__ __forceinline__ uint32_t a_offset(int s, int pix0, int pitch, int hi) {
  constexpr int U = KC / 8;
  int pix, c8;
  if constexpr (KC >= 16) {
    const int tap = (2 * s) / U;
    pix = pix0 + (tap / 3) * pitch + tap % 3;
    c8 = (2 * s) % U + hi;
  } else {
    const int t0 = 2 * s, t1 = 2 * s + 1 < 9 ? 2 * s + 1 : 8;
    pix = pix0 + (hi ? (t1 / 3) * pitch + t1 % 3 : (t0 / 3) * pitch + t0 % 3);
    c8 = 0;
  }
  return (uint32_t)pix * (KC * 2) + c8 * 16;
}

// One stage's MMAs for one consumer warpgroup: STEPS k16 steps over the
// stage's halo tile `st` (A, by ldmatrix) and B slice `wb`. A narrow wgmma
// (m64n32k16 is 16 cycles of the SM's tensor cores) is shorter than the
// latency of loading its A fragment, so the steps go in groups of G: the A
// fragments of a group are loaded together, its G wgmmas issued back to
// back and committed as one group, and the next group's loads overlap them
// (two register buffers; wait_group 1 frees the older one).
template <int KC, int BN>
__device__ __forceinline__ void mma_stage(float (*acc)[BN < 128 ? BN / 2 : 64], uint32_t st,
                                          uint32_t wb, int pix0, int pitch, int hi) {
  constexpr int STEPS = steps_per_stage(KC);
  constexpr int NW = BN < 128 ? BN : 128;
  constexpr int G = BN <= 32 ? 4 : BN <= 128 ? 2 : 1;  // k16 steps per wgmma group
  constexpr int NG = (STEPS + G - 1) / G;
  uint32_t a[2][G][4];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (g * G + i < STEPS)
        ldmatrix_x4(a[g & 1][i], st + swizzle<KC>(a_offset<KC>(g * G + i, pix0, pitch, hi)));
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < G; ++i)
      if (g * G + i < STEPS)
#pragma unroll
        for (int h = 0; h < BN / NW; ++h)
          wgmma_rs<NW>(acc[h], a[g & 1][i], b_desc(wb + (g * G + i) * BN * 32 + h * NW * 32));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
}

// Bias, activation and bf16 rounding of output channels col, col + 1.
__device__ __forceinline__ __nv_bfloat162 epilogue_pair(float v0, float v1, const Params& p,
                                                        int col) {
  v0 += p.bias[col];
  v1 += p.bias[col + 1];
  if (p.act == ACT_RELU) {
    v0 = fmaxf(v0, 0.0f);
    v1 = fmaxf(v1, 0.0f);
  } else if (p.act == ACT_ELU) {
    v0 = v0 > 0.0f ? v0 : expm1f(v0);
    v1 = v1 > 0.0f ? v1 : expm1f(v1);
  }
  return __floats2bfloat162_rn(v0, v1);
}

template <int KC, int BN>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(BN))
conv_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
            const Params p) {
  constexpr int NW = BN < 128 ? BN : 128;
  constexpr int NSPLIT = BN / NW;
  extern __shared__ unsigned char smem_raw[];
  const Layout L(KC, BN, p);
  const uint32_t base = align1024(smem_u32(smem_raw));
  const uint32_t w_s = base;
  const uint32_t out_s = base + align1024(L.w_bytes);
  const uint32_t stage0 = out_s + L.out_bytes;
  const uint32_t bars = stage0 + p.stages * L.stage_bytes;
  const uint32_t wbar = bars + 16 * MAX_STAGES;
  const int kits = p.n_chunks * p.planes;
  const int pitch = p.tw + 2;
  const int tiles_x = (p.W + p.tw - 1) / p.tw;
  const int tiles_yx = tiles_x * ((p.H + p.th - 1) / p.th);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                          // full: the producer
      mbar_init(bars + 8 * (MAX_STAGES + s), CONSUMERS);   // empty: each warpgroup
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == CONSUMERS * 4) {
    // producer warp: one lane issues every copy
    if (lane == 0) {
      if (p.resident) {
        mbar_expect_tx(wbar, L.w_bytes);
        bulk_load(w_s, p.wimg, L.w_bytes, wbar);
      }
      const uint32_t tx = L.halo_bytes + (p.resident ? 0u : L.wslice);
      uint32_t it = 0;
      for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
        const int z = t / tiles_yx, ty = (t % tiles_yx) / tiles_x, tx0 = t % tiles_x;
        for (int k = 0; k < kits; ++k, ++it) {
          const uint32_t s = it % p.stages, use = it / p.stages;
          const uint32_t st = stage0 + s * L.stage_bytes;
          mbar_wait(bars + 8 * (MAX_STAGES + s), (use & 1) ^ 1);
          mbar_expect_tx(bars + 8 * s, tx);
          tma_load_4d(st, &xmap, bars + 8 * s, (k / p.planes) * KC, tx0 * p.tw - 1,
                      ty * p.th - 1, z + k % p.planes - p.planes / 2);
          if (!p.resident)
            bulk_load(st + L.halo_al, reinterpret_cast<const char*>(p.wimg) + (size_t)k * L.wslice,
                      L.wslice, bars + 8 * s);
        }
      }
    }
  } else {
    const int wg = warp / 4, wl = warp % 4;
    // the output pixel whose A row this lane addresses, as the halo pixel of tap (0, 0)
    const int m = wg * 64 + wl * 16 + (lane & 15);
    const int pix0 = (m / p.tw) * pitch + m % p.tw;
    const int hi = lane >> 4;
    const int r0 = wg * 64 + wl * 16 + lane / 4;   // this thread's output rows r0, r0 + 8
    const int cq = 2 * (lane & 3);
    const bool leader = threadIdx.x == 0;           // issues the tile's TMA store
    if (p.resident) mbar_wait(wbar, 0);
    float acc[NSPLIT][NW / 2];
    uint32_t it = 0;
    for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
      const int z = t / tiles_yx, ty = (t % tiles_yx) / tiles_x, tx0 = t % tiles_x;
#pragma unroll
      for (int h = 0; h < NSPLIT; ++h)
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) acc[h][i] = 0.0f;
      for (int k = 0; k < kits; ++k, ++it) {
        const uint32_t s = it % p.stages, use = it / p.stages;
        const uint32_t st = stage0 + s * L.stage_bytes;
        mbar_wait(bars + 8 * s, use & 1);
        mma_stage<KC, BN>(acc, st, p.resident ? w_s + k * L.wslice : st + L.halo_al, pix0,
                          pitch, hi);
        // every wgmma of this warpgroup that read stage s has completed
        if (threadIdx.x % 128 == 0) mbar_arrive(bars + 8 * (MAX_STAGES + s));
      }
#pragma unroll
      for (int h = 0; h < NSPLIT; ++h)
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) fence_reg(acc[h][i]);
      if constexpr (staged_store(BN)) {
        // the previous tile's store has read the staging tile
        if (leader) tma_store_wait<true>();
        consumers_sync();
        const uint32_t smask = swizzle_mask(p.sw);
        const int sw_log = __ffs(p.sw) - 1;
        const uint32_t slab_bytes = (uint32_t)(TILE_M * p.sw * 2);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t mrow = (uint32_t)((r0 + 8 * half) * p.sw * 2);
#pragma unroll
          for (int h = 0; h < NSPLIT; ++h)
#pragma unroll
            for (int j = 0; j < NW / 8; ++j) {
              const int col = h * NW + 8 * j + cq;
              if (col >= p.cout) continue;
              const __nv_bfloat162 v = epilogue_pair(acc[h][4 * j + 2 * half],
                                                     acc[h][4 * j + 2 * half + 1], p, col);
              const uint32_t off = mrow + (uint32_t)(col & (p.sw - 1)) * 2;
              const uint32_t dst = out_s + (col >> sw_log) * slab_bytes +
                                   (off ^ (((off >> 7) & smask) << 4));
              asm volatile("st.shared.b32 [%0], %1;"
                           :: "r"(dst), "r"(*reinterpret_cast<const uint32_t*>(&v)) : "memory");
            }
        }
        // make the staged tile visible to the TMA unit, then store its slabs
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        consumers_sync();
        if (leader)
          for (int c = 0; c < p.cout; c += p.sw)
            tma_store_4d(&ymap, out_s + (c / p.sw) * slab_bytes, c, tx0 * p.tw, ty * p.th, z);
      } else {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int mm = r0 + 8 * half;
          const int yy = ty * p.th + mm / p.tw, xx = tx0 * p.tw + mm % p.tw;
          if (yy >= p.H || xx >= p.W) continue;
          __nv_bfloat16* out = p.y + (((size_t)z * p.H + yy) * p.W + xx) * p.ldy;
#pragma unroll
          for (int h = 0; h < NSPLIT; ++h)
#pragma unroll
            for (int j = 0; j < NW / 8; ++j) {
              const int col = h * NW + 8 * j + cq;
              if (col >= p.cout) continue;
              *reinterpret_cast<__nv_bfloat162*>(out + col) = epilogue_pair(
                  acc[h][4 * j + 2 * half], acc[h][4 * j + 2 * half + 1], p, col);
            }
        }
      }
    }
    if (staged_store(BN) && leader) tma_store_wait<false>();
  }
}

// ---- host side --------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so
// that the library needs no link against libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

template <int KC, int BN>
cudaError_t launch_kc_bn(const CUtensorMap& xmap, const CUtensorMap& ymap, const Params& p,
                         int smem, int grid, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(conv_kernel<KC, BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  conv_kernel<KC, BN><<<grid, THREADS, smem, stream>>>(xmap, ymap, p);
  return cudaGetLastError();
}

template <int KC>
cudaError_t launch_kc(int bn, const CUtensorMap& xmap, const CUtensorMap& ymap, const Params& p,
                      int smem, int grid, cudaStream_t stream) {
  switch (bn) {
    case 16: return launch_kc_bn<KC, 16>(xmap, ymap, p, smem, grid, stream);
    case 32: return launch_kc_bn<KC, 32>(xmap, ymap, p, smem, grid, stream);
    case 64: return launch_kc_bn<KC, 64>(xmap, ymap, p, smem, grid, stream);
    case 128: return launch_kc_bn<KC, 128>(xmap, ymap, p, smem, grid, stream);
    case 256: return launch_kc_bn<KC, 256>(xmap, ymap, p, smem, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

// x (D, H, W, C) bf16 (D = 1 in 2D), contiguous and 16-byte aligned;
// wimg, bias as packed by ops/conv.py for (kc, bn); y: pixel (z, r, x),
// channel co at ((z * H + r) * W + x) * ldy + co, 16-byte aligned.
// Returns a cudaError_t (cudaErrorInvalidValue for a plan the kernel cannot
// take, cudaErrorNotSupported when the driver gives no tensor-map encoder).
inline int run_conv(const void* x, const void* wimg, const void* bias, void* y, int D, int H,
                    int W, int C, int cout, int ldy, int planes, int act, int kc, int bn,
                    int resident, int stages, int th, int tw, void* stream) {
  if (D <= 0 || H <= 0 || W <= 0 || C <= 0 || C % kc || cout <= 0 || cout % 8 || cout > bn ||
      ldy < cout || ldy % 8 || (planes != 1 && planes != 3) || act < 0 || act > 2 ||
      stages < 2 || stages > MAX_STAGES || th * tw != TILE_M || tw + 2 > 256 || th + 2 > 256 ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(wimg) & 15) ||
      (reinterpret_cast<uintptr_t>(y) & 15))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.wimg = static_cast<const __nv_bfloat16*>(wimg);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.ldy = ldy;
  p.D = D; p.H = H; p.W = W;
  p.cout = cout; p.planes = planes; p.n_chunks = C / kc;
  p.sw = cout % 64 == 0 ? 64 : cout % 32 == 0 ? 32 : cout % 16 == 0 ? 16 : 8;
  p.th = th; p.tw = tw;
  p.n_tiles = D * ((H + th - 1) / th) * ((W + tw - 1) / tw);
  p.stages = stages; p.resident = resident ? 1 : 0; p.act = act;
  const Layout L(kc, bn, p);
  if (L.smem > (uint32_t)smem_limit(bn)) return (int)cudaErrorInvalidValue;

  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // input: the halo box of one plane and K chunk; output: one tile, all cout
  CUtensorMap xmap, ymap;
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D};
  const cuuint64_t xstrides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                  (cuuint64_t)H * W * C * 2};
  const cuuint32_t xbox[4] = {(cuuint32_t)kc, (cuuint32_t)(tw + 2), (cuuint32_t)(th + 2), 1};
  const cuuint64_t ydims[4] = {(cuuint64_t)cout, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D};
  const cuuint64_t ystrides[3] = {(cuuint64_t)ldy * 2, (cuuint64_t)W * ldy * 2,
                                  (cuuint64_t)H * W * ldy * 2};
  const cuuint32_t ybox[4] = {(cuuint32_t)p.sw, (cuuint32_t)tw, (cuuint32_t)th, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  // a row of kc (sw) bf16 elements takes the swizzle of its width
  auto swizzle_of = [](int row_elems) {
    return row_elems == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
           : row_elems == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
           : row_elems == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                             : CU_TENSOR_MAP_SWIZZLE_NONE;
  };
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdims, xstrides,
             xbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(kc),
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&ymap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, y, ydims, ystrides, ybox, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(p.sw), CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  const int slots = n_sm * blocks_per_sm(bn);
  const int grid = p.n_tiles < slots ? p.n_tiles : slots;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kc) {
    case 8: return (int)launch_kc<8>(bn, xmap, ymap, p, (int)L.smem, grid, s);
    case 16: return (int)launch_kc<16>(bn, xmap, ymap, p, (int)L.smem, grid, s);
    case 32: return (int)launch_kc<32>(bn, xmap, ymap, p, (int)L.smem, grid, s);
    case 64: return (int)launch_kc<64>(bn, xmap, ymap, p, (int)L.smem, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace conv_sm90
