"""Smoke run of stardist_torch on one CUDA card.

    python3 chip_smoke.py [--phases bcdefghijklmnopqrstuvwx]

Phases (each prints one line; any failed check exits non-zero):
  (a) the card's name and power limit; build the five CUDA kernels from
      stardist_torch/csrc (one nvcc each, all at once) and time the builds;
      with (b) or (f), the conv kernels' registers and spills, with (h) the
      lattice kernel's, from a second compile of their sources with
      ptxas's report, made in the same pool;
  (b) conv kernel vs its plain version at every layer shape of the
      full-width StarDist 2D forward (Config2D() defaults) on a 4096^2
      image; per shape and in total: the kernel's time, the cuDNN yardstick
      (one bf16 channels-last F.conv2d call), the plain version's, the bound
      (the larger of FLOPs over the bf16 peak and bytes over the HBM rate)
      and the kernel's share of it;
  (c) pair kernel vs its plain version on 10^5 seeded random polygon pairs
      at S = 8 and S = 16: results must be exactly equal; times and bound;
      then exact equality at R = 3, 32 and 128 on random pairs and on pairs
      whose samples sit where the kernel's wedge lookup is most likely to go
      wrong (adversarial_offsets);
  (d) the full-width forward at 4096^2 with seeded random weights, kernel
      path vs plain path;
  (e) StarDist2D(None, "2D_demo", "models/examples").predict_instances on a
      synthetic nuclei field of 2048^2 on the card: stage times, counts,
      AP@0.5 (StarDist's matching accuracy) against the field's ground truth,
      launch counts of the conv, pair and raster kernels, the exact pairs
      at S = 8 and at S = 16, and the pair kernel's bound for them; one
      nms_polygons call on the same candidates split by torch.profiler
      (nms_profile), and the raster stage split (raster_split); then 1024^2
      on the card against the same call on the CPU;
  (f) conv3d kernel vs its plain version at every layer shape of the
      full-width StarDist 3D forward (Config3D(grid=(1, 2, 2)), 96 rays,
      depth 2, 32 filters) on a 64x512x512 volume; times, the cuDNN
      yardstick (F.conv3d) and the bound, as in (b);
  (g) that full-width 3D forward with seeded random weights, kernel path
      vs plain path;
  (h) StarDist3D(None, "3D_demo", "models/examples").predict_instances on
      the benchmark's synthetic 3D nuclei field, 64x256x256, on the card:
      stage times, counts, AP@0.1 against the field's ground truth, the
      conv3d launch count and the lattice kernel's (one per exact round);
      then the lattice kernel alone on that call's exact pairs at S = 10
      and 12 (H_LATTICE_S): counts exactly the plain twin's, its time (CUDA
      events), the call's, the plain twin's on the card, and its bound
      (lattice_bound: the lattice points and those inside the first
      polyhedron, F face tests each, at the f32 peak); then a 32x96x96 crop
      on the card against the same call on the CPU;
  (i) raster kernel vs its plain version on three seeded polygon fields (the
      4096^2 bench-shaped field, ~7k polygons; a dense 2048^2 field of 60k
      overlapping ones; an adversarial 2048^2 field, adversarial_polygons):
      labels must be exactly equal, with the 32- and the 64-bit packing and
      int32 and uint16 output; times of the kernel + memset and of the call
      (both packings) and of the plain version, by CUDA events, and the
      bound of the function counted from the field; then 66k polygons, more
      than the 32-bit packing holds, equal too; then the bench-shaped and the
      adversarial field drawn with scale_dist (0.5, 0.5), (1.0, 0.5) and
      (2.0, 1.0) about non-integer centres (scaled_field): labels exactly
      the plain twin's with both packings, and the kernel + memset and call
      times beside the unscaled kernel's on the same centres;
  (j) StarDist2D.predict_instances_device (2D_demo, 2048^2): labels and
      survivors must equal predict_instances on the card exactly, for a
      numpy and a pre-staged CUDA tensor input; walls with fetch=True and
      fetch=False, stage times, the host syncs of one call
      (torch.cuda.set_sync_debug_mode) and the kernels' launch counts; then
      the median walls of 5 rounds of predict_instances and the device path
      (fetch=True, fetch=False) called in turn, with their stage times;
  (k) tiled predict_instances (2D_demo) on the 4096^2 synthetic field,
      n_tiles=(2, 2) against (1, 1): matching accuracy >= 0.99, walls and
      stage times (forward, extract, NMS, raster; and their medians over 3
      rounds in turn), launch counts, and where the
      two differ: the differing pixels and survivors, in all and within
      the tiles' overlap band around a seam, and the dense prediction's
      largest differences, tiled against untiled; and the untiled call's
      nms_polygons split by torch.profiler and its raster stage split;
  (l) 2D training at full width (Config2D(grid=(2, 2)): 256^2 patches,
      batch 4) on eight seeded 1024^2 synthetic nuclei fields: on one fixed
      raw batch with the same weights and TF32 off, the card's fused
      targets against the CPU port's (dist exactly, prob within
      TARGET_TOL), its loss and metrics (rtol METRIC_RTOL) and every
      parameter's gradient (within GRAD_TOL of its largest magnitude); then
      StarDist2D.train for 2 epochs x 25 steps from the seeded init, with
      TF32 off and on: finite losses, the last 10 steps' mean below the
      first 10's, steps/s, the step split (the wait for the producer by the
      host clock; upload, targets, forward + backward, optimizer by CUDA
      events), peak memory, the host syncs of one step and the device busy
      share of 10 steps (torch.profiler); then the trained net's kernel
      path against its plain path (FWD_TOL: the packed weights followed
      Adam's updates), and weights_best.h5 loaded into a fresh model that
      serves predict_instances through the conv, pair and raster kernels
      and agrees with the same file loaded on the CPU;
  (m) StarDist2D(None, "2D_demo", ...).optimize_thresholds on three seeded
      1024^2 synthetic nuclei fields with the reference's defaults
      (nms_threshs 0.3, 0.4, 0.5; golden section, tol 1e-2, maxiter 20;
      n_tiles from _guess_n_tiles): the thresholds, the measure of
      predict_instances at them, the wall split into predict, extraction,
      the prefix NMS calls (images x nms_threshs), the probes (count, and
      per probe the raster with the labels' copy, and the matching), one
      probe's raster stage split, and the conv, pair and raster launches
      (each nonzero); thresholds.json reloaded; on one 512^2 field's dense
      prediction, the card's keep flags and (prob_thresh, measure) exactly
      the CPU port's; then predict_instances on the 2048^2 field with
      sparse=False (labels exactly sparse=True's) and scale=0.5, their
      AP@0.5 and stage times, and the scaled call on a 512^2 crop against
      the CPU (matching accuracy >= 0.99, as in (e));
  (n) 3D training with the configuration of upstream StarDist's
      examples/3D/2_training.ipynb: Rays_GoldenSpiral(96) and the grid from
      the anisotropy of the training labels' extents (calculate_extents),
      48x96x96 patches, batch 2, the ResNet backbone, on eight seeded
      64x192x192 synthetic nuclei volumes (two for validation): on one
      fixed raw batch with the same weights and TF32 off, the card's fused
      targets exactly the CPU port's, its loss and metrics (METRIC_RTOL) and
      gradients (GRAD_TOL), and the targets' split (EDT, march) by CUDA
      events; StarDist3D.train 2 epochs x 10 steps (TF32 off): finite
      losses, the last 5 steps' mean below the first 5's, steps/s, the step
      split at model.step_marks, peak memory, the producer's host work per
      batch, the device busy share of 3 steps (torch.profiler);
      weights_best.h5 reloaded on the card (the port's reader) and on the
      CPU, forwards within FWD_TOL; then the same configuration with the
      U-Net for 1 epoch x 5 steps, and predict_instances with its
      weights_best.h5 through the conv3d kernel (one launch per conv);
  (o) the rest of the 3D surface, 3D_demo on the 64x256x256 field of (h):
      predict_instances_device with fetch=True equal to predict_instances
      with nms_kwargs={"samples": 10} (the reference's device lattice),
      fetch=False's CUDA tensors equal too, sparse=False equal to
      sparse=True, scale=(1, 0.5, 0.5) and overlap_label=-1; each call's
      wall and stages and the conv3d launches; on a 32x64x64 crop the
      CPU's candidates through the card's and the CPU's NMS and raster with
      scale and overlap_label: labels exactly equal;
  (p) multiclass 2D: the published Config2D() at full width with three
      input channels and six classes (grid 2), seeded weights, 4096^2:
      kernel path vs plain for prob, dist and prob_class, and the conv
      kernel at the two layers the other nets lack (the C = 3 first layer,
      the class branch's feature conv) against cuDNN, plain and the bound,
      as (b); eight seeded 1024^2 three-channel fields whose nuclei carry a
      seeded class 1..6: one host-built batch (class maps included) card vs
      CPU with TF32 off (targets exactly, loss, prob_class_loss and metrics
      within METRIC_RTOL, gradients within GRAD_TOL), StarDist2D.train 2 x
      10 steps (finite losses, prob_class_loss falling; steps/s and the step
      split); a seeded six-class branch grafted on 2D_demo (grafted): on
      (e)'s 2048^2 field the labels and survivors exactly 2D_demo's,
      class_prob the dense class map at the survivors, class_id its argmax,
      predict_instances_device equal with fetch=True and fetch=False (class
      rows on the card), walls against 2D_demo's in turn, launches; at
      1024^2 the card's candidates through the card's and the CPU's NMS and
      raster (labels and class rows equal); the class logits (log
      prob_class, centred) card vs the CPU's bf16 plain path within FWD_TOL
      of their largest magnitude, as dist in (d), the class_id flips only
      at top-two logit margins inside the largest logit difference, and
      matching accuracy against the CPU's f32 path >= 0.99;
  (q) multiclass 3D: a two-class branch grafted on 3D_demo, (h)'s
      64x256x256 field: labels equal 3D_demo's, class_prob the class map at
      the survivors, the conv3d kernel at every conv (the class conv too);
      the 32x96x96 crop's candidates card vs CPU, the class logits within
      FWD_TOL of the CPU's bf16 plain path, as in (p);
      then (n)'s notebook configuration (ResNet) with n_classes=2: one step
      card vs CPU and 1 x 5 steps on the card;
  (r) predict_instances_big: 2D_demo on a seeded 8192^2 field, blocks of
      4096 with min_overlap and context 128, against one predict_instances
      call on the field (matching accuracy >= 0.99): walls, blocks,
      objects, peak memory, the raster packing each call ran; then the
      grafted six-class 2D_demo block-wise at 4096^2 with blocks of 2048:
      one class row per object;
  (s) the parallel layer's block-wise prediction on (r)'s field and
      blocks: predict_instances_big_sharded with devices=[cuda:0] and with
      two slots on the card (one model replica each), labels against
      predict_instances_big's (matching accuracy 1.0 at IoU 0.99, the same
      object count), the three calls' walls (median of SHARDED_ROUNDS
      rounds in turn), the reader's wait, forward and stitch split, peak
      memory, launches (the conv once per conv and block, the raster once
      per block); then predict_instances_big_multihost on 2 gloo ranks
      spawned on the card (run_ranks; a rank's failure or a timeout fails
      the phase), both stitch modes: replicated, each rank's labels exactly
      predict_instances_big's (by hash); partitioned, the ranks' writes
      into one shared np.memmap exactly them; every object key equal on
      both ranks in both modes; each rank's blocks, walls, the exchange's
      bytes and time, peak memory and launches;
  (t) data-parallel training with (l)'s configuration (TensorBoard off),
      TF32 off: 2 gloo ranks on the card, each on its rows of the same
      stream, against one process on the whole batch: one fixed raw batch's
      gradients on rank 0 within DP_GRAD_TOL of their largest magnitude,
      DP_STEPS losses of StarDist2D.train within DP_LOSS_RTOL, the same on
      both ranks; steps/s of both and the step split (the all-reduce by
      CUDA events); dryrun_multichip(2, device="cuda"); then rank 0's
      weights_best.h5 served through the kernels (kernel path vs plain
      within FWD_TOL; the pair kernel runs exactly when the NMS has pairs);
  (u) the imports: StarDist2D.from_pretrained("2D_demo") on the card, and
      from a file:// zip of it built in build/ (md5 checked, a wrong md5
      refused, the port's own cache): labels exactly
      StarDist2D(None, "2D_demo", "models/examples")'s on (e)'s 2048^2
      field; the native host library (stardist_torch/lib) built with g++
      and held against the card: star distances (grid 1 and 2) and the
      survivors' labels exactly, the NMS keep flags of (e)'s candidates
      equal. The Keras HDF5 import is not driven here (no h5py on the
      card's machine); the phase says so;
  (v) the interop surface on the card: (e)'s 2048^2 field written as a
      uint16 tiff and run through the prediction CLI
      (stardist_torch.scripts.predict2d: make_parser(2), run(args,
      StarDist2D, 2)) with 2D_demo, untiled and with --n_tiles 2 2: the
      label file read back exactly the in-process predict_instances of
      normalize(img, 1, 99.8), the walls (host clock) and the conv, pair and
      raster launches (each nonzero); the 3D CLI with 3D_demo on a
      64x128x128 crop of (h)'s field, equal too, with its conv3d launches;
      predict_sparse(device_dist=True) on (e)'s field: dist a CUDA tensor
      whose rows, prob and points are exactly device_dist=False's; one
      predict_instances at 1024^2 inside core.profiling.trace, in a fresh
      process (trace_child): the Chrome trace names the conv, pair and
      raster kernels' __global__ functions;
      Timer laps with device_sync; data.test_image_nuclei_2d through
      2D_demo on the card, AP@0.5 against its mask, against the CPU port's
      call at the card's precision, bf16 (matching accuracy >= 0.99), and
      in f32 (printed); then, each only where its package
      is installed (importlib.util.find_spec): export_TF (the SavedModel's
      output within FWD_TOL of the card's predict; TensorFlow kept on the
      host), export_bioimageio + import_bioimageio (the imported model's
      predict on the card exactly the exported one's) and render_label.
      Where imageio is missing, the CLI's _imread / _imwrite are swapped
      for np.load / np.save here (never a CLI option); the line says so;
  (w) the network options: the published Config2D() (grid 1) at 2048^2
      with seeded weights, seeded batch-norm statistics (mean in +-0.1,
      var in [0.5, 2]) and a seeded dist bias of 6-12 pixels (so that the
      polygons overlap; seed_network_options), as a relu net, with batch
      norm (folded into the conv kernel's weights), with gelu (after the
      kernel's linear output) and with 5x5 kernels (cuDNN, no conv-kernel
      launch): each forward kernel path vs plain (FWD_TOL) and its time
      against the relu net's by CUDA events, the conv launches of one
      forward (batch norm: the relu net's count); predict_instances on
      (e)'s field at the prob_thresh that keeps ~8,000 candidates of the
      card's map (2,000-20,000 held), its launches (pair and raster
      nonzero), and a 512^2 crop card vs CPU at bf16 (matching >= 0.99;
      f32 printed); the 3D ResNet of upstream's notebook with batch norm,
      (1, 3, 3) kernels and he_uniform on a 64x128x128 crop of (h)'s
      volume (cuDNN; ~800 candidates), a 32x64x64 crop card vs CPU at bf16
      (>= 0.9); training Config2D(grid=(2, 2), unet_activation="swish",
      unet_kernel_size=(5, 5)) at 256^2 x 4: one batch card vs CPU (TF32
      off: loss within METRIC_RTOL) and 1 x 5 steps of StarDist2D.train
      (finite losses); the batch-norm net's train raising
      NotImplementedError;
  (x) the NMS's samples option and the prediction generators: the pair
      kernel against its plain version at S = 3, 5, 10, 12, 24 and 32 (10^5
      seeded random pairs at R = 32, timed beside the plain version and the
      bound; then R = 3, 32 and 128, random and adversarial pairs with each
      S's extent): exactly equal; 2D_demo on (e)'s 2048^2 field with
      nms_kwargs={"samples": S}, S = 10, 12 and 16: AP@0.5 >= 0.95, S = 16
      exactly the default call's labels, the scheduling options changing
      no label, the NMS stage, fine pairs and pair launches; (e)'s 1024^2
      crop, the card's candidates through the card's and the CPU's NMS and
      raster at S = 12: labels equal; 3D_demo on (h)'s field:
      predict_instances_device (fetch=True and fetch=False) exactly
      predict_instances(nms_kwargs={"samples": 10}), the survivors that
      differ from S = 12 and the walls; _predict_instances_generator on
      (k)'s 4096^2 field with n_tiles=(2, 2): "predict", 4 x "tile", "nms"
      and predict_instances' result; the host syncs of one device-path call
      equal those of its generator run by hand and (j)'s count;
  (y) the 3D raster kernel (csrc/raster_polyhedra.cu) on the survivors of
      one predict_instances call (raster3d_args): 3D_demo on (h)'s
      64x256x256 field, and the benchmark's notebook model
      (portbench/configs/3D_notebook) on a seeded 64x512x512 anisotropic
      stack of the benchmark's generator (portbench/frozen.py): labels and
      counts exactly the plain twin's on the CPU (3D_demo in the "full",
      "kernel" and "bbox" modes, the stack in "full"), the call's one
      launch, the kernel + memset and the call by CUDA events, the twin's
      host time, and the bound (raster3d_bound: each drawn polyhedron's
      clipped cube, F face tests a voxel, at the f32 peak); then seeded
      96-ray polyhedra (F = 188; polyhedra_field) exactly the twin's in
      every mode, with and without the count.
The line before the last is the kernels' JSON record (the launches of
(e), (h), (p), (q), (r), (s), (t), (u), (v), (w), (x) and (y)); the last line is
{"ok": true, "device": {...}}. With --phases, only (a) and the named phases
run (e.g. --phases k to time the tiled call alone), and neither line is
printed.

Imports torch, numpy, scipy and stardist_torch only (never JAX), and in (y)
the benchmark's stack generator from portbench/frozen.py.
"""
import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

CONV_TOL = 1e-2      # relative to max(1, |ref|max): bf16 outputs, f32 sums in another order
FWD_TOL = 2e-2       # prob absolute, dist relative to max(1, |dist|max)
FWD_SIZE = 4096      # full-width forward input, (b) and (d)
E2E_SIZE = 2048      # predict_instances field on the card, (e)
CMP_SIZE = 1024      # card vs CPU comparison field, (e)
N_PAIRS = 100_000    # (c)
FWD3D_SHAPE = (64, 512, 512)   # full-width 3D forward input, (f) and (g)
E2E3D_SHAPE = (64, 256, 256)   # 3D predict_instances field on the card, (h)
CMP3D_SHAPE = (32, 96, 96)     # card vs CPU comparison crop, (h)
H_LATTICE_S = (10, 12)         # (h): the lattice kernel timed on the call's exact pairs
RASTER_FIELDS = ((4096, 7000), (2048, 60_000))  # (i): (image side, polygons)
RASTER_ADVERSARIAL = (2048, 200)  # (i): image side, polygons of each adversarial kind
RASTER_MANY = (2048, 66_000)      # (i): more polygons than the 32-bit packing holds
RASTER_SCALES = ((0.5, 0.5), (1.0, 0.5), (2.0, 1.0))  # (i): scale_dist of the scaled fields
TILED_SIZE = 4096                # (k)
TRAIN_FIELDS = (8, 1024)         # (l): synthetic nuclei fields (count, side)
TRAIN_CONFIG = dict(grid=(2, 2))  # (l): Config2D's full width and training defaults
TRAIN_EPOCHS, TRAIN_STEPS = 2, 25  # (l)
TRAIN_PROFILED = 10              # (l): steps in the torch.profiler window
TARGET_TOL = 1e-6    # (l) prob targets, card vs CPU (dist: exact)
METRIC_RTOL = 1e-4   # (l) loss and metrics, card vs CPU, TF32 off
GRAD_TOL = 1e-3      # (l) gradients, relative to the parameter's largest |grad| on the CPU
THRESH_FIELDS = (3, 1024)        # (m): validation fields of optimize_thresholds (count, side)
THRESH_CMP = 512                 # (m): card vs CPU search on one field's dense prediction
TRAIN3D_FIELDS = (8, (64, 192, 192))  # (n): synthetic nuclei volumes (count, shape)
TRAIN3D_CONFIG = dict(n_rays=96, train_patch_size=(48, 96, 96), train_batch_size=2)  # (n)
TRAIN3D_EPOCHS, TRAIN3D_STEPS = 2, 10  # (n): the ResNet; the U-Net trains 1 x 5
SURFACE3D_CMP = (32, 64, 64)     # (o): card vs CPU crop
# (p): the published Config2D() at full width with H&E-style three-channel
# input and the six nucleus classes of the CoNIC 2022 challenge
MC_CONFIG = dict(n_channel_in=3, n_classes=6, grid=(2, 2))
MC_TRAIN_EPOCHS, MC_TRAIN_STEPS = 2, 10  # (p)
MC3D_CLASSES = 2                 # (q)
BIG_SIZE = 8192                  # (r): predict_instances_big's field side
BIG_BLOCKS = dict(block_size=4096, min_overlap=128, context=128)  # (r)
BIG_MC = (4096, 2048)            # (r): the multiclass field's side and block size
SHARDED_ROUNDS = 2               # (s): rounds of the block-wise calls, in turn
RANK_TIMEOUT = 600               # (s), (t): seconds for a spawn of ranks to end
DP_STEPS = 5                     # (t): steps of the 2-rank and the one-process training
DP_GRAD_TOL = 1e-4   # (t) first-step gradients, 2 ranks vs one process, of their largest |grad|
DP_LOSS_RTOL = 1e-4  # (t) losses, 2 ranks vs one process
CLI3D_SHAPE = (64, 128, 128)     # (v): the 3D CLI's crop of (h)'s field
W_SIZE = 2048                    # (w): the forwards' and predict_instances' field side
W_CMP = (512, 500)               # (w): card vs CPU crop side, candidates aimed at
W_CANDIDATES = (2_000, 8_000, 20_000)  # (w): a 2D call's least, aimed and most candidates
W_TRAIN = (4, 1024)              # (w): training fields (count, side)
W_TRAIN_STEPS = 5                # (w)
W3D_SHAPE = (64, 128, 128)       # (w): the ResNet's crop of (h)'s volume
W3D_CMP = ((32, 64, 64), 40)     # (w): its card vs CPU crop, candidates aimed at
W3D_CANDIDATES = (100, 800, 3_000)  # (w): the 3D call's least, aimed and most candidates
X_S = (3, 5, 10, 12, 24, 32)     # (x): the pair kernel's grids beside the cascade's 8 and 16
X_R = (3, 32, 128)               # (x): rays of the exact checks
X_SAMPLES = (10, 12, 16)         # (x): the 2D NMS's fine grid through nms_kwargs
X_SCHEDULING = dict(dense_max=8, row_block=3, col_block=5, device_nms=True, dist_max=3.0)  # (x)
Y_STACK = ((64, 512, 512), 11)  # (y): the notebook stack's shape and seed
# (y): the stack's generator parameters, the benchmark's stack_64x512x512 mix
Y_STACK_PARAMS = dict(r_range=(4, 7), density=2.5e-4, anisotropy=(2, 1, 1))
Y_FIELD = (120, (40, 72, 64))    # (y): seeded polyhedra of 96 rays, volume
ALL_PHASES = "bcdefghijklmnopqrstuvwxy"  # (a) runs always
# one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit): bf16 tensor
# cores, f32 outside them, HBM3
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def synthetic_nuclei(shape, seed, r_range=(7, 14), density=6e-4):
    """The benchmark's synthetic nuclei field (bench.py::_synthetic_nuclei)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    lbl = np.zeros(shape, np.int32)
    n = int(density * np.prod(shape[:2]))
    yy, xx = np.mgrid[: 64, : 64]
    k = 0
    for _ in range(n):
        r = rng.uniform(*r_range)
        cy = rng.uniform(r, shape[0] - r)
        cx = rng.uniform(r, shape[1] - r)
        y0, x0 = int(cy) - 32, int(cx) - 32
        if y0 < 0 or x0 < 0 or y0 + 64 > shape[0] or x0 + 64 > shape[1]:
            continue
        mask = ((yy - (cy - y0)) ** 2 + (xx - (cx - x0)) ** 2) < r ** 2
        region = lbl[y0:y0 + 64, x0:x0 + 64]
        if (region[mask] > 0).any():
            continue
        k += 1
        region[mask] = k
    img = (lbl > 0).astype(np.float32)
    img = gaussian_filter(img, 1.5)
    img += 0.05 * rng.normal(size=shape).astype(np.float32)
    return img.astype(np.float32), lbl


_BIG_FIELD = {}


def big_field():
    """(r)'s and (s)'s seeded BIG_SIZE^2 field, made once (10 s of host work)."""
    if BIG_SIZE not in _BIG_FIELD:
        _BIG_FIELD[BIG_SIZE] = synthetic_nuclei((BIG_SIZE, BIG_SIZE), seed=555)
    return _BIG_FIELD[BIG_SIZE]


def synthetic_nuclei_3d(shape, seed, r_range=(4, 7), density=2.5e-4):
    """The benchmark's synthetic 3D nuclei field (bench.py::_synthetic_nuclei_3d)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    lbl = np.zeros(shape, np.int32)
    n = int(density * np.prod(shape))
    k = 0
    zz, yy, xx = np.mgrid[:24, :24, :24]
    for _ in range(n):
        r = rng.uniform(*r_range)
        c = [rng.uniform(r, s - r) for s in shape]
        z0, y0, x0 = (int(v) - 12 for v in c)
        if min(z0, y0, x0) < 0 or z0 + 24 > shape[0] or y0 + 24 > shape[1] or x0 + 24 > shape[2]:
            continue
        mask = ((zz - (c[0] - z0)) ** 2 + (yy - (c[1] - y0)) ** 2
                + (xx - (c[2] - x0)) ** 2) < r ** 2
        region = lbl[z0:z0 + 24, y0:y0 + 24, x0:x0 + 24]
        if (region[mask] > 0).any():
            continue
        k += 1
        region[mask] = k
    img = (lbl > 0).astype(np.float32)
    img = gaussian_filter(img, 1.0)
    img += 0.05 * rng.normal(size=shape).astype(np.float32)
    return img.astype(np.float32), lbl


def cuda_ms(fn, warmup=1, iters=3):
    """Mean milliseconds of fn() by CUDA events, after warm-up runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def walls_ms(fns, rounds):
    """Host-clock walls (ms) of warm calls, each ended by a synchronize: the
    callables of ``fns`` (name -> fn) in turn, ``rounds`` times, so that
    slow drifts of the card or the host hit every one alike. Returns
    name -> "median (min-max) ms", followed, for a call that returns
    (labels, details) with ``details["timings_s"]``, by the median of each
    stage."""
    walls = {name: [] for name in fns}
    stages = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
            if isinstance(out, tuple) and isinstance(out[-1], dict) and "timings_s" in out[-1]:
                stages[name].append(out[-1]["timings_s"])

    def line(name):
        w, st = walls[name], stages[name]
        text = f"{np.median(w):.1f} ({min(w):.1f}-{max(w):.1f}) ms"
        if st:
            text += " [" + ", ".join(f"{k} {np.median([t[k] for t in st]) * 1e3:.1f}"
                                     for k in st[0]) + " ms]"
        return text
    return {name: line(name) for name in fns}


def ptxas_report(kernel, cuda_build):
    """Registers per thread (range over the template instances) and spill
    bytes of ``kernel``'s source, read from ptxas's report (-Xptxas -v) of a
    compile of it made here, in this run (the library the port loads is
    built without the report)."""
    import re
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = cuda_build.BUILD_DIR / f"ptxas_{kernel.source.stem}.{os.getpid()}.so"
    cmd = [cuda_build.nvcc_path(), *kernel.flags, "-Xptxas", "-v", "-o", str(out),
           str(kernel.source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.unlink(missing_ok=True)
    check(proc.returncode == 0, f"nvcc -Xptxas -v failed for {kernel.source.name}")
    log = proc.stdout + proc.stderr
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spill = sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
    check(len(regs) > 0, f"no ptxas report for {kernel.source.name}")
    return f"{len(regs)} instances, {min(regs)}-{max(regs)} registers, {spill} spill bytes"


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def bound(ops, nbytes, peak):
    """The least time (ms) the card could take for work of ``ops``
    operations at ``peak`` per second and ``nbytes`` moved at the HBM rate:
    (ms, "operations" or "bytes", whichever sets it)."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_bound(shape, Cout):
    """Bound of one SAME 3x3 (3x3x3) conv on channels-last bf16 ``shape``
    (*sp, C) -> Cout: 2 * taps * C * Cout FLOPs per output pixel on the
    bf16 tensor cores; input, output and weights in bf16 (bias f32), each
    moved once."""
    *sp, C = shape
    npix, taps = int(np.prod(sp)), 3 ** len(sp)
    return bound(2 * taps * C * Cout * npix,
                 2 * npix * (C + Cout) + 2 * taps * C * Cout + 4 * Cout, PEAK_BF16)


def library_conv_ms(xs, w, b):
    """The yardstick: one cuDNN call, F.conv2d / F.conv3d on the same bf16
    input in channels-last memory format, with bf16 weights and bias and
    cudnn.benchmark on (bias only: the activation is a second call). Layout
    changes are made before the timed region; the port never calls it."""
    import torch.nn.functional as F
    nd = xs.dim() - 1
    fmt = torch.channels_last if nd == 2 else torch.channels_last_3d
    x = xs.movedim(-1, 0)[None].contiguous(memory_format=fmt)        # (1, C, *sp)
    wt = w.to(torch.bfloat16).permute(nd + 1, nd, *range(nd)).contiguous(memory_format=fmt)
    bt = b.to(torch.bfloat16)
    conv = F.conv2d if nd == 2 else F.conv3d
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        return cuda_ms(lambda: conv(x, wt, bt, padding=1), warmup=2, iters=5)
    finally:
        torch.backends.cudnn.benchmark = prev


def conv_layers_vs_plain(net, x, dev, kernel_fn, plain_fn, only=None):
    """Kernel vs plain at every conv layer shape of ``net``'s forward on x
    (shapes found with forward hooks; of the convs ``only`` where given):
    checks each, times each beside the cuDNN yardstick and its bound.
    Returns (per-shape dicts, totals dict); the totals weight each shape by
    its count in the forward."""
    shapes = {}

    def hook(mod, args, out):
        key = (tuple(args[0].shape), mod.weight.shape[-1], mod.act)
        shapes.setdefault(key, [mod, 0])[1] += 1

    hooks = [blk.register_forward_hook(hook) for blk in (only or net.conv_blocks())]
    net(x)
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for (shape, Cout, act), (mod, count) in shapes.items():
        xs = torch.rand(*shape, device=dev, generator=g).to(torch.bfloat16)
        y = kernel_fn(xs, mod.weight, mod.bias, act)
        ref = plain_fn(xs, mod.weight, mod.bias, act)
        torch.cuda.synchronize()
        scale = max(1.0, ref.float().abs().max().item())
        e = (y.float() - ref.float()).abs().max().item()
        check(e / scale < CONV_TOL,
              f"conv kernel disagrees at {shape}->{Cout}: {e} (scale {scale})")
        del y, ref
        b_ms, b_by = conv_bound(shape, Cout)
        rows.append(dict(
            shape=shape, Cout=Cout, count=count, err=e, bound_ms=b_ms, bound_by=b_by,
            ms=cuda_ms(lambda: kernel_fn(xs, mod.weight, mod.bias, act)),
            library_ms=library_conv_ms(xs, mod.weight, mod.bias),
            plain_ms=cuda_ms(lambda: plain_fn(xs, mod.weight, mod.bias, act))))
        del xs
    tot = {k: sum(r["count"] * r[k] for r in rows)
           for k in ("ms", "library_ms", "plain_ms", "bound_ms")}
    by_ops = sum(r["count"] * r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    tot["bound_by"] = "operations" if 2 * by_ops >= tot["bound_ms"] else "bytes"
    tot["err"] = max(r["err"] for r in rows)
    return rows, tot


def conv_report(tag, what, rows, tot):
    """One line: per shape kernel / cuDNN / plain ms, the bound and the
    kernel's share of it; then the forward's totals."""
    per = "; ".join(
        "x".join(map(str, r["shape"][:-1])) + f":{r['shape'][-1]}->{r['Cout']}x{r['count']} "
        f"{r['ms']:.3f}/{r['library_ms']:.3f}/{r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.3f} ms ({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% of bound"
        for r in rows)
    print(f"({tag}) {what} kernel vs plain: {len(rows)} layer shapes ok, max_abs_err "
          f"{tot['err']:.3e}; convs of the forward: kernel {tot['ms']:.3f} ms, cuDNN bf16 "
          f"channels-last {tot['library_ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.3f} ms ({tot['bound_by']}), kernel at "
          f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of bound; per shape "
          f"kernel/cuDNN/plain: {per}", flush=True)


def phase_b(net, dev, conv):
    """Conv kernel vs plain at the full-width forward's layer shapes."""
    x = torch.rand(FWD_SIZE, FWD_SIZE, 1, device=dev)
    rows, tot = conv_layers_vs_plain(net, x, dev, conv.conv3x3_hwc, conv.conv3x3_hwc_plain)
    conv_report("b", "conv", rows, tot)
    return tot


def random_pairs(P, R, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    d_r = torch.rand(P, R, device=dev, generator=g) * 8 + 4
    d_c = torch.rand(P, R, device=dev, generator=g) * 8 + 4
    p_r = torch.rand(P, 2, device=dev, generator=g) * 100
    p_c = p_r + torch.randn(P, 2, device=dev, generator=g) * 6
    lo = torch.maximum(p_r - d_r.amax(1, keepdim=True), p_c - d_c.amax(1, keepdim=True))
    hi = torch.minimum(p_r + d_r.amax(1, keepdim=True), p_c + d_c.amax(1, keepdim=True))
    return d_r, p_r, d_c, p_c, lo, (hi - lo).clamp_min(0.0)


def adversarial_offsets(R):
    """Offsets u = q - p (f32, (n, 2)) of a sample from a polygon's centre
    where the pair kernel's wedge lookup is most likely to go wrong: on
    every ray, +-1 ulp off it, at the centre, at |u| of 1e-30 and 1e-44,
    at theta near +-pi and near 2 pi - dphi / 2, and above 2^64."""
    dphi = 2 * np.pi / R
    ang = np.arange(R) * dphi
    s0, c0 = np.sin(ang).astype(np.float32), np.cos(ang).astype(np.float32)
    u = []
    for r in (1.0, 0.5, 3.0, 7.77, 1e-30, 1e-44, 1e20):
        u += list(zip(np.float32(r) * s0, np.float32(r) * c0))
    on_ray = np.array(u[:4 * R], np.float32)
    for ax in (0, 1):
        for to in (np.inf, -np.inf):
            off = on_ray.copy()
            off[:, ax] = np.nextafter(off[:, ax], np.float32(to))
            u += list(map(tuple, off))
    u += [(0.0, 0.0), (-0.0, 0.0), (0.0, -0.0), (1e-44, 0.0), (0.0, -1e-44), (1e-44, -1e-44),
          (-1e-30, 1e-30), (1e-45, 1e-45)]
    for tiny in (0.0, -0.0, 1e-7, -1e-7, 1e-30, -1e-30, 1e-45, -1e-45):
        for uc in (-1.0, -5.0):
            u.append((tiny, uc))
    for a in (2 * np.pi - dphi / 2, np.pi, -np.pi):
        for e in (-1e-6, -1e-7, 0.0, 1e-7, 1e-6):
            for r in (1.0, 6.0):
                u.append((r * math.sin(a + e), r * math.cos(a + e)))
    return np.array(u, np.float32)


def adversarial_pairs(R, dev, seed=0, extents=(8, 16)):
    """A pair for each :func:`adversarial_offsets` u and each of
    ``extents``, both polygons centred at -u (some regular), over a bbox
    intersection from (-0.5, -0.5) whose extent is S: the first sample of
    the S x S grid lies at the origin, so the kernel tests u itself and the
    grid's other samples about it (the default, 8 and 16, the cascade's two
    grids)."""
    u = torch.from_numpy(adversarial_offsets(R))
    n, k = len(u), len(extents)
    g = torch.Generator().manual_seed(seed)
    d_r = torch.rand(k * n, R, generator=g) * 8 + 4
    d_c = torch.rand(k * n, R, generator=g) * 8 + 4
    d_c[::3] = 6.0
    p = torch.cat([-u] * k)
    ext = torch.cat([torch.full((n, 2), float(e)) for e in extents])
    plo = torch.full((k * n, 2), -0.5)
    return tuple(t.to(dev) for t in (d_r, p, d_c, p.clone(), plo, ext))


LATTICE_LO, LATTICE_HI = np.float32(-1e-7), np.float32(1 + 1e-7)  # the inside test's bounds


def lattice_bound_cases(F, dev):
    """Polyhedra of F faces whose one lattice point, u = (1, 1, 1) about the
    centre 0, has barycentric coordinates (b0, b1, b2) in one face exactly
    at, and one f32 ulp either side of, the inside test's bounds:
    f32(-1e-7) for each coordinate, f32(1 + 1e-7) for their sum (that
    face's inverse is diag(b), so b is exact). The passing face is the
    first, a middle or the last; every other face is either degenerate
    (valid False) with an inverse that would pass, or valid and failing.
    Each is paired with one always inside, one never inside (every face
    degenerate) and itself, both ways, and once more with an empty lattice.
    Returns (points, inv, valid, i, j, plo, phi, stride, expected (P, 2)
    int32: the points inside i, and inside both)."""
    def ulp(x, d):
        return x if d == 0 else np.nextafter(x, np.float32(d * np.inf))
    cases = []                                          # (b, inside)
    for d in (-1, 0, 1):
        for r in range(3):
            b = [np.float32(0.25)] * 3
            b[r] = ulp(LATTICE_LO, d)
            cases.append((b, d >= 0))
        cases.append(([ulp(LATTICE_HI, d), np.float32(0), np.float32(0)], d <= 0))
    n = len(cases)
    inv = np.zeros((n + 2, F, 3, 3), np.float32)
    valid = np.zeros((n + 2, F), bool)
    inv[:, :, [0, 1, 2], [0, 1, 2]] = np.where(np.arange(F) % 2, -1.0, 0.0)[None, :, None]
    valid[:, 1::2] = True                               # odd faces valid and failing
    for c, (b, _) in enumerate(cases):
        f = (0, F // 2, F - 1)[c % 3]
        inv[c, f] = np.diag(b)
        valid[c, f] = True
    always, never = n, n + 1
    inv[always, F - 1], valid[always, F - 1] = 0.0, True   # b = 0 passes
    valid[never] = False
    inside = [ok for _, ok in cases] + [True, False]
    pairs = []                                          # (i, j, expected)
    for c in range(n):
        for a, b in ((c, always), (always, c), (c, c), (c, never), (never, c)):
            pairs.append((a, b, (inside[a], inside[a] and inside[b])))
    empty = [(c, always, (0, 0)) for c in range(n)]     # phi < plo on the first axis
    i, j = (np.array([p[k] for p in pairs + empty], np.int64) for k in (0, 1))
    expected = np.array([p[2] for p in pairs + empty], np.int32)
    P = len(i)
    plo = np.ones((P, 3), np.float32)
    phi = np.ones((P, 3), np.float32)
    stride = np.ones((P, 3), np.float32)
    phi[len(pairs):, 0] = 0.0
    arrays = (np.zeros((n + 2, 3), np.float32), inv, valid, i, j, plo, phi, stride, expected)
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def octahedron_rays():
    """The six axis rays and eight faces of an octahedron: with integer
    distances and centres its faces pass through lattice points, whose
    barycentric sums then round to either side of 1."""
    dirs = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    faces = np.array([(a, b, c) for a in (0, 3) for b in (1, 4) for c in (2, 5)], np.int64)
    return torch.from_numpy(dirs), torch.from_numpy(faces)


def lattice_pair_set(ray_dirs, faces, n, S, dev, seed, integer=False):
    """n seeded star polyhedra of a ray set around a few centres, a tenth of
    them with a ray of length 0 (degenerate faces), and every pair of them
    whose bboxes meet, with its lattice at S; ``integer``: integer
    distances and centres (on the octahedron, points on the faces).
    Returns (points, inv, valid, i, j, plo, phi, stride)."""
    from stardist_torch.ops.lattice_overlap import lattice_grid
    from stardist_torch.ops.polyhedron import polyhedron_bboxes, polyhedron_face_inverses
    rng = np.random.RandomState(seed)
    R = len(ray_dirs)
    centres = rng.uniform(0, 24, (max(1, n // 8), 3))
    points = centres[rng.randint(len(centres), size=n)] + rng.normal(0, 3, (n, 3))
    dist = rng.uniform(2, 9, (n, R))
    if integer:
        points, dist = np.round(points), np.round(dist)
    dist[rng.rand(n) < 0.1, rng.randint(R)] = 0.0
    points = torch.from_numpy(points.astype(np.float32)).to(dev)
    dist = torch.from_numpy(dist.astype(np.float32)).to(dev)
    ray_dirs, faces = ray_dirs.to(dev), faces.to(dev)
    inv, valid = polyhedron_face_inverses(dist, ray_dirs, faces)
    lo, hi = polyhedron_bboxes(dist, points, ray_dirs)
    i, j = torch.triu_indices(n, n, 1, device=dev)
    meet = ((torch.minimum(hi[i], hi[j]) - torch.maximum(lo[i], lo[j])) >= 0).all(dim=1)
    i, j = i[meet], j[meet]
    return (points, inv, valid, i, j, *lattice_grid(lo, hi, i, j, S))


def lattice_bound(n_points, n_inside_first, F, P):
    """Bound of the lattice kernel's function: each lattice point tested
    against its pair's first polyhedron and each point inside it against
    the second, at F face tests of 17 f32 operations (9 products and 8
    sums; the comparisons not counted) plus the point's offset (3); per
    pair the two face sets (F x (9 + 1 valid byte)), the lattice's 9
    values and the two indices read once, the two counts written once."""
    ops = (n_points + n_inside_first) * (F * 17 + 3)
    return bound(ops, P * (2 * F * 37 + 9 * 4 + 16 + 8), PEAK_F32)


def exact_pairs(model, img, samples):
    """The exact pairs of one ``predict_instances`` call at the lattice
    ``samples``, all its rounds in one list, as ``lattice_counts`` was
    given them: ((points, inv, valid, i, j, plo, phi, stride), rounds)."""
    from stardist_torch.ops import nms as nms_ops
    calls, real = [], nms_ops.lattice_counts

    def record(*args):
        calls.append(args)
        return real(*args)
    nms_ops.lattice_counts = record
    try:
        model.predict_instances(img, nms_kwargs={"samples": samples})
    finally:
        nms_ops.lattice_counts = real
    check(len(calls) > 0 and all(c[0] is calls[0][0] for c in calls),
          "exact_pairs: not one NMS call")
    return (*calls[0][:3], *(torch.cat([c[k] for c in calls]) for k in range(3, 8))), len(calls)


def lattice_kernel_ms(lk, args, S):
    """The lattice kernel alone on ``args`` (one launch a run; the output
    made once)."""
    points, inv, valid, i, j = args[:5]
    P, F = i.numel(), valid.shape[1]
    out = torch.empty(P, 2, dtype=torch.int32, device=points.device)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*args, out)]
    return cuda_ms(lambda: lk.KERNEL.launch(*ptrs, P, F, S, lk.stream_ptr(points.device)),
                   warmup=2, iters=10)


def inside_test_ops(R):
    """f32 operations of one inside test of a point against a star polygon
    of R rays, as the function needs it: the wedge found by ceil(log2 R)
    cross-product sign tests (2 products and a difference each), then the
    point's offset from the centre (2) and one edge test (11: the edge, the
    two cross products and their product)."""
    return 3 * math.ceil(math.log2(R)) + 13


def pair_bound(P, R, S):
    """Bound of the pair kernel's function: per pair, S * S samples (4
    flops for a sample's coordinates), each tested against both polygons
    (:func:`inside_test_ops`, plus the wedge's two vertices, 4 products), at
    the f32 rate; the (2R + 8) f32 inputs read once and the f32 result
    written once."""
    return bound(P * S * S * (2 * (inside_test_ops(R) + 4) + 4), P * ((2 * R + 8) * 4 + 4),
                 PEAK_F32)


def pair_kernel_ms(po, args, S):
    """The pair kernel alone on ``args``: the trig table and the output made
    once, one launch per run (the call adds the wrapper's checks and
    allocation on the host)."""
    P, R = args[0].shape
    out = torch.empty(P, device=args[0].device)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*args, po.trig_table(R, args[0].device), out)]
    return cuda_ms(lambda: po.KERNEL.launch(*ptrs, P, R, S, po.stream_ptr(args[0].device)),
                   warmup=3, iters=30)


def phase_c(dev, po):
    """Pair kernel vs plain: exact, times and bound on 10^5 pairs (R = 32);
    exact on random and adversarial pairs at R = 3, 32 and 128."""
    args = random_pairs(N_PAIRS, 32, dev, 7)
    out = {}
    for S in (8, 16):
        got = po.pair_frac(*args, S=S)
        ref = po.pair_frac_plain(*args, S=S)
        torch.cuda.synchronize()
        n_diff = int((got != ref).sum().item())
        check(n_diff == 0, f"pair kernel differs from plain on {n_diff} pairs at S={S}")
        b_ms, b_by = pair_bound(N_PAIRS, 32, S)
        out[S] = dict(ms=pair_kernel_ms(po, args, S),
                      call_ms=cuda_ms(lambda: po.pair_frac(*args, S=S), warmup=3, iters=30),
                      plain_ms=cuda_ms(lambda: po.pair_frac_plain(*args, S=S), iters=1),
                      mean=float(got.mean().item()), err=(got - ref).abs().max().item(),
                      bound_ms=b_ms, bound_by=b_by)
    n_more = 0
    for R in (3, 32, 128):
        more = [torch.cat(ts) for ts in zip(random_pairs(20_000, R, dev, R),
                                             adversarial_pairs(R, dev))]
        for S in (8, 16):
            n_diff = int((po.pair_frac(*more, S=S) != po.pair_frac_plain(*more, S=S)).sum().item())
            check(n_diff == 0, f"pair kernel differs from plain on {n_diff} pairs at R={R}, S={S}")
        n_more += len(more[0])
    print(f"(c) pair kernel vs plain on {N_PAIRS} pairs: exact at S=8 and S=16; "
          + "; ".join(f"S={S}: kernel {r['ms']:.4f} ms (call {r['call_ms']:.4f} ms) / plain "
                      f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                      f"kernel at {100 * r['bound_ms'] / r['ms']:.1f}% of bound, mean frac "
                      f"{r['mean']:.4f}" for S, r in out.items())
          + f"; exact too on {n_more} random and adversarial pairs at R = 3, 32 and 128",
          flush=True)
    return out


def phase_d(net, dev):
    g = torch.Generator().manual_seed(3)
    x = torch.rand(FWD_SIZE, FWD_SIZE, 1, generator=g).to(dev)
    prob, dist = net(x)
    prob_p, dist_p = net(x, plain=True)
    torch.cuda.synchronize()
    n = FWD_SIZE // 2
    check(prob.shape == (n, n) and dist.shape == (32, n, n), "forward shapes")
    check(bool(torch.isfinite(dist).all()) and bool(torch.isfinite(prob).all()),
          "non-finite forward output")
    e_prob = (prob - prob_p).abs().max().item()
    e_dist = ((dist - dist_p).abs().max() / dist_p.abs().max().clamp_min(1.0)).item()
    check(e_prob < FWD_TOL and e_dist < FWD_TOL,
          f"kernel forward disagrees with plain: prob {e_prob}, dist {e_dist}")
    del prob, dist, prob_p, dist_p
    t_k = cuda_ms(lambda: net(x))
    t_p = cuda_ms(lambda: net(x, plain=True))
    print(f"(d) full-width forward {FWD_SIZE}^2 (Config2D() defaults, seeded weights): "
          f"kernel {t_k:.2f} ms, plain {t_p:.2f} ms; prob max abs diff {e_prob:.2e}, "
          f"dist max rel diff {e_dist:.2e}", flush=True)


def reset_launches(kernels):
    for k in kernels.values():
        k.launches = 0


def read_launches(kernels, model, n_calls=1):
    """Launch counts since the reset; the main path must have launched every
    2D kernel (the conv once per conv layer and call)."""
    launches = {name: k.launches for name, k in kernels.items()}
    n_conv = len(model.net.conv_blocks()) * n_calls
    check(launches["conv"] == n_conv,
          f"conv launches {launches['conv']} != {n_conv} convs x {n_calls} calls")
    check(launches["pair"] > 0, "the NMS launched no pair kernel")
    check(launches["raster"] > 0, "the label image was drawn without the raster kernel")
    return launches


def host_syncs(fn):
    """The host syncs of one call of fn(), as torch's sync debug mode flags
    them: (count, the distinct places in the Python source that made them).
    Only the flags count, not the mode's own warning that it is a
    prototype, which a process shows once."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    return len(sites), sorted(set(sites))


def nms_profile(model, img, pair_kernel, n_top=8):
    """One whole nms_polygons call on the candidates of
    ``model.predict_instances(img)`` (one tile), as ``predict_instances``
    makes it, split by torch.profiler: its wall, the device time of its
    CUDA kernels and copies (and the share of the wall they fill), the
    launches of ``pair_kernel``, the host syncs of one call, and the ``n_top``
    CUDA ops by device time. Returns the line's text."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from stardist_torch.nms import descending_order
    from stardist_torch.ops.nms import nms_polygons
    prob, dist, points = model._predict_sparse(img)
    o = descending_order(prob)
    d, p = dist[o].float().contiguous(), points[o].float().contiguous()
    thresh, stats = model.thresholds.nms, {}
    nms_polygons(d, p, thresh=thresh)                 # warm-up
    n_sync = host_syncs(lambda: nms_polygons(d, p, thresh=thresh))[0]
    torch.cuda.synchronize()
    n0 = pair_kernel.launches
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            nms_polygons(d, p, thresh=thresh, stats=stats)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ops = []
        for e in prof.key_averages():                 # the card's kernels and copies
            if e.device_type == DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                us = getattr(e, "self_cuda_time_total", 0) if us is None else us
                ops.append((us / 1e3, e.count, e.key))
    except Exception as exc:                          # a measurement, not a check
        return f"torch.profiler failed: {exc!r}"
    if not ops:
        return "torch.profiler saw no device time"
    ops.sort(reverse=True)
    busy = sum(ms for ms, _, _ in ops)
    top = "; ".join(f"{name[:70]} {ms:.3f} ms x{n}" for ms, n, name in ops[:n_top])
    return (f"{stats['n_candidates']} candidates, {stats['n_pairs']} bbox pairs, "
            f"{stats['n_eval_pairs']} exact pairs at S=8, {stats['n_fine_pairs']} at S=16: wall "
            f"{wall:.2f} ms (profiled), device time {busy:.2f} ms ({100 * busy / wall:.0f}% of "
            f"the wall), pair kernel launches {pair_kernel.launches - n0}, host syncs {n_sync}; "
            f"top CUDA ops by device time: {top}")


def phase_e(dev, kernels, matching, StarDist2D, rt):
    model = StarDist2D(None, "2D_demo", "models/examples", device=dev)
    img, lbl = synthetic_nuclei((E2E_SIZE, E2E_SIZE), seed=123)
    model.predict_instances(img)                       # warm-up: allocator, caches
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    labels, details = model.predict_instances(img)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels, model)
    check(labels.shape == img.shape and labels.max() > 0, "empty label image")
    ap = matching(lbl, labels, thresh=0.5).accuracy
    check(ap >= 0.95, f"AP@0.5 {ap} < 0.95")
    t = details["timings_s"]
    c = details["nms_counters"]
    b_pair, b_pair_by = pair_bound(c["n_eval_pairs"], model.config.n_rays, 8)
    b_fine, b_fine_by = pair_bound(c["n_fine_pairs"], model.config.n_rays, 16)
    print(f"(e) predict_instances {E2E_SIZE}^2 on the card: wall {wall * 1e3:.1f} ms = forward "
          f"{t['forward'] * 1e3:.1f} + extract {t['extract'] * 1e3:.1f} + nms "
          f"{t['nms'] * 1e3:.1f} + raster {t['raster'] * 1e3:.1f} ms (+ host setup); "
          f"{c['n_candidates']} candidates, {c['n_pairs']} bbox pairs, {c['n_eval_pairs']} "
          f"exact pairs in {c['n_rounds']} rounds ({c['n_fine_pairs']} of them at S=16 too), "
          f"{len(details['prob'])} objects ({int(lbl.max())} true), AP@0.5 {ap:.4f}; launches "
          f"{launches}; the pair kernel's bound for these exact pairs at S=8: {b_pair:.4f} ms "
          f"({b_pair_by}), at S=16: {b_fine:.4f} ms ({b_fine_by})", flush=True)
    print(f"(e) nms_polygons at {E2E_SIZE}^2, split: {nms_profile(model, img, kernels['pair'])}", flush=True)
    print(f"(e) raster stage at {E2E_SIZE}^2 (stage {t['raster'] * 1e3:.3f} ms in the call "
          f"above), split: {raster_split(model, details, img.shape, rt)}", flush=True)

    img1, _ = synthetic_nuclei((CMP_SIZE, CMP_SIZE), seed=123)
    lab_gpu, _ = model.predict_instances(img1)
    cpu_model = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
    t0 = time.perf_counter()
    lab_cpu, det_cpu = cpu_model.predict_instances(img1)
    t_cpu = time.perf_counter() - t0
    acc = matching(lab_cpu, lab_gpu, thresh=0.5).accuracy
    check(acc >= 0.99, f"card (bf16) vs CPU (f32) labels at {CMP_SIZE}^2: accuracy {acc} < 0.99")
    print(f"(e) {CMP_SIZE}^2 card vs CPU plain path: matching accuracy {acc:.4f}, objects "
          f"{int(lab_gpu.max())} / {int(lab_cpu.max())}, CPU call {t_cpu:.1f} s", flush=True)
    return launches


def phase_f(net3, dev, conv):
    """conv3d kernel vs plain at the full-width 3D forward's layer shapes."""
    x = torch.rand(*FWD3D_SHAPE, 1, device=dev)
    rows, tot = conv_layers_vs_plain(net3, x, dev, conv.conv3x3x3_dhwc,
                                     conv.conv3x3x3_dhwc_plain)
    conv_report("f", "conv3d", rows, tot)
    return tot


def phase_g(net3, dev):
    g = torch.Generator().manual_seed(3)
    x = torch.rand(*FWD3D_SHAPE, 1, generator=g).to(dev)
    prob, dist = net3(x)
    prob_p, dist_p = net3(x, plain=True)
    torch.cuda.synchronize()
    out = tuple(s // gr for s, gr in zip(FWD3D_SHAPE, net3.grid))
    check(tuple(prob.shape) == out and tuple(dist.shape) == (net3.n_rays,) + out,
          "3D forward shapes")
    check(bool(torch.isfinite(dist).all()) and bool(torch.isfinite(prob).all())
          and bool(torch.isfinite(dist_p).all()), "non-finite 3D forward output")
    e_prob = (prob - prob_p).abs().max().item()
    e_dist = ((dist - dist_p).abs().max() / dist_p.abs().max().clamp_min(1.0)).item()
    check(e_prob < FWD_TOL and e_dist < FWD_TOL,
          f"3D kernel forward disagrees with plain: prob {e_prob}, dist {e_dist}")
    del prob, dist, prob_p, dist_p
    t_k = cuda_ms(lambda: net3(x))
    t_p = cuda_ms(lambda: net3(x, plain=True))
    print(f"(g) full-width 3D forward {'x'.join(map(str, FWD3D_SHAPE))} (Config3D(grid=(1, 2, 2)), "
          f"seeded weights): kernel {t_k:.2f} ms, plain {t_p:.2f} ms; prob max abs diff "
          f"{e_prob:.2e}, dist max rel diff {e_dist:.2e}", flush=True)


def phase_h(dev, conv, lk, matching, StarDist3D):
    model = StarDist3D(None, "3D_demo", "models/examples", device=dev)
    img, lbl = synthetic_nuclei_3d(E2E3D_SHAPE, seed=3)
    model.predict_instances(img)                       # warm-up: allocator, caches
    torch.cuda.synchronize()
    conv.KERNEL3D.launches = lk.KERNEL.launches = 0
    t0 = time.perf_counter()
    labels, details = model.predict_instances(img)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = conv.KERNEL3D.launches
    n_conv = len(model.net.conv_blocks())
    check(launches == n_conv, f"conv3d launches {launches} != {n_conv} convs x 1 call")
    lattice_launches = lk.KERNEL.launches
    check(lattice_launches == details["nms_counters"]["n_rounds"] > 0,
          f"lattice launches {lattice_launches} != {details['nms_counters']['n_rounds']} rounds")
    check(labels.shape == img.shape and labels.max() > 0, "empty label volume")
    ap = matching(lbl, labels, thresh=0.1).accuracy
    check(ap >= 0.8, f"AP@0.1 {ap} < 0.8")
    ap5 = matching(lbl, labels, thresh=0.5).accuracy
    t = details["timings_s"]
    c = details["nms_counters"]
    print(f"(h) 3D predict_instances {'x'.join(map(str, E2E3D_SHAPE))} on the card: wall "
          f"{wall * 1e3:.1f} ms = forward {t['forward'] * 1e3:.1f} + extract "
          f"{t['extract'] * 1e3:.1f} + nms {t['nms'] * 1e3:.1f} (exact lattice test "
          f"{c['exact_s'] * 1e3:.1f}) + raster {t['raster'] * 1e3:.1f} ms (+ host setup); "
          f"{c['n_candidates']} candidates, {c['n_pairs']} bbox pairs, {c['n_eval_pairs']} "
          f"exact pairs in {c['n_rounds']} rounds, {c['n_survivors']} survivors, "
          f"{int(labels.max())} objects ({int(lbl.max())} true), AP@0.1 {ap:.4f}, AP@0.5 "
          f"{ap5:.4f}; {c['n_lattice_points']} lattice points, {c['n_lattice_inside_first']} "
          f"inside the first polyhedron; conv3d launches {launches}, lattice launches "
          f"{lattice_launches}", flush=True)

    # the lattice kernel alone on the call's exact pairs, against its bound and its plain twin
    rows = {}
    for S in H_LATTICE_S:
        args, rounds = exact_pairs(model, img, S)
        got = lk.lattice_counts(*args, S)
        ref = lk.lattice_counts_plain(*args, S)
        torch.cuda.synchronize()
        n_diff = int((got != ref).any(dim=1).sum().item())
        check(n_diff == 0, f"(h) lattice kernel differs from plain on {n_diff} pairs at S={S}")
        P, F = len(args[3]), args[2].shape[1]
        n_points = int(lk.lattice_points(*args[5:], S).sum().item())
        n_first = int(ref[:, 0].sum().item())
        b_ms, b_by = lattice_bound(n_points, n_first, F, P)
        rows[S] = dict(ms=lattice_kernel_ms(lk, args, S), bound_ms=b_ms, bound_by=b_by,
                       call_ms=cuda_ms(lambda: lk.lattice_counts(*args, S), warmup=2, iters=10),
                       plain_ms=cuda_ms(lambda: lk.lattice_counts_plain(*args, S), iters=1),
                       err=0.0, pairs=P, points=n_points, first=n_first, rounds=rounds)
    print("(h) lattice kernel on the call's exact pairs (F = "
          f"{F}), exactly the plain twin's counts: " + "; ".join(
              f"S={S}: {r['pairs']} pairs in {r['rounds']} rounds, {r['points']} lattice points, "
              f"{r['first']} inside the first; kernel {r['ms']:.4f} ms (call {r['call_ms']:.4f} "
              f"ms) / plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), kernel at {100 * r['bound_ms'] / r['ms']:.1f}% of bound"
              for S, r in rows.items()), flush=True)

    crop = img[:CMP3D_SHAPE[0], :CMP3D_SHAPE[1], :CMP3D_SHAPE[2]]
    lab_gpu, _ = model.predict_instances(crop)
    cpu_model = StarDist3D(None, "3D_demo", "models/examples", device="cpu")
    t0 = time.perf_counter()
    lab_cpu, _ = cpu_model.predict_instances(crop)
    t_cpu = time.perf_counter() - t0
    acc = matching(lab_cpu, lab_gpu, thresh=0.5).accuracy
    n_gpu, n_cpu = int(lab_gpu.max()), int(lab_cpu.max())
    check(n_cpu > 0 and acc >= 0.9 and abs(n_gpu - n_cpu) <= 1,
          f"card (bf16) vs CPU (f32) labels at {CMP3D_SHAPE}: accuracy {acc}, "
          f"objects {n_gpu} / {n_cpu}")
    print(f"(h) {'x'.join(map(str, CMP3D_SHAPE))} crop card vs CPU plain path: matching "
          f"accuracy {acc:.4f}, objects {n_gpu} / {n_cpu}, CPU call {t_cpu:.1f} s", flush=True)
    return launches, lattice_launches, rows


def polygon_field(n, size, seed, n_rays=32, r_range=(7, 14)):
    """Seeded star polygons on a size^2 image: integer centres on a grid of
    2 (as predict_instances gives them), some beyond the border, radii in
    ``r_range`` with ray-wise jitter; order values a permutation (1-based),
    labels a permutation."""
    rng = np.random.RandomState(seed)
    points = 2 * rng.randint(-4, size // 2 + 4, (n, 2))
    dist = rng.uniform(*r_range, (n, 1)) * rng.uniform(0.85, 1.15, (n, n_rays))
    return (dist.astype(np.float32), points.astype(np.float32),
            rng.permutation(n) + 1, rng.permutation(n))


def adversarial_polygons(shape, R, seed, big, n_each=8):
    """Seeded star polygons where the raster kernel's wedge lookup and box
    are most likely to go wrong: integer and half-integer centres (rows of
    pixels with ur = 0 or uc = 0); for every ray, a pixel on it and +-1 ulp
    off it; centres 1e-30 from row or column 0 (the last wedge ends within
    1.2e-15 rad of ray 0); dists of 0 (one, or all), of 1e-3 beside 10 and
    beside ``big`` (the polygon that sets the window), all equal, and
    integers about an integer centre (vertices on ray 0 on pixels); centres
    across and beyond each border. Order values a permutation
    (1-based), labels a permutation."""
    rng = np.random.RandomState(seed)
    H, W = shape
    ang = np.arange(R) * (2 * np.pi / R)
    ray = np.stack([np.sin(ang), np.cos(ang)], 1).astype(np.float32)
    pts, dists = [], []

    def add(p, d=None):
        pts.append(np.asarray(p, np.float32))
        dists.append(rng.uniform(4, 12, R) if d is None else d)

    for _ in range(4 * n_each):
        add(rng.randint(-6, (H + 6, W + 6)) + rng.choice([0.0, 0.5], 2))
    for k in range(R):
        p = rng.randint(0, (H, W)).astype(np.float32) - np.float32(rng.uniform(2, 9)) * ray[k]
        add(p)
        for ax in (0, 1):
            for to in (np.inf, -np.inf):
                q = p.copy()
                q[ax] = np.nextafter(q[ax], np.float32(to))
                add(q)
    for e in (1e-30, -1e-30):
        for _ in range(n_each // 2):
            add((e, rng.randint(0, W)))
            add((rng.randint(0, H), e))
    for _ in range(n_each):
        c = rng.randint(0, (H, W)).astype(np.float32)
        d = rng.uniform(4, 12, R)
        d[rng.randint(R)] = 0.0
        add(c, d)
        d = np.full(R, 10.0)
        d[::2] = 1e-3
        add(c + 0.25, d)
        add(c - 0.5, np.full(R, 6.0))
        add(c + 1, rng.randint(3, 12, R).astype(np.float64))   # vertices on pixels
    add(rng.randint(0, (H, W)), np.zeros(R))
    d = np.full(R, 8.0)
    d[::3] = 1e-3
    d[1] = big
    add(rng.randint(0, (H, W)) + 0.5, d)
    n = len(pts)
    return (np.stack(dists).astype(np.float32), np.stack(pts), rng.permutation(n) + 1,
            rng.permutation(n))


def scaled_field(points, scale_dist, seed):
    """A field's centres as a scaled predict_instances draws them: times
    ``scale_dist`` (the grid points times 1 / scale), in f64, and one
    centre in two moved by a seeded fraction of a pixel (f32)."""
    rng = np.random.RandomState(seed)
    p = (np.asarray(points, np.float64) * np.asarray(scale_dist, np.float64)).astype(np.float32)
    p[1::2] += rng.uniform(-0.5, 0.5, p[1::2].shape).astype(np.float32)
    return p


def raster_bound(rt, d, p, shape, o, lab, scale_dist=(1, 1)):
    """Bound of the raster kernel's function on this field, counted from its
    data: every drawn polygon tests the pixels of its bounding box (its
    longest ray about its centre, times ``scale_dist`` per axis) that lie in
    the image and in its splat window, one inside test each
    (:func:`inside_test_ops`; scaled, after two products that unscale the
    offset), after 2R products for its vertices, at the f32 rate; the
    inputs read once and the int32 label image written once."""
    H, W = shape
    N, R = d.shape
    window = rt.tile_window(d.max().item(), shape, scale_dist)
    reach, centre = d.float().amax(1), p.float()
    origin = torch.round(centre).long() - window // 2
    side = []
    for ax, size in ((0, H), (1, W)):
        r = reach * float(scale_dist[ax])
        lo = torch.maximum(torch.ceil(centre[:, ax] - r).long(), origin[:, ax].clamp_min(0))
        hi = torch.minimum(torch.floor(centre[:, ax] + r).long(),
                           (origin[:, ax] + window).clamp_max(size) - 1)
        side.append((hi - lo + 1).clamp_min(0))
    pixels = int((side[0] * side[1] * (o > 0)).sum().item())
    per_pixel = inside_test_ops(R) + (0 if tuple(scale_dist) == (1, 1) else 2)
    nbytes = sum(t.numel() * t.element_size() for t in (d, p, o, lab)) + H * W * 4
    return bound(pixels * per_pixel + N * 2 * R, nbytes, PEAK_F32)


def raster_fields():
    """(i)'s fields: (name, shape, dist, points, order values, labels) as
    numpy, seeded."""
    out = [(f"{n} polygons at {size}^2", (size, size), *polygon_field(n, size, seed=11 + k))
           for k, (size, n) in enumerate(RASTER_FIELDS)]
    size, n_each = RASTER_ADVERSARIAL
    out.append((f"adversarial at {size}^2", (size, size),
                *adversarial_polygons((size, size), 32, seed=13, big=60.0, n_each=n_each)))
    return out


def phase_i(dev, rt, splat):
    """Raster kernel vs its plain version (exact, both packings) and the
    atan2 splat."""
    out = []
    for name, shape, *arrays in raster_fields():
        d, p, o, lab = (torch.from_numpy(np.asarray(a)).to(dev) for a in arrays)
        n = len(d)
        ref = rt.rasterize_polygons_tiles_plain(d, p, shape, o, lab)
        n_diff, err = 0, 0
        for vb in (n, None):                    # the 32-bit packing, then the 64-bit one
            for dtype in (torch.int32, torch.uint16):
                got = rt.rasterize_polygons_tiles_cuda(d, p, shape, o, lab, out_dtype=dtype,
                                                       value_bound=vb)
                torch.cuda.synchronize()
                check(got.dtype == dtype, f"raster kernel gave {got.dtype} for {dtype}")
                got = got.to(torch.int32)
                n_diff += int((got != ref).sum().item())
                err = max(err, int((got.long() - ref.long()).abs().max().item()))
        check(n_diff == 0, f"raster kernel differs from plain on {n_diff} pixels ({name})")
        n_splat = int((got != splat(d, p, shape, o, lab)).sum().item())
        fg = int((ref > 0).sum().item())
        window = rt.tile_window(d.max().item(), shape)
        del ref, got
        inputs = rt.kernel_inputs(d, p, o, lab)
        t_kern = cuda_ms(lambda: rt.draw(inputs, shape, True), iters=10)
        t_k64 = cuda_ms(lambda: rt.draw(inputs, shape, False), iters=10)
        t_call = cuda_ms(lambda: rt.rasterize_polygons_tiles_cuda(
            d, p, shape, o, lab, value_bound=n), iters=10)
        t_call64 = cuda_ms(lambda: rt.rasterize_polygons_tiles_cuda(d, p, shape, o, lab),
                           iters=10)
        t_plain = cuda_ms(lambda: rt.rasterize_polygons_tiles_plain(d, p, shape, o, lab), iters=1)
        b_ms, b_by = raster_bound(rt, d, p, shape, o, lab)
        out.append(dict(name=name, n=n, n_diff=n_diff, err=err, ms=t_call, kernel_ms=t_kern,
                        plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by))
        print(f"(i) raster, {name} (R = {d.shape[1]}, window {window}, {fg} foreground "
              f"pixels): kernel == plain with both packings and both output types "
              f"({n_diff} differing pixels; {n_splat} differ from the atan2 splat); "
              f"32-bit packing: kernel + memset {t_kern:.4f} ms, call {t_call:.4f} ms; 64-bit: "
              f"kernel + memset {t_k64:.4f} ms, call {t_call64:.4f} ms; plain {t_plain:.2f} "
              f"ms; bound of the function on this field {b_ms:.4f} ms ({b_by}), kernel + "
              f"memset at {100 * b_ms / t_kern:.1f}% of it, the call at "
              f"{100 * b_ms / t_call:.1f}%", flush=True)
        del inputs
    # more polygons than the 32-bit packing holds: the int64 image, equal too
    size, n = RASTER_MANY
    d, p, o, lab = (torch.from_numpy(np.asarray(a)).to(dev)
                    for a in polygon_field(n, size, seed=17))
    got = rt.rasterize_polygons_tiles_cuda(d, p, (size, size), o, lab, value_bound=n)
    ref = rt.rasterize_polygons_tiles_plain(d, p, (size, size), o, lab)
    n_diff = int((got != ref).sum().item())
    check(n > rt.PACK32_MAX and n_diff == 0,
          f"raster kernel differs from plain on {n_diff} pixels ({n} polygons, 64-bit)")
    print(f"(i) raster, {n} polygons at {size}^2 (value_bound {n} > {rt.PACK32_MAX}: the "
          f"64-bit packing): kernel == plain ({n_diff} differing pixels, {int(got.max())} "
          f"largest label)", flush=True)
    del got, ref
    fields = raster_fields()
    for name, shape, dist, points, order, labels in (fields[0], fields[-1]):
        for k, sd in enumerate(RASTER_SCALES):
            d, p, o, lab = (torch.from_numpy(np.asarray(a)).to(dev) for a in (
                dist, scaled_field(points, sd, seed=31 + k), order, labels))
            n = len(d)
            ref = rt.rasterize_polygons_tiles_plain(d, p, shape, o, lab, scale_dist=sd)
            n_diff = 0
            for vb in (n, None):
                got = rt.rasterize_polygons_tiles_cuda(d, p, shape, o, lab, scale_dist=sd,
                                                       value_bound=vb)
                torch.cuda.synchronize()
                n_diff += int((got != ref).sum().item())
            check(n_diff == 0, f"raster kernel differs from plain on {n_diff} pixels ({name}, "
                               f"scale_dist {sd})")
            fg = int((ref > 0).sum().item())
            del ref, got
            inputs = rt.kernel_inputs(d, p, o, lab)
            t_kern = cuda_ms(lambda: rt.draw(inputs, shape, True, sd), iters=10)
            t_unscaled = cuda_ms(lambda: rt.draw(inputs, shape, True), iters=10)
            t_call = cuda_ms(lambda: rt.rasterize_polygons_tiles_cuda(
                d, p, shape, o, lab, scale_dist=sd, value_bound=n), iters=10)
            t_plain = cuda_ms(lambda: rt.rasterize_polygons_tiles_plain(
                d, p, shape, o, lab, scale_dist=sd), iters=1)
            b_ms, b_by = raster_bound(rt, d, p, shape, o, lab, sd)
            out.append(dict(name=f"{name}, scale_dist {sd}", n=n, n_diff=n_diff, err=0,
                            ms=t_call, kernel_ms=t_kern, plain_ms=t_plain, bound_ms=b_ms,
                            bound_by=b_by))
            print(f"(i) raster, {name}, scale_dist {sd}, non-integer centres (window "
                  f"{rt.tile_window(d.max().item(), shape, sd)}, {fg} foreground pixels): "
                  f"kernel == plain with both packings ({n_diff} differing pixels); 32-bit "
                  f"packing: kernel + memset {t_kern:.4f} ms (unscaled, same centres "
                  f"{t_unscaled:.4f} ms), call {t_call:.4f} ms; plain {t_plain:.2f} ms; "
                  f"bound of the function on this field {b_ms:.4f} ms ({b_by}), kernel + "
                  f"memset at {100 * b_ms / t_kern:.1f}% of it, the call at "
                  f"{100 * b_ms / t_call:.1f}%", flush=True)
            del inputs
    return out


def raster_split(model, det, shape, rt):
    """The raster stage of one 2D call, split (medians of 5): setup (the
    render order, the labels and the kernel's inputs; CUDA events), the
    kernel + memset, the unpack to uint16 or int32, the device-to-host copy
    and the host's astype(np.int32) (host clock). The survivors are the
    call's ``det``."""
    from stardist_torch.geometry.geom2d import render_order
    dev = model.device
    d = torch.from_numpy(det["dist"]).to(dev)
    p = torch.from_numpy(det["points"]).to(dev)
    prob = torch.from_numpy(det["prob"]).to(dev)
    n = len(prob)
    dtype = torch.uint16 if n < 2 ** 16 - 1 else torch.int32

    def setup():
        order = render_order(prob)
        return rt.kernel_inputs(d, p, order, torch.arange(n, device=dev))

    inputs = setup()
    img = rt.draw(inputs, shape, n <= rt.PACK32_MAX)
    lab = rt.narrow(img, shape, dtype)        # in place on an int32 image: alike when repeated
    ms = dict(setup=cuda_ms(setup, iters=5),
              kernel_memset=cuda_ms(lambda: rt.draw(inputs, shape, n <= rt.PACK32_MAX), iters=5),
              unpack=cuda_ms(lambda: rt.narrow(img, shape, dtype), iters=5))
    host = {"copy": [], "astype": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cpu = lab.cpu()
        t1 = time.perf_counter()
        cpu.numpy().astype(np.int32)
        t2 = time.perf_counter()
        host["copy"].append((t1 - t0) * 1e3)
        host["astype"].append((t2 - t1) * 1e3)
    ms.update({k: float(np.median(v)) for k, v in host.items()})
    return (f"{n} survivors, {dtype} labels: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
            + f" ms (sum {sum(ms.values()):.3f} ms)")


def phase_j(dev, kernels, StarDist2D):
    """predict_instances_device against predict_instances, on the card."""
    model = StarDist2D(None, "2D_demo", "models/examples", device=dev)
    img, _ = synthetic_nuclei((E2E_SIZE, E2E_SIZE), seed=123)
    ref_labels, ref = model.predict_instances(img)
    model.predict_instances_device(img)                # warm-up
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    labels, det = model.predict_instances_device(img)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels, model)
    check(np.array_equal(labels, ref_labels), "device path labels differ from predict_instances")
    for k in ("points", "prob", "coord"):
        check(np.array_equal(det[k], ref[k]), f"device path {k} differs from predict_instances")
    t0 = time.perf_counter()
    lab_d, det_d = model.predict_instances_device(img, fetch=False)
    torch.cuda.synchronize()
    wall_nf = time.perf_counter() - t0
    check(lab_d.is_cuda and lab_d.dtype == torch.uint16 and det_d["dist"].is_cuda,
          "fetch=False must return uint16 labels and survivors on the card")
    check(np.array_equal(lab_d.cpu().numpy().astype(np.int32), labels), "fetch=False labels")
    x_dev = torch.from_numpy(img).to(dev)
    lab_t, _ = model.predict_instances_device(x_dev)
    check(np.array_equal(lab_t, labels), "pre-staged tensor input gives other labels")
    n_sync = host_syncs(lambda: model.predict_instances_device(x_dev, fetch=False))[0]
    walls = walls_ms({"predict_instances": lambda: model.predict_instances(img),
                      "fetch=True": lambda: model.predict_instances_device(img),
                      "fetch=False": lambda: model.predict_instances_device(img, fetch=False)},
                     rounds=5)
    t, c = det["timings_s"], det["nms_counters"]
    print(f"(j) predict_instances_device {E2E_SIZE}^2 on the card: labels, points, prob and "
          f"coord equal predict_instances ({len(det['prob'])} objects; pre-staged tensor "
          f"input equal too); wall fetch=True {wall * 1e3:.1f} ms = forward "
          f"{t['forward'] * 1e3:.1f} + extract {t['extract'] * 1e3:.1f} + nms "
          f"{t['nms'] * 1e3:.1f} + raster and copy back {t['raster'] * 1e3:.1f} ms; fetch=False {wall_nf * 1e3:.1f} ms; "
          f"{c['n_candidates']} candidates; {n_sync} host syncs flagged in one call "
          f"(pre-staged input, fetch=False); launches {launches}; 5 rounds of warm calls in "
          f"turn, median (min-max): {walls}", flush=True)
    return n_sync


def seam_report(model, img, lab1, lab2, det1, det2):
    """Where the untiled (lab1, det1) and tiled (lab2, det2, n_tiles=(2, 2))
    results differ: the differing pixels and the survivors found by only
    one call, each counted in all and within a seam's overlap band (the
    context a tile adds on each side of a seam); the survivors with tied
    probs (whose ids and drawing order follow the candidate list order,
    which tiling changes) and the pixels that still differ once the tiled
    labels carry the untiled ids; and the dense prediction's largest
    differences, tiled against untiled."""
    grid = model.config.grid
    band = [int(np.ceil(o / d)) * d for o, d in zip(model._axes_tile_overlap("YX"),
                                                    model._axes_div_by("YX"))]
    seams = [set(), set()]
    for _, _, s_dst in model._tiles(np.zeros(img.shape + (1,), np.float32), "YXC", (2, 2, 1)):
        for ax in (0, 1):
            if s_dst[ax].start > 0:
                seams[ax].add(s_dst[ax].start * grid[ax])
    masks = [np.zeros(n, bool) for n in img.shape]    # per axis: within a band
    for ax in (0, 1):
        for at in seams[ax]:
            masks[ax][max(0, at - band[ax]):at + band[ax] + 1] = True

    def near(yx):
        yx = np.asarray(yx, np.int64).reshape(-1, 2)
        return masks[0][yx[:, 0]] | masks[1][yx[:, 1]]

    diff = np.argwhere(lab1 != lab2)
    only = np.array(sorted(set(map(tuple, det1["points"].tolist()))
                           ^ set(map(tuple, det2["points"].tolist()))))
    # the tiled labels renamed to the untiled call's ids of the same survivors
    # (by position): what differs then is not the naming of the objects
    ids = {p: i + 1 for i, p in enumerate(map(tuple, det1["points"].tolist()))}
    rename = np.array([0] + [ids.get(p, 0) for p in map(tuple, det2["points"].tolist())])
    n_renamed = int((rename[lab2] != lab1).sum())
    ties = len(det1["prob"]) - len(np.unique(det1["prob"]))
    in_band = 1 - (1 - masks[0].mean()) * (1 - masks[1].mean())
    p1, d1 = model.predict(img, n_tiles=(1, 1))
    p2, d2 = model.predict(img, n_tiles=(2, 2))
    dp = np.abs(p1 - p2)
    rows = np.argwhere(dp > 0) * np.array(grid)
    return (f"seams at {sorted(seams[0])}/{sorted(seams[1])} px, overlap band +-{band} px "
            f"({in_band:.3f} of the image): differing pixels {len(diff)}, of them "
            f"{int(near(diff).sum())} in the band; survivors found by one call only "
            f"{len(only)}, of them {int(near(only).sum())} in the band; survivors whose prob "
            f"ties another's {ties}; differing pixels after renaming the tiled labels to the "
            f"untiled ids of the same survivors {n_renamed}; dense predict tiled "
            f"vs untiled: prob max abs diff {dp.max():.3g} at {len(rows)} grid points, "
            f"{int(near(rows).sum())} in the band; dist max abs diff "
            f"{np.abs(d1 - d2).max():.3g}")


def phase_k(dev, kernels, matching, StarDist2D, rt):
    """Tiled predict_instances (n_tiles=(2, 2)) against one tile."""
    model = StarDist2D(None, "2D_demo", "models/examples", device=dev)
    img, lbl = synthetic_nuclei((TILED_SIZE, TILED_SIZE), seed=321)
    for n_tiles in ((2, 2), (1, 1)):                   # warm-up (and the receptive field)
        model.predict_instances(img, n_tiles=n_tiles)
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    lab2, det2 = model.predict_instances(img, n_tiles=(2, 2))
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches = read_launches(kernels, model, n_calls=4)
    t0 = time.perf_counter()
    lab1, det1 = model.predict_instances(img, n_tiles=(1, 1))
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    acc = matching(lab1, lab2, thresh=0.5).accuracy
    check(acc >= 0.99, f"tiled vs untiled labels: matching accuracy {acc} < 0.99")
    ap = matching(lbl, lab2, thresh=0.5).accuracy
    n_diff = int((lab1 != lab2).sum())
    seams = seam_report(model, img, lab1, lab2, det1, det2)
    walls = walls_ms({"n_tiles=(2, 2)": lambda: model.predict_instances(img, n_tiles=(2, 2)),
                      "n_tiles=(1, 1)": lambda: model.predict_instances(img, n_tiles=(1, 1))},
                     rounds=3)
    def split(det):
        return ", ".join(f"{k} {v * 1e3:.1f}" for k, v in det["timings_s"].items()) + " ms"

    print(f"(k) predict_instances {TILED_SIZE}^2 on the card, n_tiles=(2, 2) vs (1, 1): "
          f"matching accuracy {acc:.4f}, labels equal: {np.array_equal(lab1, lab2)} "
          f"({n_diff} pixels differ), objects {len(det2['prob'])} / {len(det1['prob'])} "
          f"({int(lbl.max())} true), tiled AP@0.5 {ap:.4f}; wall tiled {wall2 * 1e3:.1f} ms "
          f"[{split(det2)}], untiled {wall1 * 1e3:.1f} ms [{split(det1)}]; tile overlap "
          f"{model._axes_tile_overlap('YX')}; "
          f"{seams}; "
          f"launches (tiled call) {launches}; 3 rounds of warm calls in turn, median "
          f"(min-max): {walls}", flush=True)
    print(f"(k) nms_polygons at {TILED_SIZE}^2 untiled, split: "
          f"{nms_profile(model, img, kernels['pair'])}", flush=True)
    print(f"(k) raster stage at {TILED_SIZE}^2 untiled (stage "
          f"{det1['timings_s']['raster'] * 1e3:.3f} ms in the call above), split: "
          f"{raster_split(model, det1, img.shape, rt)}", flush=True)
    return launches


def set_tf32(on):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


class StageMarks:
    """A CUDA event and a host time at each stage of the training loop's
    steps (the model's ``step_marks`` hook)."""

    def __init__(self):
        self.marks = []

    def __call__(self, stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((stage, time.perf_counter(), ev))

    def split(self):
        """Median per stage over the steps: "wait" (for the producer) by the
        host clock, the others by CUDA events (each from the previous
        stage's mark to its own); and the median host time from one step's
        start to the next's."""
        torch.cuda.synchronize()
        steps = []
        for m in self.marks:
            if m[0] == "start":
                steps.append([])
            steps[-1].append(m)
        stages = {}
        for st in steps:
            for (_, h0, e0), (name, h1, e1) in zip(st, st[1:]):
                stages.setdefault(name, []).append(
                    (h1 - h0) * 1e3 if name == "wait" else e0.elapsed_time(e1))
        walls = [(b[0][1] - a[0][1]) * 1e3 for a, b in zip(steps, steps[1:])]
        return {k: float(np.median(v)) for k, v in stages.items()}, float(np.median(walls))


def device_busy(fn):
    """fn() under torch.profiler: its wall, the device time of its CUDA
    kernels and copies, the six largest ops; or a text saying why not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ops, host = [], []
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                us = getattr(e, "self_cuda_time_total", 0) if us is None else us
                ops.append((us / 1e3, e.count, e.key))
            else:
                host.append((e.self_cpu_time_total / 1e3, e.count, e.key))
    except Exception as exc:                          # a measurement, not a check
        return f"torch.profiler failed: {exc!r}"
    if not ops:
        return "torch.profiler saw no device time"
    ops.sort(reverse=True)
    host.sort(reverse=True)
    busy = sum(ms for ms, _, _ in ops)
    top = "; ".join(f"{name[:60]} {ms:.2f} ms x{n}" for ms, n, name in ops[:6])
    top_host = "; ".join(f"{name[:50]} {ms:.2f} ms x{n}" for ms, n, name in host[:8])
    return (f"wall {wall:.1f} ms, device {busy:.1f} ms ({100 * busy / wall:.0f}% busy); top "
            f"device ops: {top}; top host ops (self CPU time): {top_host}")


def train_vs_cpu(dev, StarDist2D, cfg, data):
    """One fixed raw batch, the same seeded weights, TF32 off: the card's
    targets, loss, metrics and gradients against the CPU port's."""
    np.random.seed(11)
    raw = data.raw_item(0)
    out = []
    for device in (dev, "cpu"):
        m = StarDist2D(cfg, name="l_cmp", basedir=None, device=device)
        m.prepare_for_training()
        t = m._targets_fn(m._put_batch(raw))
        loss, metrics = m._loss_and_metrics(t)
        loss.backward()
        out.append((t, {k: float(v) for k, v in metrics.items()},
                    {k: p.grad.cpu() for k, p in m.net.named_parameters()}))
    (tg, mg, gg), (tc, mc, gc) = out
    R = cfg.n_rays
    check(torch.equal(tg["dist"][..., :R].cpu(), tc["dist"][..., :R]),
          "star-dist targets: card != CPU")
    e_prob = max((tg[k][..., -1].cpu() - tc[k][..., -1]).abs().max().item() for k in ("prob", "dist"))
    check(e_prob <= TARGET_TOL, f"prob targets: card vs CPU {e_prob}")
    e_met = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30) for k in mc)
    check(e_met <= METRIC_RTOL, f"loss / metrics: card vs CPU rel {e_met}: {mg} {mc}")
    e_grad = max(((gg[k] - gc[k]).abs().max() / gc[k].abs().max().clamp_min(1e-30)).item()
                 for k in gc)
    check(e_grad <= GRAD_TOL, f"gradients: card vs CPU rel {e_grad}")
    n_lab = int((raw["labels"] > 0).sum())
    return (f"targets equal (dist exact, prob max abs diff {e_prob:.1e}; {n_lab} labels, march "
            f"bound {raw['steps']} steps), loss {mg['loss']:.6f} vs {mc['loss']:.6f}, metrics max "
            f"rel diff {e_met:.1e}, gradients max rel diff {e_grad:.1e} over "
            f"{len(gc)} parameters; {targets_split(dev, cfg, raw)}")


def targets_split(dev, cfg, raw):
    """CUDA-event times of the two parts of the fused targets on ``raw``:
    the EDT prob and the star-distance march."""
    from stardist_torch.ops.edt import edt_prob_batch
    from stardist_torch.ops.stardist2d import star_dist2d
    gy, gx = cfg.grid
    y = torch.from_numpy(raw["y"]).to(dev).clamp_min(0)
    labels = torch.from_numpy(raw["labels"]).to(dev)
    ms_edt = cuda_ms(lambda: edt_prob_batch(y[:, ::gy, ::gx], labels))
    ms_march = cuda_ms(lambda: star_dist2d(y, cfg.n_rays, cfg.grid, n_steps=raw["steps"]))
    return (f"targets split on this batch: EDT {ms_edt:.3f} ms ({labels.shape[0]} x "
            f"{labels.shape[1]} labels), march {ms_march:.3f} ms")


def train_run(dev, kernels, StarDist2D, cfg, X, Y, workdir, tf32):
    """StarDist2D.train on the card: checks and numbers of one run."""
    set_tf32(tf32)
    m = StarDist2D(cfg, name=f"l_tf32_{'on' if tf32 else 'off'}", basedir=workdir, device=dev)
    x0 = torch.from_numpy(X[0][:512, :512, None]).to(dev)
    m.net(x0)                      # the kernel path's packed weights, before training
    marks = StageMarks()
    m.step_marks = marks
    reset_launches(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    h = m.train(X, Y, validation_data=(X[:2], Y[:2]), seed=21, epochs=TRAIN_EPOCHS,
                steps_per_epoch=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    m.step_marks = None
    launches = {name: k.launches for name, k in kernels.items()}
    losses = np.asarray(h.steps["loss"])
    check(len(losses) == TRAIN_EPOCHS * TRAIN_STEPS and np.isfinite(losses).all(),
          f"training losses not finite: {losses}")
    first, last = losses[:10].mean(), losses[-10:].mean()
    check(last < first, f"training loss did not fall: first 10 steps {first}, last 10 {last}")
    split, step_ms = marks.split()
    gen = torch.Generator(device=dev).manual_seed(0)
    # pinned, as the training loop's producer hands them over
    batches = [{k: torch.from_numpy(v).pin_memory() if isinstance(v, np.ndarray) else v
                for k, v in m.data_train.raw_item(i).items()} for i in range(TRAIN_PROFILED)]
    m._train_step(m._put_batch(batches[0]), gen)
    n_sync, sites = host_syncs(lambda: m._train_step(m._put_batch(batches[0]), gen))
    busy = device_busy(lambda: [m._train_step(m._put_batch(b), gen) for b in batches])
    host = host_split(m, batches, gen)
    text = (f"TF32 {'on' if tf32 else 'off'}: {len(losses)} steps, call {wall:.1f} s "
            f"({len(losses) / wall:.1f} steps/s with validation, checkpoints and start-up), "
            f"step {step_ms:.2f} ms median ({1e3 / step_ms:.1f} steps/s); loss first 10 "
            f"{first:.4f}, last 10 {last:.4f}, val_loss {h.history['val_loss']}; split (median "
            f"ms): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) +
            f"; peak memory {peak:.2f} GiB; host syncs in one step {n_sync} {sites}; "
            f"{TRAIN_PROFILED} steps profiled: {busy}; {host}; kernel launches during train "
            f"{launches}")
    return m, text


def host_split(m, batches, gen):
    """Host clock: the producer's work for one batch (``raw_item`` and the
    pinning), and the wall of the pre-made ``batches``' steps alone and
    with a thread doing the producer's work beside them."""
    import threading

    def produce(i):
        return {k: torch.from_numpy(v).pin_memory() if isinstance(v, np.ndarray) else v
                for k, v in m.data_train.raw_item(i).items()}

    t0 = time.perf_counter()
    for i in range(len(batches)):
        produce(i)
    t_batch = (time.perf_counter() - t0) * 1e3 / len(batches)

    def steps_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            m._train_step(m._put_batch(b), gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(batches)

    alone = steps_ms()
    stop = threading.Event()

    def busy_producer():
        i = 0
        while not stop.is_set():
            produce(i)
            i += 1

    thread = threading.Thread(target=busy_producer)
    thread.start()
    try:
        beside = steps_ms()
    finally:
        stop.set()
        thread.join()
    return (f"host: the producer's work {t_batch:.1f} ms per batch; a step {alone:.1f} ms "
            f"alone, {beside:.1f} ms beside a thread doing the producer's work")


def phase_l(dev, kernels, StarDist2D, Config2D):
    """2D training on the card, at full width."""
    from stardist_torch.models.model2d import StarDistData2D
    import shutil
    import tempfile
    n, side = TRAIN_FIELDS
    fields = [synthetic_nuclei((side, side), seed=700 + i) for i in range(n)]
    X, Y = [f[0] for f in fields], [f[1] for f in fields]
    cfg = Config2D(**TRAIN_CONFIG)
    os.makedirs("build", exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_", dir="build")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        set_tf32(False)
        data = StarDistData2D(X, Y, batch_size=cfg.train_batch_size, n_rays=cfg.n_rays, length=1,
                              patch_size=cfg.train_patch_size, grid=cfg.grid,
                              foreground_prob=cfg.train_foreground_only)
        print(f"(l) training step at {cfg.train_patch_size} x {cfg.train_batch_size}, card vs CPU "
              f"(TF32 off): {train_vs_cpu(dev, StarDist2D, cfg, data)}", flush=True)
        runs = {}
        for tf32 in (False, True):
            runs[tf32], text = train_run(dev, kernels, StarDist2D, cfg, X, Y, workdir, tf32)
            print(f"(l) StarDist2D.train {TRAIN_EPOCHS} x {TRAIN_STEPS} steps, {n} fields of "
                  f"{side}^2: {text}", flush=True)
        set_tf32(False)
        m = runs[False]
        x = torch.from_numpy(X[1][:, :, None]).to(dev)
        prob, dist = m.net(x)
        prob_p, dist_p = m.net(x, plain=True)
        e_prob = (prob - prob_p).abs().max().item()
        e_dist = ((dist - dist_p).abs().max() / dist_p.abs().max().clamp_min(1.0)).item()
        check(e_prob < FWD_TOL and e_dist < FWD_TOL,
              f"trained net: kernel path vs plain: prob {e_prob}, dist {e_dist}")
        served = StarDist2D(None, name=m.name, basedir=workdir, device=dev)
        on_cpu = StarDist2D(None, name=m.name, basedir=workdir, device="cpu")
        img = X[1]
        prob_map, _ = served.predict(img)
        thresh = float(min(0.5, np.quantile(prob_map, 0.95)))
        reset_launches(kernels)
        labels, det = served.predict_instances(img, prob_thresh=thresh)
        torch.cuda.synchronize()
        launches = read_launches(kernels, served)
        check(labels.shape == img.shape and labels.max() > 0, "served model drew no label")
        p_c, d_c = on_cpu.net(torch.from_numpy(img[:, :, None]))
        p_g, d_g = served.net(x)
        e_c = max((p_g.cpu() - p_c).abs().max().item(),
                  ((d_g.cpu() - d_c).abs().max() / d_c.abs().max().clamp_min(1.0)).item())
        check(e_c < FWD_TOL, f"weights_best.h5 on the card vs on the CPU: {e_c}")
        print(f"(l) the trained net (TF32 off run): kernel path vs plain prob {e_prob:.2e}, dist "
              f"{e_dist:.2e}; weights_best.h5 reloaded: card (kernels, bf16) vs CPU (plain, "
              f"f32) forward {e_c:.2e}; predict_instances {side}^2 at prob_thresh {thresh:.3f}: "
              f"{len(det['prob'])} objects ({int(Y[1].max())} true), stages "
              + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in det["timings_s"].items())
              + f" ms, launches {launches}", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        shutil.rmtree(workdir, ignore_errors=True)


def phase_m(dev, kernels, matching, StarDist2D, rt):
    """The threshold search on the card, then sparse=False and scale."""
    import shutil
    import tempfile
    from stardist_torch.matching import matching_dataset
    from stardist_torch.nms import _ind_prob_thresh, descending_order
    from stardist_torch.utils import optimize_threshold
    n, side = THRESH_FIELDS
    fields = [synthetic_nuclei((side, side), seed=900 + i) for i in range(n)]
    X, Y = [f[0] for f in fields], [f[1] for f in fields]
    os.makedirs("build", exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_thresholds_", dir="build")
    try:
        shutil.copytree("models/examples/2D_demo", os.path.join(workdir, "2D_demo"))
        model = StarDist2D(None, "2D_demo", workdir, device=dev)
        model.predict_instances(X[0][:256, :256])          # warm-up
        torch.cuda.synchronize()
        reset_launches(kernels)
        timings = {}
        t0 = time.perf_counter()
        opt = model.optimize_thresholds(X, Y, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        check(all(launches[k] > 0 for k in ("conv", "pair", "raster")),
              f"(m) the search missed a kernel: launches {launches}")
        with open(os.path.join(workdir, "2D_demo", "thresholds.json")) as f:
            saved = json.load(f)
        reloaded = StarDist2D(None, "2D_demo", workdir, device=dev)
        check(saved == opt and tuple(reloaded.thresholds) == (opt["prob"], opt["nms"]),
              f"thresholds.json {saved} does not reload as {opt}")
        preds = [model.predict_instances(x)[0] for x in X]
        measure = float(np.mean([s.accuracy for s in matching_dataset(
            Y, preds, thresh=(0.3, 0.5, 0.7), show_progress=False)]))
        check(np.isfinite(measure) and measure > 0.5, f"(m) measure {measure}")
        probes = timings["probes"]
        t = {k: v * 1e3 for k, v in timings.items() if k != "probes"}
        lab0, det0 = model.predict_instances(X[0])
        split = raster_split(model, det0, X[0].shape, rt)
        print(f"(m) optimize_thresholds, {n} fields of {side}^2 (2D_demo, n_tiles "
              f"{model._guess_n_tiles(X[0])}): prob {opt['prob']:.6f}, nms {opt['nms']}; mean "
              f"accuracy over IoU 0.3/0.5/0.7 of predict_instances at them {measure:.4f}; wall "
              f"{wall * 1e3:.1f} ms = predict {t['predict']:.1f} + extract {t['extract']:.1f} + "
              f"prefix NMS {t['nms']:.1f} ({n * 3} calls) + {probes} probes x {n} images: "
              f"raster and copy {t['render']:.1f} ({t['render'] / probes:.2f} per probe) + "
              f"matching {t['matching']:.1f} ({t['matching'] / probes:.2f} per probe) ms "
              f"(+ {wall * 1e3 - sum(t.values()):.1f} ms other); launches {launches}; one "
              f"probe's raster stage at {side}^2: {split}", flush=True)

        x_c, y_c = synthetic_nuclei((THRESH_CMP, THRESH_CMP), seed=950)
        yhat = [model.predict(x_c)]
        cpu = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
        prob = torch.from_numpy(yhat[0][0])
        mask = _ind_prob_thresh(prob, float(yhat[0][0].max()) / 2)
        o = descending_order(prob[mask])
        cand = (prob[mask][o], torch.from_numpy(yhat[0][1])[mask][o],
                (torch.nonzero(mask)[o] * torch.tensor(cpu.config.grid)).float())
        keep_gpu = model._nms_keep(*(c.to(dev) for c in cand), 0.4).cpu()
        keep_cpu = cpu._nms_keep(*cand, 0.4)
        check(torch.equal(keep_gpu, keep_cpu), "(m) keep flags: card != CPU")
        res_gpu = optimize_threshold([y_c], yhat, model, 0.4, verbose=0)
        res_cpu = optimize_threshold([y_c], yhat, cpu, 0.4, verbose=0)
        check(res_gpu == res_cpu, f"(m) search at {THRESH_CMP}^2: card {res_gpu} != CPU "
                                  f"{res_cpu}")
        print(f"(m) {THRESH_CMP}^2, the card's dense prediction: keep flags of {len(keep_cpu)} "
              f"candidates ({int(keep_cpu.sum())} kept) and the search at nms 0.4, (prob_thresh, "
              f"measure) = ({float(res_gpu[0]):.6f}, {float(res_gpu[1]):.4f}): card == CPU",
              flush=True)

        demo = StarDist2D(None, "2D_demo", "models/examples", device=dev)
        img, lbl = synthetic_nuclei((E2E_SIZE, E2E_SIZE), seed=123)
        lab_s, det_s = demo.predict_instances(img)
        reset_launches(kernels)
        lab_d, det_d = demo.predict_instances(img, sparse=False)
        torch.cuda.synchronize()
        launches_d = {name: k.launches for name, k in kernels.items()}
        check(np.array_equal(lab_s, lab_d), "(m) sparse=False labels != sparse=True labels")
        reset_launches(kernels)
        lab_sc, det_sc = demo.predict_instances(img, scale=0.5)
        torch.cuda.synchronize()
        launches_sc = {name: k.launches for name, k in kernels.items()}
        check(launches_d["raster"] > 0 and launches_sc["raster"] > 0 and launches_d["pair"] > 0,
              f"(m) sparse=False / scale missed a kernel: {launches_d}, {launches_sc}")
        ap_d = matching(lbl, lab_d, thresh=0.5).accuracy
        ap_sc = matching(lbl, lab_sc, thresh=0.5).accuracy
        check(ap_d >= 0.95 and lab_sc.shape == img.shape and lab_sc.max() > 0,
              f"(m) sparse=False AP@0.5 {ap_d}, scaled labels {lab_sc.shape}")
        crop = img[:THRESH_CMP, :THRESH_CMP]
        lab_g = demo.predict_instances(crop, scale=0.5)[0]
        lab_c = cpu.predict_instances(crop, scale=0.5)[0]
        acc = matching(lab_c, lab_g, thresh=0.5).accuracy
        check(acc >= 0.99, f"(m) scale=0.5 at {THRESH_CMP}^2, card vs CPU: accuracy {acc} < 0.99")

        def stages(det):
            return ", ".join(f"{k} {v * 1e3:.1f}" for k, v in det["timings_s"].items()) + " ms"
        print(f"(m) predict_instances {E2E_SIZE}^2: sparse=False == sparse=True labels, "
              f"{len(det_d['prob'])} objects, AP@0.5 {ap_d:.4f}, stages {stages(det_d)} "
              f"(sparse=True: {stages(det_s)}), "
              f"launches {launches_d}; scale=0.5: {len(det_sc['prob'])} objects, AP@0.5 "
              f"{ap_sc:.4f}, stages {stages(det_sc)}, launches {launches_sc}; scale=0.5 at "
              f"{THRESH_CMP}^2 card vs CPU: matching accuracy {acc:.4f}", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def train3d_config(Y, backbone, Config3D, **extra):
    """upstream StarDist's examples/3D/2_training.ipynb: the anisotropy from
    the median extents of the training labels, the grid 1 along an axis
    more than 1.5 times coarser and 2 along the others, 96 golden-spiral
    rays with that anisotropy; ``extra`` config keys on top."""
    from stardist_torch.rays3d import Rays_GoldenSpiral
    from stardist_torch.utils import calculate_extents
    extents = calculate_extents(Y)
    anisotropy = tuple(float(a) for a in np.max(extents) / extents)
    grid = tuple(1 if a > 1.5 else 2 for a in anisotropy)
    kw = dict(TRAIN3D_CONFIG)
    rays = Rays_GoldenSpiral(kw.pop("n_rays"), anisotropy=anisotropy)
    return Config3D(rays=rays, grid=grid, anisotropy=anisotropy, backbone=backbone,
                    train_tensorboard=False, **kw, **extra)


def train3d_vs_cpu(dev, StarDist3D, cfg, raw):
    """One fixed raw batch, the same seeded weights, TF32 off: the card's
    targets, loss, metrics and gradients against the CPU port's."""
    from stardist_torch.ops.edt import edt_prob_batch
    from stardist_torch.ops.stardist3d import star_dist3d
    out = []
    for device in (dev, "cpu"):
        m = StarDist3D(cfg, name="n_cmp", basedir=None, device=device)
        m.prepare_for_training()
        t0 = time.perf_counter()
        t = m._targets_fn(m._put_batch(raw))
        if device == "cpu":
            t_cpu = time.perf_counter() - t0
        loss, metrics = m._loss_and_metrics(t)
        loss.backward()
        out.append((t, {k: float(v) for k, v in metrics.items()},
                    {k: p.grad.cpu() for k, p in m.net.named_parameters()}))
    (tg, mg, gg), (tc, mc, gc) = out
    for k in ("x", "prob", "dist"):
        check(torch.equal(tg[k].cpu(), tc[k]), f"(n) {k} targets: card != CPU")
    e_met = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30) for k in mc)
    check(e_met <= METRIC_RTOL, f"(n) loss / metrics: card vs CPU rel {e_met}: {mg} {mc}")
    e_grad = max(((gg[k] - gc[k]).abs().max() / gc[k].abs().max().clamp_min(1e-30)).item()
                 for k in gc)
    check(e_grad <= GRAD_TOL, f"(n) gradients: card vs CPU rel {e_grad}")
    gz, gy, gx = cfg.grid
    y = torch.from_numpy(raw["y"]).to(dev).clamp_min(0)
    labels = torch.from_numpy(raw["labels"]).to(dev)
    spacing = tuple(float(a) for a in cfg.anisotropy)
    rays = m.rays
    ms_edt = cuda_ms(lambda: edt_prob_batch(y, labels, spacing))
    ms_march = cuda_ms(lambda: star_dist3d(y, rays, cfg.grid, n_steps=raw["steps"]))
    n_lab = int((raw["labels"] > 0).sum())
    return (f"targets exactly equal ({n_lab} labels, march bound {raw['steps']} steps; the "
            f"CPU's targets {t_cpu:.1f} s), loss {mg['loss']:.6f} vs {mc['loss']:.6f}, metrics "
            f"max rel diff {e_met:.1e}, gradients max rel diff {e_grad:.1e} over {len(gc)} "
            f"parameters; targets split on this batch: EDT {ms_edt:.3f} ms (full resolution, "
            f"{labels.shape[0]} x {labels.shape[1]} labels), march {ms_march:.3f} ms")


def train3d_run(dev, StarDist3D, cfg, X, Y, workdir, name, epochs, steps):
    """StarDist3D.train on the card (TF32 off): checks and numbers of one run."""
    m = StarDist3D(cfg, name=name, basedir=workdir, device=dev)
    marks = StageMarks()
    m.step_marks = marks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    h = m.train(X[2:], Y[2:], validation_data=(X[:2], Y[:2]), seed=31, epochs=epochs,
                steps_per_epoch=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    m.step_marks = None
    losses = np.asarray(h.steps["loss"])
    check(len(losses) == epochs * steps and np.isfinite(losses).all()
          and np.isfinite(h.history["val_loss"]).all(), f"(n) {name}: losses not finite: {losses}")
    first, last = losses[:5].mean(), losses[-5:].mean()
    split, step_ms = marks.split()
    text = (f"{len(losses)} steps, call {wall:.1f} s ({len(losses) / wall:.2f} steps/s with "
            f"validation, checkpoints and start-up), step {step_ms:.1f} ms median "
            f"({1e3 / step_ms:.2f} steps/s); loss first 5 {first:.4f}, last 5 {last:.4f}, val_loss "
            f"{[round(v, 4) for v in h.history['val_loss']]}; split (median ms): "
            + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + f"; peak memory {peak:.2f} GiB")
    return m, text, (first, last)


def phase_n(dev, conv, StarDist3D, Config3D):
    """3D training on the card: the upstream training notebook's configuration."""
    import shutil
    import tempfile
    from stardist_torch.models.model3d import StarDistData3D
    from stardist_torch.rays3d import rays_from_json
    n, shape = TRAIN3D_FIELDS
    fields = [synthetic_nuclei_3d(shape, seed=1100 + i) for i in range(n)]
    X, Y = [f[0] for f in fields], [f[1] for f in fields]
    cfg = train3d_config(Y[2:], "resnet", Config3D)
    os.makedirs("build", exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train3d_", dir="build")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        set_tf32(False)
        data = StarDistData3D(X[2:], Y[2:], rays=rays_from_json(cfg.rays_json),
                              batch_size=cfg.train_batch_size,
                              length=3, patch_size=cfg.train_patch_size, grid=cfg.grid,
                              anisotropy=cfg.anisotropy,
                              foreground_prob=cfg.train_foreground_only, device=dev)
        np.random.seed(13)
        t0 = time.perf_counter()
        raw = data.raw_item(0)
        t_raw = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        data.raw_item(1)
        t_raw2 = (time.perf_counter() - t0) * 1e3
        print(f"(n) config (examples/3D/2_training.ipynb): anisotropy "
              f"{tuple(round(a, 3) for a in cfg.anisotropy)}, grid {cfg.grid}, {cfg.n_rays} rays, "
              f"patches {cfg.train_patch_size} x {cfg.train_batch_size}, {n} volumes of "
              f"{'x'.join(map(str, shape))} ({sum(int(y.max()) for y in Y)} nuclei); the "
              f"producer's host work for a batch {t_raw:.1f} ms (first, with the sampling "
              f"caches) / {t_raw2:.1f} ms (second)", flush=True)
        print(f"(n) ResNet training step at {cfg.train_patch_size} x {cfg.train_batch_size}, card "
              f"vs CPU (TF32 off): {train3d_vs_cpu(dev, StarDist3D, cfg, raw)}", flush=True)
        m, text, (first, last) = train3d_run(dev, StarDist3D, cfg, X, Y, workdir, "n_resnet",
                                             TRAIN3D_EPOCHS, TRAIN3D_STEPS)
        check(last < first, f"(n) ResNet training loss did not fall: first 5 {first}, last 5 {last}")
        gen = torch.Generator(device=dev).manual_seed(0)
        batches = [{k: torch.from_numpy(v).pin_memory() if isinstance(v, np.ndarray) else v
                    for k, v in m.data_train.raw_item(i).items()} for i in range(3)]
        m._train_step(m._put_batch(batches[0]), gen)
        busy = device_busy(lambda: [m._train_step(m._put_batch(b), gen) for b in batches])
        print(f"(n) StarDist3D.train (ResNet) {TRAIN3D_EPOCHS} x {TRAIN3D_STEPS} steps: {text}; "
              f"3 steps profiled: {busy}", flush=True)

        served = StarDist3D(None, name="n_resnet", basedir=workdir, device=dev)
        on_cpu = StarDist3D(None, name="n_resnet", basedir=workdir, device="cpu")
        check(all(torch.equal(a.cpu(), b) for a, b in zip(served.net.state_dict().values(),
                                                           on_cpu.net.state_dict().values())),
              "(n) weights_best.h5 reads differently on the card and on the CPU")
        xv = X[0][:32, :64, :64]
        p_g, d_g = served.net(torch.from_numpy(xv[..., None]).to(dev))
        p_c, d_c = on_cpu.net(torch.from_numpy(xv[..., None]))
        e_c = max((p_g.cpu() - p_c).abs().max().item(),
                  ((d_g.cpu() - d_c).abs().max() / d_c.abs().max().clamp_min(1.0)).item())
        check(e_c < FWD_TOL, f"(n) ResNet weights_best.h5: card (bf16) vs CPU (f32) forward {e_c}")

        cfg_u = train3d_config(Y[2:], "unet", Config3D)
        mu, text_u, _ = train3d_run(dev, StarDist3D, cfg_u, X, Y, workdir, "n_unet", 1, 5)
        served_u = StarDist3D(None, name="n_unet", basedir=workdir, device=dev)
        img = X[1]
        prob_map, _ = served_u.predict(img)
        thresh = float(min(0.5, np.quantile(prob_map, 0.999)))
        served_u.predict_instances(img[:32, :64, :64], prob_thresh=thresh)     # warm-up
        torch.cuda.synchronize()
        conv.KERNEL3D.launches = 0
        labels, det = served_u.predict_instances(img, prob_thresh=thresh)
        torch.cuda.synchronize()
        launches = conv.KERNEL3D.launches
        n_conv = len(served_u.net.conv_blocks())
        check(launches == n_conv, f"(n) conv3d launches {launches} != {n_conv} convs x 1 call")
        check(labels.shape == img.shape, "(n) served U-Net: label volume shape")
        print(f"(n) ResNet weights_best.h5 reloaded: card (bf16 F.conv3d) vs CPU (f32) forward "
              f"{e_c:.2e}; StarDist3D.train (U-Net) 1 x 5 steps: {text_u}; its weights_best.h5 "
              f"served by predict_instances on {'x'.join(map(str, img.shape))} at prob_thresh "
              f"{thresh:.3f}: {len(det['prob'])} objects, stages "
              + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in det["timings_s"].items())
              + f" ms, conv3d launches {launches} ({n_conv} convs)", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        shutil.rmtree(workdir, ignore_errors=True)


def phase_o(dev, conv, matching, StarDist3D):
    """The 3D surface on the card: the device path, sparse=False, scale,
    overlap_label."""
    model = StarDist3D(None, "3D_demo", "models/examples", device=dev)
    img, lbl = synthetic_nuclei_3d(E2E3D_SHAPE, seed=3)
    model.predict_instances(img)                       # warm-up
    torch.cuda.synchronize()

    def call(name, fn):
        conv.KERNEL3D.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = conv.KERNEL3D.launches
        check(launches == len(model.net.conv_blocks()),
              f"(o) {name}: conv3d launches {launches} != {len(model.net.conv_blocks())}")
        det = out[1]
        text = f"{name} {wall:.1f} ms"
        if "timings_s" in det:
            text += (" [" + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in det["timings_s"].items())
                     + " ms]")
        return out, f"{text}, {len(det['prob'])} objects, conv3d launches {launches}"

    (ref, det_ref), t_ref = call("predict_instances", lambda: model.predict_instances(img))
    # the device path runs the reference's device lattice, S = 10
    (ref10, det10), t_10 = call("samples=10", lambda: model.predict_instances(
        img, nms_kwargs={"samples": 10}))
    (lab_d, det_d), t_d = call("predict_instances_device fetch=True",
                               lambda: model.predict_instances_device(img))
    check(np.array_equal(lab_d, ref10), "(o) device path labels != predict_instances at S=10")
    for k in ("points", "prob", "dist"):
        check(np.array_equal(det_d[k], det10[k]), f"(o) device path {k} != predict_instances "
                                                  f"at S=10")
    (lab_t, det_t), t_t = call("fetch=False",
                               lambda: model.predict_instances_device(img, fetch=False))
    check(lab_t.is_cuda and lab_t.dtype == torch.int32
          and all(det_t[k].is_cuda for k in ("points", "prob", "dist")),
          "(o) fetch=False must return the labels and survivors on the card")
    check(np.array_equal(lab_t.cpu().numpy(), ref10), "(o) fetch=False labels")
    (lab_s, det_s), t_s = call("sparse=False", lambda: model.predict_instances(img, sparse=False))
    check(np.array_equal(lab_s, ref), "(o) sparse=False labels != sparse=True labels")
    (lab_sc, det_sc), t_sc = call("scale=(1, 0.5, 0.5)",
                                  lambda: model.predict_instances(img, scale=(1, 0.5, 0.5)))
    check(lab_sc.shape == img.shape and lab_sc.max() > 0, "(o) scaled labels")
    (lab_o, det_o), t_o = call("overlap_label=-1",
                               lambda: model.predict_instances(img, overlap_label=-1))
    n_overlap = int((lab_o == -1).sum())
    check(n_overlap > 0 and np.array_equal(lab_o != 0, ref > 0),
          "(o) overlap_label=-1: no overlap, or the objects' union moved")
    ap = {k: matching(lbl, np.maximum(v, 0), thresh=0.1).accuracy
          for k, v in (("scale", lab_sc), ("overlap_label", lab_o))}

    from scipy import ndimage as ndi
    crop = img[tuple(slice(0, s) for s in SURFACE3D_CMP)]
    cpu = StarDist3D(None, "3D_demo", "models/examples", device="cpu")
    zoomed = ndi.zoom(crop, (1, 0.5, 0.5), order=1)
    cand = cpu._predict_sparse(zoomed)
    check(len(cand[0]) > 0, f"(o) no candidates in the {SURFACE3D_CMP} crop")
    scale = {"Z": 1, "Y": 0.5, "X": 0.5}
    kw = dict(scale=scale, render_kw=dict(overlap_label=-1))
    lab_g, det_g = model._instances_from_prediction(crop.shape, *(c.to(dev) for c in cand), **kw)
    lab_c, det_c = cpu._instances_from_prediction(crop.shape, *cand, **kw)
    check(np.array_equal(lab_g, lab_c) and np.array_equal(det_g["points"], det_c["points"]),
          f"(o) {SURFACE3D_CMP} crop, scale and overlap_label on the CPU's candidates: card != CPU")
    print(f"(o) 3D surface, 3D_demo on {'x'.join(map(str, E2E3D_SHAPE))}: device path (fetch=True "
          f"and fetch=False on the card) == predict_instances(nms_kwargs={{'samples': 10}}), "
          f"sparse=False == sparse=True; "
          f"scale AP@0.1 {ap['scale']:.4f}, overlap_label=-1 {n_overlap} voxels (AP@0.1 "
          f"{ap['overlap_label']:.4f}); calls: {t_ref}; {t_10}; {t_d}; {t_t}; {t_s}; {t_sc}; "
          f"{t_o}; "
          f"{'x'.join(map(str, SURFACE3D_CMP))} crop with scale (1, 0.5, 0.5) and "
          f"overlap_label=-1 on the CPU's {len(cand[0])} candidates: card == CPU "
          f"({len(det_c['prob'])} objects)", flush=True)


def multiclass_config(config, n_classes):
    """A model's config with a class branch of ``n_classes`` (and the
    reference's loss and class weights for it)."""
    return dict(config.to_dict(), n_classes=n_classes, train_loss_weights=(1, 0.2, 1),
                train_class_weights=(1,) * (n_classes + 1))


def grafted(Model, Config, name, n_classes, dev):
    """``models/examples/<name>`` with a seeded class branch of
    ``n_classes`` grafted on (the model's seeded initialisation for it, the
    demo's trained weights for everything else) on ``dev``, and the demo."""
    demo = Model(None, name, "models/examples", device=dev)
    m = Model(Config(**multiclass_config(demo.config, n_classes)), basedir=None, device=dev)
    missing, unexpected = m.net.load_state_dict(demo.net.state_dict(), strict=False)
    check(not unexpected and missing and all("class" in k for k in missing),
          f"graft: missing {missing}, unexpected {unexpected}")
    m.thresholds = demo.thresholds
    return m, demo


def on_cpu(model, Model, inference_dtype=None):
    """The same model (config, weights, thresholds) on the CPU (float32
    convs unless ``inference_dtype`` says "bfloat16": the plain convs in the
    kernel's types)."""
    m = Model(model.config, basedir=None, device="cpu", inference_dtype=inference_dtype)
    m.net.load_state_dict({k: v.cpu() for k, v in model.net.state_dict().items()})
    m.thresholds = model.thresholds
    return m


def class_rows_at(model, img, points):
    """The dense class map of ``model.predict`` (on its device) at the
    survivors' ``points`` (full-resolution pixels)."""
    pc = model._predict(img)[2]
    g = torch.tensor(model.config.grid, device=pc.device)
    return pc[tuple((torch.from_numpy(np.asarray(points)).to(pc.device).long() // g).t())]


def shared_candidates(model, cpu, img):
    """The card's candidates of ``img`` through the card's and the CPU's NMS,
    raster and class rows: labels and every key must be equal."""
    prob, dist, pc, points = model._predict_sparse(img)
    lab_g, det_g = model._instances_from_prediction(img.shape[:model.config.n_dim], prob, dist,
                                                    points, pc)
    lab_c, det_c = cpu._instances_from_prediction(img.shape[:model.config.n_dim], prob.cpu(),
                                                  dist.cpu(), points.cpu(), pc.cpu())
    check(np.array_equal(lab_g, lab_c), "the same candidates: labels, card != CPU")
    for k in ("points", "prob", "class_prob", "class_id"):
        check(np.array_equal(det_g[k], det_c[k]), f"the same candidates: {k}, card != CPU")
    return len(prob), len(det_c["prob"])


def class_logits(pc):
    """The class logits of softmax maps ``pc`` (..., C), centred over the
    classes (log p minus its mean: the logits up to their shared offset),
    and where every class's probability is above 0 (elsewhere the log is
    not defined)."""
    ok = (pc > 0).all(-1)
    lg = np.log(np.where(pc > 0, pc, 1.0).astype(np.float64))
    return lg - lg.mean(-1, keepdims=True), ok


def class_maps_vs_cpu(model, cpu, img):
    """Card against CPU, both bf16 (the kernel and its plain twin). The
    class head is a linear head as the dist head is, so its logits get the
    dist's rule of (d): their largest difference relative to max(1, their
    largest magnitude) (the softmax, in f32 on both sides, amplifies a
    logit's bf16 rounding by up to p (1 - p) per unit); returns that, the
    class maps' largest difference, the pixels left out (a probability
    of 0), and the CPU survivors whose class_id the card's map would give
    otherwise, with their top-two logit margins on the CPU."""
    pc_g, pc_c = model.predict(img)[2], cpu.predict(img)[2]
    (zg, okg), (zc, okc) = class_logits(pc_g), class_logits(pc_c)
    ok = okg & okc
    e_z = np.abs(zg - zc)[ok].max()
    e_rel = float(e_z / max(1.0, np.abs(zc[ok]).max()))
    det = cpu.predict_instances(img)[1]
    at = tuple((det["points"] // np.array(cpu.config.grid)).T)
    flip = np.argmax(pc_g[at], -1) != det["class_id"]
    top2 = np.sort(zc[at], -1)[:, -2:]
    return (e_rel, float(e_z), float(np.abs(pc_g - pc_c).max()), int((~ok).sum()),
            int(flip.sum()), (top2[:, 1] - top2[:, 0])[flip], len(det["prob"]))


def he_field(shape, seed, n_classes):
    """A three-channel (H&E-like) synthetic field of the benchmark's nuclei,
    each nucleus given a seeded class 1..n_classes that shades its second
    channel: (image (H, W, 3) float32, labels, {label: class})."""
    from scipy.ndimage import gaussian_filter
    img, lbl = synthetic_nuclei(shape, seed)
    ids = np.arange(1, int(lbl.max()) + 1)
    cls = np.random.RandomState(seed + 1).randint(1, n_classes + 1, len(ids))
    shade = gaussian_filter(np.concatenate([[0], cls]).astype(np.float32)[lbl] / n_classes, 1.5)
    x = np.stack([img, img * shade, 1 - img], -1).astype(np.float32)
    return x, lbl, {int(i): int(c) for i, c in zip(ids, cls)}


def train_step_vs_cpu(dev, Model, cfg, make_data, tag):
    """One fixed host-built batch (class maps included), the same seeded
    weights, TF32 off: the card's targets, loss, prob_class_loss, metrics
    and gradients against the CPU port's."""
    out = []
    for device in (dev, "cpu"):
        np.random.seed(17)
        (x,), targets = make_data(device)[0]
        m = Model(cfg, name=f"{tag}_cmp", basedir=None, device=device)
        m.prepare_for_training()
        batch = m._put_batch(dict(zip(("x", "prob", "dist", "prob_class"), (x, *targets))))
        loss, metrics = m._loss_and_metrics(batch)
        loss.backward()
        out.append(((x, *targets), {k: float(v) for k, v in metrics.items()},
                    {k: p.grad.cpu() for k, p in m.net.named_parameters()}))
    (tg, mg, gg), (tc, mc, gc) = out
    check(all(np.array_equal(a, b) for a, b in zip(tg, tc)),
          f"({tag}) host targets (class maps included): card != CPU")
    e_met = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30) for k in mc)
    check(e_met <= METRIC_RTOL, f"({tag}) loss / metrics: card vs CPU rel {e_met}: {mg} {mc}")
    e_grad = max(((gg[k] - gc[k]).abs().max() / gc[k].abs().max().clamp_min(1e-30)).item()
                 for k in gc)
    check(e_grad <= GRAD_TOL, f"({tag}) gradients: card vs CPU rel {e_grad}")
    return (f"targets equal (class maps {tuple(tc[3].shape)}, {int((tc[3] < 0).any(-1).sum())} "
            f"ignored pixels), loss {mg['loss']:.6f} vs {mc['loss']:.6f}, prob_class_loss "
            f"{mg['prob_class_loss']:.6f} vs {mc['prob_class_loss']:.6f}, metrics max rel diff "
            f"{e_met:.1e}, gradients max rel diff {e_grad:.1e} over {len(gc)} parameters")


def phase_p(dev, kernels, conv, matching, StarDist2D, Config2D):
    """Multiclass 2D: the full-width forward with three input channels and
    six classes, training, and serving a class branch grafted on 2D_demo."""
    import shutil
    import tempfile
    from stardist_torch.models.model2d import StarDistData2D
    from stardist_torch.models.unet import StarDistNet
    net = StarDistNet(Config2D(**MC_CONFIG), dtype=torch.bfloat16)
    net.init_weights(torch.Generator().manual_seed(0))
    net.to(dev)
    C = MC_CONFIG["n_channel_in"]
    x = torch.rand(FWD_SIZE, FWD_SIZE, C, generator=torch.Generator().manual_seed(3)).to(dev)
    out, out_p = net(x), net(x, plain=True)
    torch.cuda.synchronize()
    n, ncls = FWD_SIZE // 2, MC_CONFIG["n_classes"] + 1
    check(tuple(out[2].shape) == (ncls, n, n) and tuple(out[1].shape) == (32, n, n),
          "(p) forward shapes")
    check(all(bool(torch.isfinite(t).all()) for t in out + out_p), "(p) non-finite forward output")
    e_prob = (out[0] - out_p[0]).abs().max().item()
    e_dist = ((out[1] - out_p[1]).abs().max() / out_p[1].abs().max().clamp_min(1.0)).item()
    e_pc = (out[2] - out_p[2]).abs().max().item()
    check(max(e_prob, e_dist, e_pc) < FWD_TOL,
          f"(p) kernel forward vs plain: prob {e_prob}, dist {e_dist}, prob_class {e_pc}")
    del out, out_p
    t_k, t_p = cuda_ms(lambda: net(x)), cuda_ms(lambda: net(x, plain=True))
    first, fc = net.conv_blocks()[0], net.feat_class
    check(first.weight.shape[-2] == C and fc is not None, "(p) the two new conv layers")
    rows, tot = conv_layers_vs_plain(net, x, dev, conv.conv3x3_hwc, conv.conv3x3_hwc_plain,
                                     only=(first, fc))
    conv_report("p", f"conv at the C = {C} first layer and the class feature conv", rows, tot)
    print(f"(p) full-width multiclass forward {FWD_SIZE}^2 x {C} (Config2D({MC_CONFIG}), seeded "
          f"weights): kernel {t_k:.2f} ms, plain {t_p:.2f} ms; prob max abs diff {e_prob:.2e}, "
          f"dist max rel diff {e_dist:.2e}, prob_class max abs diff {e_pc:.2e}", flush=True)
    del net, x
    torch.cuda.empty_cache()

    n_f, side = TRAIN_FIELDS
    fields = [he_field((side, side), 1300 + i, MC_CONFIG["n_classes"]) for i in range(n_f)]
    X, Y, CL = ([f[k] for f in fields] for k in range(3))
    cfg = Config2D(**MC_CONFIG, train_tensorboard=False)
    os.makedirs("build", exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_multiclass_", dir="build")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        set_tf32(False)

        def make_data(device):
            return StarDistData2D(X, Y, batch_size=cfg.train_batch_size, n_rays=cfg.n_rays,
                                  length=1, n_classes=cfg.n_classes, classes=CL,
                                  patch_size=cfg.train_patch_size, grid=cfg.grid,
                                  foreground_prob=cfg.train_foreground_only, device=device)
        print(f"(p) multiclass training step at {cfg.train_patch_size} x {cfg.train_batch_size}, "
              f"{n_f} three-channel fields of {side}^2, card vs CPU (TF32 off): "
              f"{train_step_vs_cpu(dev, StarDist2D, cfg, make_data, 'p')}", flush=True)
        m = StarDist2D(cfg, name="p_train", basedir=workdir, device=dev)
        marks = StageMarks()
        m.step_marks = marks
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        h = m.train(X, Y, classes=CL, validation_data=(X[:2], Y[:2], CL[:2]), seed=23,
                    epochs=MC_TRAIN_EPOCHS, steps_per_epoch=MC_TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        m.step_marks = None
        losses, lc = np.asarray(h.steps["loss"]), np.asarray(h.steps["prob_class_loss"])
        n_steps = MC_TRAIN_EPOCHS * MC_TRAIN_STEPS
        check(len(lc) == n_steps and np.isfinite(losses).all() and np.isfinite(lc).all()
              and np.isfinite(h.history["val_loss"]).all(), f"(p) losses not finite: {losses}")
        check(lc[-5:].mean() < lc[:5].mean(),
              f"(p) prob_class_loss did not fall: first 5 {lc[:5].mean()}, last 5 {lc[-5:].mean()}")
        split, step_ms = marks.split()
        print(f"(p) StarDist2D.train (multiclass, host targets) {MC_TRAIN_EPOCHS} x "
              f"{MC_TRAIN_STEPS} steps: call {wall:.1f} s ({n_steps / wall:.2f} steps/s with "
              f"validation, checkpoints and start-up), step {step_ms:.2f} ms median "
              f"({1e3 / step_ms:.1f} steps/s); loss first 5 {losses[:5].mean():.4f}, last 5 "
              f"{losses[-5:].mean():.4f}; prob_class_loss first 5 {lc[:5].mean():.4f}, last 5 "
              f"{lc[-5:].mean():.4f}; val_prob_class_loss {h.history['val_prob_class_loss']}; "
              f"split (median ms): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f"; peak memory {peak:.2f} GiB", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        shutil.rmtree(workdir, ignore_errors=True)

    g, demo = grafted(StarDist2D, Config2D, "2D_demo", MC_CONFIG["n_classes"], dev)
    img, lbl = synthetic_nuclei((E2E_SIZE, E2E_SIZE), seed=123)
    lab_d, det_d = demo.predict_instances(img)
    g.predict_instances(img)                            # warm-up
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    lab, det = g.predict_instances(img)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels, g)
    check(len(det["prob"]) > 0, "(p) no survivors")
    check(np.array_equal(lab, lab_d), "(p) the grafted model's labels != 2D_demo's")
    for k in ("points", "prob", "dist"):
        check(np.array_equal(det[k], det_d[k]), f"(p) the grafted model's {k} != 2D_demo's")
    rows = class_rows_at(g, img, det["points"]).cpu().numpy()
    check(np.array_equal(det["class_prob"], rows), "(p) class_prob != the class map at the points")
    check(np.array_equal(det["class_id"], np.argmax(rows, -1)), "(p) class_id != argmax")
    lab_v, det_v = g.predict_instances_device(img)
    lab_t, det_t = g.predict_instances_device(img, fetch=False)
    check(np.array_equal(lab_v, lab) and all(np.array_equal(det_v[k], det[k])
                                             for k in ("points", "class_prob", "class_id")),
          "(p) predict_instances_device (fetch=True) != predict_instances")
    check(lab_t.is_cuda and det_t["class_prob"].is_cuda and det_t["class_id"].is_cuda
          and np.array_equal(det_t["class_prob"].cpu().numpy(), det["class_prob"])
          and np.array_equal(det_t["class_id"].cpu().numpy(), det["class_id"]),
          "(p) fetch=False: the class rows must stay on the card and equal fetch=True's")
    walls = walls_ms({"2D_demo": lambda: demo.predict_instances(img),
                      "multiclass": lambda: g.predict_instances(img)}, rounds=3)
    img1, _ = synthetic_nuclei((CMP_SIZE, CMP_SIZE), seed=123)
    cpu = on_cpu(g, StarDist2D)
    n_cand, n_surv = shared_candidates(g, cpu, img1)
    e_z, e_zabs, e_pc, n_out, n_flip, margins, n_cpu = class_maps_vs_cpu(
        g, on_cpu(g, StarDist2D, "bfloat16"), img1)
    check(e_z < FWD_TOL and np.all(margins <= 2 * e_zabs),
          f"(p) class logits card vs CPU (bf16): rel {e_z}; class_id flips at logit margins "
          f"{margins} (largest logit difference {e_zabs})")
    e_pc32 = float(np.abs(g.predict(img1)[2] - cpu.predict(img1)[2]).max())
    acc = matching(cpu.predict_instances(img1)[0], g.predict_instances(img1)[0],
                   thresh=0.5).accuracy
    check(acc >= 0.99, f"(p) {CMP_SIZE}^2 card vs CPU labels: matching accuracy {acc} < 0.99")
    t = det["timings_s"]
    classes = np.bincount(det["class_id"], minlength=MC_CONFIG["n_classes"] + 1).tolist()
    print(f"(p) 2D_demo with a grafted {MC_CONFIG['n_classes']}-class branch, predict_instances "
          f"{E2E_SIZE}^2 on the card: labels, points, prob, dist == 2D_demo's; class_prob == "
          f"the dense class map at the {len(det['prob'])} survivors, class_id its argmax "
          f"(per class {classes}); predict_instances_device == it, fetch=False's class rows on "
          f"the card; wall {wall * 1e3:.1f} ms = forward {t['forward'] * 1e3:.1f} + extract "
          f"{t['extract'] * 1e3:.1f} + nms {t['nms'] * 1e3:.1f} + raster "
          f"{t['raster'] * 1e3:.1f} ms; launches {launches}; 3 rounds in turn, median "
          f"(min-max): {walls}; {CMP_SIZE}^2 card vs CPU: the card's {n_cand} candidates "
          f"through both: labels and class rows equal ({n_surv} survivors); against the CPU's "
          f"bf16 plain path: class logits max rel diff {e_z:.2e} (abs {e_zabs:.3f}; {n_out} "
          f"pixels with a probability of 0 left out), class maps max abs diff {e_pc:.2e} "
          f"({e_pc32:.2e} against the CPU's f32 path); {n_flip} of the CPU's {n_cpu} survivors "
          f"would take another class_id from the card's map (top-two logit margins "
          f"{np.round(margins, 4).tolist()}); matching accuracy against the CPU's f32 path "
          f"{acc:.4f}", flush=True)
    return launches


def phase_q(dev, conv, StarDist3D, Config3D):
    """Multiclass 3D: a class branch grafted on 3D_demo, and a training step
    and five steps at the upstream 3D notebook's configuration."""
    from stardist_torch.models.model3d import StarDistData3D
    from stardist_torch.rays3d import rays_from_json
    g, demo = grafted(StarDist3D, Config3D, "3D_demo", MC3D_CLASSES, dev)
    img, _ = synthetic_nuclei_3d(E2E3D_SHAPE, seed=3)
    lab_d, det_d = demo.predict_instances(img)
    torch.cuda.synchronize()
    conv.KERNEL3D.launches = 0
    t0 = time.perf_counter()
    lab, det = g.predict_instances(img)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = conv.KERNEL3D.launches
    check(launches == len(g.net.conv_blocks()),
          f"(q) conv3d launches {launches} != {len(g.net.conv_blocks())} (class conv included)")
    check(len(det["prob"]) > 0, "(q) no survivors")
    check(np.array_equal(lab, lab_d) and np.array_equal(det["points"], det_d["points"]),
          "(q) the grafted model's labels / points != 3D_demo's")
    rows = class_rows_at(g, img, det["points"]).cpu().numpy()
    check(np.array_equal(det["class_prob"], rows) and np.array_equal(det["class_id"],
                                                                      np.argmax(rows, -1)),
          "(q) class_prob / class_id != the class map at the survivors")
    crop = img[tuple(slice(0, s) for s in CMP3D_SHAPE)]
    n_cand, n_surv = shared_candidates(g, on_cpu(g, StarDist3D), crop)
    cpu16 = on_cpu(g, StarDist3D, "bfloat16")
    (zg, okg), (zc, okc) = (class_logits(m.predict(crop)[2]) for m in (g, cpu16))
    ok = okg & okc
    e_z = float(np.abs(zg - zc)[ok].max() / max(1.0, np.abs(zc[ok]).max()))
    check(e_z < FWD_TOL, f"(q) class logits card vs CPU (bf16) at {CMP3D_SHAPE}: rel {e_z}")
    t = det["timings_s"]
    print(f"(q) 3D_demo with a grafted {MC3D_CLASSES}-class branch, predict_instances "
          f"{'x'.join(map(str, E2E3D_SHAPE))}: labels and points == 3D_demo's, class_prob == "
          f"the class map at the {len(det['prob'])} survivors, class_id its argmax; wall "
          f"{wall * 1e3:.1f} ms [" + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in t.items())
          + f" ms], conv3d launches {launches}; {'x'.join(map(str, CMP3D_SHAPE))} crop: the "
          f"card's {n_cand} candidates through the card's and the CPU's NMS and raster: labels "
          f"and class rows equal ({n_surv} survivors); class logits card vs CPU (both bf16) "
          f"max rel diff {e_z:.2e}", flush=True)

    n_v, shape = 4, TRAIN3D_FIELDS[1]
    fields = [synthetic_nuclei_3d(shape, seed=1400 + i) for i in range(n_v)]
    X, Y = [f[0] for f in fields], [f[1] for f in fields]
    rng = np.random.RandomState(1450)
    CL = [{int(i): int(rng.randint(1, MC3D_CLASSES + 1)) for i in range(1, int(y.max()) + 1)}
          for y in Y]
    cfg = train3d_config(Y[1:], "resnet", Config3D, n_classes=MC3D_CLASSES,
                         train_loss_weights=(1, 0.2, 1),
                         train_class_weights=(1,) * (MC3D_CLASSES + 1))
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        set_tf32(False)

        def make_data(device):
            return StarDistData3D(X[1:], Y[1:], rays=rays_from_json(cfg.rays_json),
                                  batch_size=cfg.train_batch_size, length=1,
                                  n_classes=MC3D_CLASSES, classes=CL[1:],
                                  patch_size=cfg.train_patch_size, grid=cfg.grid,
                                  anisotropy=cfg.anisotropy,
                                  foreground_prob=cfg.train_foreground_only, device=device)
        step = train_step_vs_cpu(dev, StarDist3D, cfg, make_data, "q")
        m = StarDist3D(cfg, name="q_train", basedir=None, device=dev)
        t0 = time.perf_counter()
        h = m.train(X[1:], Y[1:], classes=CL[1:], validation_data=(X[:1], Y[:1], CL[:1]),
                    seed=33, epochs=1, steps_per_epoch=5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    lc = np.asarray(h.steps["prob_class_loss"])
    check(len(lc) == 5 and np.isfinite(h.steps["loss"]).all() and np.isfinite(lc).all()
          and np.isfinite(h.history["val_prob_class_loss"]).all(),
          f"(q) multiclass 3D training losses not finite: {h.steps}")
    print(f"(q) multiclass 3D training (examples/3D/2_training.ipynb's configuration, ResNet, "
          f"n_classes={MC3D_CLASSES}, grid {cfg.grid}, {cfg.train_patch_size} x "
          f"{cfg.train_batch_size}): one step card vs CPU (TF32 off): {step}; StarDist3D.train "
          f"1 x 5 steps on the card in {wall:.1f} s, prob_class_loss "
          f"{np.round(lc, 4).tolist()}, val_prob_class_loss "
          f"{h.history['val_prob_class_loss']}", flush=True)
    return launches


def phase_r(dev, kernels, matching, StarDist2D, Config2D, rt):
    """predict_instances_big on an 8192^2 field against one call, then the
    grafted multiclass 2D_demo block-wise."""
    model = StarDist2D(None, "2D_demo", "models/examples", device=dev)
    img, lbl = big_field()
    packings, draw = [], rt.draw

    def spy(inputs, shape, pack32, *args, **kw):       # which packing each raster call ran
        packings.append(bool(pack32))
        return draw(inputs, shape, pack32, *args, **kw)
    rt.draw = spy
    try:
        model.predict_instances(img[:BIG_MC[1], :BIG_MC[1]])          # warm-up
        model._axes_tile_overlap("YX")     # the receptive field (two forwards), kept
        torch.cuda.synchronize()
        reset_launches(kernels)
        packings.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lab_b, det_b = model.predict_instances_big(img, "YX", **BIG_BLOCKS)
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0
        peak_b = torch.cuda.max_memory_allocated() / 2 ** 30
        n_blocks, pack_b = len(packings), sorted(set(packings))
        launches = {name: k.launches for name, k in kernels.items()}
        n_conv = len(model.net.conv_blocks())
        check(launches["conv"] == n_conv * n_blocks and launches["pair"] > 0
              and launches["raster"] == n_blocks,
              f"(r) launches {launches} for {n_blocks} blocks of {n_conv} convs")
        packings.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lab_1, det_1 = model.predict_instances(img)
        torch.cuda.synchronize()
        wall_1 = time.perf_counter() - t0
        peak_1 = torch.cuda.max_memory_allocated() / 2 ** 30
        pack_1 = packings[-1]
    finally:
        rt.draw = draw
    n_obj = len(det_b["prob"])
    check(lab_b.shape == img.shape and int(lab_b.max()) == n_obj
          and len(np.unique(lab_b)) == n_obj + 1, "(r) block-wise labels are not 1..n")
    acc = matching(lab_1, lab_b, thresh=0.5).accuracy
    check(acc >= 0.99, f"(r) block-wise vs one call: matching accuracy {acc} < 0.99")
    ap = matching(lbl, lab_b, thresh=0.5).accuracy
    print(f"(r) predict_instances_big {BIG_SIZE}^2 (2D_demo, {BIG_BLOCKS}): {n_blocks} blocks, "
          f"{n_obj} objects ({int(lbl.max())} true, AP@0.5 {ap:.4f}), wall {wall_b:.2f} s, peak "
          f"memory {peak_b:.2f} GiB, raster packing {['64-bit', '32-bit'][pack_b[0]]}"
          f"{'' if len(pack_b) == 1 else ' and 64-bit'} per block; one predict_instances call "
          f"on the field: {len(det_1['prob'])} objects, wall {wall_1:.2f} s, peak memory "
          f"{peak_1:.2f} GiB, raster packing {'32-bit' if pack_1 else '64-bit'}; matching "
          f"accuracy block-wise vs one call {acc:.4f}; launches (block-wise) {launches}",
          flush=True)

    g, _ = grafted(StarDist2D, Config2D, "2D_demo", MC_CONFIG["n_classes"], dev)
    side, block = BIG_MC
    img2, _ = synthetic_nuclei((side, side), seed=556)
    reset_launches(kernels)
    t0 = time.perf_counter()
    lab_m, det_m = g.predict_instances_big(img2, "YX", block_size=block,
                                           min_overlap=BIG_BLOCKS["min_overlap"],
                                           context=BIG_BLOCKS["context"])
    torch.cuda.synchronize()
    wall_m = time.perf_counter() - t0
    launches_m = {name: k.launches for name, k in kernels.items()}
    n_m = len(det_m["prob"])
    check(det_m["class_prob"].shape == (n_m, MC_CONFIG["n_classes"] + 1)
          and det_m["class_id"].shape == (n_m,) and int(lab_m.max()) == n_m
          and np.array_equal(det_m["class_id"], np.argmax(det_m["class_prob"], -1)),
          "(r) multiclass block-wise: class rows != objects")
    check(all(v > 0 for v in launches_m.values()), f"(r) multiclass launches {launches_m}")
    print(f"(r) grafted multiclass 2D_demo, predict_instances_big {side}^2 with block_size "
          f"{block}: {n_m} objects, class_prob {det_m['class_prob'].shape} and class_id "
          f"{det_m['class_id'].shape} rows (one per object), wall {wall_m:.2f} s, launches "
          f"{launches_m}", flush=True)
    return {k: launches[k] + launches_m[k] for k in launches}


# -- (s) block-sharded and multi-process prediction ---------------------------

def hashed(a):
    """(shape, dtype, sha256) of an array: exact equality across processes
    without shipping the array."""
    import hashlib
    a = np.ascontiguousarray(a)
    return a.shape, str(a.dtype), hashlib.sha256(a.data).hexdigest()


def object_rows(polys):
    """The object keys of a result (big.OBJECT_KEYS), for an exact
    comparison across processes."""
    from stardist_torch.big import OBJECT_KEYS
    return {k: v for k, v in polys.items() if k in OBJECT_KEYS}


def same_objects(got, want, what):
    check(set(got) == set(want), f"{what}: keys {sorted(got)} != {sorted(want)}")
    for k, w in want.items():
        check(got[k].dtype == w.dtype and got[k].shape == w.shape and np.array_equal(got[k], w),
              f"{what}: {k} differs")


def s_rank(rank, world_size, device, img_path, shared):
    """One rank of (s): predict_instances_big_multihost on the 2D_demo field
    in both stitch modes, each timed; the replicated labels' hash, the
    objects of both, the partitioned labels into the memmap ``shared``; this
    rank's blocks, exchange, peak memory and kernel launches."""
    from stardist_torch.models import StarDist2D
    from stardist_torch.ops import conv, pair_overlap as po, raster_tiles as rt
    from stardist_torch.parallel import predict_instances_big_multihost
    kernels = {"conv": conv.KERNEL, "pair": po.KERNEL, "raster": rt.KERNEL}
    model = StarDist2D(None, "2D_demo", "models/examples", device=device)
    img = np.load(img_path, mmap_mode="r")            # the field every rank holds, as a view
    model.predict_instances(np.asarray(img[:1024, :1024]))           # warm-up
    torch.cuda.synchronize()
    reset_launches(kernels)
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for stitch in ("replicated", "partitioned"):
        stats = {}
        labels_out = (np.memmap(shared, dtype=np.int32, mode="r+", shape=img.shape)
                      if stitch == "partitioned" else None)
        t0 = time.perf_counter()
        labels, polys = predict_instances_big_multihost(model, img, "YX", stitch=stitch,
                                                        labels_out=labels_out, stats=stats,
                                                        **BIG_BLOCKS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if stitch == "partitioned":
            labels.flush()
            labels = None
        out[stitch] = {"wall": wall, "stats": stats, "polys": object_rows(polys),
                       "labels": None if labels is None else hashed(labels)}
    out["launches"] = {name: k.launches for name, k in kernels.items()}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def phase_s(dev, kernels, matching, StarDist2D):
    """Block-sharded and multi-process predict_instances_big (2D_demo, the
    seeded 8192^2 field of (r), blocks of 4096) against predict_instances_big."""
    import shutil
    import tempfile
    from stardist_torch.parallel import predict_instances_big_sharded, run_ranks
    t_phase = time.perf_counter()
    model = StarDist2D(None, "2D_demo", "models/examples", device=dev)
    img, _ = big_field()
    model.predict_instances(img[:1024, :1024])         # warm-up
    model._axes_tile_overlap("YX")
    n_conv = len(model.net.conv_blocks())
    one, two = [dev], [dev, dev]
    calls = {"predict_instances_big": lambda: model.predict_instances_big(img, "YX", **BIG_BLOCKS),
             "sharded x1": lambda: predict_instances_big_sharded(model, img, "YX", devices=one,
                                                                 timings=tim["sharded x1"],
                                                                 **BIG_BLOCKS),
             "sharded x2": lambda: predict_instances_big_sharded(model, img, "YX", devices=two,
                                                                 timings=tim["sharded x2"],
                                                                 **BIG_BLOCKS)}
    walls = {k: [] for k in calls}
    tim = {k: {} for k in calls}
    launches = {k: 0 for k in kernels}
    results, peaks = {}, {}
    for rnd in range(SHARDED_ROUNDS):
        for name, fn in calls.items():
            if rnd > 0 and name == "predict_instances_big":
                continue
            torch.cuda.synchronize()
            reset_launches(kernels)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
            if name != "predict_instances_big":
                n_blocks = tim[name]["blocks"]
                got = {k: kr.launches for k, kr in kernels.items()}
                check(got["conv"] == n_conv * n_blocks and got["pair"] > 0
                      and got["raster"] == n_blocks,
                      f"(s) {name}: launches {got} for {n_blocks} blocks of {n_conv} convs")
                for k in launches:
                    launches[k] += got[k]
            if rnd == 0:
                results[name] = res
    lab_b, det_b = results["predict_instances_big"]
    n_obj = len(det_b["prob"])
    exact = {}
    for name in ("sharded x1", "sharded x2"):
        lab, det = results[name]
        # equal labels match at accuracy 1.0; the matching itself takes ~35 s
        # of host time at 8192^2, so it runs only where they differ
        exact[name] = np.array_equal(lab_b, lab)
        acc = 1.0 if exact[name] else matching(lab_b, lab, thresh=0.99).accuracy
        check(acc == 1.0 and len(det["prob"]) == n_obj,
              f"(s) {name} vs predict_instances_big: accuracy {acc} at IoU 0.99, "
              f"{len(det['prob'])} vs {n_obj} objects")
    med = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"(s) predict_instances_big_sharded {BIG_SIZE}^2 (2D_demo, {BIG_BLOCKS}): "
          f"{tim['sharded x1']['blocks']} blocks; matching accuracy 1.0 at IoU 0.99 and {n_obj} "
          f"objects for devices=[cuda:0] and [cuda:0, cuda:0] (labels exactly equal: "
          f"{exact['sharded x1']}, {exact['sharded x2']}); walls (the block-wise call "
          f"once, the sharded calls median of {SHARDED_ROUNDS} rounds in turn): " + ", ".join(
              f"{k} {med[k]:.2f} s ({min(walls[k]):.2f}-{max(walls[k]):.2f})" for k in walls) +
          "; split of the last sharded calls: " + "; ".join(
              f"{k}: reader wait {tim[k]['read_wait']:.3f} s, forward {tim[k]['forward']:.3f} s, "
              f"candidates + NMS + labels + stitch {tim[k]['stitch']:.3f} s, {tim[k]['batches']} "
              f"batches" for k in ("sharded x1", "sharded x2")) +
          "; peak memory " + ", ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items()) +
          f"; launches (sharded calls) {launches}", flush=True)

    del results
    torch.cuda.empty_cache()
    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_s_", dir="build")
    try:
        img_path = os.path.join(work, "field.npy")
        np.save(img_path, img)
        shared = os.path.join(work, "labels.i32")
        np.memmap(shared, dtype=np.int32, mode="w+", shape=img.shape).flush()
        t0 = time.perf_counter()
        ranks = run_ranks(s_rank, 2, (str(dev), img_path, shared), backend="gloo",
                          timeout=RANK_TIMEOUT, tmp_dir=work)
        t_spawn = time.perf_counter() - t0
        part = np.memmap(shared, dtype=np.int32, mode="r", shape=img.shape)
        check(np.array_equal(part, lab_b), "(s) partitioned: the shared memmap != "
                                           "predict_instances_big's labels")
        del part
    finally:
        shutil.rmtree(work, ignore_errors=True)
    want = object_rows(det_b)
    want_hash = hashed(lab_b)
    for r, out in enumerate(ranks):
        check(out["replicated"]["labels"] == want_hash,
              f"(s) replicated: rank {r}'s labels != predict_instances_big's")
        for stitch in ("replicated", "partitioned"):
            same_objects(out[stitch]["polys"], want, f"(s) {stitch}, rank {r}")
        check(all(v > 0 for v in out["launches"].values()),
              f"(s) rank {r} launches {out['launches']}")
        for k in launches:
            launches[k] += out["launches"][k]
    print(f"(s) predict_instances_big_multihost on 2 ranks (gloo, one card), {BIG_SIZE}^2: "
          f"replicated labels exactly predict_instances_big's on both ranks; partitioned: the "
          f"shared memmap exactly them; objects equal on both ranks in both modes; spawn and "
          f"both calls {t_spawn:.1f} s; " + "; ".join(
              f"rank {r}: {o['replicated']['stats']['blocks']} blocks, walls replicated "
              f"{o['replicated']['wall']:.2f} s (exchange {o['replicated']['stats']['bytes']} B "
              f"in {o['replicated']['stats']['exchange_s'] * 1e3:.1f} ms, the wait for the other "
              f"rank included), partitioned "
              f"{o['partitioned']['wall']:.2f} s (exchange {o['partitioned']['stats']['bytes']} "
              f"B in {o['partitioned']['stats']['exchange_s'] * 1e3:.1f} ms), peak memory "
              f"{o['peak_gib']:.2f} GiB, launches {o['launches']}"
              for r, o in enumerate(ranks)) + f"; the phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# -- (t) data-parallel training -----------------------------------------------

def t_train(dev, workdir, rank=0):
    """The (l) configuration on ``dev`` with TF32 off: one step on a fixed
    raw batch (this rank's rows of it under a process group) and its
    gradients, then StarDist2D.train 1 x DP_STEPS steps (rank 0 writes
    weights into ``workdir``): losses, walls, the step split."""
    from stardist_torch.models import Config2D, StarDist2D
    from stardist_torch.models.model2d import StarDistData2D
    set_tf32(False)
    n, side = TRAIN_FIELDS
    fields = [synthetic_nuclei((side, side), seed=700 + i) for i in range(n)]
    X, Y = [f[0] for f in fields], [f[1] for f in fields]
    # no TensorBoard: importing it may reseed numpy's RNG, and only rank 0
    # (which writes) would import it, so the one process would draw another stream
    cfg = Config2D(**TRAIN_CONFIG, train_tensorboard=False)
    m = StarDist2D(cfg, basedir=None, device=dev)
    m.prepare_for_training()
    data = StarDistData2D(X, Y, batch_size=cfg.train_batch_size, n_rays=cfg.n_rays, length=1,
                          patch_size=cfg.train_patch_size, grid=cfg.grid,
                          foreground_prob=cfg.train_foreground_only)
    np.random.seed(11)
    batch = m._put_batch(data.raw_item(0), shard=True)
    m._train_step(batch, torch.Generator(device=dev).manual_seed(0))
    grads = {k: p.grad.cpu() for k, p in m.net.named_parameters()}
    m = StarDist2D(cfg, name="t_dp", basedir=workdir if rank == 0 else None, device=dev)
    marks = StageMarks()
    m.step_marks = marks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = m.train(X, Y, validation_data=(X[:2], Y[:2]), seed=21, epochs=1,
                steps_per_epoch=DP_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split, step_ms = marks.split()
    return {"rows": len(batch["x"]), "grads": grads, "losses": list(h.steps["loss"]),
            "wall": wall, "split": split, "step_ms": step_ms}


def t_rank(rank, world_size, device, workdir):
    return t_train(torch.device(device), workdir, rank)


def phase_t(dev, kernels, StarDist2D):
    """Data-parallel training: 2 gloo ranks on the card against one process
    on the whole batch; dryrun_multichip; the trained weights served."""
    import shutil
    import tempfile
    from stardist_torch.parallel import dryrun_multichip, run_ranks
    t_phase = time.perf_counter()
    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_t_", dir="build")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        t0 = time.perf_counter()
        ranks = run_ranks(t_rank, 2, (str(dev), work), backend="gloo", timeout=RANK_TIMEOUT,
                          tmp_dir=work)
        t_ranks = time.perf_counter() - t0
        t0 = time.perf_counter()
        one = t_train(dev, None)
        t_one = time.perf_counter() - t0
        r0 = ranks[0]
        check([r["rows"] for r in ranks] == [one["rows"] // 2] * 2,
              f"(t) rows per rank {[r['rows'] for r in ranks]} of a batch of {one['rows']}")
        e_grad = max(float((r0["grads"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                     for k, g in one["grads"].items())
        check(e_grad <= DP_GRAD_TOL, f"(t) first-step gradients: rank 0 vs one process {e_grad}")
        e_loss = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], one["losses"]))
        check(len(r0["losses"]) == len(one["losses"]) == DP_STEPS and e_loss <= DP_LOSS_RTOL,
              f"(t) losses 2 ranks {r0['losses']} vs one process {one['losses']}")
        check(ranks[1]["losses"] == r0["losses"], "(t) the ranks' losses differ")
        t0 = time.perf_counter()
        dry = dryrun_multichip(2, device="cuda", timeout=RANK_TIMEOUT)
        t_dry = time.perf_counter() - t0
        set_tf32(False)

        def split(r):
            return ", ".join(f"{k} {v:.3f}" for k, v in r["split"].items())
        print(f"(t) data-parallel training, {TRAIN_CONFIG} at {one['rows']} x 256^2 (TF32 off): "
              f"2 gloo ranks on the card ({r0['rows']} rows each) vs one process: first-step "
              f"gradients max {e_grad:.2e} of their largest magnitude, {DP_STEPS} losses max rel "
              f"diff {e_loss:.2e} ({r0['losses'][0]:.5f} .. {r0['losses'][-1]:.5f}); steps/s "
              f"(median step): 2 ranks {1e3 / r0['step_ms']:.1f} ({r0['step_ms']:.1f} ms; split "
              f"ms {split(r0)}), one process {1e3 / one['step_ms']:.1f} ({one['step_ms']:.1f} "
              f"ms; split ms {split(one)}); train() walls {r0['wall']:.1f} s (2 ranks) and "
              f"{one['wall']:.1f} s (one); spawn + both ranks {t_ranks:.1f} s, the one process "
              f"{t_one:.1f} s; dryrun_multichip(2, 'cuda') in {t_dry:.1f} s: {dry}", flush=True)

        served = StarDist2D(None, name="t_dp", basedir=work, device=dev)
        img, _ = synthetic_nuclei((TRAIN_FIELDS[1],) * 2, seed=701)
        x = torch.from_numpy(img[:, :, None]).to(dev)
        prob, dist = served.net(x)
        prob_p, dist_p = served.net(x, plain=True)
        e_prob = (prob - prob_p).abs().max().item()
        e_dist = ((dist - dist_p).abs().max() / dist_p.abs().max().clamp_min(1.0)).item()
        check(e_prob < FWD_TOL and e_dist < FWD_TOL,
              f"(t) served weights: kernel path vs plain: prob {e_prob}, dist {e_dist}")
        thresh = float(min(0.5, np.quantile(prob.cpu().numpy(), 0.95)))
        reset_launches(kernels)
        labels, det = served.predict_instances(img, prob_thresh=thresh)
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        pairs = det["nms_counters"]["n_eval_pairs"]
        # after DP_STEPS steps the polygons may be too small to overlap: the
        # pair kernel runs exactly when the NMS has pairs to test
        check(launches["conv"] == len(served.net.conv_blocks()) and launches["raster"] > 0
              and (launches["pair"] > 0) == (pairs > 0),
              f"(t) served: launches {launches}, {pairs} exact pairs")
        check(labels.shape == img.shape and labels.max() > 0, "(t) served model drew no label")
        print(f"(t) the 2-rank training's weights_best.h5 served on the card: kernel path vs "
              f"plain prob {e_prob:.2e}, dist {e_dist:.2e}; predict_instances "
              f"{TRAIN_FIELDS[1]}^2 at prob_thresh {thresh:.3f}: {len(det['prob'])} objects, "
              f"{pairs} exact pairs, launches {launches}; the phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        shutil.rmtree(work, ignore_errors=True)
    return launches


# -- (u) imports ----------------------------------------------------------------

def phase_u(dev, kernels, StarDist2D):
    """from_pretrained (the registry's 2D_demo, and a file:// zip) and the
    native host library against the port on the card."""
    import hashlib
    import shutil
    import tempfile
    import zipfile
    from stardist_torch.geometry import polygons_to_label, star_dist
    from stardist_torch.geometry.geom2d import render_order
    from stardist_torch.lib import get_lib, nms2d_native, polygons_to_label_native, \
        star_dist2d_native
    from stardist_torch.models import register_model
    from stardist_torch.nms import descending_order
    t_phase = time.perf_counter()
    img, lbl = synthetic_nuclei((E2E_SIZE, E2E_SIZE), seed=123)
    ref = StarDist2D(None, "2D_demo", "models/examples", device=dev)
    lab_ref, det_ref = ref.predict_instances(img)
    launches = {k: 0 for k in kernels}

    def counted(model):
        reset_launches(kernels)
        out = model.predict_instances(img)
        torch.cuda.synchronize()
        got = read_launches(kernels, model)
        for k in launches:
            launches[k] += got[k]
        return out

    lab, det = counted(StarDist2D.from_pretrained("2D_demo", device=dev))
    check(np.array_equal(lab, lab_ref), "(u) from_pretrained('2D_demo') labels differ")
    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_u_", dir="build")
    cache = os.environ.get("STARDIST_TORCH_MODEL_CACHE")
    try:
        zip_path = os.path.join(work, "2D_demo.zip")
        with zipfile.ZipFile(zip_path, "w") as z:
            for f in sorted(os.listdir("models/examples/2D_demo")):
                if os.path.isfile(os.path.join("models/examples/2D_demo", f)):
                    z.write(os.path.join("models/examples/2D_demo", f), f"2D_demo/{f}")
        md5 = hashlib.md5(open(zip_path, "rb").read()).hexdigest()
        os.environ["STARDIST_TORCH_MODEL_CACHE"] = os.path.join(work, "cache")
        uri = "file://" + os.path.abspath(zip_path)
        register_model(StarDist2D, "2D_demo_zip", uri, md5)
        register_model(StarDist2D, "2D_demo_bad_md5", uri, "0" * 32)
        t0 = time.perf_counter()
        zipped = StarDist2D.from_pretrained("2D_demo_zip", device=dev)
        t_zip = time.perf_counter() - t0
        lab_z, _ = counted(zipped)
        check(np.array_equal(lab_z, lab_ref), "(u) from_pretrained of the zip: labels differ")
        try:
            StarDist2D.from_pretrained("2D_demo_bad_md5", device=dev)
            bad = False
        except ValueError:
            bad = True
        check(bad, "(u) a zip with a wrong md5 was loaded")
    finally:
        if cache is None:
            os.environ.pop("STARDIST_TORCH_MODEL_CACHE", None)
        else:
            os.environ["STARDIST_TORCH_MODEL_CACHE"] = cache
        shutil.rmtree(work, ignore_errors=True)

    import importlib.util
    h5py_found = importlib.util.find_spec("h5py") is not None
    t0 = time.perf_counter()
    get_lib()
    t_lib = time.perf_counter() - t0
    n_rays = ref.config.n_rays
    for grid in ((1, 1), tuple(ref.config.grid)):
        a = star_dist(lbl, n_rays, grid=grid, device=dev)
        check(np.array_equal(a, star_dist2d_native(lbl, n_rays, grid=grid)),
              f"(u) star distances (grid {grid}): card != native")
    dist, points, prob = (det_ref[k] for k in ("dist", "points", "prob"))
    lab_card = polygons_to_label(torch.from_numpy(dist).to(dev), torch.from_numpy(points).to(dev),
                                 img.shape, prob=torch.from_numpy(prob).to(dev)).cpu().numpy()
    lab_nat = polygons_to_label_native(dist, points, img.shape,
                                       render_order(torch.from_numpy(prob)).numpy(),
                                       labels=np.arange(len(prob)))
    check(np.array_equal(lab_card, lab_nat) and np.array_equal(lab_ref, lab_nat),
          "(u) labels: card != native")
    cand_prob, cand_dist, cand_points = ref._predict_sparse(img)
    order = descending_order(cand_prob)
    d_s, p_s = cand_dist[order], cand_points[order]
    nms = float(ref.thresholds.nms)
    reset_launches(kernels)
    keep = ref._nms_keep(cand_prob[order], d_s, p_s, nms).cpu().numpy()
    torch.cuda.synchronize()
    launches["pair"] += kernels["pair"].launches
    t0 = time.perf_counter()
    keep_nat = nms2d_native(d_s.cpu().numpy(), p_s.cpu().numpy().astype(np.float32), nms)
    t_nat = time.perf_counter() - t0
    check(np.array_equal(keep, keep_nat), f"(u) keep flags: card {int(keep.sum())} vs native "
                                          f"{int(keep_nat.sum())} of {len(keep)}")
    print(f"(u) from_pretrained('2D_demo') on the card: labels exactly StarDist2D(None, "
          f"'2D_demo', 'models/examples')'s at {E2E_SIZE}^2 ({int(lab.max())} objects); from a "
          f"file:// zip (md5 checked, {t_zip:.2f} s to unpack and load): equal too, and a wrong "
          f"md5 refused; native library built in {t_lib:.1f} s: star distances (grid 1 and "
          f"{tuple(ref.config.grid)}, {n_rays} rays, {E2E_SIZE}^2) exactly the card's, labels of "
          f"{len(prob)} polygons exactly the card's, keep flags of {len(keep)} candidates "
          f"({int(keep.sum())} kept) exactly the card's (native NMS {t_nat:.2f} s on the host); "
          f"the Keras HDF5 import is not driven here: it needs h5py (installed: {h5py_found}; "
          f"tests/test_torch_h5_import.py holds it on the CPU); launches {launches}; the phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def as_uint16(img):
    """A synthetic field as a microscope writes it: uint16 counts."""
    return np.clip(img * 4000 + 1000, 0, 65535).astype(np.uint16)


def cli_run(predict2d, argv, Model, ndim, kernels, conv, model, n_calls, read):
    """One run of the CLI on the card with the launch counts set to 0 just
    before it and read just after: (the label file read back with
    ``read(path, ndim)``, the returned labels, details, wall seconds,
    launches)."""
    args = predict2d.make_parser(ndim).parse_args(argv)
    reset_launches(kernels)
    conv.KERNEL3D.launches = 0
    t0 = time.perf_counter()
    lab, det = predict2d.run(args, Model, ndim)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if ndim == 2:
        launches = read_launches(kernels, model, n_calls)
    else:
        launches = {"conv3d": conv.KERNEL3D.launches}
        n_conv = len(model.net.conv_blocks()) * n_calls
        check(launches["conv3d"] == n_conv,
              f"(v) 3D CLI: conv3d launches {launches['conv3d']} != {n_conv}")
    name = os.path.splitext(os.path.basename(args.input))[0] + ".labels.tif"
    return read(os.path.join(args.outdir, name), ndim), lab, det, wall, launches


def trace_child(trace_dir):
    """(v)'s traced call, run by phase_v in a process of its own: 2D_demo's
    predict_instances on the CMP_SIZE^2 field once to warm up, then once
    inside core.profiling.trace(trace_dir); prints the profiled seconds."""
    from stardist_torch.core.profiling import trace
    from stardist_torch.models import StarDist2D
    model = StarDist2D(None, "2D_demo", "models/examples")
    img, _ = synthetic_nuclei((CMP_SIZE, CMP_SIZE), seed=123)
    model.predict_instances(img)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trace(trace_dir):
        model.predict_instances(img)
    print(json.dumps({"profiled_s": time.perf_counter() - t0}))


def phase_v(dev, kernels, conv, matching, StarDist2D, StarDist3D):
    """The interop surface on the card: the CLI (2D untiled and tiled, 3D),
    predict_sparse(device_dist=True), profiling, data and, where their
    packages are installed, export_TF, bioimage.io and render_label."""
    import importlib.util
    import shutil
    import tempfile
    import zipfile
    from stardist_torch.core.normalize import normalize
    from stardist_torch.core.profiling import Timer
    from stardist_torch.data import test_image_nuclei_2d
    from stardist_torch.scripts import predict2d
    t_phase = time.perf_counter()
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("imageio", "tensorflow", "yaml", "matplotlib")}
    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_v_", dir="build")
    saved_io = predict2d._imread, predict2d._imwrite
    if not found["imageio"]:                 # here only; never a CLI option
        predict2d._imread = lambda path, ndim=2: np.load(path)
        predict2d._imwrite = lambda path, arr: np.save(path, arr)
    ext = ".tif" if found["imageio"] else ".npy"

    def write_input(name, arr):
        path = os.path.join(work, name + ext)
        predict2d._imwrite(path, arr)
        return path

    def read_output(path, ndim):
        return predict2d._imread(path, ndim) if found["imageio"] else np.load(path + ".npy")

    launches = {"conv": 0, "pair": 0, "raster": 0, "conv3d": 0}
    lines = []
    try:
        model = StarDist2D(None, "2D_demo", "models/examples", device=dev)
        img, lbl = synthetic_nuclei((E2E_SIZE, E2E_SIZE), seed=123)
        u16 = as_uint16(img)
        x = normalize(u16, 1, 99.8)
        src = write_input("field2d", u16)
        for n_tiles in (None, (2, 2)):
            argv = ["-i", src, "-o", os.path.join(work, f"out_{n_tiles}"), "-m", "2D_demo",
                    "--modeldir", "models/examples"]
            argv += ["--n_tiles", "2", "2"] if n_tiles else []
            # tiled: the 4 tiles and the receptive field's 2 forwards (the CLI's
            # model is new, so it measures its tile overlap once)
            got, lab, det, wall, n = cli_run(predict2d, argv, StarDist2D, 2, kernels, conv,
                                             model, 6 if n_tiles else 1, read_output)
            want, det_in = model.predict_instances(x, n_tiles=n_tiles)
            check(got.dtype == np.uint16 and got.shape == img.shape and got.max() > 0,
                  f"(v) 2D CLI n_tiles={n_tiles}: label file {got.dtype} {got.shape}")
            check(np.array_equal(got, want) and np.array_equal(lab, want),
                  f"(v) 2D CLI n_tiles={n_tiles}: labels differ from the in-process call")
            check(np.array_equal(det["points"], det_in["points"]),
                  f"(v) 2D CLI n_tiles={n_tiles}: survivors differ")
            for k in n:
                launches[k] += n[k]
            ap = matching(lbl, got, thresh=0.5).accuracy
            lines.append(f"2D CLI {E2E_SIZE}^2 n_tiles={n_tiles}: labels exactly the "
                         f"in-process call's ({int(got.max())} objects, AP@0.5 {ap:.4f}), wall "
                         f"{wall:.2f} s, launches {n}")

        model3 = StarDist3D(None, "3D_demo", "models/examples", device=dev)
        img3, _ = synthetic_nuclei_3d(E2E3D_SHAPE, seed=3)
        u16_3 = as_uint16(img3[tuple(slice(0, s) for s in CLI3D_SHAPE)])
        src3 = write_input("field3d", u16_3)
        argv = ["-i", src3, "-o", os.path.join(work, "out3d"), "-m", "3D_demo", "--modeldir",
                "models/examples"]
        from stardist_torch.scripts import predict3d
        check(predict3d.run is predict2d.run, "(v) the 3D CLI runs predict2d.run")
        got, lab, det, wall, n = cli_run(predict2d, argv, StarDist3D, 3, kernels, conv,
                                         model3, 1, read_output)
        want, _ = model3.predict_instances(normalize(u16_3, 1, 99.8))
        check(got.shape == CLI3D_SHAPE and got.max() > 0 and np.array_equal(got, want),
              "(v) 3D CLI: labels differ from the in-process call")
        launches["conv3d"] += n["conv3d"]
        lines.append(f"3D CLI {'x'.join(map(str, CLI3D_SHAPE))}: labels exactly the "
                     f"in-process call's ({int(got.max())} objects), wall {wall:.2f} s, "
                     f"launches {n}")

        prob, dist, points = model.predict_sparse(x, device_dist=True)
        prob0, dist0, points0 = model.predict_sparse(x)
        check(isinstance(dist, torch.Tensor) and dist.is_cuda
              and dist.device.type == model.device.type, "(v) device_dist: dist not on the card")
        check(np.array_equal(dist.cpu().numpy(), dist0) and np.array_equal(prob, prob0)
              and np.array_equal(points, points0), "(v) device_dist=True != device_dist=False")
        lines.append(f"predict_sparse(device_dist=True) {E2E_SIZE}^2: dist a CUDA tensor "
                     f"{tuple(dist.shape)} on {dist.device}, rows, prob and points exactly "
                     f"device_dist=False's")

        # the trace is taken in a fresh process: in a full run of this script
        # on an H100, a trace taken here after (a)-(u) held the pair and
        # raster kernels' events but none of the conv kernel's, where in a
        # process that had run (v) alone, or (e) and (v), it held all three
        trace_dir = os.path.join(work, "trace")
        here = os.path.dirname(os.path.abspath(__file__))
        child = subprocess.run(
            [sys.executable, "-c", f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
                                   f"chip_smoke.trace_child({trace_dir!r})"],
            capture_output=True, text=True, timeout=600)
        check(child.returncode == 0, f"(v) the traced process failed: {child.stderr[-2000:]}")
        t_trace = json.loads(child.stdout.strip().splitlines()[-1])["profiled_s"]
        img1, _ = synthetic_nuclei((CMP_SIZE, CMP_SIZE), seed=123)
        files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
        check(len(files) == 1, f"(v) trace: {files}")
        with open(os.path.join(trace_dir, files[0])) as f:
            events = json.load(f)["traceEvents"]
        kern = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        named = {k: sum(k in e for e in kern) for k in ("conv_kernel", "pair_kernel",
                                                       "raster_kernel")}
        check(all(named.values()), f"(v) the trace names no launch of {named}; its kernel "
                                   f"events ({len(kern)}): {sorted(set(kern))[:12]}")
        timer = Timer()                 # each lap ends in device_sync of what it boxed
        for _ in range(3):
            with timer(f"predict_instances {CMP_SIZE}^2"):
                model.predict_instances(img1)
            with timer(f"dense predict {CMP_SIZE}^2 (tensors on the card)") as box:
                box.append(model._predict(img1))
        laps = {k: [round(v * 1e3, 2) for v in vs] for k, vs in timer.laps.items()}
        lines.append(f"trace of one predict_instances {CMP_SIZE}^2 in a fresh process "
                     f"({t_trace:.2f} s profiled, "
                     f"{os.path.getsize(os.path.join(trace_dir, files[0])) / 1e6:.1f} MB, "
                     f"{len(kern)} kernel events): launches named {named}; Timer laps ms {laps}")

        img_d, mask_d = test_image_nuclei_2d(return_mask=True)
        xd = normalize(img_d, 1, 99.8)
        lab_d, _ = model.predict_instances(xd)
        # the CPU port at the card's precision (bf16 plain convs), and in f32:
        # on this 48-object image bf16 drops one object against f32, on the
        # CPU alone too (accuracy 0.979), so the check holds like with like
        acc = {}
        for dtype in ("bfloat16", "float32"):
            lab_c, _ = StarDist2D(None, "2D_demo", "models/examples", device="cpu",
                                  inference_dtype=dtype).predict_instances(xd)
            acc[dtype] = matching(lab_c, lab_d, thresh=0.5).accuracy
        ap_d = matching(mask_d, lab_d, thresh=0.5).accuracy
        check(acc["bfloat16"] >= 0.99,
              f"(v) data image: card vs CPU (bf16) accuracy {acc['bfloat16']} < 0.99")
        lines.append(f"data.test_image_nuclei_2d {img_d.shape}: AP@0.5 {ap_d:.4f} against its "
                     f"mask ({int(lab_d.max())} objects, {int(mask_d.max())} true), card vs CPU "
                     f"accuracy {acc['bfloat16']:.4f} (CPU in bf16), {acc['float32']:.4f} "
                     f"(CPU in f32)")

        ran = []
        if found["tensorflow"]:
            import tensorflow as tf
            tf.config.set_visible_devices([], "GPU")   # TensorFlow's ops on the host
            t0 = time.perf_counter()
            z = model.export_TF(fname=os.path.join(work, "TF_SavedModel.zip"))
            t_tf = time.perf_counter() - t0
            with zipfile.ZipFile(z) as zz:
                zz.extractall(os.path.join(work, "saved_model"))
            out = tf.saved_model.load(os.path.join(work, "saved_model"))(
                tf.constant(xd[None, ..., None])).numpy()[0]
            prob_c, dist_c = model.predict(xd)
            g = model.config.grid
            e_prob = float(np.abs(out[::g[0], ::g[1], 0] - prob_c).max())
            e_dist = float(np.abs(np.maximum(out[::g[0], ::g[1], 1:], 1e-3) - dist_c).max()
                           / max(1.0, float(np.abs(dist_c).max())))
            check(e_prob <= FWD_TOL and e_dist <= FWD_TOL,
                  f"(v) export_TF: prob {e_prob:.2e}, dist {e_dist:.2e} > {FWD_TOL}")
            ran.append(f"export_TF ({t_tf:.1f} s; SavedModel vs the card's predict: prob "
                       f"{e_prob:.2e}, dist {e_dist:.2e} of |dist|max)")
        if found["yaml"]:
            from stardist_torch.bioimageio_utils import export_bioimageio, import_bioimageio
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # "TF SavedModel bundle not included"
                zb = export_bioimageio(model, os.path.join(work, "bioimageio"))
            imported = import_bioimageio(zb, os.path.join(work, "bioimageio_imported"))
            t_bio = time.perf_counter() - t0
            check(imported.device.type == "cuda", "(v) import_bioimageio: not on the card")
            same = all(np.array_equal(a, b) for a, b in zip(imported.predict(xd),
                                                             model.predict(xd)))
            check(same, "(v) import_bioimageio: predict differs from the exported model's")
            with zipfile.ZipFile(zb) as zz:
                tf_bundle = "TF_SavedModel.zip" in zz.namelist()
            ran.append(f"export_bioimageio + import_bioimageio ({t_bio:.1f} s; predict exactly "
                       f"the exported model's; TF bundle included: {tf_bundle})")
        if found["matplotlib"]:
            from stardist_torch.plot import render_label
            rgba = render_label(lab_d, img=xd)
            check(rgba.shape == lab_d.shape + (4,) and np.isfinite(rgba).all(),
                  "(v) render_label")
            ran.append("render_label")
        lines.append(f"optional packages found {found}; ran: {'; '.join(ran) or 'none'}")
    finally:
        predict2d._imread, predict2d._imwrite = saved_io
        shutil.rmtree(work, ignore_errors=True)
    io_note = ("imageio tiffs" if found["imageio"] else
               "imageio is not installed: the CLI's _imread/_imwrite swapped for "
               "np.load/np.save in this script")
    print(f"(v) interop on the card ({io_note}): " + "; ".join(lines) + f"; launches {launches}; "
          f"the phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def seed_network_options(net, seed, dist_bias):
    """Seeded values on a seeded net: every batch norm non-trivial (scale in
    [0.8, 1.2], bias and mean in +-0.1, var in [0.5, 2]) and the dist
    head's bias drawn from ``dist_bias`` (pixels), so that the polygons
    have a nucleus's size and overlap (a random net's distances are near 0,
    clamped at 1e-3). The prob map stays a random net's: nearly flat, so
    that its candidates reorder under a last-bit change of prob, and
    w_predict holds the labels of the card's candidates (and a trained
    net's whole call: identity_batch_norm)."""
    from stardist_torch.models.unet import BatchNorm
    g = torch.Generator().manual_seed(seed)

    def draw(t, lo, hi):
        t.copy_((torch.rand(t.shape, generator=g) * (hi - lo) + lo).to(t.device))

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                for t, lo, hi in ((m.scale, 0.8, 1.2), (m.bias, -0.1, 0.1), (m.mean, -0.1, 0.1),
                                  (m.var, 0.5, 2.0)):
                    draw(t, lo, hi)
        draw(net.head_dist.bias, *dist_bias)


def w_forward(net, x, conv):
    """One network option's forward on the card: the kernel path (the conv
    kernel's launches in one forward) against the plain path at FWD_TOL,
    and both times by CUDA events."""
    conv.KERNEL.launches = 0
    prob, dist = net(x)
    torch.cuda.synchronize()
    n = conv.KERNEL.launches
    prob_p, dist_p = net(x, plain=True)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(dist).all()) and bool(torch.isfinite(prob).all()),
          "(w) non-finite forward output")
    e_prob = (prob - prob_p).abs().max().item()
    e_dist = ((dist - dist_p).abs().max() / dist_p.abs().max().clamp_min(1.0)).item()
    check(e_prob < FWD_TOL and e_dist < FWD_TOL,
          f"(w) kernel forward disagrees with plain: prob {e_prob}, dist {e_dist}")
    del prob, dist, prob_p, dist_p
    return dict(launches=n, ms=cuda_ms(lambda: net(x)),
                plain_ms=cuda_ms(lambda: net(x, plain=True)), e_prob=e_prob, e_dist=e_dist)


def w_threshold(model, img, n):
    """The prob_thresh that keeps about ``n`` candidates of ``model``'s prob
    map of ``img``: a quantile of the map without its border, where
    predict_instances takes no candidate (b = 2) and a random net's most
    extreme values sit."""
    inner = model.predict(img)[0][(slice(2, -2),) * model.config.n_dim]
    return float(np.quantile(inner, 1 - n / inner.size))


def w_predict(model, Model, img, kernels, matching, n_range, cmp, acc_min=None):
    """predict_instances on the card at the prob_thresh that keeps about
    ``n_range[1]`` candidates (the net's weights are seeded; the call must
    have from ``n_range[0]`` to ``n_range[2]``), the launches of that call
    (reset before it, read after it); then ``cmp`` = (crop shape,
    candidates aimed at), the crop on the card against the CPU at the
    card's precision (bf16 plain twins): the dense prediction within
    FWD_TOL, the card's candidates through the card's and the CPU's NMS and
    raster (labels exactly equal), and each side's whole call (matching
    accuracy, held to ``acc_min`` where given: a random net's clustered
    candidates reorder under a last-bit change of prob, so that a seeded
    net's labels are held through the shared candidates). Returns
    (launches, text)."""
    n_lo, n_want, n_hi = n_range
    thresh = w_threshold(model, img, n_want)
    model.predict_instances(img, prob_thresh=thresh)           # warm-up
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    labels, det = model.predict_instances(img, prob_thresh=thresh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    c = det["nms_counters"]
    check(n_lo <= c.get("n_candidates", 0) <= n_hi,
          f"(w) {c.get('n_candidates', 0)} candidates at prob_thresh {thresh}: not in "
          f"[{n_lo}, {n_hi}]")
    check(labels.shape == img.shape and labels.max() > 0, "(w) empty label image")
    shape, n_cmp = cmp
    crop = img[tuple(slice(0, n) for n in shape)]
    thresh_c = w_threshold(model, crop, n_cmp)
    cpu = on_cpu(model, Model, "bfloat16")
    (p_g, d_g), (p_c, d_c) = model.predict(crop), cpu.predict(crop)
    e_prob = float(np.abs(p_g - p_c).max())
    e_dist = float(np.abs(d_g - d_c).max() / max(1.0, float(np.abs(d_c).max())))
    check(e_prob < FWD_TOL and e_dist < FWD_TOL,
          f"(w) card vs CPU (bf16) dense prediction: prob {e_prob}, dist {e_dist}")
    prob, dist, points = model._predict_sparse(crop, prob_thresh=thresh_c)
    lab_s, det_s = model._instances_from_prediction(crop.shape, prob, dist, points)
    lab_sc = cpu._instances_from_prediction(crop.shape, prob.cpu(), dist.cpu(), points.cpu())[0]
    check(np.array_equal(lab_s, lab_sc), "(w) the card's candidates: labels, card != CPU")
    lab_g = model.predict_instances(crop, prob_thresh=thresh_c)[0]
    t1 = time.perf_counter()
    lab_c = cpu.predict_instances(crop, prob_thresh=thresh_c)[0]
    t_cpu = time.perf_counter() - t1
    acc = matching(lab_c, lab_g, thresh=0.5).accuracy
    if acc_min is not None:
        check(acc >= acc_min, f"(w) card vs CPU (bf16) labels on the crop: accuracy {acc} < "
                              f"{acc_min}")
    t = det["timings_s"]
    text = (f"predict_instances {'x'.join(map(str, img.shape))} at prob_thresh {thresh:.6f}: wall "
            f"{wall * 1e3:.1f} ms (" + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in t.items())
            + f" ms), {c['n_candidates']} candidates, {c['n_pairs']} bbox pairs, "
            f"{int(labels.max())} objects; launches {launches}; {'x'.join(map(str, shape))} crop "
            f"card vs CPU at bf16: dense prob {e_prob:.2e}, dist {e_dist:.2e}; the card's "
            f"{len(prob)} candidates through both NMS and rasters: labels equal "
            f"({int(lab_s.max())} objects); whole calls at prob_thresh {thresh_c:.6f}: matching "
            f"accuracy {acc:.4f} ({'held >= ' + str(acc_min) if acc_min else 'printed'}; "
            f"{int(lab_g.max())} / {int(lab_c.max())} objects, CPU call {t_cpu:.1f} s)")
    return launches, text


def identity_batch_norm(StarDist2D, Config2D, dev, seed):
    """2D_demo with batch norm in its backbone: seeded statistics (mean in
    +-0.1, var in [0.5, 2]) and the scale and bias that undo them, so that
    the net computes 2D_demo's function through a non-trivial fold; and
    2D_demo itself, both on ``dev``."""
    from stardist_torch.models.unet import BN_EPS, BatchNorm
    demo = StarDist2D(None, "2D_demo", "models/examples", device=dev)
    m = StarDist2D(Config2D(**dict(demo.config.to_dict(), unet_batch_norm=True)), basedir=None,
                   device=dev)
    missing, unexpected = m.net.load_state_dict(demo.net.state_dict(), strict=False)
    check(not unexpected and missing and all(".bn." in k for k in missing),
          f"(w) batch-norm 2D_demo: missing {missing}, unexpected {unexpected}")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in m.net.modules():
            if isinstance(bn, BatchNorm):
                c = bn.mean.shape[0]
                mean = torch.rand(c, generator=g) * 0.2 - 0.1
                var = torch.rand(c, generator=g) * 1.5 + 0.5
                for t, v in ((bn.mean, mean), (bn.var, var), (bn.scale, (var + BN_EPS).sqrt()),
                             (bn.bias, mean)):
                    t.copy_(v.to(t.device))
    m.thresholds = demo.thresholds
    return m, demo


def w_demo(model, demo, Model, img, lbl, kernels, matching):
    """The batch-norm 2D_demo against 2D_demo on (e)'s field (labels, AP@0.5
    against the field's truth, conv launches) and against the CPU at the
    card's precision on a W_CMP crop. Returns (launches, text)."""
    lab_d = demo.predict_instances(img)[0]
    model.predict_instances(img)                        # warm-up
    torch.cuda.synchronize()
    reset_launches(kernels)
    labels, det = model.predict_instances(img)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    check(launches["conv"] == len(demo.net.conv_blocks()) and launches["pair"] > 0
          and launches["raster"] > 0, f"(w) batch-norm 2D_demo: launches {launches}")
    same = matching(lab_d, labels, thresh=0.5).accuracy
    ap = matching(lbl, labels, thresh=0.5).accuracy
    check(same >= 0.99 and ap >= 0.95,
          f"(w) batch-norm 2D_demo: against 2D_demo {same}, AP@0.5 {ap}")
    crop = img[:W_CMP[0], :W_CMP[0]]
    lab_g = model.predict_instances(crop)[0]
    lab_c = on_cpu(model, Model, "bfloat16").predict_instances(crop)[0]
    acc = matching(lab_c, lab_g, thresh=0.5).accuracy
    check(acc >= 0.99, f"(w) batch-norm 2D_demo: card vs CPU (bf16) accuracy {acc} < 0.99")
    t = det["timings_s"]
    return launches, (
        f"predict_instances {W_SIZE}^2: {int(labels.max())} objects ({int(lbl.max())} true), "
        f"AP@0.5 {ap:.4f}, matching against 2D_demo's labels {same:.4f}; stages "
        + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in t.items()) + f" ms; launches {launches} "
        f"(2D_demo's convs {len(demo.net.conv_blocks())}); {W_CMP[0]}^2 crop card vs CPU at "
        f"bf16: matching accuracy {acc:.4f} ({int(lab_g.max())} / {int(lab_c.max())} objects)")


def phase_w(dev, smi, kernels, conv, matching, StarDist2D, Config2D, StarDist3D, Config3D):
    """The network options that the port took last: batch norm (folded into
    the conv kernel's weights), gelu (after the kernel's linear output), a
    5x5 U-Net (cuDNN), the notebook's 3D ResNet with batch norm, (1, 3, 3)
    kernels and he-uniform; training a swish 5x5 net, and a batch-norm net's
    training refused."""
    from stardist_torch.models.model2d import StarDistData2D
    t_phase = time.perf_counter()
    launches = {"conv": 0, "pair": 0, "raster": 0, "conv3d": 0}
    counted = dict(kernels, conv3d=conv.KERNEL3D)
    img, lbl = synthetic_nuclei((W_SIZE, W_SIZE), seed=123)
    x = torch.from_numpy(img[:, :, None]).to(dev)
    tag = f"[{smi}]"

    base = StarDist2D(Config2D(), basedir=None, device=dev)
    seed_network_options(base.net, 40, (6.0, 12.0))
    fwd_base = w_forward(base.net, x, conv)
    check(fwd_base["launches"] == len(base.net.conv_blocks()), "(w) relu net: conv launches")
    del base
    models = {}
    for name, kw, seed in (("batch_norm", dict(unet_batch_norm=True), 41),
                           ("gelu", dict(unet_activation="gelu"), 42),
                           ("kernel 5x5", dict(unet_kernel_size=(5, 5)), 43)):
        m = StarDist2D(Config2D(**kw), basedir=None, device=dev)
        seed_network_options(m.net, seed, (6.0, 12.0))
        models[name] = m
        f = w_forward(m.net, x, conv)
        n_conv = len(m.net.conv_blocks())
        check(f["launches"] == n_conv, f"(w) {name}: conv launches {f['launches']} != {n_conv}")
        if name == "batch_norm":
            check(f["launches"] == fwd_base["launches"],
                  "(w) the batch-norm net launched another count of convs than the relu net's")
        got, text = w_predict(m, StarDist2D, img, counted, matching, W_CANDIDATES,
                              ((W_CMP[0],) * 2, W_CMP[1]))
        check(got["pair"] > 0 and got["raster"] > 0 and got["conv"] == n_conv,
              f"(w) {name}: launches {got}, {n_conv} convs on the kernel")
        for k in launches:
            launches[k] += got[k]
        note = (" (no conv on the kernel: cuDNN's F.conv2d, as the reference runs XLA's; conv "
                "launches 0)" if n_conv == 0 else "")
        print(f"(w) {name} Config2D() {tag}{note}: forward {W_SIZE}^2 kernel path "
              f"{f['ms']:.2f} ms ({f['ms'] - fwd_base['ms']:+.2f} ms against the relu net's "
              f"{fwd_base['ms']:.2f} ms, same seeds), plain {f['plain_ms']:.2f} ms, prob max abs "
              f"diff {f['e_prob']:.2e}, dist max rel diff {f['e_dist']:.2e}, conv launches "
              f"{f['launches']} (the relu net's {fwd_base['launches']}); {text}", flush=True)
        torch.cuda.empty_cache()

    demo_bn, demo = identity_batch_norm(StarDist2D, Config2D, dev, 45)
    got, text = w_demo(demo_bn, demo, StarDist2D, img, lbl, counted, matching)
    for k in launches:
        launches[k] += got[k]
    print(f"(w) batch norm on 2D_demo's trained weights {tag}: {text}", flush=True)
    del demo_bn, demo
    torch.cuda.empty_cache()

    img3, lbl3 = synthetic_nuclei_3d(E2E3D_SHAPE, seed=3)          # (h)'s volume
    vol = img3[:W3D_SHAPE[0], :W3D_SHAPE[1], :W3D_SHAPE[2]]
    cfg3 = train3d_config([lbl3], "resnet", Config3D, resnet_batch_norm=True,
                          resnet_kernel_size=(1, 3, 3), resnet_kernel_init="he_uniform")
    m3 = StarDist3D(cfg3, basedir=None, device=dev)
    seed_network_options(m3.net, 44, (2.5, 5.0))
    got, text = w_predict(m3, StarDist3D, vol, counted, matching, W3D_CANDIDATES, W3D_CMP)
    check(got["conv3d"] == 0, "(w) the ResNet launched the conv3d kernel")
    for k in launches:
        launches[k] += got[k]
    print(f"(w) 3D ResNet, upstream's notebook (96 rays, grid {cfg3.grid}) with batch norm, "
          f"(1, 3, 3) kernels, he_uniform {tag} (cuDNN's F.conv3d, as the reference runs XLA's; "
          f"conv3d launches 0): {text}", flush=True)
    del m3
    torch.cuda.empty_cache()

    n, side = W_TRAIN
    fields = [synthetic_nuclei((side, side), seed=700 + i) for i in range(n)]
    X, Y = [f[0] for f in fields], [f[1] for f in fields]
    cfg = Config2D(grid=(2, 2), unet_activation="swish", unet_kernel_size=(5, 5),
                   train_tensorboard=False)
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        set_tf32(False)
        data = StarDistData2D(X, Y, batch_size=cfg.train_batch_size, n_rays=cfg.n_rays, length=1,
                              patch_size=cfg.train_patch_size, grid=cfg.grid,
                              foreground_prob=cfg.train_foreground_only)
        cmp_text = train_vs_cpu(dev, StarDist2D, cfg, data)
        m = StarDist2D(cfg, basedir=None, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = m.train(X, Y, validation_data=(X[:1], Y[:1]), seed=21, epochs=1,
                    steps_per_epoch=W_TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    losses = np.asarray(h.steps["loss"])
    check(len(losses) == W_TRAIN_STEPS and np.isfinite(losses).all()
          and np.isfinite(h.history["val_loss"]).all(), f"(w) training losses: {losses}")
    refused = None
    try:
        models["batch_norm"].train(X, Y, validation_data=(X[:1], Y[:1]), epochs=1,
                                   steps_per_epoch=1)
    except NotImplementedError as e:                   # the refusal this phase checks
        refused = str(e)
    check(refused is not None, "(w) training the batch-norm net did not raise NotImplementedError")
    print(f"(w) training Config2D(grid=(2, 2), unet_activation='swish', unet_kernel_size=(5, 5)) "
          f"at {cfg.train_patch_size} x {cfg.train_batch_size} {tag}, TF32 off: one batch card "
          f"vs CPU: {cmp_text}; StarDist2D.train 1 x {W_TRAIN_STEPS} steps on {n} fields of "
          f"{side}^2: losses {[round(float(v), 5) for v in losses]}, val_loss "
          f"{h.history['val_loss']}, {wall:.1f} s with validation and start-up; the batch-norm "
          f"net's train raised NotImplementedError ({refused[:60]}...); the phase "
          f"{time.perf_counter() - t_phase:.1f} s, launches {launches}", flush=True)
    return launches


def phase_x(dev, kernels, conv, po, matching, StarDist2D, StarDist3D, j_syncs=None):
    """The NMS's samples option, the 3D device path's lattice and the
    prediction generators on the card."""
    t_phase = time.perf_counter()
    # the pair kernel at any S: exact against its plain version
    args = random_pairs(N_PAIRS, 32, dev, 7)
    rows = {}
    for S in X_S:
        got = po.pair_frac(*args, S=S)
        ref = po.pair_frac_plain(*args, S=S)
        torch.cuda.synchronize()
        n_diff = int((got != ref).sum().item())
        check(n_diff == 0, f"(x) pair kernel differs from plain on {n_diff} pairs at S={S}")
        b_ms, b_by = pair_bound(N_PAIRS, 32, S)
        rows[S] = dict(ms=pair_kernel_ms(po, args, S),
                       call_ms=cuda_ms(lambda: po.pair_frac(*args, S=S), warmup=3, iters=30),
                       plain_ms=cuda_ms(lambda: po.pair_frac_plain(*args, S=S), iters=1),
                       err=(got - ref).abs().max().item(), bound_ms=b_ms, bound_by=b_by)
    n_more = 0
    for R in X_R:
        more = [torch.cat(ts) for ts in zip(random_pairs(20_000, R, dev, R),
                                             adversarial_pairs(R, dev, extents=X_S))]
        for S in X_S:
            n_diff = int((po.pair_frac(*more, S=S) != po.pair_frac_plain(*more, S=S)).sum().item())
            check(n_diff == 0, f"(x) pair kernel differs from plain on {n_diff} pairs at R={R}, "
                               f"S={S}")
        n_more += len(more[0])
    del args, more
    print(f"(x) pair kernel vs plain on {N_PAIRS} pairs (R = 32): exact at S = "
          f"{', '.join(map(str, X_S))}; " + "; ".join(
              f"S={S}: kernel {r['ms']:.4f} ms (call {r['call_ms']:.4f} ms) / plain "
              f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), kernel at "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound" for S, r in rows.items())
          + f"; exact too on {n_more} random and adversarial pairs at R = "
          f"{', '.join(map(str, X_R))}, each S", flush=True)

    # 2D_demo on (e)'s field with nms_kwargs={"samples": S}
    model = StarDist2D(None, "2D_demo", "models/examples", device=dev)
    img, lbl = synthetic_nuclei((E2E_SIZE, E2E_SIZE), seed=123)
    base, _ = model.predict_instances(img)
    counts = dict.fromkeys(kernels, 0)
    parts = []
    for S in X_SAMPLES:
        kw = dict(nms_kwargs={"samples": S})
        model.predict_instances(img, **kw)               # warm-up
        torch.cuda.synchronize()
        reset_launches(kernels)
        lab, det = model.predict_instances(img, **kw)
        torch.cuda.synchronize()
        la = read_launches(kernels, model)
        for k, v in la.items():
            counts[k] += v
        ap = matching(lbl, lab, thresh=0.5).accuracy
        check(ap >= 0.95, f"(x) samples={S}: AP@0.5 {ap} < 0.95")
        if S == 16:
            check(np.array_equal(lab, base), "(x) samples=16 labels != the default call's")
        same = np.array_equal(model.predict_instances(img, nms_kwargs=dict(kw["nms_kwargs"],
                                                                           **X_SCHEDULING))[0], lab)
        check(same, f"(x) the scheduling options changed the labels at samples={S}")
        t, c = det["timings_s"], det["nms_counters"]
        parts.append(f"S={S}: nms {t['nms'] * 1e3:.1f} ms, {c['n_eval_pairs']} exact pairs, "
                     f"{c['n_fine_pairs']} of them on the fine grid, pair launches {la['pair']}, "
                     f"{len(det['prob'])} objects, AP@0.5 {ap:.4f}, {int((lab != base).sum())} "
                     f"pixels differ from S=16")
    img1, _ = synthetic_nuclei((CMP_SIZE, CMP_SIZE), seed=123)
    cpu = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
    prob, dist, points = model._predict_sparse(img1)
    lab_g, det_g = model._instances_from_prediction(img1.shape, prob, dist, points, samples=12)
    lab_c, det_c = cpu._instances_from_prediction(img1.shape, prob.cpu(), dist.cpu(),
                                                  points.cpu(), samples=12)
    check(np.array_equal(lab_g, lab_c) and np.array_equal(det_g["points"], det_c["points"]),
          f"(x) {CMP_SIZE}^2, the card's candidates at samples=12: card != CPU")
    print(f"(x) 2D_demo {E2E_SIZE}^2 with nms_kwargs={{'samples': S}}: " + "; ".join(parts)
          + f"; the scheduling options {sorted(X_SCHEDULING)} change no label; {CMP_SIZE}^2, "
          f"the card's {len(prob)} candidates through the card's and the CPU's NMS and raster "
          f"at S=12: labels equal ({len(det_c['prob'])} objects)", flush=True)

    # the 3D device path at the reference's device lattice, S = 10
    m3 = StarDist3D(None, "3D_demo", "models/examples", device=dev)
    img3, _ = synthetic_nuclei_3d(E2E3D_SHAPE, seed=3)
    conv.KERNEL3D.launches = 0
    t0 = time.perf_counter()
    lab_d, det_d = m3.predict_instances_device(img3)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    counts["conv3d"] = conv.KERNEL3D.launches
    check(counts["conv3d"] == len(m3.net.conv_blocks()), "(x) 3D device path: conv3d launches")
    t0 = time.perf_counter()
    lab10, det10 = m3.predict_instances(img3, nms_kwargs={"samples": 10})
    torch.cuda.synchronize()
    wall_10 = time.perf_counter() - t0
    t0 = time.perf_counter()
    lab12, det12 = m3.predict_instances(img3)
    torch.cuda.synchronize()
    wall_12 = time.perf_counter() - t0
    check(np.array_equal(lab_d, lab10), "(x) 3D device path labels != samples=10's")
    for k in ("points", "prob", "dist"):
        check(np.array_equal(det_d[k], det10[k]), f"(x) 3D device path {k} != samples=10's")
    lab_t, det_t = m3.predict_instances_device(img3, fetch=False)
    check(lab_t.is_cuda and np.array_equal(lab_t.cpu().numpy(), lab10)
          and all(np.array_equal(det_t[k].cpu().numpy(), det10[k])
                  for k in ("points", "prob", "dist")),
          "(x) 3D device path with fetch=False != samples=10's")
    at10 = {tuple(p) for p in det10["points"].tolist()}
    at12 = {tuple(p) for p in det12["points"].tolist()}
    check(len(at10) > 0, "(x) 3D device path: no survivors")
    print(f"(x) 3D_demo {'x'.join(map(str, E2E3D_SHAPE))}: predict_instances_device (fetch=True "
          f"and fetch=False) == predict_instances(nms_kwargs={{'samples': 10}}), "
          f"{len(at10)} survivors; {len(at10 ^ at12)} survivors differ from S=12 "
          f"({len(at12)}); walls: device path {wall_d * 1e3:.1f} ms (nms "
          f"{det_d['timings_s']['nms'] * 1e3:.1f}), samples=10 {wall_10 * 1e3:.1f} ms, "
          f"S=12 {wall_12 * 1e3:.1f} ms (nms {det12['timings_s']['nms'] * 1e3:.1f}); conv3d "
          f"launches {counts['conv3d']}", flush=True)
    del m3

    # the prediction generator on (k)'s field, tiled
    imgk, _ = synthetic_nuclei((TILED_SIZE, TILED_SIZE), seed=321)
    steps, res = [], None
    t0 = time.perf_counter()
    for r in model._predict_instances_generator(imgk, n_tiles=(2, 2)):
        if isinstance(r, str):
            steps.append(r)
        else:
            res = r
    torch.cuda.synchronize()
    wall_g = time.perf_counter() - t0
    check(steps == ["predict"] + ["tile"] * 4 + ["nms"], f"(x) the generator yielded {steps}")
    lab_k, det_k = model.predict_instances(imgk, n_tiles=(2, 2))
    check(np.array_equal(res[0], lab_k)
          and all(np.array_equal(res[1][k], det_k[k]) for k in ("points", "prob", "coord")),
          "(x) the tiled generator's result != predict_instances'")
    x_dev = torch.from_numpy(img).to(dev)
    n_sync = host_syncs(lambda: model.predict_instances_device(x_dev, fetch=False))[0]
    n_sync_gen = host_syncs(lambda: list(model._predict_instances_generator(
        x_dev, fetch=False)))[0]
    check(n_sync == n_sync_gen and (j_syncs is None or n_sync == j_syncs),
          f"(x) host syncs of the device path {n_sync}, of its generator {n_sync_gen}, "
          f"(j) {j_syncs}")
    print(f"(x) _predict_instances_generator {TILED_SIZE}^2, n_tiles=(2, 2): yields {steps}, "
          f"result == predict_instances' ({len(det_k['prob'])} objects), wall {wall_g * 1e3:.1f} "
          f"ms; host syncs of one {E2E_SIZE}^2 device-path call {n_sync}, its generator run by "
          f"hand {n_sync_gen}, (j) {j_syncs}; (x) took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return rows, counts


def raster3d_args(model, img):
    """The arguments of the one ``rasterize_polyhedra`` call of a 3D
    ``predict_instances`` on ``img``: (dist, points, ray_dirs, faces, shape,
    order_values, labels), as ``polyhedron_to_label`` gave them."""
    from stardist_torch.geometry import geom3d
    calls, real = [], geom3d.rasterize_polyhedra

    def record(*args, **kwargs):
        calls.append((*args, kwargs["labels"]))
        return real(*args, **kwargs)
    geom3d.rasterize_polyhedra = record
    try:
        model.predict_instances(img)
    finally:
        geom3d.rasterize_polyhedra = real
    check(len(calls) == 1, f"raster3d_args: {len(calls)} raster calls")
    return calls[0]


def raster3d_voxels(dist, points, shape, order_values):
    """The voxels the 3D raster tests: each drawn polyhedron's cube (the
    window of the largest dist about its rounded centre) clipped to the
    volume, summed."""
    from stardist_torch.ops.raster_tiles import tile_window
    window = tile_window(float(dist.max()), shape)
    start = torch.round(points.float().cpu()).long() - window // 2
    lo = start.clamp(min=0)
    hi = torch.minimum(start + window, torch.tensor(shape))
    n = (hi - lo).clamp(min=0).prod(dim=1)
    return int(n[order_values.cpu() > 0].sum()), window


def raster3d_bound(n_voxels, F, N, n_image):
    """Bound of the 3D raster kernel's function: each voxel of every drawn
    polyhedron's clipped cube tested against its F faces at 17 f32
    operations (9 products and 8 sums; the comparisons not counted) plus its
    offset (3), as lattice_bound counts; each polyhedron's face rows (F x (9
    + 1 valid byte)), centre and two int64 values read once, the int64 image
    written once."""
    return bound(n_voxels * (F * 17 + 3), N * (F * 37 + 12 + 16) + n_image * 8, PEAK_F32)


def raster3d_rays(name, dev="cpu"):
    """(ray_dirs, faces) of a ray set on ``dev``: "golden32", "golden96"
    (anisotropic (2, 1, 1), 188 faces: the notebook's) or "octahedron"
    (faces through voxels at integer centres and dists)."""
    from stardist_torch.ops.polyhedron import ray_tensors
    from stardist_torch.rays3d import Rays_GoldenSpiral
    if name == "octahedron":
        return tuple(t.to(dev) for t in octahedron_rays())
    if name == "golden96":
        return ray_tensors(Rays_GoldenSpiral(96, anisotropy=(2, 1, 1)), dev)
    return ray_tensors(Rays_GoldenSpiral(32), dev)


def polyhedra_field(ray_dirs, n, shape, dev, seed, integer=False):
    """n seeded star polyhedra for the 3D raster: centres in the volume and
    up to 6 voxels beyond it (cut by its edges), half of them about a few
    cluster centres (overlapping), dists of 2-9 a polyhedron, each ray within
    25% of it, a tenth of the rows holding a ray of length 0 (degenerate
    faces), order values drawn from
    1..n // 4 with a fifth set to 0 (ties, and polyhedra never drawn), and
    seeded labels; ``integer``: integer centres and dists (on the
    octahedron, faces through voxels). Returns (dist, points, order_values,
    labels) on ``dev``."""
    rng = np.random.RandomState(seed)
    R = len(ray_dirs)
    hi = np.array(shape, np.float64)
    points = rng.uniform(-6, hi + 6, (n, 3))
    cl = rng.uniform(0, hi, (4, 3))
    half = rng.rand(n) < 0.5
    points[half] = cl[rng.randint(4, size=half.sum())] + rng.normal(0, 3, (half.sum(), 3))
    dist = rng.uniform(2, 9, (n, 1)) * rng.uniform(0.75, 1.25, (n, R))
    if integer:
        points, dist = np.round(points), np.round(dist)
    dist[rng.rand(n) < 0.1, rng.randint(R)] = 0.0
    order = rng.randint(1, max(2, n // 4) + 1, n)
    order[rng.rand(n) < 0.2] = 0
    labels = rng.permutation(n) + 1
    arrays = (dist.astype(np.float32), points.astype(np.float32), order.astype(np.int64),
              labels.astype(np.int64))
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def raster3d_vs_twin(tag, dist, points, ray_dirs, faces, shape, order, labels, mode):
    """The 3D raster kernel's labels, and its count, against the plain
    twin's on the same tensors moved to the CPU, with and without the count;
    fails where a voxel differs. Returns the twin's (labels, count, seconds)."""
    from stardist_torch.ops.raster_polyhedra import rasterize_polyhedra_cuda
    from stardist_torch.ops.rasterize import rasterize_polyhedra
    cpu = [None if t is None else t.cpu() for t in (dist, points, ray_dirs, faces, order, labels)]
    t0 = time.perf_counter()
    ref, ref_cnt = rasterize_polyhedra(*cpu[:4], shape, cpu[4], labels=cpu[5],
                                       return_count=True, mode=mode)
    seconds = time.perf_counter() - t0
    for count in (False, True):
        got, cnt = rasterize_polyhedra_cuda(dist, points, ray_dirs, faces, shape, order, labels,
                                            return_count=count, mode=mode)
        check(got.is_cuda and got.dtype == torch.int32 and (cnt is not None) == count,
              f"{tag} {mode}: a {got.dtype} image on {got.device}, count {cnt is not None}")
        n_diff = int((got.cpu() != ref).sum()) + (int((cnt.cpu() != ref_cnt).sum()) if count
                                                  else 0)
        check(n_diff == 0, f"{tag} {mode} labels={labels is not None} count={count}: {n_diff} "
                           "voxels differ from the plain twin")
    return ref, ref_cnt, seconds


def phase_y(dev, r3, StarDist3D):
    """The 3D raster kernel against its plain twin on the CPU."""
    from portbench.frozen import synthetic_nuclei_3d_aniso
    t_phase = time.perf_counter()
    stack_shape, stack_seed = Y_STACK
    cells = (("3D_demo", "models/examples",
              lambda: synthetic_nuclei_3d(E2E3D_SHAPE, seed=3)[0], ("full", "kernel", "bbox")),
             ("3D_notebook", "portbench/configs",
              lambda: synthetic_nuclei_3d_aniso(stack_shape, seed=stack_seed,
                                                **Y_STACK_PARAMS)[0], ("full",)))
    rows = {}
    for name, basedir, make, modes in cells:
        model = StarDist3D(None, name, basedir, device=dev)
        img = make()
        model.predict_instances(img)                   # warm-up: allocator, caches
        n0 = r3.KERNEL.launches
        dist, points, ray_dirs, faces, vol, order, labels = raster3d_args(model, img)
        check(r3.KERNEL.launches - n0 == 1,
              f"(y) {name}: {r3.KERNEL.launches - n0} raster launches in one call")
        plain_s = {}
        for mode in modes:
            ref, _, plain_s[mode] = raster3d_vs_twin(f"(y) {name}", dist, points, ray_dirs,
                                                     faces, vol, order, labels, mode)
            check(int(ref.max()) > 0, f"(y) {name} {mode}: empty label volume")
        N, F = len(dist), len(faces)
        inputs = r3.kernel_inputs(dist, points, ray_dirs, faces, order, labels, "full")
        n_vox, window = raster3d_voxels(dist, points, vol, order)
        b_ms, b_by = raster3d_bound(n_vox, F, N, int(np.prod(vol)))
        k_ms = cuda_ms(lambda: r3.draw(inputs, vol, F, "full"), warmup=2, iters=10)
        rows[name] = dict(
            ms=k_ms, call_ms=cuda_ms(lambda: r3.rasterize_polyhedra_cuda(
                dist, points, ray_dirs, faces, vol, order, labels), warmup=2, iters=10),
            plain_ms=plain_s["full"] * 1e3, bound_ms=b_ms, bound_by=b_by, N=N, F=F,
            window=window, voxels=n_vox, shape=vol, modes=modes, plain_s=plain_s)
        del model
        torch.cuda.empty_cache()
    print("(y) 3D raster kernel on one call's survivors, labels and counts exactly the plain "
          "twin's (CPU): " + "; ".join(
              f"{name} {'x'.join(map(str, r['shape']))}: {r['N']} survivors, F = {r['F']}, "
              f"window {r['window']}, {r['voxels']} voxels tested, modes {'/'.join(r['modes'])}; "
              f"kernel + memset {r['ms']:.4f} ms, call {r['call_ms']:.4f} ms, twin "
              + "/".join(f"{s:.2f}" for s in r["plain_s"].values())
              + f" s; bound {r['bound_ms']:.4f} ms ({r['bound_by']}), kernel + memset at "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound"
              for name, r in rows.items()), flush=True)

    # seeded polyhedra of 96 anisotropic rays: every mode, with and without the count
    n, shape = Y_FIELD
    dirs, faces = raster3d_rays("golden96", dev)
    dist, points, order, labels = polyhedra_field(dirs, n, shape, dev, seed=5)
    drawn = {}
    for mode in ("full", "kernel", "bbox"):
        for lab in (labels, None):
            ref, ref_cnt, _ = raster3d_vs_twin("(y) 96-ray field", dist, points, dirs, faces,
                                               shape, order, lab, mode)
        drawn[mode] = (int((ref > 0).sum()), int(ref_cnt.max()))
    print(f"(y) {n} seeded 96-ray polyhedra (F = {len(faces)}) in {'x'.join(map(str, shape))}: "
          "labels and counts exactly the plain twin's in every mode, with and without labels "
          "and the count (" + ", ".join(f"{m}: {v} voxels drawn, up to {c} deep"
                                       for m, (v, c) in drawn.items())
          + f"); (y) took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=ALL_PHASES,
                    help="the phases to run after (a), e.g. 'k'; the kernels' record and "
                         "the ok line need all of them (default: %(default)s)")
    phases = set(ap.parse_args(argv).phases)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from stardist_torch.matching import matching
    from stardist_torch.models import Config2D, Config3D, StarDist2D, StarDist3D
    from stardist_torch.models.unet import StarDistNet
    from stardist_torch.ops import conv, cuda_build, lattice_overlap as lk
    from stardist_torch.ops import pair_overlap as po, raster_polyhedra as r3, raster_tiles as rt
    from stardist_torch.ops.rasterize import rasterize_polygons_splat

    torch.backends.cudnn.allow_tf32 = False        # plain convs in full f32
    torch.backends.cuda.matmul.allow_tf32 = False  # the head in full f32
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    kernels = {"conv": conv.KERNEL, "pair": po.KERNEL, "raster": rt.KERNEL}
    builds = {"conv": conv.KERNEL, "pair": po.KERNEL, "conv3d": conv.KERNEL3D,
              "raster": rt.KERNEL, "lattice": lk.KERNEL, "raster3d": r3.KERNEL}
    reports = {name: builds[name] for name in ("conv", "conv3d") if phases & set("bf")}
    if "h" in phases:
        reports["lattice"] = lk.KERNEL
    if "y" in phases:
        reports["raster3d"] = r3.KERNEL
    jobs = [k.build for k in builds.values()]
    jobs += [lambda k=k: ptxas_report(k, cuda_build) for k in reports.values()]
    with ThreadPoolExecutor(len(jobs)) as pool:        # one nvcc per compile, all at once
        done = list(pool.map(lambda job: job(), jobs))
    ptxas = "".join(f"; {name} {r}" for name, r in zip(reports, done[len(builds):]))
    ptxas = f"; ptxas, compiled again in this run{ptxas}" if ptxas else ""
    print(f"(a) {torch.cuda.get_device_name(0)} [{smi}]; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; kernels built in {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{name} {k.build_seconds:.1f} s" for name, k in builds.items())
          + f"){ptxas}", flush=True)

    if phases & set("bcde"):
        net = StarDistNet(Config2D(grid=(2, 2)), dtype=torch.bfloat16)
        net.init_weights(torch.Generator().manual_seed(0))
        net.to(dev)
        conv2d = phase_b(net, dev, conv) if "b" in phases else None
        pair = phase_c(dev, po) if "c" in phases else None
        if "d" in phases:
            phase_d(net, dev)
        launches = phase_e(dev, kernels, matching, StarDist2D, rt) if "e" in phases else None
        del net
        torch.cuda.empty_cache()

    if phases & set("fg"):
        net3 = StarDistNet(Config3D(grid=(1, 2, 2)), dtype=torch.bfloat16)
        net3.init_weights(torch.Generator().manual_seed(0))
        net3.to(dev)
        conv3d = phase_f(net3, dev, conv) if "f" in phases else None
        if "g" in phases:
            phase_g(net3, dev)
        del net3
        torch.cuda.empty_cache()
    if "h" in phases:
        launches3d, lattice_launches, lattice = phase_h(dev, conv, lk, matching, StarDist3D)
        torch.cuda.empty_cache()

    raster = phase_i(dev, rt, rasterize_polygons_splat) if "i" in phases else None
    j_syncs = phase_j(dev, kernels, StarDist2D) if "j" in phases else None
    if "k" in phases:
        phase_k(dev, kernels, matching, StarDist2D, rt)
    if "l" in phases:
        phase_l(dev, kernels, StarDist2D, Config2D)
    if "m" in phases:
        phase_m(dev, kernels, matching, StarDist2D, rt)
    if "n" in phases:
        phase_n(dev, conv, StarDist3D, Config3D)
        torch.cuda.empty_cache()
    if "o" in phases:
        phase_o(dev, conv, matching, StarDist3D)
        torch.cuda.empty_cache()
    more = []                      # the new paths' launches, counted with the main path's
    if "p" in phases:
        more.append(phase_p(dev, kernels, conv, matching, StarDist2D, Config2D))
        torch.cuda.empty_cache()
    if "q" in phases:
        more.append({"conv3d": phase_q(dev, conv, StarDist3D, Config3D)})
        torch.cuda.empty_cache()
    if "r" in phases:
        more.append(phase_r(dev, kernels, matching, StarDist2D, Config2D, rt))
        torch.cuda.empty_cache()
    if "s" in phases:
        more.append(phase_s(dev, kernels, matching, StarDist2D))
        torch.cuda.empty_cache()
    if "t" in phases:
        more.append(phase_t(dev, kernels, StarDist2D))
        torch.cuda.empty_cache()
    if "u" in phases:
        more.append(phase_u(dev, kernels, StarDist2D))
        torch.cuda.empty_cache()
    if "v" in phases:
        more.append(phase_v(dev, kernels, conv, matching, StarDist2D, StarDist3D))
        torch.cuda.empty_cache()
    if "w" in phases:
        more.append(phase_w(dev, smi, kernels, conv, matching, StarDist2D, Config2D, StarDist3D,
                            Config3D))
        torch.cuda.empty_cache()
    if "x" in phases:
        pair_any, counts = phase_x(dev, kernels, conv, po, matching, StarDist2D, StarDist3D,
                                   j_syncs)
        more.append(counts)
    raster3d = phase_y(dev, r3, StarDist3D) if "y" in phases else None
    if phases != set(ALL_PHASES):
        return 0
    launches["conv3d"] = launches3d
    for counts in more:
        for k, v in counts.items():
            launches[k] += v

    def conv_row(name, source, replaces, n, tot):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": tot["err"], "ms": tot["ms"],
                "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": tot["bound_by"], "library_ms": tot["library_ms"]}

    record = {"kernels": [
        conv_row("conv3x3_bf16_hwc", "stardist_torch/csrc/conv3x3.cu",
                 "stardist_tpu/ops/conv_pallas.py:393", launches["conv"], conv2d),
        {"name": "pair_frac_f32", "route": "cuda",
         "source": "stardist_torch/csrc/pair_overlap.cu",
         "replaces": "stardist_tpu/ops/pair_overlap.py:82",
         "launches": launches["pair"],
         "max_abs_err": max(r["err"] for r in (*pair.values(), *pair_any.values())),
         **{k: pair[16][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None, "ms_s8": pair[8]["ms"], "call_ms": pair[16]["call_ms"],
         "ms_by_s": {str(S): r["ms"] for S, r in pair_any.items()}},
        conv_row("conv3x3x3_bf16_dhwc", "stardist_torch/csrc/conv3x3x3.cu",
                 "stardist_tpu/ops/conv_pallas.py:574", launches["conv3d"], conv3d),
        {"name": "raster_labels_u32", "route": "cuda",
         "source": "stardist_torch/csrc/raster_tiles.cu",
         "replaces": "stardist_tpu/ops/raster_pallas.py:80",
         "launches": launches["raster"], "max_abs_err": max(r["err"] for r in raster),
         "mismatched_pixels": sum(r["n_diff"] for r in raster),
         "ms": raster[0]["ms"], "plain_ms": raster[0]["plain_ms"],
         "bound_ms": raster[0]["bound_ms"], "bound_by": raster[0]["bound_by"],
         "library_ms": None, "kernel_ms": raster[0]["kernel_ms"]},
        {"name": "lattice_counts_i32", "route": "cuda",
         "source": "stardist_torch/csrc/lattice_overlap.cu", "replaces": None,
         "launches": lattice_launches, "launches_script": lk.KERNEL.launches,
         "max_abs_err": 0.0,
         **{k: lattice[12][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "call_ms")},
         "library_ms": None, "ms_by_s": {str(S): r["ms"] for S, r in lattice.items()}},
        {"name": "raster_polyhedra_i64", "route": "cuda",
         "source": "stardist_torch/csrc/raster_polyhedra.cu", "replaces": None,
         "launches_script": r3.KERNEL.launches, "max_abs_err": 0.0,
         **{k: raster3d["3D_notebook"][k]
            for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         "ms_by_config": {name: r["ms"] for name, r in raster3d.items()}},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
