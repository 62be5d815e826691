"""Smoke run of stardist_torch on one CUDA card.

    python3 chip_smoke.py [--phases bcdefghijklm]

Phases (each prints one line; any failed check exits non-zero):
  (a) the card's name and power limit; build the four CUDA kernels from
      stardist_torch/csrc (one nvcc each, all at once) and time the builds;
      with (b) or (f), the conv kernels' registers and spills, from a
      second compile of their sources with ptxas's report, made in the same
      pool;
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
      conv3d launch count; then a 32x96x96 crop on the card against the
      same call on the CPU;
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
      the CPU (matching accuracy >= 0.99, as in (e)).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. With --phases, only (a) and the named phases
run (e.g. --phases k to time the tiled call alone), and neither line is
printed.

Imports torch, numpy, scipy and stardist_torch only (never JAX).
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
ALL_PHASES = "bcdefghijklm"      # (a) runs always
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


def conv_layers_vs_plain(net, x, dev, kernel_fn, plain_fn):
    """Kernel vs plain at every conv layer shape of ``net``'s forward on x
    (shapes found with forward hooks): checks each, times each beside the
    cuDNN yardstick and its bound. Returns (per-shape dicts, totals dict);
    the totals weight each shape by its count in the forward."""
    shapes = {}

    def hook(mod, args, out):
        key = (tuple(args[0].shape), mod.weight.shape[-1], mod.act)
        shapes.setdefault(key, [mod, 0])[1] += 1

    hooks = [blk.register_forward_hook(hook) for blk in net.conv_blocks()]
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


def adversarial_pairs(R, dev, seed=0):
    """A pair for each :func:`adversarial_offsets` u, both polygons centred
    at -u (some regular), over a bbox intersection whose first sample lies
    at the origin at S = 8 (extent 8) or at S = 16 (extent 16): the kernel
    tests u itself and the grid's other samples about it."""
    u = torch.from_numpy(adversarial_offsets(R))
    n = len(u)
    g = torch.Generator().manual_seed(seed)
    d_r = torch.rand(2 * n, R, generator=g) * 8 + 4
    d_c = torch.rand(2 * n, R, generator=g) * 8 + 4
    d_c[::3] = 6.0
    p = torch.cat([-u, -u])
    ext = torch.cat([torch.full((n, 2), 8.0), torch.full((n, 2), 16.0)])
    plo = torch.full((2 * n, 2), -0.5)
    return tuple(t.to(dev) for t in (d_r, p, d_c, p.clone(), plo, ext))


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


def phase_h(dev, conv, matching, StarDist3D):
    model = StarDist3D(None, "3D_demo", "models/examples", device=dev)
    img, lbl = synthetic_nuclei_3d(E2E3D_SHAPE, seed=3)
    model.predict_instances(img)                       # warm-up: allocator, caches
    torch.cuda.synchronize()
    conv.KERNEL3D.launches = 0
    t0 = time.perf_counter()
    labels, details = model.predict_instances(img)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = conv.KERNEL3D.launches
    n_conv = len(model.net.conv_blocks())
    check(launches == n_conv, f"conv3d launches {launches} != {n_conv} convs x 1 call")
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
          f"{ap5:.4f}; conv3d launches {launches}", flush=True)

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
    return launches


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
    return launches


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
    from stardist_torch.ops import conv, cuda_build, pair_overlap as po, raster_tiles as rt
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
    jobs = [k.build for k in (conv.KERNEL, po.KERNEL, conv.KERNEL3D, rt.KERNEL)]
    if phases & set("bf"):
        jobs += [lambda k=k: ptxas_report(k, cuda_build) for k in (conv.KERNEL, conv.KERNEL3D)]
    with ThreadPoolExecutor(len(jobs)) as pool:        # one nvcc per compile, all at once
        done = list(pool.map(lambda job: job(), jobs))
    ptxas = (f"; ptxas, compiled again in this run: conv {done[4]}; conv3d {done[5]}"
             if len(done) > 4 else "")
    print(f"(a) {torch.cuda.get_device_name(0)} [{smi}]; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; kernels built in {time.perf_counter() - t0:.1f} s "
          f"(conv {conv.KERNEL.build_seconds:.1f} s, pair {po.KERNEL.build_seconds:.1f} s, "
          f"conv3d {conv.KERNEL3D.build_seconds:.1f} s, raster "
          f"{rt.KERNEL.build_seconds:.1f} s){ptxas}", flush=True)

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
        launches3d = phase_h(dev, conv, matching, StarDist3D)
        torch.cuda.empty_cache()

    raster = phase_i(dev, rt, rasterize_polygons_splat) if "i" in phases else None
    if "j" in phases:
        phase_j(dev, kernels, StarDist2D)
    if "k" in phases:
        phase_k(dev, kernels, matching, StarDist2D, rt)
    if "l" in phases:
        phase_l(dev, kernels, StarDist2D, Config2D)
    if "m" in phases:
        phase_m(dev, kernels, matching, StarDist2D, rt)
    if phases != set(ALL_PHASES):
        return 0
    launches["conv3d"] = launches3d

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
         "launches": launches["pair"], "max_abs_err": max(r["err"] for r in pair.values()),
         **{k: pair[16][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None, "ms_s8": pair[8]["ms"], "call_ms": pair[16]["call_ms"]},
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
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
