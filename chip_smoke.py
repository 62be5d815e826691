"""Smoke run of stardist_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failed check exits non-zero):
  (a) the card's name and power limit; build the four CUDA kernels from
      stardist_torch/csrc (one nvcc each, all at once) and time the builds;
  (b) conv kernel vs its plain version at every layer shape of the
      full-width StarDist 2D forward (Config2D() defaults) on a 4096^2
      image, with times;
  (c) pair kernel vs its plain version on 10^5 seeded random polygon pairs
      at S = 8 and S = 16: results must be exactly equal;
  (d) the full-width forward at 4096^2 with seeded random weights, kernel
      path vs plain path;
  (e) StarDist2D(None, "2D_demo", "models/examples").predict_instances on a
      synthetic nuclei field of 2048^2 on the card: stage times, counts,
      AP@0.5 (StarDist's matching accuracy) against the field's ground truth,
      launch counts of the conv, pair and raster kernels; then 1024^2 on the
      card against the same call on the CPU;
  (f) conv3d kernel vs its plain version at every layer shape of the
      full-width StarDist 3D forward (Config3D(grid=(1, 2, 2)), 96 rays,
      depth 2, 32 filters) on a 64x512x512 volume, with times;
  (g) that full-width 3D forward with seeded random weights, kernel path
      vs plain path;
  (h) StarDist3D(None, "3D_demo", "models/examples").predict_instances on
      the benchmark's synthetic 3D nuclei field, 64x256x256, on the card:
      stage times, counts, AP@0.1 against the field's ground truth, the
      conv3d launch count; then a 32x96x96 crop on the card against the
      same call on the CPU;
  (i) raster kernel vs its plain version on two seeded polygon fields (the
      4096^2 bench-shaped field, ~7k polygons, and a dense 2048^2 field of
      60k overlapping ones): labels must be exactly equal; times of the
      kernel, the plain version and the atan2 splat (the CUDA raster before
      the kernel), by CUDA events;
  (j) StarDist2D.predict_instances_device (2D_demo, 2048^2): labels and
      survivors must equal predict_instances on the card exactly, for a
      numpy and a pre-staged CUDA tensor input; walls with fetch=True and
      fetch=False, stage times, the host syncs of one call
      (torch.cuda.set_sync_debug_mode) and the kernels' launch counts; then
      the median walls of 5 rounds of predict_instances and the device path
      (fetch=True, fetch=False) called in turn;
  (k) tiled predict_instances (2D_demo) on the 4096^2 synthetic field,
      n_tiles=(2, 2) against (1, 1): matching accuracy >= 0.99, walls (and
      their medians over 3 rounds in turn), launch counts, and where the
      two differ: the differing pixels and survivors, in all and within
      the tiles' overlap band around a seam, and the dense prediction's
      largest differences, tiled against untiled.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.

Imports torch, numpy, scipy and stardist_torch only (never JAX).
"""
import ctypes
import json
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
TILED_SIZE = 4096                # (k)


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
    name -> "median (min-max) ms"."""
    walls = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    return {name: f"{np.median(w):.1f} ({min(w):.1f}-{max(w):.1f}) ms"
            for name, w in walls.items()}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def conv_layers_vs_plain(net, x, dev, kernel_fn, plain_fn):
    """Kernel vs plain at every conv layer shape of ``net``'s forward on x
    (shapes found with forward hooks): checks each, times each. Returns
    (max abs err, forward convs ms kernel, ms plain, per-shape strings)."""
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
    err, ms, plain_ms, rows = 0.0, 0.0, 0.0, []
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
        t_k = cuda_ms(lambda: kernel_fn(xs, mod.weight, mod.bias, act))
        t_p = cuda_ms(lambda: plain_fn(xs, mod.weight, mod.bias, act))
        err = max(err, e)
        ms += count * t_k
        plain_ms += count * t_p
        rows.append("x".join(map(str, shape[:-1])) + f":{shape[-1]}->{Cout}x{count} "
                    f"{t_k:.3f}/{t_p:.3f}ms")
        del xs
    return err, ms, plain_ms, rows


def phase_b(net, dev, conv):
    """Conv kernel vs plain at the full-width forward's layer shapes."""
    x = torch.rand(FWD_SIZE, FWD_SIZE, 1, device=dev)
    err, ms, plain_ms, rows = conv_layers_vs_plain(net, x, dev, conv.conv3x3_hwc,
                                                   conv.conv3x3_hwc_plain)
    print(f"(b) conv kernel vs plain: {len(rows)} layer shapes ok, max_abs_err {err:.3e}, "
          f"full-width forward convs {ms:.2f} ms kernel / {plain_ms:.2f} ms plain; "
          + "; ".join(rows), flush=True)
    return err, ms, plain_ms


def random_pairs(P, R, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    d_r = torch.rand(P, R, device=dev, generator=g) * 8 + 4
    d_c = torch.rand(P, R, device=dev, generator=g) * 8 + 4
    p_r = torch.rand(P, 2, device=dev, generator=g) * 100
    p_c = p_r + torch.randn(P, 2, device=dev, generator=g) * 6
    lo = torch.maximum(p_r - d_r.amax(1, keepdim=True), p_c - d_c.amax(1, keepdim=True))
    hi = torch.minimum(p_r + d_r.amax(1, keepdim=True), p_c + d_c.amax(1, keepdim=True))
    return d_r, p_r, d_c, p_c, lo, (hi - lo).clamp_min(0.0)


def phase_c(dev, po):
    args = random_pairs(N_PAIRS, 32, dev, 7)
    out = {}
    for S in (8, 16):
        got = po.pair_frac(*args, S=S)
        ref = po.pair_frac_plain(*args, S=S)
        torch.cuda.synchronize()
        n_diff = int((got != ref).sum().item())
        check(n_diff == 0, f"pair kernel differs from plain on {n_diff} pairs at S={S}")
        out[S] = (cuda_ms(lambda: po.pair_frac(*args, S=S)),
                  cuda_ms(lambda: po.pair_frac_plain(*args, S=S), iters=1),
                  float(got.mean().item()), (got - ref).abs().max().item())
    print(f"(c) pair kernel vs plain on {N_PAIRS} pairs: exact at S=8 and S=16; "
          + "; ".join(f"S={S}: {k:.3f} ms kernel / {p:.1f} ms plain, mean frac {m:.4f}"
                      for S, (k, p, m, _) in out.items()), flush=True)
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


def phase_e(dev, kernels, matching, StarDist2D):
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
    print(f"(e) predict_instances {E2E_SIZE}^2 on the card: wall {wall * 1e3:.1f} ms = forward "
          f"{t['forward'] * 1e3:.1f} + extract {t['extract'] * 1e3:.1f} + nms "
          f"{t['nms'] * 1e3:.1f} + raster {t['raster'] * 1e3:.1f} ms (+ host setup); "
          f"{c['n_candidates']} candidates, {c['n_pairs']} bbox pairs, {c['n_eval_pairs']} "
          f"exact pairs in {c['n_rounds']} rounds, {len(details['prob'])} objects "
          f"({int(lbl.max())} true), AP@0.5 {ap:.4f}; launches {launches}", flush=True)

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
    err, ms, plain_ms, rows = conv_layers_vs_plain(net3, x, dev, conv.conv3x3x3_dhwc,
                                                   conv.conv3x3x3_dhwc_plain)
    print(f"(f) conv3d kernel vs plain: {len(rows)} layer shapes ok, max_abs_err {err:.3e}, "
          f"full-width 3D forward convs {ms:.2f} ms kernel / {plain_ms:.2f} ms plain "
          f"(per shape kernel/plain); " + "; ".join(rows), flush=True)
    return err, ms, plain_ms


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


def phase_i(dev, rt, splat):
    """Raster kernel vs its plain version (exact) and the atan2 splat."""
    out = []
    for k, (size, n) in enumerate(RASTER_FIELDS):
        d, p, o, lab = (torch.from_numpy(np.asarray(a)).to(dev)
                        for a in polygon_field(n, size, seed=11 + k))
        shape = (size, size)
        got = rt.rasterize_polygons_tiles_cuda(d, p, shape, o, lab)
        ref = rt.rasterize_polygons_tiles_plain(d, p, shape, o, lab)
        spl = splat(d, p, shape, o, lab)
        torch.cuda.synchronize()
        n_diff = int((got != ref).sum().item())
        err = int((got.long() - ref.long()).abs().max().item())
        check(n_diff == 0, f"raster kernel differs from plain on {n_diff} pixels ({n} polygons)")
        n_splat = int((got != spl).sum().item())
        fg = int((got > 0).sum().item())
        del ref, spl
        # the kernel alone: inputs set up once, the memset and one launch per run
        feats, pts, origin, packed, window = rt._setup(d, p, shape, o, lab)
        trig = rt._tables(d.shape[1], d.device)[1]
        img = torch.empty(size * size, dtype=torch.int64, device=dev)

        def kernel_only():
            img.zero_()
            rt.KERNEL.launch(*(ctypes.c_void_p(t.data_ptr())
                               for t in (feats, pts, origin, packed, trig, img)),
                             n, d.shape[1], size, size, window, rt.stream_ptr(dev))

        t_kern = cuda_ms(kernel_only, iters=10)
        t_call = cuda_ms(lambda: rt.rasterize_polygons_tiles_cuda(d, p, shape, o, lab), iters=10)
        t_plain = cuda_ms(lambda: rt.rasterize_polygons_tiles_plain(d, p, shape, o, lab), iters=1)
        t_splat = cuda_ms(lambda: splat(d, p, shape, o, lab), iters=1)
        out.append(dict(size=size, n=n, n_diff=n_diff, err=err, ms=t_call, kernel_ms=t_kern,
                        plain_ms=t_plain, splat_ms=t_splat))
        print(f"(i) raster {size}^2, {n} polygons (window {window}, {fg} foreground pixels): "
              f"kernel == plain ({n_diff} differing pixels; {n_splat} differ from the atan2 "
              f"splat); call {t_call:.3f} ms (kernel + memset alone {t_kern:.3f} ms), plain "
              f"{t_plain:.2f} ms, atan2 splat {t_splat:.2f} ms", flush=True)
        del feats, pts, origin, packed, img, got
    return out


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
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model.predict_instances_device(x_dev, fetch=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n_sync = sum("synchroniz" in str(w.message).lower() for w in caught)
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


def phase_k(dev, kernels, matching, StarDist2D):
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
    print(f"(k) predict_instances {TILED_SIZE}^2 on the card, n_tiles=(2, 2) vs (1, 1): "
          f"matching accuracy {acc:.4f}, labels equal: {np.array_equal(lab1, lab2)} "
          f"({n_diff} pixels differ), objects {len(det2['prob'])} / {len(det1['prob'])} "
          f"({int(lbl.max())} true), tiled AP@0.5 {ap:.4f}; wall tiled {wall2 * 1e3:.1f} ms, "
          f"untiled {wall1 * 1e3:.1f} ms; tile overlap {model._axes_tile_overlap('YX')}; "
          f"{seams}; "
          f"launches (tiled call) {launches}; 3 rounds of warm calls in turn, median "
          f"(min-max): {walls}", flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from stardist_torch.matching import matching
    from stardist_torch.models import Config2D, Config3D, StarDist2D, StarDist3D
    from stardist_torch.models.unet import StarDistNet
    from stardist_torch.ops import conv, pair_overlap as po, raster_tiles as rt
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
    builds = (conv.KERNEL, po.KERNEL, conv.KERNEL3D, rt.KERNEL)
    with ThreadPoolExecutor(len(builds)) as pool:      # one nvcc per source, all at once
        list(pool.map(lambda k: k.build(), builds))
    print(f"(a) {torch.cuda.get_device_name(0)} [{smi}]; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; kernels built in {time.perf_counter() - t0:.1f} s "
          f"(conv {conv.KERNEL.build_seconds:.1f} s, pair {po.KERNEL.build_seconds:.1f} s, "
          f"conv3d {conv.KERNEL3D.build_seconds:.1f} s, raster "
          f"{rt.KERNEL.build_seconds:.1f} s)", flush=True)

    net = StarDistNet(Config2D(grid=(2, 2)), dtype=torch.bfloat16)
    net.init_weights(torch.Generator().manual_seed(0))
    net.to(dev)
    conv_err, conv_ms, conv_plain_ms = phase_b(net, dev, conv)
    pair = phase_c(dev, po)
    phase_d(net, dev)
    launches = phase_e(dev, kernels, matching, StarDist2D)
    del net
    torch.cuda.empty_cache()

    net3 = StarDistNet(Config3D(grid=(1, 2, 2)), dtype=torch.bfloat16)
    net3.init_weights(torch.Generator().manual_seed(0))
    net3.to(dev)
    conv3d_err, conv3d_ms, conv3d_plain_ms = phase_f(net3, dev, conv)
    phase_g(net3, dev)
    del net3
    torch.cuda.empty_cache()
    launches["conv3d"] = phase_h(dev, conv, matching, StarDist3D)
    torch.cuda.empty_cache()

    raster = phase_i(dev, rt, rasterize_polygons_splat)
    phase_j(dev, kernels, StarDist2D)
    phase_k(dev, kernels, matching, StarDist2D)

    record = {"kernels": [
        {"name": "conv3x3_bf16_hwc", "route": "cuda",
         "source": "stardist_torch/csrc/conv3x3.cu",
         "replaces": "stardist_tpu/ops/conv_pallas.py:393",
         "launches": launches["conv"], "max_abs_err": conv_err,
         "ms": conv_ms, "plain_ms": conv_plain_ms},
        {"name": "pair_frac_f32", "route": "cuda",
         "source": "stardist_torch/csrc/pair_overlap.cu",
         "replaces": "stardist_tpu/ops/pair_overlap.py:82",
         "launches": launches["pair"], "max_abs_err": max(pair[8][3], pair[16][3]),
         "ms": pair[16][0], "plain_ms": pair[16][1]},
        {"name": "conv3x3x3_bf16_dhwc", "route": "cuda",
         "source": "stardist_torch/csrc/conv3x3x3.cu",
         "replaces": "stardist_tpu/ops/conv_pallas.py:574",
         "launches": launches["conv3d"], "max_abs_err": conv3d_err,
         "ms": conv3d_ms, "plain_ms": conv3d_plain_ms},
        {"name": "raster_tiles_i64", "route": "cuda",
         "source": "stardist_torch/csrc/raster_tiles.cu",
         "replaces": "stardist_tpu/ops/raster_pallas.py:80",
         "launches": launches["raster"], "max_abs_err": max(r["err"] for r in raster),
         "mismatched_pixels": sum(r["n_diff"] for r in raster),
         "ms": raster[0]["ms"], "plain_ms": raster[0]["plain_ms"]},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
