"""Smoke run of stardist_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failed check exits non-zero):
  (a) the card's name and power limit; build both CUDA kernels from
      stardist_torch/csrc and time the build;
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
      launch counts of both kernels; then 1024^2 on the card against the
      same call on the CPU.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.

Imports torch, numpy, scipy and stardist_torch only (never JAX).
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

CONV_TOL = 1e-2      # relative to max(1, |ref|max): bf16 outputs, f32 sums in another order
FWD_TOL = 2e-2       # prob absolute, dist relative to max(1, |dist|max)
FWD_SIZE = 4096      # full-width forward input, (b) and (d)
E2E_SIZE = 2048      # predict_instances field on the card, (e)
CMP_SIZE = 1024      # card vs CPU comparison field, (e)
N_PAIRS = 100_000    # (c)


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


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_b(net, dev, conv):
    """Conv kernel vs plain at the full-width forward's layer shapes."""
    shapes = {}

    def hook(mod, args, out):
        h = args[0]
        key = (tuple(h.shape), mod.weight.shape[-1], mod.act)
        shapes.setdefault(key, [mod, 0])[1] += 1

    hooks = [blk.register_forward_hook(hook) for blk in net.conv_blocks()]
    x = torch.rand(FWD_SIZE, FWD_SIZE, 1, device=dev)
    net(x)
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    g = torch.Generator(device=dev).manual_seed(1)
    err, ms, plain_ms, rows = 0.0, 0.0, 0.0, []
    for ((H, W, C), Cout, act), (mod, count) in shapes.items():
        xs = torch.rand(H, W, C, device=dev, generator=g).to(torch.bfloat16)
        y = conv.conv3x3_hwc(xs, mod.weight, mod.bias, act)
        ref = conv.conv3x3_hwc_plain(xs, mod.weight, mod.bias, act)
        torch.cuda.synchronize()
        scale = max(1.0, ref.float().abs().max().item())
        e = (y.float() - ref.float()).abs().max().item()
        check(e / scale < CONV_TOL,
              f"conv kernel disagrees at {(H, W, C, Cout)}: {e} (scale {scale})")
        t_k = cuda_ms(lambda: conv.conv3x3_hwc(xs, mod.weight, mod.bias, act))
        t_p = cuda_ms(lambda: conv.conv3x3_hwc_plain(xs, mod.weight, mod.bias, act))
        err = max(err, e)
        ms += count * t_k
        plain_ms += count * t_p
        rows.append(f"{H}x{W}:{C}->{Cout}x{count} {t_k:.3f}/{t_p:.3f}ms")
        del xs, y, ref
    print(f"(b) conv kernel vs plain: {len(shapes)} layer shapes ok, max_abs_err {err:.3e}, "
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


def phase_e(dev, conv, po, matching, StarDist2D):
    model = StarDist2D(None, "2D_demo", "models/examples", device=dev)
    img, lbl = synthetic_nuclei((E2E_SIZE, E2E_SIZE), seed=123)
    model.predict_instances(img)                       # warm-up: allocator, caches
    torch.cuda.synchronize()
    conv.KERNEL.launches = 0
    po.KERNEL.launches = 0
    t0 = time.perf_counter()
    labels, details = model.predict_instances(img)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"conv": conv.KERNEL.launches, "pair": po.KERNEL.launches}
    n_conv = len(model.net.conv_blocks())
    check(launches["conv"] == n_conv,
          f"conv launches {launches['conv']} != {n_conv} convs x 1 call")
    check(launches["pair"] > 0, "the NMS launched no pair kernel")
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from stardist_torch.matching import matching
    from stardist_torch.models import Config2D, StarDist2D
    from stardist_torch.models.unet import StarDistNet
    from stardist_torch.ops import conv, pair_overlap as po

    torch.backends.cudnn.allow_tf32 = False        # plain convs in full f32
    torch.backends.cuda.matmul.allow_tf32 = False  # the head in full f32
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    conv.KERNEL.build()
    po.KERNEL.build()
    print(f"(a) {torch.cuda.get_device_name(0)} [{smi}]; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; kernels built in {time.perf_counter() - t0:.1f} s "
          f"(conv {conv.KERNEL.build_seconds:.1f} s, pair {po.KERNEL.build_seconds:.1f} s)",
          flush=True)

    net = StarDistNet(Config2D(grid=(2, 2)), dtype=torch.bfloat16)
    net.init_weights(torch.Generator().manual_seed(0))
    net.to(dev)
    conv_err, conv_ms, conv_plain_ms = phase_b(net, dev, conv)
    pair = phase_c(dev, po)
    phase_d(net, dev)
    launches = phase_e(dev, conv, po, matching, StarDist2D)

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
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
