"""The benchmark of stardist_torch on one CUDA card, one cell a run.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a model folder under ``portbench/configs`` and a traffic mix
``portbench/traffic/<mix>.json``, which the harness reads as data: the
model's method called (``entry``) and its keyword arguments (``kwargs``),
whether the inputs are staged on the card in set-up (``staged``), the
generator of the inputs, their shape and parameters, their count
(``items``), the warm-up calls and the outputs judged (``checked``). The
inputs are made from ``--seed`` in set-up. Set-up loads the model, makes
the inputs and warms up; the window then calls the entry in a closed loop
for ``--seconds`` (``window.py``). Every metric, end to end or per layer, is
read by ``portbench/metrics/<name>.py`` from the window's calls: with
``--trace 0`` the cell's end-to-end metrics; with ``--trace 1`` its
per-layer ones, the stage times and rates from the window's first
two thirds, untraced, and the device's from a torch.profiler trace of its
last third.

Once the window has closed, the plain reference (``portbench/reference``)
judges a sample of the window's outputs, drawn from the seed, against the
limits in ``portbench/limits/<workload>.json``. The last line of standard
output is the result, as JSON; the numbers compared come last in it and
on the last lines of standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "stardist_tpu")
SMI_QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"
TRACED_SHARE = 1 / 3        # of a --trace 1 window, its last part, profiled


def process_age():
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def banned_modules():
    """Top-level names of loaded modules that the run may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def cache_dirs(root):
    """Build and kernel caches inside the checkout, at fixed paths."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


class Smi:
    """nvidia-smi sampling the card's clocks and power once a second."""

    def __init__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader,nounits",
                 "-i", "0", "-lms", "1000"], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self):
        if self.proc is None:
            return "nvidia-smi: not run"
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = [[float(v) for v in line.split(",")] for line in out.splitlines()
                if line.count(",") == 3 and "N/A" not in line]
        if not rows:
            return "nvidia-smi: no samples"
        cols = list(zip(*rows))
        return (f"nvidia-smi ({len(rows)} samples): sm clock {min(cols[0]):.0f}-"
                f"{max(cols[0]):.0f} MHz, power {min(cols[1]):.1f}-{max(cols[1]):.1f} W, "
                f"limit {cols[2][0]:.2f} W, {min(cols[3]):.0f}-{max(cols[3]):.0f} C")


def make_inputs(mix, seed):
    """The mix's inputs, item k drawn from (seed, k)."""
    from portbench import frozen
    gen = {"synthetic_nuclei": frozen.synthetic_nuclei,
           "synthetic_nuclei_3d": frozen.synthetic_nuclei_3d,
           "synthetic_nuclei_3d_aniso": frozen.synthetic_nuclei_3d_aniso}[mix["generator"]]
    params = {k: tuple(v) if isinstance(v, list) else v for k, v in mix["params"].items()}
    out = []
    for k in range(int(mix["items"])):
        s = int(np.random.SeedSequence([seed % 2 ** 64, k]).generate_state(1)[0] >> 1)
        out.append(gen(tuple(mix["shape"]), seed=s, **params)[0])
    return out


def entry(model, mix, inputs):
    """call(item) -> (survivors, stage timings, output) of the mix's entry:
    the model's method ``mix["entry"]`` on input ``item`` (a tensor on the
    model's device where the mix has ``staged``), with ``mix["kwargs"]``
    (lists as tuples); it returns (labels, details)."""
    import torch
    fn = getattr(model, mix["entry"])
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in mix.get("kwargs", {}).items()}
    items = ([torch.from_numpy(x).to(model.device) for x in inputs] if mix.get("staged")
             else inputs)

    def call(k):
        labels, det = fn(items[k], **kwargs)
        return len(det["prob"]), det.get("timings_s", {}), (labels, det)
    return call


def judge(model_dir, inputs, kept, calls, rng, n_checked, device):
    """The numbers compared: the reference's on a seeded sample of the
    inputs (each with a seeded one of its calls' outputs), the widest over
    them, and ``count_spread``, the widest spread of the survivor counts of
    all the window's calls on one input."""
    import torch
    from portbench.reference.pipeline import Reference
    ref = Reference(model_dir, device)
    nums = {}
    for k in sorted(rng.sample(sorted(kept), min(n_checked, len(kept)))):
        labels, det = kept[k]
        if isinstance(labels, torch.Tensor):
            labels = labels.to(torch.int32)
        out = dict(labels=labels, dist=det["dist"], points=det["points"], prob=det["prob"])
        maps = ref.maps(inputs[k])
        got = ref.judge(inputs[k], out, maps, ref.instances(inputs[k], maps))
        print(f"checked item {k}: {json.dumps(got)}", flush=True)
        for name, v in got.items():
            nums[name] = max(nums.get(name, v), v)
        del maps, out
        if device == "cuda":
            torch.cuda.empty_cache()
    counts = {}
    for c in calls:
        if c.n_objects >= 0:
            counts.setdefault(c.item, set()).add(c.n_objects)
    nums["count_spread"] = max((max(v) - min(v) for v in counts.values()), default=0)
    return nums


class Ctx:
    """What a metric's reader reads: the config, the input shape, the set-up
    time, the window's calls that no profiler slowed (``calls``: all of
    them with ``--trace 0``, the first part with ``--trace 1``), the traced
    part's calls and its trace (``traced``, ``trace``: empty and None with
    ``--trace 0``), and the host syncs of one call, counted when read."""

    def __init__(self, cfg, shape, setup_s, calls, traced=(), trace=None, syncs=None):
        from portbench import flops, window
        self.cfg, self.ndim, self.shape = cfg, int(cfg["n_dim"]), tuple(shape)
        self.setup_s, self.calls, self.traced, self.trace = setup_s, calls, list(traced), trace
        self.input_size = int(np.prod(self.shape))
        self.conv_layers = flops.conv_layers(cfg, shape)
        self.flops_per_call = flops.forward_flops(cfg, shape)
        self._window, self._syncs = window, syncs

    @staticmethod
    def done(calls):
        return sum(1 for c in calls if c.n_objects >= 0)

    def rate(self, work_per_call):
        return self._window.rate(self.calls, work_per_call)

    def p95_ms(self):
        return self._window.p95_ms(self.calls)

    def span(self):
        return self._window.span(self.calls)

    def stage_ms(self, stage):
        return self._window.stage_ms(self.calls, stage)

    @functools.cached_property
    def host_syncs(self):
        return None if self._syncs is None else self._syncs()


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    a = parse(argv)
    age0 = process_age() - (time.perf_counter() - T_START)      # at T_START
    cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT))
    from portbench import manifest
    cell = manifest.workload(manifest.load(ROOT), a.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        import stardist_torch  # noqa: F401
    except ImportError as exc:
        print(f"cannot import the program under test: {exc!r}", file=sys.stderr)
        return 4
    out = run(a, "cuda", age0)
    bad = banned_modules()
    if bad:
        print(f"loaded modules the run may not load: {bad}", file=sys.stderr)
        return 5
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def run(a, device, age0=0.0, mix=None, lim=None, root=ROOT):
    """One run of the cell ``a.workload`` on ``device`` ("cuda": the card;
    "cpu": the program's plain versions, for tests), with the manifest and
    the benchmark's files of the checkout ``root``; ``mix`` and ``lim``
    stand in for the cell's traffic mix and limits where given. Returns
    the result dict."""
    import torch
    from portbench import manifest, window
    from stardist_torch.models import StarDist2D, StarDist3D
    here = Path(root) / HERE.name
    man = manifest.load(root)
    cell = manifest.workload(man, a.workload)
    _, model_dir = manifest.config(man, cell["config"], root)
    mix = manifest.traffic(cell["traffic"], here) if mix is None else mix
    lim = manifest.limits(cell["name"], here) if lim is None else lim
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = json.loads((model_dir / "config.json").read_text())
    Model = StarDist2D if int(cfg["n_dim"]) == 2 else StarDist3D
    inputs = make_inputs(mix, a.seed)
    model = Model(None, model_dir.name, str(model_dir.parent), device=device)
    call = entry(model, mix, inputs)
    for k in range(int(mix["warmup"])):
        call(k % len(inputs))
    sync()

    rng = random.Random(a.seed)
    kept = {}

    def keep(i, item, out):
        if item not in kept or rng.random() < 0.5:
            kept[item] = out

    smi = Smi() if on_card else None
    setup_s = age0 + time.perf_counter() - T_START
    calls = window.closed_loop(call, len(inputs), a.seconds * (1 - TRACED_SHARE * a.trace),
                               sync, keep)
    traced, tr = [], None
    if a.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        from portbench.trace import CALL, WINDOW, Trace

        def timed(k):
            with record_function(CALL):
                return call(k)
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
            with record_function(WINDOW):
                traced = window.closed_loop(timed, len(inputs), a.seconds * TRACED_SHARE, sync,
                                            keep, first=len(calls))
    t_window = time.perf_counter()
    if smi is not None:
        print(smi.stop(), file=sys.stderr, flush=True)
    peak = int(torch.cuda.max_memory_allocated(0)) if on_card else 0
    every = calls + traced
    failed = sum(1 for c in every if c.n_objects < 0)
    for part, cs in (("window", calls), ("traced part", traced)):
        per_item = {}
        for c in cs:
            per_item.setdefault(c.item, []).append(c)
        if cs:
            print(f"{part}: {len(cs)} calls, {len(cs) - Ctx.done(cs)} failed, "
                  f"{window.span(cs):.3f} s, {np.mean([c.seconds for c in cs]) * 1e3:.2f} ms a "
                  "call; per item: " + "; ".join(
                      f"{k}: {len(v)} calls, {np.mean([c.seconds for c in v]) * 1e3:.2f} ms, "
                      f"survivors {sorted({c.n_objects for c in v})}"
                      for k, v in sorted(per_item.items())), flush=True)

    device_info = dict(platform="gpu" if on_card else "cpu",
                       kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                       count=int(cell["chips"]), memory_peak_bytes=peak)
    breakdown = None
    syncs = None
    if a.trace:
        tr = Trace.from_profiler(prof)
        del prof
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = dict(device_ops=tr.top_device_ops(), idle_gaps=tr.top_idle())
        print(tr.summary(), flush=True)
        if on_card:
            from portbench import frozen
            syncs = lambda: frozen.host_syncs(lambda: call(0))[0]  # noqa: E731
    ctx = Ctx(cfg, mix["shape"], setup_s, calls, traced, tr, syncs)
    metrics = {}
    group = manifest.per_layer(man, cell["name"]) if a.trace else manifest.end_to_end(
        man, cell["name"])
    for m in group:
        v = manifest.reader(m["name"], here)(ctx)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    del model, call, ctx, tr
    if on_card:
        torch.cuda.empty_cache()
    t_read = time.perf_counter()
    nums = judge(model_dir, inputs, kept, every, rng, int(mix["checked"]), device)
    print(f"seconds: set-up {setup_s:.3f}, window {window.span(calls):.3f}"
          + (f" untraced and {window.span(traced):.3f} traced" if traced else "")
          + f", reading the window {t_read - t_window:.3f}, the reference "
          f"{time.perf_counter() - t_read:.3f}", file=sys.stderr, flush=True)
    checks = {k: dict(value=nums[k], limit=lim[k]) for k in lim}
    correct = failed == 0 and all(v["value"] <= v["limit"] for v in checks.values())
    out = dict(correct=correct, attempted=len(every), failed=failed, metrics=metrics,
               device=device_info)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


if __name__ == "__main__":
    sys.exit(main())
