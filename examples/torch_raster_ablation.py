"""What each design point of the CUDA raster kernel (stardist_torch/csrc/
raster_tiles.cu) buys, on one CUDA card:

    python3 examples/torch_raster_ablation.py [--parent DIR]

Builds the kernel as it is and four variants, each made by replacing one
piece of its source text: "walk" (every pixel walks all R wedges: no
lookup), "window" (every polygon tests its whole splat window: no box),
"no_atomic" (the inside test runs, but no pixel is written: what the
atomics cost), "preread" (an inside pixel is read first, and takes its
atomicMax only when that can win). Times kernel + memset of each (32-bit
packing) on chip_smoke's raster fields by CUDA events, the variants in
turns, twice, and checks that the variants that draw give the plain twin's
labels. With ``--parent DIR`` (the parent commit of the port unpacked with
git archive, whose raster kernel is the earlier design: one block per
polygon, a walk over every wedge, a 64-bit image) its kernel + memset and
its whole call are timed in the same turns, beside this tree's call.
Imports torch, numpy and stardist_torch only.
"""
import argparse
import ctypes
import importlib
import importlib.util
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from stardist_torch.ops import cuda_build, raster_tiles as rt  # noqa: E402

ATOMIC = "if (inside(ur, uc, tab, edge, cc, R, rscale)) atomicMax(img + (size_t)row * W + col, v);"
VARIANTS = {
    "kernel": [],
    "walk": [("  if (ur == 0.0f && uc == 0.0f) return true;\n",
              "  if (ur == 0.0f && uc == 0.0f) return true;\n"
              "  return inside_walk(ur, uc, tab, edge, cc, R);\n")],
    "window": [("    if (ok) {\n", "    if (false && ok) {\n")],
    "no_atomic": [(ATOMIC, "if (inside(ur, uc, tab, edge, cc, R, rscale) && v == (T)0) "
                           "img[(size_t)row * W + col] = v;")],
    "preread": [(ATOMIC, "if (inside(ur, uc, tab, edge, cc, R, rscale)) { T* q = img + "
                         "(size_t)row * W + col; if (*q < v) atomicMax(q, v); }")],
}


def build(name, edits):
    """The variant's library, built from an edited copy of the source in the
    build directory; returns the ctypes function."""
    src = rt.KERNEL.source.read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
        src = src.replace(old, new)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = cuda_build.BUILD_DIR / f"raster_ablation_{name}.cu"
    path.write_text(src)
    out = path.with_suffix(".so")
    subprocess.run([cuda_build.nvcc_path(), *rt.KERNEL.flags, f"-I{cuda_build.CSRC}", "-o",
                    str(out), str(path)], check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(out)), rt.KERNEL.entry)
    fn.argtypes, fn.restype = rt.KERNEL.argtypes, ctypes.c_int
    return fn


def load_parent_raster(parent):
    """The raster module (ops/raster_tiles.py) of another checkout of the
    port, imported under another package name beside this one, its kernel
    built."""
    root = os.path.join(os.path.abspath(parent), "stardist_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_stardist_torch", os.path.join(root, "__init__.py"),
        submodule_search_locations=[root])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pkg
    spec.loader.exec_module(pkg)
    prt = importlib.import_module("parent_stardist_torch.ops.raster_tiles")
    prt.KERNEL.build()
    return prt


def parent_kernel(prt, d, p, shape, o, lab):
    """The earlier design's kernel + memset alone, as its chip_smoke timed
    it: inputs set up once, the int64 memset and one launch per run."""
    feats, pts, origin, packed, window = prt._setup(d, p, shape, o, lab)
    trig = prt._tables(d.shape[1], d.device)[1]
    img = torch.empty(shape[0] * shape[1], dtype=torch.int64, device=d.device)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (feats, pts, origin, packed, trig, img)]

    def run():
        img.zero_()
        prt.KERNEL.launch(*ptrs, d.shape[0], d.shape[1], *shape, window,
                          prt.stream_ptr(d.device))
    run.keep = (feats, pts, origin, packed, trig, img)
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit, timed in the same turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_raster_ablation: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    fns = {name: build(name, edits) for name, edits in VARIANTS.items()}
    prt = load_parent_raster(args.parent) if args.parent else None
    for name, shape, *arrays in chip_smoke.raster_fields():
        d, p, o, lab = (torch.from_numpy(np.asarray(a)).to(dev) for a in arrays)
        inputs = rt.kernel_inputs(d, p, o, lab)
        tabs = rt._tables(d.shape[1], dev)
        ref = rt.rasterize_polygons_tiles_plain(d, p, shape, o, lab)
        N, R = d.shape

        def launcher(fn):
            def run():
                img = torch.zeros(shape[0] * shape[1], dtype=torch.int32, device=dev)
                ptrs = [ctypes.c_void_p(0 if t is None else t.data_ptr())
                        for t in (*inputs, *tabs, img)]
                err = fn(*ptrs, N, R, *shape, 32, rt.stream_ptr(dev))
                if err:
                    raise RuntimeError(f"CUDA error {err}")
                return img
            return run

        runs = {k: launcher(fn) for k, fn in fns.items()}
        for k, run in runs.items():
            if k != "no_atomic" and not torch.equal(rt.narrow(run(), shape, torch.int32), ref):
                raise AssertionError(f"variant {k} differs from plain on {name}")
        runs["call"] = lambda: rt.rasterize_polygons_tiles_cuda(d, p, shape, o, lab,
                                                                value_bound=N)
        if prt is not None:
            runs["parent"] = parent_kernel(prt, d, p, shape, o, lab)
            runs["parent_call"] = lambda: prt.rasterize_polygons_tiles_cuda(d, p, shape, o, lab)
            if not torch.equal(runs["parent_call"](), ref):
                raise AssertionError(f"the parent differs from plain on {name}")
        times = {k: [] for k in runs}
        for order in (list(runs), list(runs)[::-1]):
            for k in order:
                times[k].append(chip_smoke.cuda_ms(runs[k], iters=10))
        print(f"{name}: kernel + memset (the call where named), ms, two turns: "
              + "; ".join(f"{k} {'/'.join(f'{t:.4f}' for t in v)}" for k, v in times.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
