"""Train the model of upstream StarDist's 3D training notebook
(examples/3D/2_training.ipynb) with stardist_torch, from seeded synthetic
volumes, and set its thresholds as the notebook does:

    python3 examples/train_3d_notebook.py --out <folder> [--device cuda]

The configuration is the notebook's: ``Config3D(rays=Rays_GoldenSpiral(96,
anisotropy), grid=(1, 2, 2), anisotropy=(2, 1, 1), backbone="resnet",
train_patch_size=(48, 96, 96), train_batch_size=2)``, every other key at
its default. The notebook computes the anisotropy from its data's median
object extents; here the data are ``synthetic_nuclei_3d_aniso`` volumes
(64x256x256, density 2.5e-4, radii 4-7, anisotropy (2, 1, 1)), sixteen to
train on and four to validate, drawn from fixed seeds, so the anisotropy
is the generator's. ``StarDist3D.train`` runs ``--steps`` steps an epoch
(``SEED`` fixes numpy's sampling) in stages of ``--stage`` epochs, each
resuming the last, up to ``--epochs``; it stops after a stage whose best
validation loss is less than ``MIN_GAIN`` (relative) below the best
before it. Then ``optimize_thresholds`` on the validation volumes writes
``thresholds.json``. The model folder ``<out>/3D_notebook`` receives
``config.json``, ``weights_best.h5`` (the best validation loss) and
``thresholds.json``; ``<out>/train_log.json`` the epochs' losses, the
stages' times and the thresholds. The training's own files (logs, other
checkpoints, the resume state) stay in ``<work>``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
NAME = "3D_notebook"
SHAPE = (64, 256, 256)
PARAMS = dict(density=2.5e-4, r_range=(4, 7), anisotropy=(2, 1, 1))
TRAIN_SEEDS = range(3100, 3116)
VAL_SEEDS = range(3200, 3204)
KEEP = ("config.json", "weights_best.h5", "thresholds.json")
SEED = 31
MIN_GAIN = 0.01     # a stage that gains less than this is the last


def notebook_config():
    """The notebook's Config3D at the generator's anisotropy."""
    from stardist_torch.models import Config3D
    from stardist_torch.rays3d import Rays_GoldenSpiral
    anisotropy = tuple(PARAMS["anisotropy"])
    return Config3D(rays=Rays_GoldenSpiral(96, anisotropy=anisotropy), grid=(1, 2, 2),
                    anisotropy=anisotropy, backbone="resnet", train_patch_size=(48, 96, 96),
                    train_batch_size=2)


def volumes(seeds, shape):
    from portbench.frozen import synthetic_nuclei_3d_aniso
    pairs = [synthetic_nuclei_3d_aniso(shape, seed=s, **PARAMS) for s in seeds]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="folder for the model folder and the log")
    p.add_argument("--work", default="build/train_3d_notebook",
                   help="folder for the training's own files")
    p.add_argument("--device", default="cuda")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--stage", type=int, default=10)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--shape", default="x".join(map(str, SHAPE)),
                   help="volume shape DxHxW (smaller for a trial)")
    p.add_argument("--n-train", type=int, default=len(TRAIN_SEEDS))
    return p.parse_args(argv)


def main(argv=None):
    a = parse(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from stardist_torch.models import StarDist3D
    shape = tuple(int(s) for s in a.shape.split("x"))
    t0 = time.perf_counter()
    X, Y = volumes(list(TRAIN_SEEDS)[:a.n_train], shape)
    Xv, Yv = volumes(VAL_SEEDS, shape)
    print(f"{len(X)} + {len(Xv)} volumes of {'x'.join(map(str, shape))}, "
          f"{sum(int(y.max()) for y in Y)} + {sum(int(y.max()) for y in Yv)} nuclei, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    work = Path(a.work)
    shutil.rmtree(work / NAME, ignore_errors=True)
    model = StarDist3D(notebook_config(), NAME, str(work), device=a.device)
    stages, best, epochs = [], np.inf, 0
    while epochs < a.epochs:
        epochs = min(epochs + a.stage, a.epochs)
        t0 = time.perf_counter()
        hist = model.train(X, Y, validation_data=(Xv, Yv), seed=SEED, epochs=epochs,
                           steps_per_epoch=a.steps, resume=epochs > a.stage)
        if a.device != "cpu":
            torch.cuda.synchronize()
        val = hist.history["val_loss"]
        stage_best = min(val[epochs - min(a.stage, epochs):])
        stages.append(dict(epochs=epochs, seconds=round(time.perf_counter() - t0, 1),
                           best_val_loss=stage_best))
        print(f"epochs {epochs}: val_loss " + ", ".join(f"{v:.4f}" for v in val[-a.stage:])
              + f"; {stages[-1]['seconds']} s", flush=True)
        flat = stage_best > best * (1 - MIN_GAIN)
        best = min(best, stage_best)
        if flat:
            break

    served = StarDist3D(None, NAME, str(work), device=a.device)
    t0 = time.perf_counter()
    thresholds = served.optimize_thresholds(Xv, Yv)
    t_thr = time.perf_counter() - t0
    out = Path(a.out)
    (out / NAME).mkdir(parents=True, exist_ok=True)
    for f in KEEP:
        shutil.copy(work / NAME / f, out / NAME / f)
    log = dict(history=hist.history, stages=stages, thresholds=thresholds,
               thresholds_s=round(t_thr, 1), shape=shape, n_train=len(X), n_val=len(Xv),
               steps_per_epoch=a.steps, seed=SEED,
               device=torch.cuda.get_device_name(0) if a.device != "cpu" else "cpu")
    (out / "train_log.json").write_text(json.dumps(log, indent=1))
    print(f"thresholds {thresholds} ({t_thr:.1f} s); {', '.join(KEEP)} in {out / NAME}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
