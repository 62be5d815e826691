"""Readings that the limits of ``portbench/limits/<workload>.json`` are set
from, on the card at the cell's own size:

    python3 portbench/control.py --workload <name> --seeds 1,2,... --control-seeds 7,8,9

For each of ``--seeds`` the cell's inputs are made, the program's entry is
called once on each and the reference judges every output, as a run judges
its sample. For each of ``--control-seeds`` the control, the reference run
in fp8 in the program's place, is judged the same way. One JSON line per
reading; the runs of the benchmark never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "portbench"))
    import torch
    import run
    from portbench import manifest
    from portbench.reference.pipeline import Reference
    from stardist_torch.models import StarDist2D, StarDist3D
    run.cache_dirs(ROOT)
    man = manifest.load(ROOT)
    cell = manifest.workload(man, a.workload)
    _, model_dir = manifest.config(man, cell["config"], ROOT)
    mix = manifest.traffic(cell["traffic"])
    seeds = [int(s) for s in a.seeds.split(",") if s]
    control_seeds = [int(s) for s in a.control_seeds.split(",") if s]
    cfg = json.loads((model_dir / "config.json").read_text())
    Model = StarDist2D if int(cfg["n_dim"]) == 2 else StarDist3D
    model = Model(None, model_dir.name, str(model_dir.parent), device="cuda")
    ref = Reference(model_dir, "cuda")
    ctl = Reference(model_dir, "cuda", precision="fp8")
    for seed in seeds + control_seeds:
        inputs = run.make_inputs(mix, seed)
        side = "program" if seed in seeds else "control"
        if side == "program":
            call = run.entry(model, mix, inputs)
            call(0)
            outs = []
            for k in range(len(inputs)):
                labels, det = call(k)[2]
                if isinstance(labels, torch.Tensor):
                    labels = labels.to(torch.int32)
                outs.append(dict(labels=labels, dist=det["dist"], points=det["points"],
                                 prob=det["prob"]))
            torch.cuda.synchronize()
        for k, img in enumerate(inputs):
            t0 = time.perf_counter()
            maps = ref.maps(img)
            whole = ref.instances(img, maps)
            torch.cuda.synchronize()
            t_ref = time.perf_counter() - t0
            out = outs[k] if side == "program" else ctl.instances(img)
            got = ref.judge(img, out, maps, whole)
            print(json.dumps(dict(side=side, seed=seed, item=k, reference_s=round(t_ref, 3),
                                  survivors=len(out["prob"]), **got)), flush=True)
            del maps, whole, out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
