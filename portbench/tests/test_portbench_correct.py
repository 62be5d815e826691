"""``correct`` on the CPU at small sizes: the program's plain versions pass
with every cell's limits, the control (the reference in the program's
place, in fp8) fails, and so does each fault planted in the timed path; a
cell added as files only runs, traced and untraced."""
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from portbench import manifest
from portbench.reference.pipeline import Reference

sys.path.insert(0, str(manifest.HERE))
import run  # noqa: E402

SMALL = {"2D_demo.fields_4096": [256, 256], "2D_demo.device_2048": [256, 256],
         "3D_demo.volume_64x256x256": [32, 96, 96]}


def small_mix(cell):
    man = manifest.load(manifest.HERE.parent)
    mix = manifest.traffic(manifest.workload(man, cell)["traffic"])
    return dict(mix, shape=SMALL[cell], items=2, warmup=1, checked=2)


def run_cpu(cell, seed=2147483659, seconds=0.5):
    torch.set_num_threads(4)
    a = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds)])
    return run.run(a, "cpu", mix=small_mix(cell))


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    out = run_cpu(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", ["2D_demo.fields_4096", "3D_demo.volume_64x256x256"])
def test_control_fails(cell):
    man = manifest.load(manifest.HERE.parent)
    w = manifest.workload(man, cell)
    _, model_dir = manifest.config(man, w["config"], manifest.HERE.parent)
    lim = manifest.limits(cell)
    mix = small_mix(cell)
    ref = Reference(model_dir, "cpu")
    ctl = Reference(model_dir, "cpu", precision="fp8")
    img = run.make_inputs(mix, 7)[0]
    maps = ref.maps(img)
    got = ref.judge(img, ctl.instances(img), maps)
    assert any(got[k] > lim[k] for k in got), got


def altered_labels(labels, det):
    """One object's label taken over by its neighbour in the list."""
    labels = labels.copy()
    labels[labels == 1] = 2
    return labels, det


def half_left_out(labels, det):
    """Every second survivor dropped from the answer and its label image."""
    labels = labels.copy()
    n = len(det["prob"])
    for k in range(1, n, 2):
        labels[labels == k + 1] = 0
    det = dict(det, **{key: np.asarray(det[key])[0::2] for key in ("dist", "points", "prob")})
    return labels, det


def shifted_dist(labels, det):
    """The survivors' distances altered where they are produced."""
    return labels, dict(det, dist=np.asarray(det["dist"]) * 1.25)


@pytest.mark.parametrize("fault", [altered_labels, half_left_out, shifted_dist])
def test_faults_fail(monkeypatch, fault):
    from stardist_torch.models import StarDist2D
    orig = StarDist2D.predict_instances

    def broken(self, *args, **kwargs):
        labels, det = orig(self, *args, **kwargs)
        return fault(labels, det)
    monkeypatch.setattr(StarDist2D, "predict_instances", broken)
    out = run_cpu("2D_demo.fields_4096")
    assert not out["correct"], out["checks"]


def test_answer_of_other_input_fails(monkeypatch):
    """A call that answers for another input (its image turned upside down)."""
    from stardist_torch.models import StarDist2D
    orig = StarDist2D.predict_instances

    def other(self, img, *args, **kwargs):
        return orig(self, np.ascontiguousarray(img[::-1]), *args, **kwargs)
    monkeypatch.setattr(StarDist2D, "predict_instances", other)
    out = run_cpu("2D_demo.fields_4096")
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SMALL))
def test_cell_on_the_card(cuda_device, cell):
    """A short run of each cell at its own size on the card."""
    out = run.run(run.parse(["--workload", cell, "--seed", "5", "--seconds", "2"]), "cuda")
    assert out["correct"], out["checks"]


def test_a_cell_added_as_files_runs(tmp_path):
    """A tiled cell, added to a copy of the benchmark as a traffic mix (the
    entry's ``n_tiles`` among its ``kwargs``), its limits and manifest
    entries, with no file of the copy edited, runs and is judged, and
    reports its end-to-end and per-layer metrics."""
    root = manifest.HERE.parent
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = manifest.load(root)
    name = "2D_demo.tiled_small"
    man["workloads"].append(dict(name=name, config="2D_demo", traffic="tiled_small", chips=1,
                                 why="2x2 tiles"))
    for m in man["end_to_end"] + man["per_layer"]:
        if "2D_demo.fields_4096" in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    mix = dict(manifest.traffic("fields_4096"), kwargs={"n_tiles": [2, 2]}, shape=[256, 256],
               items=2, warmup=1, checked=2)
    (tmp_path / "portbench" / "traffic" / "tiled_small.json").write_text(json.dumps(mix))
    shutil.copy(manifest.HERE / "limits" / "2D_demo.fields_4096.json",
                tmp_path / "portbench" / "limits" / f"{name}.json")
    torch.set_num_threads(4)
    for trace, group, present in ((0, manifest.end_to_end, {"mpix_s", "setup_s"}),
                                  (1, manifest.per_layer, {"forward_ms.2d", "nms_ms.2d",
                                                           "raster_ms.2d", "mfu.2d"})):
        a = run.parse(["--workload", name, "--seed", "2147483701", "--seconds", "0.6",
                       "--trace", str(trace)])
        out = run.run(a, "cpu", root=tmp_path)
        assert out["correct"], out["checks"]
        assert present <= set(out["metrics"]) <= {m["name"] for m in group(man, name)}
        # the CPU makes no CUDA sync, so the NMS's sync count and wait read 0 there
        syncs = {"nms_syncs.2d", "nms_sync_ms.2d"}
        assert all(v["value"] == 0 if k in syncs else v["value"] > 0
                   for k, v in out["metrics"].items()), out["metrics"]
