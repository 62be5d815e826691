"""The committed cell of upstream's 3D notebook model,
``3D_notebook.stack_64x512x512``: its manifest entries parse, its model
folder loads through the program's normal path with 188 faces, its limits
hold every check, its mix's generator makes volumes at the mix's
parameters; and a small cell of the same model, added to a copy of the
benchmark as files and entries, runs on the CPU traced and untraced, is
judged correct, and reads ``raster_inside_ms.3d`` but neither of the
metrics that need the card's trace."""
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from portbench import manifest

sys.path.insert(0, str(manifest.HERE))
import run  # noqa: E402

CELL, CONFIG, MIX = "3D_notebook.stack_64x512x512", "3D_notebook", "stack_64x512x512"
SMALL, SMALL_MIX = "3D_notebook.stack_small", "stack_small"
NEW_METRICS = ("resnet_roofline.3d", "raster_inside_ms.3d", "raster_syncs.3d")
SEED = 3000000019


def test_manifest_entries_parse():
    man = manifest.load(manifest.HERE.parent)
    cfg, model_dir = manifest.config(man, CONFIG, manifest.HERE.parent)
    assert cfg["reduced"] == [] and cfg["source"].startswith("https://github.com/stardist/")
    cell = manifest.workload(man, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, MIX, 1)
    assert [m["name"] for m in manifest.end_to_end(man, CELL)] == ["mvox_s", "setup_s"]
    layers = {m["name"] for m in manifest.per_layer(man, CELL)}
    assert layers == {"forward_ms.3d", "nms_ms.3d", "nms_exact_ms.3d", "raster_ms.3d",
                      "idle_share.3d", "mfu.3d", *NEW_METRICS}
    assert "conv_roofline.3d" not in layers
    demo = {m["name"] for m in manifest.per_layer(man, "3D_demo.volume_64x256x256")}
    assert {"raster_inside_ms.3d", "raster_syncs.3d"} <= demo
    assert "resnet_roofline.3d" not in demo
    for name in NEW_METRICS:
        assert callable(manifest.reader(name))


def test_model_loads_through_the_program():
    from stardist_torch.models import StarDist3D
    man = manifest.load(manifest.HERE.parent)
    _, model_dir = manifest.config(man, CONFIG, manifest.HERE.parent)
    m = StarDist3D(None, CONFIG, str(model_dir.parent), device="cpu")
    c = m.config
    assert (c.backbone, c.n_rays, tuple(c.grid), tuple(c.anisotropy)) == (
        "resnet", 96, (1, 2, 2), (2, 1, 1))
    assert len(m.rays.faces) == 188
    assert tuple(c.train_patch_size) == (48, 96, 96) and c.train_batch_size == 2
    thr = json.loads((model_dir / "thresholds.json").read_text())
    assert m.thresholds.prob == thr["prob"] and m.thresholds.nms == thr["nms"]
    # trained: the heads are not the seeded start
    assert float(m.net.head_dist.bias.abs().max()) > 0


def test_limits_hold_every_check():
    lim = manifest.limits(CELL)
    assert set(lim) == {"prob_gap", "dist_gap", "label_diff_px", "iou_deficit", "count_spread"}
    assert lim["count_spread"] == 0 and all(v >= 0 for v in lim.values())


def test_mix_generator_at_the_mix_params():
    mix = manifest.traffic(MIX)
    assert mix["entry"] == "predict_instances" and not mix.get("staged")
    assert mix["generator"] == "synthetic_nuclei_3d_aniso" and mix["shape"] == [64, 512, 512]
    assert (mix["items"], mix["warmup"], mix["checked"]) == (4, 1, 1)
    small = dict(mix, shape=[12, 48, 48], items=1)
    (img,) = run.make_inputs(small, SEED)
    assert img.shape == (12, 48, 48) and img.dtype == np.float32
    again = run.make_inputs(small, SEED)[0]
    assert np.array_equal(img, again)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with a small cell of the committed model:
    a mix of 12x48x48 anisotropic volumes, the committed cell's limits, and
    the cell's name added to every metric list that names the committed
    cell."""
    root = tmp_path_factory.mktemp("bench")
    here = root / "portbench"
    shutil.copytree(manifest.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = manifest.load(manifest.HERE.parent)
    man["workloads"].append(dict(name=SMALL, config=CONFIG, traffic=SMALL_MIX, chips=1,
                                 why="12x48x48 anisotropic volumes"))
    for m in man["end_to_end"] + man["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(SMALL)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    mix = dict(manifest.traffic(MIX), shape=[12, 48, 48], items=2, warmup=1, checked=2,
               params=dict(manifest.traffic(MIX)["params"], density=1e-3))
    (here / "traffic" / f"{SMALL_MIX}.json").write_text(json.dumps(mix))
    shutil.copy(manifest.HERE / "limits" / f"{CELL}.json", here / "limits" / f"{SMALL}.json")
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_small_cell_runs_and_is_correct(root, trace):
    torch.set_num_threads(4)
    a = run.parse(["--workload", SMALL, "--seed", str(SEED), "--seconds", "0.6",
                   "--trace", str(trace)])
    out = run.run(a, "cpu", root=root)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    got = out["metrics"]
    assert all(v["value"] > 0 for v in got.values()), got
    if trace:
        assert {"forward_ms.3d", "nms_ms.3d", "raster_ms.3d", "mfu.3d",
                "raster_inside_ms.3d"} <= set(got)
        # no device events on the CPU: no CUDA sync, no kernel
        assert "raster_syncs.3d" not in got and "resnet_roofline.3d" not in got
    else:
        assert set(got) == {"mvox_s", "setup_s"}


def test_small_cell_judges_survivors(root):
    """The judged outputs hold survivors, so the NMS and the raster at 188
    faces are compared, not only the maps."""
    from stardist_torch.models import StarDist3D
    man = manifest.load(root)
    _, model_dir = manifest.config(man, CONFIG, root)
    mix = manifest.traffic(SMALL_MIX, root / "portbench")
    img = run.make_inputs(mix, SEED)[0]
    m = StarDist3D(None, CONFIG, str(model_dir.parent), device="cpu")
    assert len(m.predict_instances(img)[1]["prob"]) >= 2
