"""A StarDist3D ResNet with 96 anisotropic golden-spiral rays, shaped as
upstream's 3D training notebook (``Config3D(backbone="resnet", rays=
Rays_GoldenSpiral(96, (2, 1, 1)), grid=(1, 2, 2), anisotropy=(2, 1, 1))``,
its published widths), added to a copy of the benchmark as new files and
manifest entries only, runs on the CPU traced and untraced and is judged
correct; with its residual shortcuts dropped in the program it is not."""
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from portbench import manifest

sys.path.insert(0, str(manifest.HERE))
import run  # noqa: E402

NAME, CONFIG, MIX = "3D_notebook.aniso_small", "3D_notebook", "aniso_small"
LIKE = "3D_demo.volume_64x256x256"      # the cell whose metrics the new one reports
SEED = 2147483713


def notebook_model(basedir, mix):
    """The notebook's model in ``basedir/3D_notebook``: the port's seeded
    weights with the dist head shifted so that every ray is positive, as a
    trained model's are; the prob threshold at the 99th percentile of the
    prob map's inside (off the 2-cell border) on the run's volumes, so that
    a few candidates exist in each."""
    from stardist_torch.models import Config3D, StarDist3D
    from stardist_torch.rays3d import Rays_GoldenSpiral
    conf = Config3D(backbone="resnet", rays=Rays_GoldenSpiral(96, (2, 1, 1)), grid=(1, 2, 2),
                    anisotropy=(2, 1, 1))
    model = StarDist3D(conf, CONFIG, str(basedir), device="cpu")
    with torch.no_grad():
        model.net.head_dist.weight.mul_(0.25)
        model.net.head_dist.bias.fill_(4.0)
    model.save_weights()
    inside = []
    for img in run.make_inputs(mix, SEED):
        prob, _ = model.net.forward(torch.from_numpy(img)[..., None])
        inside.append(np.quantile(prob[2:-2, 2:-2, 2:-2].numpy(), 0.99))
    thr = dict(prob=float(min(inside)), nms=0.3)
    (basedir / CONFIG / "thresholds.json").write_text(json.dumps(thr))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with the cell added as files: the model
    folder, a mix of ``synthetic_nuclei_3d_aniso`` volumes, limits (the
    3D cell's) and manifest entries; no file of the copy edited."""
    root = tmp_path_factory.mktemp("bench")
    here = root / "portbench"
    shutil.copytree(manifest.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = manifest.load(manifest.HERE.parent)
    man["configs"].append(dict(name=CONFIG, source="https://github.com/stardist/stardist/blob/"
                               "master/examples/3D/2_training.ipynb",
                               file=f"portbench/configs/{CONFIG}/config.json", reduced=[],
                               why="ResNet, 96 anisotropic rays"))
    man["workloads"].append(dict(name=NAME, config=CONFIG, traffic=MIX, chips=1,
                                 why="12x48x48 anisotropic volumes"))
    for m in man["end_to_end"] + man["per_layer"]:
        if LIKE in m.get("workloads", []):
            m["workloads"].append(NAME)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    mix = dict(manifest.traffic("volume_64x256x256"), generator="synthetic_nuclei_3d_aniso",
               shape=[12, 48, 48], params={"density": 1e-3, "r_range": [4, 7],
                                           "anisotropy": [2, 1, 1]},
               items=2, warmup=1, checked=2)
    (here / "traffic" / f"{MIX}.json").write_text(json.dumps(mix))
    shutil.copy(manifest.HERE / "limits" / f"{LIKE}.json", here / "limits" / f"{NAME}.json")
    torch.manual_seed(0)
    notebook_model(here / "configs", mix)
    return root


def run_cell(root, trace):
    torch.set_num_threads(4)
    a = run.parse(["--workload", NAME, "--seed", str(SEED), "--seconds", "0.6",
                   "--trace", str(trace)])
    return run.run(a, "cpu", root=root)


@pytest.mark.parametrize("trace, group, present", [
    (0, manifest.end_to_end, {"mvox_s", "setup_s"}),
    (1, manifest.per_layer, {"forward_ms.3d", "nms_ms.3d", "raster_ms.3d", "mfu.3d"})])
def test_resnet_cell_added_as_files_runs(root, trace, group, present):
    out = run_cell(root, trace)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    man = manifest.load(root)
    assert present <= set(out["metrics"]) <= {m["name"] for m in group(man, NAME)}
    assert all(v["value"] > 0 for v in out["metrics"].values()), out["metrics"]


def test_resnet_cell_judges_a_real_segmentation(root):
    """The judged outputs hold survivors, so the NMS and the raster at
    188 faces are compared, not only the maps."""
    from portbench.reference.pipeline import Reference
    man = manifest.load(root)
    _, model_dir = manifest.config(man, CONFIG, root)
    ref = Reference(model_dir, "cpu")
    assert ref.faces.shape == (188, 3)
    mix = manifest.traffic(MIX, root / "portbench")
    img = run.make_inputs(mix, SEED)[0]
    assert len(ref.instances(img)["prob"]) >= 2


def test_resnet_shortcut_dropped_fails(root, monkeypatch):
    from stardist_torch.models import unet

    def no_shortcut(self, x):
        y = x
        for conv in self.convs:
            y = conv(y)
        return self.act(y)
    monkeypatch.setattr(unet.ResNetBlock, "forward", no_shortcut)
    out = run_cell(root, 0)
    assert not out["correct"], out["checks"]
    checks = out["checks"]
    assert any(checks[k]["value"] > checks[k]["limit"] for k in ("prob_gap", "dist_gap")), checks
