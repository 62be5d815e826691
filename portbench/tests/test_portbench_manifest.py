"""The manifest keeps to the benchmark's naming rules, and the harness finds a
cell's configuration, mix, limits and metric readers by name, new ones
added as files included."""
import json
import re
import shutil

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units():
    man = manifest.load(manifest.HERE.parent)
    names = [c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]]
    names += [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    names += [w["config"] for w in man["workloads"]] + [w["traffic"] for w in man["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in man[group]]
        assert len(seen) == len(set(seen)), group
    assert {m["name"] for m in man["end_to_end"]} >= {"setup_s"}


def test_every_cell_is_found():
    root = manifest.HERE.parent
    man = manifest.load(root)
    for w in man["workloads"]:
        _, model_dir = manifest.config(man, w["config"], root)
        assert (model_dir / "config.json").is_file() and (model_dir / "weights_best.h5").is_file()
        mix = manifest.traffic(w["traffic"])
        assert {"entry", "generator", "shape", "items", "warmup", "checked"} <= set(mix)
        assert set(manifest.limits(w["name"])) == {"prob_gap", "dist_gap", "label_diff_px",
                                                   "iou_deficit", "count_spread"}
        e2e = {m["name"] for m in manifest.end_to_end(man, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in e2e:
            assert callable(manifest.reader(m))
        layers = manifest.per_layer(man, w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in e2e
            assert callable(manifest.reader(m["name"]))


def test_new_files_are_picked_up(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(manifest.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    man = manifest.load(manifest.HERE.parent)
    man["workloads"].append({"name": "2D_demo.sparse_4096", "config": "2D_demo",
                             "traffic": "sparse_4096", "chips": 1, "why": "a new cell"})
    man["per_layer"].append({"name": "extract_ms.2d", "unit": "ms", "better": "lower",
                             "source": "program_span", "layer": "extract", "moves": "mpix_s",
                             "workloads": ["2D_demo.sparse_4096"]})
    for m in man["end_to_end"]:
        if m["name"] == "mpix_s":
            m["workloads"].append("2D_demo.sparse_4096")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    mix = dict(manifest.traffic("fields_4096"), params={"density": 6e-5, "r_range": [7, 14]})
    (here / "traffic" / "sparse_4096.json").write_text(json.dumps(mix))
    (here / "limits" / "2D_demo.sparse_4096.json").write_text(
        (here / "limits" / "2D_demo.fields_4096.json").read_text())
    (here / "metrics" / "extract_ms.2d.py").write_text(
        "def read(ctx):\n    return ctx.stage_ms('extract')\n")
    man2 = manifest.load(tmp_path)
    assert manifest.workload(man2, "2D_demo.sparse_4096")["traffic"] == "sparse_4096"
    assert manifest.traffic("sparse_4096", here)["params"]["density"] == 6e-5
    assert manifest.limits("2D_demo.sparse_4096", here)["count_spread"] == 0
    names = [m["name"] for m in manifest.per_layer(man2, "2D_demo.sparse_4096")]
    assert names == ["extract_ms.2d"]
    assert [m["name"] for m in manifest.end_to_end(man2, "2D_demo.sparse_4096")] == [
        "mpix_s", "setup_s"]

    class Ctx:
        def stage_ms(self, stage):
            return 1.5 if stage == "extract" else None
    assert manifest.reader("extract_ms.2d", here)(Ctx()) == 1.5
