"""Finds a cell's configuration, traffic mix, limits and metric readers by
the names in ``BENCHMARK.json``.

A configuration is a model folder (``config.json``, ``thresholds.json``,
``weights_best.h5``), named in the manifest's ``configs`` by its
``config.json``; a traffic mix is ``traffic/<name>.json``; a cell's
limits are ``limits/<workload>.json``; a per-layer metric is
``metrics/<name>.py`` with a function ``read(ctx)``. A new cell, mix or
metric is new files and new manifest entries.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(root):
    """The manifest at the checkout's root ``root``."""
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def workload(manifest, name):
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest, name, root):
    """(manifest entry, the model folder) of configuration ``name``."""
    for c in manifest["configs"]:
        if c["name"] == name:
            return c, (Path(root) / c["file"]).parent
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name, here=HERE):
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def limits(name, here=HERE):
    return json.loads((here / "limits" / f"{name}.json").read_text())


def end_to_end(manifest, cell):
    """The cell's end-to-end metrics: those without ``workloads`` and those
    that list it."""
    return [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(manifest, cell):
    """The cell's per-layer metrics: those that list it, and those without
    ``workloads`` whose end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end(manifest, cell)}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def reader(name, here=HERE):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    module = "portbench_metric_" + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
