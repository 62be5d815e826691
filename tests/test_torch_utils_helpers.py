"""The numpy helpers that the reference's training example calls, copied
into stardist_torch/utils.py: each exactly equal to its stardist_tpu
counterpart on the same seeded inputs (the ROI zip byte for byte)."""
import time

import numpy as np
import pytest

import stardist_tpu.utils as jutils
import stardist_torch.utils as tutils
from tests.utils import random_image, synthetic_nuclei_2d


def _labels_with_holes():
    lbl = synthetic_nuclei_2d((96, 96), n=12, seed=1)[1].astype(np.int32)
    rng = np.random.RandomState(0)
    holes = rng.rand(*lbl.shape) < 0.05
    return np.where(holes, 0, lbl)


def _fill_label_holes(mod):
    lbl = _labels_with_holes()
    out = mod.fill_label_holes(lbl)
    assert (out > 0).sum() > (lbl > 0).sum()
    return out


def _calculate_extents(mod):
    np.random.seed(3)
    lbls = [random_image((64, 72)) for _ in range(3)]
    vol = np.stack([lbls[0]] * 4)
    return (mod.calculate_extents(lbls[0]), mod.calculate_extents(lbls),
            mod.calculate_extents(lbls, np.mean), mod.calculate_extents(vol),
            mod.calculate_extents(np.zeros((8, 8), np.int32)))


def _sample_points(mod):
    lbl = _labels_with_holes()
    out = []
    for prob in (None, (lbl > 0) * np.linspace(0.1, 1, lbl.size).reshape(lbl.shape)):
        np.random.seed(7)
        out.append(mod.sample_points(50, lbl > 0, prob=prob, b=3))
    return tuple(out)


def _polyroi_bytearray(mod):
    rng = np.random.RandomState(2)
    x, y = rng.uniform(0, 300, 32), rng.uniform(0, 200, 32)
    return tuple(bytes(mod.polyroi_bytearray(x, y, pos=p, subpixel=s))
                 for p, s in ((None, True), (3, True), (5, False)))


def _export_imagej_rois(mod, tmp_path, monkeypatch):
    from stardist_tpu.geometry import dist_to_coord
    rng = np.random.RandomState(4)
    polys = [dist_to_coord(rng.uniform(3, 9, (n, 16)).astype(np.float32),
                           rng.uniform(10, 90, (n, 2))) for n in (5, 3)]
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)   # the zip's timestamps
    name = tmp_path / mod.__name__.split(".")[0]
    mod.export_imagej_rois(name, polys)
    mod.export_imagej_rois(str(name) + "_one.zip", polys[0], set_position=False)
    return name.with_suffix(".zip").read_bytes(), (tmp_path / (name.name + "_one.zip")).read_bytes()


CASES = {
    "fill_label_holes": _fill_label_holes,
    "calculate_extents": _calculate_extents,
    "sample_points": _sample_points,
    "polyroi_bytearray": _polyroi_bytearray,
    "export_imagej_rois": _export_imagej_rois,
}


def _equal(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, bytes):
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_equals_reference(name, tmp_path, monkeypatch):
    make = CASES[name]
    if name == "export_imagej_rois":
        got, want = make(tutils, tmp_path, monkeypatch), make(jutils, tmp_path, monkeypatch)
    else:
        got, want = make(tutils), make(jutils)
    assert _equal(got, want)
