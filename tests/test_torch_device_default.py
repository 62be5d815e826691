"""Numpy inputs of the port's NMS and label-rendering entry points go to the
card by default and run on the CPU only when the caller passes
``device="cpu"``. Whether there is a card is decided inside each test: with
none, the default must raise instead of running on the CPU; with one, the
default must give what the CPU gives."""
import numpy as np
import pytest
import torch

from stardist_torch.geometry import polygons_to_label, polyhedron_to_label
from stardist_torch.nms import (non_maximum_suppression_3d_inds,
                                non_maximum_suppression_3d_sparse,
                                non_maximum_suppression_inds,
                                non_maximum_suppression_sparse)
from stardist_torch.rays3d import Rays_GoldenSpiral


def _polygons(n=40, R=32, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.uniform(3, 9, (n, R)).astype(np.float32)
    p = rng.uniform(8, 56, (n, 2)).astype(np.float32)
    prob = rng.uniform(0.5, 1, n).astype(np.float32)
    return d, p, prob


def _polyhedra(n=30, seed=0):
    rays = Rays_GoldenSpiral(32)
    rng = np.random.RandomState(seed)
    d = rng.uniform(2, 5, (n, len(rays))).astype(np.float32)
    p = rng.uniform(6, 26, (n, 3)).astype(np.float32)
    prob = rng.uniform(0.5, 1, n).astype(np.float32)
    return d, p, prob, rays


def _calls():
    d, p, prob = _polygons()
    d3, p3, prob3, rays = _polyhedra()
    return {
        "nms_sparse": lambda **kw: non_maximum_suppression_sparse(d, prob, p, **kw),
        "nms_inds": lambda **kw: non_maximum_suppression_inds(d, p, prob, **kw),
        "nms_3d_sparse": lambda **kw: non_maximum_suppression_3d_sparse(d3, prob3, p3, rays,
                                                                        **kw),
        "nms_3d_inds": lambda **kw: non_maximum_suppression_3d_inds(d3, p3, rays, prob3, **kw),
        "polygons_to_label": lambda **kw: polygons_to_label(d, p, (64, 64), prob=prob, **kw),
        "polyhedron_to_label": lambda **kw: polyhedron_to_label(
            d3, p3, rays, (32, 32, 32), prob=prob3, verbose=False, **kw),
    }


@pytest.mark.parametrize("name", ["nms_sparse", "nms_inds", "nms_3d_sparse", "nms_3d_inds",
                                  "polygons_to_label", "polyhedron_to_label"])
def test_numpy_input_defaults_to_the_card(name):
    call = _calls()[name]
    on_cpu = call(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        return
    got = call()
    # numpy in, numpy out, wherever it ran
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    on_cpu if isinstance(on_cpu, tuple) else (on_cpu,)):
        assert isinstance(a, np.ndarray) and a.shape == b.shape


def test_tensor_input_keeps_its_device():
    d, p, prob = _polygons()
    keep = non_maximum_suppression_inds(torch.from_numpy(d), torch.from_numpy(p),
                                        torch.from_numpy(prob))
    assert isinstance(keep, torch.Tensor) and keep.device.type == "cpu"
    lbl = polygons_to_label(torch.from_numpy(d), torch.from_numpy(p), (64, 64),
                            prob=torch.from_numpy(prob))
    assert isinstance(lbl, torch.Tensor) and lbl.device.type == "cpu" and lbl.max() > 0
