"""stardist_torch's msgpack reader against flax/msgpack on the committed
checkpoints, and the flax -> torch parameter mapping."""
import msgpack
import numpy as np
import pytest
import torch

from flax import serialization

from stardist_torch.models.weights import (load_flax_checkpoint, msgpack_loads,
                                           params_from_flax)

torch.set_num_threads(2)

DEMO = "models/examples/2D_demo"


def _assert_tree_equal(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b)
        for k in b:
            _assert_tree_equal(a[k], b[k])
    else:
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)   # same bytes: exact


@pytest.mark.parametrize("name", ["weights_best.h5", "weights_last.h5", "weights_now.h5"])
def test_msgpack_reader_matches_flax(name):
    raw = open(f"{DEMO}/{name}", "rb").read()
    assert raw[:8] == b"\x81\xa6params"
    _assert_tree_equal(msgpack_loads(raw), serialization.msgpack_restore(raw))


@pytest.mark.parametrize("obj", [
    {"a": 1, "b": [1, -1, -33, 200, 70000, 2 ** 40, -2 ** 40]},
    {"k" * 40: "v" * 300, "x": None, "t": True, "f": False},
    {str(i): i for i in range(20)},            # map16
    {"f": 1.5, "b": b"\x00\x01" * 200},
    list(range(20)),                           # array16
])
def test_msgpack_reader_types(obj):
    assert msgpack_loads(msgpack.packb(obj, use_bin_type=True)) == obj


def test_msgpack_reader_arrays():
    tree = {"params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                       "s": np.float32(2.5), "i": np.arange(3, dtype=np.int64)}}
    raw = serialization.msgpack_serialize(tree)
    out = msgpack_loads(raw)
    assert np.array_equal(out["params"]["w"], tree["params"]["w"])
    assert out["params"]["s"] == np.float32(2.5)
    assert np.array_equal(out["params"]["i"], tree["params"]["i"])


def test_params_from_flax_fills_every_tensor():
    from stardist_torch.models import StarDist2D
    m = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
    params = load_flax_checkpoint(f"{DEMO}/weights_best.h5")
    sd = params_from_flax(m.net, params)
    assert set(sd) == set(m.net.state_dict())
    for k, v in m.net.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # the first conv is the flax ConvBlock_0 kernel, HWIO
    assert np.array_equal(sd["top.0.weight"].numpy(),
                          params["ConvBlock_0"]["Conv_0"]["kernel"])
