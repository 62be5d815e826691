"""The Keras HDF5 weight import of stardist_torch against stardist_tpu's
(tests/test_h5_import.py's cases, on the CPU).

The files are written here with h5py in the layout of Keras's
``save_weights`` (the layout of upstream StarDist's zoo): ``layer_names``
in the order of the forward, weightless layers among them, anonymous conv
layers and the named ``features``/``prob``/``dist`` (and a multiclass
net's ``features_class``/``prob_class``) layers, seeded weights. The
port's import must give bit for bit the tensors that
``models/weights.py::params_from_flax`` makes of the reference's import
of the same file, and the two f32 forwards agree within 1e-4 (the f32
forward tolerance of tests/test_torch_forward*.py and tests/test_h5_import.py). A file whose
shapes do not fit the net raises ``ValueError``; ``from_pretrained`` loads
such a file from a model folder and from a ``file://`` zip, checked
against its md5, through the port's own cache."""
import hashlib
import json
import zipfile

import h5py
import jax
import numpy as np
import pytest
import torch

from stardist_torch.models import (Config2D, Config3D, StarDist2D, StarDist3D,
                                   clear_models_and_aliases, get_registered_models,
                                   register_aliases, register_model)
from stardist_torch.models import _ALIASES, _MODELS
from stardist_torch.models.weights import params_from_flax
from stardist_tpu.models import Config2D as Config2DJax, Config3D as Config3DJax
from stardist_tpu.models import StarDist2D as StarDist2DJax, StarDist3D as StarDist3DJax

torch.set_num_threads(2)

CASES = {
    "2d-grid2-depth2": (2, dict(grid=(2, 2), unet_n_depth=2)),
    "2d-grid1-depth1": (2, dict(grid=(1, 1), unet_n_depth=1)),
    "2d-grid4-multiclass": (2, dict(grid=(4, 4), unet_n_depth=1, n_classes=2,
                                    train_loss_weights=(1, 0.2, 1))),
    "3d-grid122": (3, dict(grid=(1, 2, 2), unet_n_depth=1)),
}


def _configs(name):
    nd, kw = CASES[name]
    kw = dict(n_rays=8, unet_n_filter_base=8, net_conv_after_unet=16, train_batch_size=1,
              train_patch_size=(32, 32) if nd == 2 else (16, 32, 32), **kw)
    return (Config2D(**kw), Config2DJax(**kw)) if nd == 2 else (Config3D(**kw), Config3DJax(**kw))


def _models(name):
    tc, jc = _configs(name)
    if tc.n_dim == 2:
        return StarDist2D(tc, basedir=None, device="cpu"), StarDist2DJax(jc, name="j",
                                                                        basedir=None)
    return StarDist3D(tc, basedir=None, device="cpu"), StarDist3DJax(jc, name="j", basedir=None)


def write_keras_h5(path, jm, seed=0):
    """A Keras weights file for the net of ``jm`` (the reference's model):
    its conv slots in the order of the forward, seeded values, the named
    layers under their names, the rest as conv2d, conv2d_1, ..., with
    weightless layers between them."""
    rng = np.random.RandomState(seed)
    slots, named = jm._flax_conv_slots()
    by_slot = {v: k for k, v in named.items()}
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    with h5py.File(path, "w") as f:
        names, n_anon = ["input"], 0
        f.create_group("input").attrs["weight_names"] = []
        for i, slot in enumerate(slots):
            node = params
            for k in slot:
                node = node[k]
            if slot in by_slot:
                name = by_slot[slot]
            else:
                name = "conv2d" if n_anon == 0 else f"conv2d_{n_anon}"
                n_anon += 1
            g = f.create_group(name)
            wn = [f"{name}/kernel:0", f"{name}/bias:0"]
            g.attrs["weight_names"] = [w.encode() for w in wn]
            g.create_dataset(wn[0], data=rng.normal(0, 0.2, node["kernel"].shape)
                             .astype(np.float32))
            g.create_dataset(wn[1], data=rng.normal(0, 0.1, node["bias"].shape)
                             .astype(np.float32))
            names.append(name)
            if i % 2 == 1:                               # a weightless layer between convs
                f.create_group(f"max_pooling_{i}").attrs["weight_names"] = []
                names.append(f"max_pooling_{i}")
        f.attrs["layer_names"] = [n.encode() for n in names]
        f.attrs["backend"] = b"tensorflow"


@pytest.mark.parametrize("name", sorted(CASES))
def test_import_equals_reference(tmp_path, name):
    tm, jm = _models(name)
    h5 = tmp_path / "weights_best.h5"
    write_keras_h5(h5, jm)
    tm.load_weights(str(h5))
    jm.load_weights(str(h5))
    want = params_from_flax(tm.net, jax.tree_util.tree_map(np.asarray, jm.params))
    got = tm.net.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k

    rng = np.random.RandomState(1)
    shape = (32, 32) if tm.config.n_dim == 2 else (8, 32, 32)
    x = rng.uniform(0, 1, shape + (1,)).astype(np.float32)
    outs_t = tm.net(torch.from_numpy(x))
    outs_j = jm._forward_fn()(jm.params, jm._extra_vars, x[None])
    assert len(outs_t) == len(outs_j)
    for a, b in zip(outs_t, outs_j):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= 1e-4 * max(1.0, np.abs(b).max())


def test_shape_mismatch_raises(tmp_path):
    _, jm = _models("2d-grid1-depth1")
    h5 = tmp_path / "w.h5"
    write_keras_h5(h5, jm)
    kw = dict(CASES["2d-grid1-depth1"][1], n_rays=16, unet_n_filter_base=8,
              net_conv_after_unet=16, train_batch_size=1, train_patch_size=(32, 32))
    tm = StarDist2D(Config2D(**kw), basedir=None, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        tm.load_weights(str(h5))
    with pytest.raises(NotImplementedError):
        StarDist3D(Config3D(n_rays=8, backbone="resnet", resnet_n_blocks=1, grid=(1, 2, 2),
                            train_patch_size=(16, 32, 32)),
                   basedir=None, device="cpu").load_weights(str(h5))


def _model_folder(path, name):
    tm, jm = _models(name)
    path.mkdir(parents=True)
    write_keras_h5(path / "weights_best.h5", jm)
    with open(path / "config.json", "w") as f:
        json.dump(tm.config.to_dict(), f)
    with open(path / "thresholds.json", "w") as f:
        json.dump({"prob": 0.6, "nms": 0.3}, f)
    tm.load_weights(str(path / "weights_best.h5"))
    return tm


@pytest.fixture
def registry():
    saved = ({k: dict(v) for k, v in _MODELS.items()}, {k: dict(v) for k, v in _ALIASES.items()})
    yield
    clear_models_and_aliases()
    _MODELS.update(saved[0])
    _ALIASES.update(saved[1])


def test_from_pretrained_zip_and_folder(tmp_path, monkeypatch, registry):
    """A zoo-layout zip served from a file:// URL: fetched into the port's
    cache, md5 checked, unpacked, the Keras weights imported; the cache
    serves the second call; a wrong md5 raises. A model folder loads in
    place."""
    want = _model_folder(tmp_path / "payload" / "2D_test_zoo", "2d-grid2-depth2")
    zip_path = tmp_path / "python_2D_test_zoo.zip"
    with zipfile.ZipFile(zip_path, "w") as z:
        for p in (tmp_path / "payload").rglob("*"):
            z.write(p, p.relative_to(tmp_path / "payload"))
    md5 = hashlib.md5(zip_path.read_bytes()).hexdigest()
    monkeypatch.setenv("STARDIST_TORCH_MODEL_CACHE", str(tmp_path / "cache"))

    register_model(StarDist2D, "2D_test_zoo", zip_path.as_uri(), md5)
    register_aliases(StarDist2D, "2D_test_zoo", "Test zoo model")
    register_model(StarDist2D, "2D_test_bad", zip_path.as_uri(), "0" * 32)
    register_model(StarDist2D, "2D_test_folder", str(tmp_path / "payload" / "2D_test_zoo"))
    models, aliases = get_registered_models(StarDist2D)
    assert aliases["Test zoo model"] == "2D_test_zoo" and "2D_versatile_fluo" in models
    for key in ("Test zoo model", "2D_test_folder"):
        m = StarDist2D.from_pretrained(key, device="cpu")
        assert m.device == torch.device("cpu") and tuple(m.thresholds) == (0.6, 0.3)
        for k, v in want.net.state_dict().items():
            assert torch.equal(m.net.state_dict()[k], v), k
    assert (tmp_path / "cache" / "StarDist2D" / "2D_test_zoo" / "config.json").exists()
    zip_path.unlink()                                       # the cache serves it now
    assert StarDist2D.from_pretrained("2D_test_zoo", device="cpu").thresholds.prob == 0.6
    with pytest.raises(Exception):
        StarDist2D.from_pretrained("2D_test_bad", device="cpu")
    assert StarDist2D.from_pretrained() is None
