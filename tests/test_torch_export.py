"""The port's export_TF and bioimage.io export / import against
stardist_tpu's, on the CPU, with the weights carried across from a JAX
model (weights.params_from_flax). Four SavedModel saves in all: the two 2D
bundles inside the bioimage.io zips, and the 3D ResNet's from each
package."""
import json
import sys
import warnings
import zipfile

import numpy as np
import pytest
import torch
import yaml

from stardist_tpu.bioimageio_utils import export_bioimageio as jexport
from stardist_tpu.bioimageio_utils import import_bioimageio as jimport
from stardist_tpu.models import Config2D as Config2DJax
from stardist_tpu.models import Config3D as Config3DJax
from stardist_tpu.models import StarDist2D as StarDist2DJax
from stardist_tpu.models import StarDist3D as StarDist3DJax
from stardist_torch import bioimageio_utils as tbio
from stardist_torch.models import Config2D, Config3D, StarDist2D, StarDist3D
from stardist_torch.models.weights import params_from_flax

torch.set_num_threads(2)

CFG2D = dict(n_rays=8, grid=(2, 2), unet_n_depth=1, unet_n_filter_base=4,
             net_conv_after_unet=8, train_patch_size=(32, 32), train_batch_size=1)
CFG3D = dict(n_rays=16, grid=(1, 2, 2), backbone="resnet", resnet_n_blocks=2,
             resnet_n_filter_base=8, net_conv_after_resnet=16, n_classes=2,
             train_patch_size=(16, 32, 32), train_batch_size=1)
SAVED_TOL = 1e-5     # the two SavedModels: the same TF ops on the same weights
PRED_TOL = 1e-4      # a SavedModel or an imported model against the other package's forward


def _pair(tmp_path, ndim):
    """A JAX model and the port's with the JAX model's weights, each in its
    own folder under tmp_path."""
    if ndim == 2:
        jm = StarDist2DJax(Config2DJax(**CFG2D), "m", str(tmp_path / "jax"))
        tm = StarDist2D(Config2D(**CFG2D), "m", str(tmp_path / "torch"), device="cpu")
    else:
        jm = StarDist3DJax(Config3DJax(**CFG3D), "m", str(tmp_path / "jax"))
        tm = StarDist3D(Config3D(**CFG3D), "m", str(tmp_path / "torch"), device="cpu")
    tm.net.load_state_dict(params_from_flax(tm.net, jm.params))
    return jm, tm


def _saved_model(zip_path, where):
    import tensorflow as tf
    with zipfile.ZipFile(zip_path) as z:
        assert "saved_model.pb" in z.namelist()
        z.extractall(where)
    return tf.saved_model.load(str(where))


def _check_against_predict(out, prob, dist, grid):
    """As tests/test_api_surface.py::test_export_TF: the sparse prob at the
    grid positions and zeros elsewhere, the nearest-neighbour dist (raw: the
    export carries the head's output, predict clamps it at 1e-3)."""
    nd = len(grid)
    at = (0,) + tuple(slice(None, None, g) for g in grid)
    np.testing.assert_allclose(out[at + (0,)], prob, rtol=0, atol=PRED_TOL)
    off = (0,) + tuple(slice(1, None, g) if g > 1 else slice(None) for g in grid)
    assert np.all(out[off + (0,)] == 0)
    np.testing.assert_allclose(np.maximum(out[at + (slice(1, None),)], 1e-3), dist,
                               rtol=0, atol=PRED_TOL * max(1, np.abs(dist).max()))
    assert out.shape[1:1 + nd] == tuple(s * g for s, g in zip(prob.shape, grid))


@pytest.fixture(scope="module")
def bio(tmp_path_factory):
    """The 2D pair, each package's bioimage.io zip, and each zip imported by
    the other package."""
    tmp = tmp_path_factory.mktemp("bio")
    jm, tm = _pair(tmp, 2)
    z_t = tbio.export_bioimageio(tm, tmp / "pkg_torch")
    z_j = jexport(jm, tmp / "pkg_jax")
    return dict(tmp=tmp, jm=jm, tm=tm, z_t=z_t, z_j=z_j,
                j_from_t=jimport(z_t, tmp / "imported_jax"),
                t_from_j=tbio.import_bioimageio(z_j, tmp / "imported_torch", device="cpu"))


def _rdf(zip_path):
    with zipfile.ZipFile(zip_path) as z:
        return yaml.safe_load(z.read("rdf.yaml")), sorted(z.namelist())


def test_bioimageio_rdf_equals_the_reference(bio):
    """The same files and the same RDF outside description, tags and
    authors; the macro is the reference's, with the thresholds baked in."""
    (rdf_t, names_t), (rdf_j, names_j) = _rdf(bio["z_t"]), _rdf(bio["z_j"])
    assert names_t == names_j and "TF_SavedModel.zip" in names_t
    differ = {k for k in set(rdf_t) | set(rdf_j) if rdf_t.get(k) != rdf_j.get(k)}
    assert differ <= {"description", "tags", "authors"}, differ
    assert "stardist_torch" in str(rdf_t["authors"]) and "pytorch" in rdf_t["tags"]
    from stardist_tpu.bioimageio_utils import DEEPIMAGEJ_MACRO
    assert tbio.DEEPIMAGEJ_MACRO == DEEPIMAGEJ_MACRO
    with zipfile.ZipFile(bio["z_t"]) as zt, zipfile.ZipFile(bio["z_j"]) as zj:
        assert zt.read("stardist_postprocessing.ijm") == zj.read("stardist_postprocessing.ijm")
        # the weights: the flax checkpoint, byte for byte
        assert zt.read("stardist_weights.h5") == zj.read("stardist_weights.h5")


@pytest.mark.parametrize("way", ["torch_to_jax", "jax_to_torch"])
def test_bioimageio_each_package_imports_the_others_zip(bio, way):
    """Port export -> JAX import, and JAX export -> port import: the imported
    model's predict equals the exporting package's within the f32
    tolerance; the thresholds and config come across."""
    x = np.random.RandomState(0).uniform(0, 1, (32, 44)).astype(np.float32)
    src, dst = (bio["tm"], bio["j_from_t"]) if way == "torch_to_jax" else \
        (bio["jm"], bio["t_from_j"])
    assert isinstance(dst, StarDist2D if way == "jax_to_torch" else StarDist2DJax)
    assert json.loads(json.dumps(dst.config.to_dict())) == json.loads(
        json.dumps(src.config.to_dict()))          # tuples come back as lists
    assert tuple(dst.thresholds) == tuple(src.thresholds)
    for a, b in zip(src.predict(x), dst.predict(x)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=PRED_TOL)


def test_bioimageio_test_arrays_are_predicts(bio):
    """The zip's test arrays are the port's predict of its test input."""
    import io
    with zipfile.ZipFile(bio["z_t"]) as z:
        x, prob, dist = (np.load(io.BytesIO(z.read(f"test_{k}.npy")))
                         for k in ("input", "prob", "dist"))
    p, d = bio["tm"].predict(x)
    assert np.array_equal(p, prob) and np.array_equal(d, dist)


def test_export_tf_2d_equals_the_reference(bio):
    """The 2D U-Net at grid (2, 2): the port's SavedModel (the bundle in its
    bioimage.io zip) equals the JAX package's on the same input within
    SAVED_TOL, and matches the port's predict."""
    import tensorflow as tf
    tmp = bio["tmp"]
    x = np.random.RandomState(1).uniform(0, 1, (1, 64, 48, 1)).astype(np.float32)
    outs = []
    for tag, z in (("t", bio["z_t"]), ("j", bio["z_j"])):
        with zipfile.ZipFile(z) as zz:
            zz.extract("TF_SavedModel.zip", tmp / f"tf_{tag}")
        mod = _saved_model(tmp / f"tf_{tag}" / "TF_SavedModel.zip", tmp / f"tf_{tag}" / "sm")
        outs.append(mod(tf.constant(x)).numpy())
    assert outs[0].shape == (1, 64, 48, 1 + CFG2D["n_rays"])
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=SAVED_TOL)
    _check_against_predict(outs[0], *bio["tm"].predict(x[0, ..., 0]), CFG2D["grid"])


def test_export_tf_3d_resnet_multiclass_equals_the_reference(tmp_path):
    """A 3D ResNet with two classes: both packages warn and drop the class
    output; the port's zip lands at logdir/TF_SavedModel.zip; its
    SavedModel equals the JAX package's within SAVED_TOL and matches the
    port's predict."""
    import tensorflow as tf
    jm, tm = _pair(tmp_path, 3)
    with pytest.warns(UserWarning, match="multi-class mode not supported"):
        z_t = tm.export_TF()
    with pytest.warns(UserWarning, match="multi-class mode not supported"):
        z_j = jm.export_TF(fname=tmp_path / "jax_tf.zip")
    assert z_t == tm.logdir / "TF_SavedModel.zip" and z_t.exists()
    x = np.random.RandomState(2).uniform(0, 1, (1, 16, 32, 32, 1)).astype(np.float32)
    out_t = _saved_model(z_t, tmp_path / "sm_t")(tf.constant(x)).numpy()
    out_j = _saved_model(z_j, tmp_path / "sm_j")(tf.constant(x)).numpy()
    assert out_t.shape == (1, 16, 32, 32, 1 + CFG3D["n_rays"])
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=SAVED_TOL)
    prob, dist, _ = tm.predict(x[0, ..., 0])
    _check_against_predict(out_t, prob, dist, CFG3D["grid"])


def test_export_tf_without_tensorflow_raises(tmp_path, monkeypatch):
    """Without tensorflow, the reference's RuntimeError; without a model
    folder or a file name, its ValueError."""
    tm = StarDist2D(Config2D(**CFG2D), "m", str(tmp_path), device="cpu")
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(RuntimeError, match="requires tensorflow"):
        tm.export_TF()
    monkeypatch.undo()
    free = StarDist2D(Config2D(**CFG2D), None, None, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="Need explicit 'fname'"):
            free.export_TF()
