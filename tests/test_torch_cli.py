"""The port's prediction CLI (stardist_torch.scripts) against its own
in-process call and against stardist_tpu's CLI, on the CPU: the demo
models on a synthetic tiff, untiled and tiled."""
import functools
import shutil

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from stardist_tpu.models import StarDist2D as StarDist2DJax
from stardist_tpu.models import StarDist3D as StarDist3DJax
from stardist_tpu.scripts import predict2d as jcli
from stardist_torch.core.normalize import normalize
from stardist_torch.matching import matching
from stardist_torch.models import StarDist2D, StarDist3D
from stardist_torch.scripts import predict2d, predict3d
from tests.utils import synthetic_nuclei_2d, synthetic_nuclei_3d

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def modeldir(tmp_path_factory):
    """A copy of models/examples: the reference may write into the model
    folder it loads."""
    d = tmp_path_factory.mktemp("models")
    for name in ("2D_demo", "3D_demo"):
        shutil.copytree(f"models/examples/{name}", d / name)
    return d


def _args(ndim, path, outdir, model, modeldir, n_tiles):
    argv = ["-i", str(path), "-o", str(outdir), "-m", model, "--modeldir", str(modeldir)]
    if n_tiles is not None:
        argv += ["--n_tiles", *map(str, n_tiles)]
    return argv


def _run_both(tmp_path, img, ndim, model, modeldir, n_tiles, monkeypatch):
    """Both CLIs on the same tiff: (the port's file, the reference's file,
    the port's returned labels, the port's in-process labels and details,
    the port's and the reference's details). In 3D the reference CLI reads
    and writes through volread / volwrite here: its own imread reads a
    stack's first page and its imwrite refuses a volume."""
    if ndim == 3:
        monkeypatch.setattr(jcli, "_imread", lambda p: np.asarray(imageio.volread(p)))
        monkeypatch.setattr(jcli, "_imwrite", imageio.volwrite)
    path = tmp_path / "field.tif"
    (imageio.volwrite if ndim == 3 else imageio.imwrite)(path, img)
    port_cls = functools.partial(StarDist2D if ndim == 2 else StarDist3D, device="cpu")
    ref_cls = StarDist2DJax if ndim == 2 else StarDist3DJax
    parser = (predict2d if ndim == 2 else predict3d).make_parser(ndim)
    args = parser.parse_args(_args(ndim, path, tmp_path / "port", model, modeldir, n_tiles))
    lab, det = predict2d.run(args, port_cls, ndim)
    args_ref = jcli.make_parser(ndim).parse_args(
        _args(ndim, path, tmp_path / "ref", model, modeldir, n_tiles))
    _, det_ref = jcli.run(args_ref, ref_cls, ndim)
    m = port_cls(None, model, str(modeldir))
    x = normalize(imageio.volread(path) if ndim == 3 else imageio.imread(path), 1, 99.8)
    lab_in, det_in = m.predict_instances(x, n_tiles=n_tiles)
    return (tmp_path / "port" / "field.labels.tif", tmp_path / "ref" / "field.labels.tif",
            lab, lab_in, det_in, det, det_ref)


def _read(path, ndim):
    return np.asarray(imageio.volread(path) if ndim == 3 else imageio.imread(path))


@pytest.mark.parametrize("n_tiles", [None, (2, 2)], ids=["untiled", "tiled"])
def test_cli_2d(tmp_path, modeldir, n_tiles, monkeypatch):
    """2D_demo on a 256^2 uint16 tiff: the label file has the reference's
    name and dtype, equals the port's in-process call exactly, and agrees
    with the reference CLI's within test_torch_predict.py's tolerance
    (survivors within one, matching accuracy >= 0.98: the f32 convs differ
    in their last bits)."""
    img = synthetic_nuclei_2d((256, 256), seed=0)[0]
    img = np.clip(img * 1000 + 100, 0, 65535).astype(np.uint16)
    f, f_ref, lab, lab_in, det_in, det, det_ref = _run_both(tmp_path, img, 2, "2D_demo",
                                                             modeldir, n_tiles, monkeypatch)
    assert f.name == f_ref.name and f.exists() and f_ref.exists()
    got, want = _read(f, 2), _read(f_ref, 2)
    assert got.dtype == want.dtype == np.uint16 and got.shape == img.shape
    assert np.array_equal(got, lab_in) and np.array_equal(lab, lab_in)
    assert np.array_equal(det["points"], det_in["points"])
    assert got.max() > 10
    assert abs(len(det["prob"]) - len(det_ref["prob"])) <= 1
    assert matching(want, got, thresh=0.5).accuracy >= 0.98


def test_cli_3d(tmp_path, modeldir, monkeypatch):
    """3D_demo on a 32x64x64 crop: the port's file equals its in-process
    call exactly and agrees with the reference CLI's within
    test_torch_predict3d.py's tolerance (survivors within one, matching
    accuracy >= 0.9)."""
    img = synthetic_nuclei_3d((32, 64, 64), seed=0)[0]
    img = np.clip(img * 1000 + 100, 0, 65535).astype(np.uint16)
    f, f_ref, lab, lab_in, det_in, det, det_ref = _run_both(tmp_path, img, 3, "3D_demo",
                                                             modeldir, None, monkeypatch)
    assert f.name == f_ref.name
    got, want = _read(f, 3), _read(f_ref, 3)
    assert got.dtype == want.dtype == np.uint16 and got.shape == img.shape
    assert np.array_equal(got, lab_in) and np.array_equal(lab, lab_in)
    assert got.max() > 3
    assert abs(len(det["prob"]) - len(det_ref["prob"])) <= 1
    assert matching(want, got, thresh=0.5).accuracy >= 0.9


def test_label_dtype_rule(tmp_path, monkeypatch):
    """uint16 below 2^16 labels, else int32, as the reference's CLI."""
    class Fake:
        def __init__(self, *a, **k):
            pass

        def predict_instances(self, x, **kw):
            lab = np.zeros(x.shape, np.int32)
            lab[0, 0] = self.top
            return lab, {"prob": np.zeros(1)}

    written = []
    monkeypatch.setattr(predict2d, "_imread", lambda p, ndim: np.ones((8, 8), np.uint16))
    monkeypatch.setattr(predict2d, "_imwrite", lambda p, a: written.append(a.dtype))
    for top in (2 ** 16 - 1, 2 ** 16):
        Fake.top = top
        args = predict2d.make_parser(2).parse_args(["-i", "x.tif", "-o", str(tmp_path),
                                                    "-m", "m"])
        predict2d.run(args, Fake, 2)
    assert written == [np.uint16, np.int32]
