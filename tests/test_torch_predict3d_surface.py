"""The rest of stardist_torch's 3D predict surface against stardist_tpu:
sparse=False (the dense 3D NMS), scale, overlap_label, the render modes,
the geometry helpers, the 3D predict_instances_device, and the NMS's keep
flags against the reference's device NMS (_nms3d_banded_traced).

Given the same candidates (the reference's own prediction), survivors and
label volumes are exactly equal. The whole pipelines are held as
tests/test_torch_api.py holds 2D's: survivors within one, matching accuracy
>= 0.98 (the f32 convs differ in their last bits, which can reorder
near-tied probs)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import stardist_tpu.geometry.geom3d as jgeom
import stardist_tpu.nms as jnms
from stardist_torch import geometry as tgeom
from stardist_torch import nms as tnms
from stardist_torch.matching import matching, relabel_sequential
from stardist_torch.models import Config3D, StarDist3D
from stardist_torch.models.model3d import DEVICE_LATTICE_S, _relabel_sequential
from stardist_torch.ops.nms import LATTICE_S, nms_polyhedra
from stardist_torch.ops.polyhedron import ray_tensors
from stardist_torch.rays3d import Rays_GoldenSpiral
from stardist_tpu.models import StarDist3D as StarDist3DJax
from stardist_tpu.ops.nms import _nms3d_banded_traced
from stardist_tpu.rays3d import Rays_GoldenSpiral as RaysJax
from tests.utils import synthetic_nuclei_3d

torch.set_num_threads(2)
SCALE = (1, 0.5, 0.5)


@pytest.fixture(scope="module")
def setup():
    img, lbl = synthetic_nuclei_3d((16, 40, 40), n=8, seed=0)
    jm = StarDist3DJax(None, "3D_demo", "models/examples")
    tm = StarDist3D(None, "3D_demo", "models/examples", device="cpu")
    return img, lbl, jm, tm


@pytest.fixture(scope="module")
def survivors(setup):
    """The reference's candidates through both NMS: the survivors
    (points, prob, dist) of each side, exactly equal."""
    img, _, jm, tm = setup
    prob, dist, points = (np.asarray(a) for a in jm.predict_sparse(img))
    nms_j = jnms.non_maximum_suppression_3d_sparse(dist, prob, points, jm.rays, nms_thresh=0.3)
    nms_t = tm._nms_sparse(*(torch.from_numpy(a) for a in (dist, prob, points)), 0.3)
    for a, r in zip(nms_t, nms_j):
        assert np.array_equal(a.numpy(), r)
    assert len(nms_j[1]) > 3
    return nms_t[:3], nms_j[:3]


def _same(res, res_ref, keys=("points", "prob", "dist")):
    for k in keys:
        assert np.array_equal(res[k], np.asarray(res_ref[k])), k


def test_dense_nms_on_reference_maps_is_exact(setup):
    """sparse=False's stage: the reference's dense maps through the port's
    dense 3D NMS and raster; non_maximum_suppression_3d's numpy API on a
    crop of them."""
    img, _, jm, tm = setup
    prob, dist = (np.asarray(a) for a in jm.predict(img))
    lab_ref, res_ref = jm._instances_from_prediction(img.shape, prob, dist)
    lab, res = tm._instances_from_prediction(img.shape, torch.from_numpy(prob),
                                             torch.from_numpy(dist), None)
    assert lab.dtype == np.int32 and np.array_equal(lab, lab_ref) and lab.max() > 3
    _same(res, res_ref)
    crop = np.s_[:, :10, :10]
    got = tnms.non_maximum_suppression_3d(dist[crop], prob[crop], tm.rays, (1, 2, 2), 2, 0.3,
                                          0.4, device="cpu")
    want = jnms.non_maximum_suppression_3d(dist[crop], prob[crop], jm.rays, (1, 2, 2), 2, 0.3,
                                           0.4)
    assert len(want[0]) > 0
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and np.array_equal(a, r)


def test_scale_renders_as_the_reference(setup, survivors):
    """scale's stage after the NMS: centres times 1 / s (in f64) and the
    rays scaled, drawn at the volume's shape (reference model3d.py:342-349),
    on the same survivors."""
    img, _, jm, tm = setup
    (pt, probt, distt), (pj, probj, distj) = survivors
    rescale = tm._rescale(dict(zip("ZYX", SCALE)))
    assert rescale == (1, 2, 2)
    lab, res = tm._render_survivors(img.shape, distt, pt, probt, rescale=rescale)
    rays = jm.rays.copy(scale=rescale)
    lab_ref, res_ref = jm._render_survivors(img.shape, distj, pj * np.array(rescale)[None],
                                            probj, rays=rays)
    assert np.array_equal(lab, lab_ref) and lab.max() > 1
    _same(res, res_ref, ("points", "prob", "dist", "rays_vertices"))
    assert res["points"].dtype == np.float64
    with pytest.raises(ValueError):
        tm._rescale({"Y": 1, "X": 2})


@pytest.mark.parametrize("overlap_label", [-1, 7])
def test_overlap_label_renders_as_the_reference(setup, survivors, overlap_label):
    """overlap_label on the same survivors: the count image, and the
    relabel that keeps a negative label (reference model3d.py:386-394)."""
    img, _, jm, tm = setup
    (pt, probt, distt), (pj, probj, distj) = survivors
    lab, _ = tm._render_survivors(img.shape, distt, pt, probt, overlap_label=overlap_label)
    lab_ref, _ = jm._render_survivors(img.shape, distj, pj, probj, overlap_label=overlap_label)
    assert np.array_equal(lab, lab_ref)
    if overlap_label < 0:
        assert (lab == overlap_label).sum() > 100
    else:                        # renumbered with the others: the last id
        assert lab.max() == len(probt) + 1


@pytest.mark.parametrize("kw", [dict(sparse=False, overlap_label=-1), dict(scale=SCALE)],
                         ids=["sparse=False,overlap_label", "scale"])
def test_pipeline_matches_reference(setup, kw):
    img, _, jm, tm = setup
    (lab, det), (lab_ref, det_ref) = tm.predict_instances(img, **kw), jm.predict_instances(img, **kw)
    lab_ref = np.asarray(lab_ref)
    assert lab.shape == lab_ref.shape == img.shape and lab.dtype == np.int32
    assert abs(len(det["prob"]) - len(det_ref["prob"])) <= 1 and len(det["prob"]) > 1
    if "overlap_label" in kw:
        assert (lab == -1).sum() > 0
        lab, lab_ref = np.maximum(lab, 0), np.maximum(lab_ref, 0)
    assert matching(lab_ref, lab, thresh=0.5).accuracy >= 0.98


def _polyhedra(n=40, R=32, seed=0, shape=(24, 40, 40)):
    rng = np.random.RandomState(seed)
    d = rng.uniform(2.5, 7, (n, R)).astype(np.float32)
    p = np.stack([rng.uniform(2, s - 2, n) for s in shape], 1).astype(np.float32)
    prob = rng.uniform(0.5, 1, n).astype(np.float32)
    return d, p, prob, shape


@pytest.mark.parametrize("mode", ["full", "kernel", "bbox"])
def test_render_modes_equal_reference(mode):
    d, p, prob, shape = _polyhedra()
    rays = Rays_GoldenSpiral(32)
    got = tgeom.polyhedron_to_label(d, p, rays, shape, prob=prob, mode=mode, device="cpu")
    want = jgeom.polyhedron_to_label(d, p, RaysJax(32), shape, prob=prob, mode=mode)
    assert got.dtype == np.int32 and np.array_equal(got, want) and got.max() > 20
    cnt = tgeom.polyhedron_to_label(d, p, rays, shape, prob=prob, mode=mode, overlap_label=-2,
                                    device="cpu")
    assert np.array_equal(cnt, jgeom.polyhedron_to_label(d, p, RaysJax(32), shape, prob=prob,
                                                          mode=mode, overlap_label=-2))


@pytest.mark.parametrize("mode,exc", [("hull", NotImplementedError), ("debug", NotImplementedError),
                                      ("cube", KeyError)])
def test_unported_render_modes_raise(mode, exc):
    d, p, prob, shape = _polyhedra(n=3)
    with pytest.raises(exc):
        tgeom.polyhedron_to_label(d, p, Rays_GoldenSpiral(32), shape, mode=mode, device="cpu")


def test_geometry_helpers_equal_reference():
    img, lbl = synthetic_nuclei_3d((20, 40, 40), n=8, seed=5)
    rays, rays_j = Rays_GoldenSpiral(32), RaysJax(32)
    got = tgeom.relabel_image_stardist3D(lbl, rays, device="cpu")
    assert got.dtype == np.int32 and np.array_equal(got, jgeom.relabel_image_stardist3D(lbl, rays_j))
    assert got.max() > 3
    dist = tgeom.star_dist3D(lbl, rays, grid=(1, 2, 2), device="cpu")
    assert np.array_equal(tgeom.dist_to_volume(dist, rays), jgeom.dist_to_volume(dist, rays_j))
    for mode in ("absolute", "relative"):
        assert np.array_equal(tgeom.dist_to_centroid(dist, rays, mode),
                              jgeom.dist_to_centroid(dist, rays_j, mode))
    d, p, _, _ = _polyhedra(n=5)
    polys = dict(dist=d, points=p, rays_vertices=rays.vertices, rays_faces=rays.faces)
    assert np.array_equal(tgeom.dist_to_coord3D(d, p, rays.vertices),
                          jgeom.dist_to_coord3D(d, p, rays_j.vertices))
    for kw in (dict(), dict(scale=(2, 1, 0.5), single_mesh=False, uv_map=True, name="n")):
        assert tgeom.export_to_obj_file3D(polys, **kw) == jgeom.export_to_obj_file3D(polys, **kw)
    with pytest.raises(ValueError):
        tgeom.dist_to_centroid(dist, rays, "middle")


@pytest.mark.parametrize("n,thresh", [(200, 0.3), (500, 0.4)])
@pytest.mark.parametrize("S", [DEVICE_LATTICE_S, LATTICE_S])
def test_nms_keep_flags_equal_banded_traced(S, n, thresh):
    """Clustered, overlapping candidates in descending-score order
    (tests/test_nms_device.py's field): the port's nms_polyhedra keeps what
    the reference's device NMS keeps, at the device path's lattice S = 10
    (the reference's predict_instances_device) and at S = 12 (its host
    NMS's, the default of predict_instances)."""
    rays = RaysJax(16)
    rng = np.random.RandomState(n)
    n_obj = n // 8
    centers = np.stack([rng.uniform(10, 50, n_obj), rng.uniform(10, 100, n_obj),
                        rng.uniform(10, 300, n_obj)], axis=1)
    obj = rng.randint(0, n_obj, n)
    points = np.round(centers[obj] + rng.normal(0, 1.5, (n, 3))).astype(np.float32)
    radii = rng.uniform(4, 7, n_obj)[obj]
    dist = (radii[:, None] * rng.uniform(0.85, 1.15, (n, 16))).astype(np.float32)
    Q = 64
    Npad = -(-n // Q) * Q
    d = np.full((Npad, 16), 1e-3, np.float32)
    d[:n] = dist
    p = np.zeros((Npad, 3), np.float32)
    p[:n] = points
    keep, flags, _ = _nms3d_banded_traced(
        jnp.asarray(d), jnp.asarray(p), jnp.asarray(rays.vertices, jnp.float32),
        jnp.asarray(rays.faces, jnp.int32), jnp.int32(n), jnp.float32(thresh), (1, 1, 1), 2,
        Q, Npad // Q, Q, Q * Q, S)
    assert all(bool(f) for f in flags)
    keep = np.asarray(keep)[:n]
    ray_dirs, faces = ray_tensors(Rays_GoldenSpiral(16))
    got = nms_polyhedra(torch.from_numpy(dist), torch.from_numpy(points), ray_dirs, faces,
                        thresh, samples=S).numpy()
    assert 0 < keep.sum() < n // 2
    assert np.array_equal(got, keep)


def test_predict_instances_device_equals_predict_instances(setup):
    """The 3D device path is predict_instances at the reference's device
    lattice, nms_kwargs={"samples": 10}."""
    img, _, _, tm = setup
    lab, det = tm.predict_instances(img, nms_kwargs={"samples": DEVICE_LATTICE_S})
    assert lab.max() > 3
    lab_d, det_d = tm.predict_instances_device(img)
    assert np.array_equal(lab_d, lab) and lab_d.dtype == np.int32
    _same(det_d, det)
    lab_t, det_t = tm.predict_instances_device(img, fetch=False)
    assert isinstance(lab_t, torch.Tensor) and lab_t.dtype == torch.int32
    assert all(isinstance(det_t[k], torch.Tensor) for k in ("dist", "points", "prob"))
    assert np.array_equal(lab_t.numpy(), lab)
    _same({k: det_t[k].numpy() for k in ("dist", "points", "prob")}, det)
    # a pre-staged tensor (already normalized, divisible by the stride)
    crop = img[:8, :16, :16]
    lab_x, _ = tm.predict_instances_device(torch.from_numpy(crop.copy()), prob_thresh=0.3)
    assert np.array_equal(lab_x, tm.predict_instances(
        crop, prob_thresh=0.3, nms_kwargs={"samples": DEVICE_LATTICE_S})[0])


@pytest.mark.parametrize("case", ["background", "full", "overlap", "positive overlap"])
def test_relabel_on_the_device_is_relabel_sequential(case):
    """torch.unique's inverse gives relabel_sequential's ids (0 kept), also
    without background and with a negative overlap label kept (reference
    model3d.py:386-394)."""
    rng = np.random.RandomState(1)
    lbl = rng.choice([0, 3, 9, 40, 41, 200], size=(6, 7, 8)).astype(np.int32)
    overlap = None
    if case == "full":
        lbl[lbl == 0] = 9
    elif case == "overlap":
        lbl[:2] = -1
        overlap = -1
    elif case == "positive overlap":
        overlap = 40
    got = _relabel_sequential(torch.from_numpy(lbl), overlap).numpy()
    if case == "overlap":
        m = lbl == -1
        want = np.where(m, lbl.max() + 1, lbl)
        want, fwd, _ = relabel_sequential(want)
        want[want == fwd[lbl.max() + 1]] = -1
    else:
        want = relabel_sequential(lbl)[0]
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_unported_arguments_still_raise(setup):
    """predict_sparse(device_dist=True), which raised until it was ported,
    keeps dist on the model's device, its rows exactly device_dist=False's
    (the volume pads: 16x40x40). Batch norm, which raised until it was
    ported, builds and serves in both backbones; its training raises (the
    reference cannot train one)."""
    img, _, _, tm = setup
    prob, dist, points = tm.predict_sparse(img, device_dist=True)
    assert isinstance(dist, torch.Tensor) and dist.device == tm.device and len(prob) > 10
    for a, b in zip((prob, dist.numpy(), points), tm.predict_sparse(img)):
        assert np.array_equal(a, b)
    for kw in (dict(unet_batch_norm=True), dict(backbone="resnet", resnet_batch_norm=True)):
        m = StarDist3D(Config3D(n_rays=8, **kw), basedir=None, device="cpu")
        prob, dist = m.predict(img[:8, :16, :16])
        assert prob.shape == (8, 16, 16) and np.isfinite(dist).all()
        with pytest.raises(NotImplementedError):
            m.prepare_for_training()
