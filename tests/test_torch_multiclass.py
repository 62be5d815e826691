"""Multiclass StarDist in stardist_torch against stardist_tpu, on the CPU.

Inputs are made from numpy seeds; the weights go from the JAX package to
the port through ``models/weights.py``. Tolerances:
- class maps (``mask_to_categorical``, the training data's class targets),
  weight files, and every decision after the network (survivors, labels,
  ``class_prob``, ``class_id``, the 4-tuple of ``predict_sparse``) exactly,
  the last with the port's net answering with the reference's own f32
  forward (:func:`reference_forward`): everything after the forward is the
  port's code on the reference's numbers;
- the float32 forward within 1e-5 (prob and prob_class absolute, dist
  relative to max(1, |dist|max)), the convolutions summing in another
  order on each side;
- one training step's loss, prob_class_loss and metrics within rtol 1e-5,
  each gradient within 1e-4 of the parameter's largest |grad| (1e-3 for the
  ResNet, as tests/test_torch_train3d.py explains);
- a short training's history within rtol 1e-3 (tests/test_torch_train.py);
- the whole f32 pipeline with the port's own forward: survivors within one,
  matching accuracy >= 0.98 (tests/test_torch_predict.py), and the class
  rows of the survivors both find within 1e-5.
"""
import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import stardist_tpu.utils as jutils
from stardist_torch import utils as tutils
from stardist_torch.matching import matching
from stardist_torch.models import Config2D, Config3D, StarDist2D, StarDist3D
from stardist_torch.models.model2d import StarDistData2D
from stardist_torch.models.model3d import StarDistData3D
from stardist_torch.models.weights import params_from_flax
from stardist_tpu.models import Config2D as Config2DJax, Config3D as Config3DJax
from stardist_tpu.models import StarDist2D as StarDist2DJax, StarDist3D as StarDist3DJax
from stardist_tpu.models import losses as JL
from stardist_tpu.models.model2d import StarDistData2D as StarDistData2DJax
from stardist_tpu.models.model3d import StarDistData3D as StarDistData3DJax
from utils import synthetic_nuclei_2d, synthetic_nuclei_3d

torch.set_num_threads(2)

FWD_TOL = 1e-5
SMALL = {
    "2d-unet-3ch": (2, dict(n_rays=8, grid=(2, 2), n_channel_in=3, n_classes=3, unet_n_depth=1,
                            unet_n_filter_base=8, net_conv_after_unet=8,
                            train_patch_size=(32, 32), train_batch_size=2,
                            train_reduce_lr=None)),
    "3d-unet": (3, dict(n_rays=8, grid=(1, 2, 2), n_classes=2, unet_n_depth=1,
                        unet_n_filter_base=8, net_conv_after_unet=8,
                        train_patch_size=(16, 32, 32), train_batch_size=2,
                        train_reduce_lr=None)),
    "3d-resnet": (3, dict(n_rays=8, grid=(1, 2, 2), n_classes=2, backbone="resnet",
                          resnet_n_blocks=2, resnet_n_filter_base=8, net_conv_after_resnet=16,
                          train_patch_size=(16, 32, 32), train_batch_size=2,
                          train_reduce_lr=None)),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(name):
    """A seeded JAX model of SMALL[name] and the port's model with its weights."""
    nd, kw = SMALL[name]
    if nd == 2:
        jm = StarDist2DJax(Config2DJax(**kw), name="j", basedir=None)
        tm = StarDist2D(Config2D(**kw), basedir=None, device="cpu")
    else:
        jm = StarDist3DJax(Config3DJax(**kw), name="j", basedir=None)
        tm = StarDist3D(Config3D(**kw), basedir=None, device="cpu")
    tm.net.load_state_dict(params_from_flax(tm.net, _np(jm.params)))
    return jm, tm


@pytest.fixture(scope="module")
def small():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _pair(name)
        return cache[name]
    return get


def _grafted(name, n_classes, seed=0):
    """``models/examples/<name>`` with a class branch: the JAX model of its
    config with ``n_classes`` (seeded class weights), the demo's weights
    everywhere else; and the port's model with the same weights."""
    cfg = json.load(open(f"models/examples/{name}/config.json"))
    cfg = {k: v for k, v in cfg.items() if k not in ("n_dim", "n_channel_out")}
    cfg.update(n_classes=n_classes, train_loss_weights=(1, 0.2, 1),
               train_class_weights=(1,) * (n_classes + 1))
    J, JC, T, TC = ((StarDist2DJax, Config2DJax, StarDist2D, Config2D) if name.startswith("2D")
                    else (StarDist3DJax, Config3DJax, StarDist3D, Config3D))
    demo = J(None, name, "models/examples")
    jm = J(JC(**cfg), name="j", basedir=None)
    params = dict(_np(jm.params))
    params.update(_np(demo.params))
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    jm.thresholds = demo.thresholds._asdict()
    tm = T(TC(**cfg), basedir=None, device="cpu")
    tm.net.load_state_dict(params_from_flax(tm.net, params))
    tm.thresholds = jm.thresholds
    return jm, tm


@pytest.fixture(scope="module")
def demo2d():
    return _grafted("2D_demo", 3)


@pytest.fixture(scope="module")
def demo3d():
    return _grafted("3D_demo", 2)


@contextlib.contextmanager
def reference_forward(tm, jm):
    """The port's net answers with the reference's jitted f32 forward
    (``_forward_fn``: unbatched, channel-major, as the port's forward), so
    that what follows the forward sees the same numbers in both packages."""
    fwd = jm._forward_fn()
    tm.net.forward = lambda x, plain=False: tuple(
        torch.from_numpy(np.array(o)) for o in fwd(jm.params, jm._extra_vars, x.numpy()[None]))
    try:
        yield
    finally:
        del tm.net.forward


def _same_details(dt, dj, keys=("points", "prob", "class_prob", "class_id"), n_min=4):
    assert len(dj["prob"]) >= n_min
    for k in keys:
        assert dt[k].shape == dj[k].shape and np.array_equal(dt[k], dj[k]), k
    assert dt["class_id"].dtype == dj["class_id"].dtype


# -- class maps -----------------------------------------------------------

def _labels(seed=0):
    return synthetic_nuclei_2d((64, 64), n=12, seed=seed)[1].astype(np.int32)


@pytest.mark.parametrize("kind", ["int", "none", "dict", "dict_with_none", "cls_dict"])
def test_mask_to_categorical_equals_reference(kind):
    y = _labels()
    ids = np.unique(y[y > 0])
    rng = np.random.RandomState(1)
    classes = {"int": 2, "none": None, "cls_dict": {int(i): int(rng.randint(0, 4)) for i in ids},
               "dict": {int(i): int(rng.randint(1, 4)) for i in ids},
               "dict_with_none": {int(i): (None if i % 3 == 0 else int(i) % 3 + 1)
                                  for i in ids}}[kind]
    got = tutils.mask_to_categorical(y, 3, classes, return_cls_dict=kind == "cls_dict")
    want = jutils.mask_to_categorical(y, 3, classes, return_cls_dict=kind == "cls_dict")
    if kind == "cls_dict":
        assert dict(got[1]) == dict(want[1])
        got, want = got[0], want[0]
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    if kind in ("none", "dict_with_none"):
        assert (got[..., 1:] == -1).any()


def test_mask_to_categorical_errors_follow_the_reference():
    y = _labels()
    for args in ((y, 0, 1), (y, 2, 3), (y, 2, {1: 1}), (y, 2, "a"), (y.astype(float), 2, 1)):
        for f in (tutils.mask_to_categorical, jutils.mask_to_categorical):
            with pytest.raises(ValueError):
                f(*args)


def _class_data(nd, classes_of, neg=True):
    if nd == 2:
        out = [synthetic_nuclei_2d((64, 64), n=14, seed=i) for i in range(3)]
    else:
        out = [synthetic_nuclei_3d((24, 48, 48), n=14, seed=i) for i in range(3)]
    X, Y = [x for x, _ in out], [y.astype(np.int32) for _, y in out]
    if neg:
        Y[1][Y[1] % 2 == 1] = -1                      # ignored pixels
    classes = [{int(i): classes_of(i) for i in np.unique(y[y > 0])} for y in Y]
    return X, Y, classes


@pytest.mark.parametrize("nd", [2, 3])
def test_class_targets_equal_reference(nd):
    """StarDistData2D / 3D's targets with classes, negative labels and a
    grid: every target bit for bit, the class maps brought to the grid by
    the reference's order-0 zoom."""
    X, Y, classes = _class_data(nd, lambda i: int(i) % 3 + 1)
    if nd == 2:
        kw = dict(n_rays=8, grid=(2, 2), patch_size=(32, 32))
        T, J = StarDistData2D, StarDistData2DJax
    else:
        from stardist_torch.rays3d import Rays_GoldenSpiral
        from stardist_tpu.rays3d import Rays_GoldenSpiral as RaysJax
        kw = dict(grid=(1, 2, 2), patch_size=(16, 32, 32))
        T, J = ((lambda *a, **k: StarDistData3D(*a, rays=Rays_GoldenSpiral(8), **k)),
                (lambda *a, **k: StarDistData3DJax(*a, rays=RaysJax(8), **k)))
    common = dict(batch_size=3, length=2, n_classes=3, classes=classes, foreground_prob=0.9, **kw)
    for i in range(2):
        np.random.seed(5 + i)
        (xt,), yt = T(X, Y, device="cpu", **common)[i]
        np.random.seed(5 + i)
        (xj,), yj = J(X, Y, **common)[i]
        assert np.array_equal(xt, xj) and len(yt) == len(yj) == 3
        for a, b in zip(yt, yj):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert (yt[2] == -1).any() and yt[2].shape[-1] == 4


# -- network, weights, training ---------------------------------------------

def _input(nd, kw, seed=0):
    shape = (32, 48) if nd == 2 else (16, 32, 32)
    return np.random.RandomState(seed).rand(*shape, kw.get("n_channel_in", 1)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_forward_equals_reference(small, name):
    jm, tm = small(name)
    nd, kw = SMALL[name]
    x = _input(nd, kw)
    prob, dist, pc = tm.net(torch.from_numpy(x))
    rp, rd, rpc = (np.asarray(o[0]) for o in jm.net.apply({"params": jm.params}, x[None]))
    assert pc.shape == (kw["n_classes"] + 1,) + prob.shape
    np.testing.assert_allclose(pc.sum(0).numpy(), 1, atol=1e-6)
    assert np.abs(prob.numpy() - rp[..., 0]).max() <= FWD_TOL
    assert np.abs(pc.movedim(0, -1).numpy() - rpc).max() <= FWD_TOL
    assert np.abs(dist.movedim(0, -1).numpy() - rd).max() <= FWD_TOL * max(1, np.abs(rd).max())
    # the inference route (bf16 on the card) and the training route share the branch
    tp, td, tpc = tm.net.train_forward(torch.from_numpy(x[None]))
    assert torch.allclose(tpc[0], pc.movedim(0, -1), atol=1e-6)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_weight_files_both_ways(tmp_path, small, name):
    jm, _ = small(name)
    nd, kw = SMALL[name]
    T, TC = (StarDist2D, Config2D) if nd == 2 else (StarDist3D, Config3D)
    tm = T(TC(**kw), name="t", basedir=tmp_path, device="cpu")
    tm.net.load_state_dict(params_from_flax(tm.net, _np(jm.params)))
    tm.save_weights("w.h5")                              # the bytes flax writes
    assert (tmp_path / "t" / "w.h5").read_bytes() == serialization.to_bytes({"params": jm.params})
    moved = jax.tree_util.tree_map(lambda a: a + 1, jm.params)
    (tmp_path / "j").write_bytes(serialization.to_bytes({"params": moved}))
    tm.load_weights(str(tmp_path / "j"))
    ref = params_from_flax(tm.net, _np(moved))
    assert "head_prob_class.weight" in ref
    assert all(torch.equal(v, ref[k]) for k, v in tm.net.state_dict().items())
    back = serialization.from_bytes({"params": jm.params}, (tmp_path / "t" / "w.h5").read_bytes())
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(_np(back)),
                                                     jax.tree_util.tree_leaves(_np(jm.params))))


@pytest.mark.parametrize("name,grad_tol", [("2d-unet-3ch", 1e-4), ("3d-unet", 1e-4),
                                           ("3d-resnet", 1e-3)])
def test_one_step_equals_jax_value_and_grad(small, name, grad_tol):
    """One step on the host targets (with class maps and ignored pixels):
    loss, prob_class_loss and the metrics, and every gradient."""
    jm, tm = small(name)
    nd, kw = SMALL[name]
    X, Y, classes = _class_data(nd, lambda i: int(i) % 3 + 1)
    if nd == 3:
        X = [x[..., None] for x in X]
        data = StarDistData3D(X, Y, rays=tm.rays, batch_size=2, length=1, n_classes=2,
                              classes=[{k: min(v, 2) for k, v in c.items()} for c in classes],
                              patch_size=kw["train_patch_size"], grid=kw["grid"],
                              foreground_prob=0.9, device="cpu")
    else:
        X = [np.stack([x, x ** 2, 1 - x], -1) for x in X]
        data = StarDistData2D(X, Y, n_rays=8, batch_size=2, length=1, n_classes=3,
                              classes=classes, patch_size=kw["train_patch_size"],
                              grid=kw["grid"], foreground_prob=0.9, device="cpu")
    np.random.seed(3)
    (x,), (prob, dist, prob_class) = data[0]
    batch = {"x": x, "prob": prob, "dist": dist, "prob_class": prob_class}
    R = kw["n_rays"]
    w = tm.config.train_loss_weights
    cw = tuple(tm.config.train_class_weights)

    def loss_and_metrics(params):         # the reference's prepare_for_training, train=True
        p, d, pc = jm.net.apply({"params": params}, batch["x"], train=True,
                                rngs={"dropout": jax.random.PRNGKey(0)})
        dt, dm = batch["dist"][..., :R], batch["dist"][..., R:]
        lp = JL.prob_loss(batch["prob"][..., 0], p[..., 0])
        ld = JL.dist_loss(dt, dm, d, kind="mae", reg_weight=1e-4)
        lc = JL.class_loss(batch["prob_class"], pc, cw)
        loss = w[0] * lp + w[1] * ld + w[2] * lc
        return loss, {"loss": loss, "prob_loss": lp, "dist_loss": ld, "prob_class_loss": lc,
                      "prob_kld": JL.kld_metric(batch["prob"][..., 0], p[..., 0]),
                      "dist_relevant_mae": JL.relevant_mae(dt, dm, d),
                      "dist_relevant_mse": JL.relevant_mse(dt, dm, d),
                      "dist_dist_iou_metric": JL.dist_iou_metric(dt, dm, d)}

    (_, mj), gj = jax.value_and_grad(loss_and_metrics, has_aux=True)(jm.params)
    tm.net.zero_grad()
    loss, mt = tm._loss_and_metrics({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert list(mt) == list(tm._metric_names()) and mt["prob_class_loss"] > 0
    for k, v in mj.items():
        assert abs(float(mt[k]) - float(v)) <= 1e-5 * abs(float(v)), k
    ref = params_from_flax(tm.net, _np(gj))
    for pname, p in tm.net.named_parameters():
        g, r = p.grad.numpy(), ref[pname].numpy()
        assert np.abs(g - r).max() <= grad_tol * np.abs(r).max(), pname
    assert np.abs(ref["head_prob_class.weight"].numpy()).max() > 0


def test_short_training_history_equals_jax(tmp_path):
    """train(seed=7, 2 epochs x 2 steps) of a three-channel multiclass
    model in both packages from the same weights (the class targets built
    on the host in both): the same history keys in the reference's order,
    within rtol 1e-3, prob_class_loss among them."""
    _, kw = SMALL["2d-unet-3ch"]
    X, Y, classes = _class_data(2, lambda i: int(i) % 3 + 1)
    X = [np.stack([x, x ** 2, 1 - x], -1) for x in X]
    jm = StarDist2DJax(Config2DJax(**kw), name="j", basedir=None)
    tm = StarDist2D(Config2D(**kw), name="t", basedir=tmp_path, device="cpu")
    tm.net.load_state_dict(params_from_flax(tm.net, _np(jm.params)))
    val = (X[:1], Y[:1], classes[:1])
    hj = jm.train(X, Y, classes=classes, validation_data=val, seed=7, epochs=2, steps_per_epoch=2)
    ht = tm.train(X, Y, classes=classes, validation_data=val, seed=7, epochs=2,
                  steps_per_epoch=2)
    assert sorted(ht.history) == sorted(hj.history) and "val_prob_class_loss" in ht.history
    for k, v in hj.history.items():
        np.testing.assert_allclose(ht.history[k], v, rtol=1e-3, err_msg=k)
    assert tm._targets_fn is None and len(ht.steps["prob_class_loss"]) == 4
    lines = (tmp_path / "t" / "logs" / "history.jsonl").read_text().splitlines()
    assert "prob_class_loss" in json.loads(lines[-1])


# -- prediction ---------------------------------------------------------------

@pytest.fixture(scope="module")
def img2d():
    return synthetic_nuclei_2d((200, 232), seed=3)[0]


@pytest.mark.parametrize("kw", [{}, {"n_tiles": (2, 2)}, {"sparse": False}, {"scale": 0.75}],
                         ids=["untiled", "tiled", "dense", "scale"])
def test_instances_equal_reference(demo2d, img2d, kw):
    """2D_demo with a class branch: on the reference's forward, the port's
    extraction, NMS, raster and class rows give exactly the reference's
    survivors, labels, class_prob and class_id."""
    jm, tm = demo2d
    lj, dj = jm.predict_instances(img2d, **kw)
    with reference_forward(tm, jm):
        lt, dt = tm.predict_instances(img2d, **kw)
    assert np.array_equal(lt, lj)
    _same_details(dt, dj, ("points", "prob", "coord", "class_prob", "class_id"))
    assert np.array_equal(dt["class_id"], np.argmax(dt["class_prob"], -1))


def test_predict_sparse_and_dense_class_maps(demo2d, img2d):
    """predict_sparse's 4-tuple (prob, dist, prob_class, points) and
    predict's prob_class, on the reference's forward: exactly the
    reference's; return_predict hands back the three dense maps."""
    jm, tm = demo2d
    with reference_forward(tm, jm):
        got = tm.predict_sparse(img2d)
        dense = tm.predict(img2d)
        (_, det), pred = tm.predict_instances(img2d, return_predict=True)
    want = jm.predict_sparse(img2d)
    assert len(got) == len(want) == 4 and got[2].shape == (len(got[0]), 4)
    for a, b in zip(got, want):
        assert np.array_equal(a, np.asarray(b))
    for a, b in zip(dense, jm.predict(img2d)):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert len(pred) == 3 and np.array_equal(pred[2], dense[2])
    # the survivors' rows are the dense map's at their grid points
    g = np.array(tm.config.grid)
    assert np.array_equal(det["class_prob"], dense[2][tuple((det["points"] // g).T)])


def test_predict_instances_agrees_with_reference(demo2d, img2d):
    """The whole f32 pipeline with the port's own forward."""
    jm, tm = demo2d
    lj, dj = jm.predict_instances(img2d)
    lt, dt = tm.predict_instances(img2d)
    assert abs(len(dt["prob"]) - len(dj["prob"])) <= 1
    assert matching(lj, lt, thresh=0.5).accuracy >= 0.98
    common = {tuple(p): i for i, p in enumerate(dj["points"].tolist())}
    pairs = [(i, common[tuple(p)]) for i, p in enumerate(dt["points"].tolist())
             if tuple(p) in common]
    assert len(pairs) >= len(dj["prob"]) - 1
    it, ij = np.array(pairs).T
    assert np.abs(dt["class_prob"][it] - dj["class_prob"][ij]).max() <= FWD_TOL
    top2 = np.sort(dj["class_prob"][ij], -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * FWD_TOL
    assert np.array_equal(dt["class_id"][it][clear], dj["class_id"][ij][clear])


def test_device_path_2d(demo2d, img2d):
    """predict_instances_device: the reference's device path on its own
    forward, exactly; fetch=False keeps the class rows as tensors."""
    jm, tm = demo2d
    img = img2d[:192, :224]
    lj, dj = jm.predict_instances_device(img)
    with reference_forward(tm, jm):
        lt, dt = tm.predict_instances_device(img)
        lf, df = tm.predict_instances_device(torch.from_numpy(img), fetch=False)
    assert np.array_equal(lt, lj)
    _same_details(dt, dj)
    assert all(isinstance(df[k], torch.Tensor) for k in ("class_prob", "class_id", "prob"))
    assert np.array_equal(lf.numpy(), lt)
    assert np.array_equal(df["class_prob"].numpy(), dt["class_prob"])
    assert np.array_equal(df["class_id"].numpy(), dt["class_id"])


@pytest.fixture(scope="module")
def img3d():
    return synthetic_nuclei_3d((16, 40, 40), n=14, seed=2)[0]


@pytest.mark.parametrize("kw", [{}, {"sparse": False}], ids=["sparse", "dense"])
def test_instances_equal_reference_3d(demo3d, img3d, kw):
    """3D_demo with a class branch, on the reference's forward: the
    survivors, labels and class rows exactly the reference's (its sparse
    NMS sorts twice; the class rows follow both permutations)."""
    jm, tm = demo3d
    kw = dict(kw, prob_thresh=0.7)          # fewer candidates: the 3D NMS is slow on the CPU
    lj, dj = jm.predict_instances(img3d, **kw)
    with reference_forward(tm, jm):
        lt, dt = tm.predict_instances(img3d, **kw)
        if "sparse" not in kw:
            # the device path runs the reference's device lattice, S = 10
            ld, dd = tm.predict_instances_device(img3d, prob_thresh=0.7)
            lf, df = tm.predict_instances_device(img3d, prob_thresh=0.7, fetch=False)
            l10, d10 = tm.predict_instances(img3d, nms_kwargs={"samples": 10}, **kw)
    assert np.array_equal(lt, lj)
    _same_details(dt, dj, ("points", "prob", "dist", "class_prob", "class_id"), n_min=3)
    if "sparse" not in kw:
        lj10, dj10 = jm.predict_instances(img3d, nms_kwargs={"samples": 10}, **kw)
        assert np.array_equal(l10, lj10) and np.array_equal(ld, l10)
        _same_details(d10, dj10, n_min=3)
        _same_details(dd, d10, n_min=3)
        assert isinstance(df["class_id"], torch.Tensor)
        assert np.array_equal(df["class_prob"].numpy(), d10["class_prob"])


def test_three_channel_input_predicts_as_the_reference(small):
    """A three-channel image (an H&E-like input, its channels on their own
    scales) through predict_instances with a per-channel percentile
    normalizer, on the reference's forward: the port's normalised, padded
    input and everything after the forward equal the reference's."""
    from stardist_torch.core.normalize import PercentileNormalizer
    from stardist_tpu.core.normalize import PercentileNormalizer as PercentileNormalizerJax
    jm, tm = small("2d-unet-3ch")
    img = synthetic_nuclei_2d((60, 76), seed=5)[0]
    img = np.stack([255 * img, 7 * img ** 2, 1 - img], -1)
    prob, _ = jm.predict(img, normalizer=PercentileNormalizerJax(1, 99.8))[:2]
    thresh = float(np.quantile(prob, 0.9))
    lj, dj = jm.predict_instances(img, normalizer=PercentileNormalizerJax(1, 99.8),
                                  prob_thresh=thresh)
    seen = []
    with reference_forward(tm, jm):
        inner = tm.net.forward
        tm.net.forward = lambda x, plain=False: (seen.append(x), inner(x))[1]
        lt, dt = tm.predict_instances(img, normalizer=PercentileNormalizer(1, 99.8),
                                      prob_thresh=thresh)
    assert np.array_equal(lt, lj)
    _same_details(dt, dj)
    x = seen[0].numpy()                              # each channel normalised on its own
    assert x.shape == img.shape and np.allclose(np.percentile(x, 99.8, (0, 1)), 1, atol=1e-5)


def test_optimize_thresholds_on_a_multiclass_model(demo2d, tmp_path):
    """The threshold search reads a multiclass model's prob and dist maps:
    on the grafted 2D_demo it finds exactly what it finds on 2D_demo."""
    _, tm = demo2d
    plain = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
    X, Y = zip(*(synthetic_nuclei_2d((96, 96), n=10, seed=s) for s in (1, 2)))
    kw = dict(nms_threshs=(0.3, 0.5), optimize_kwargs=dict(maxiter=6), save_to_json=False)
    assert tm.optimize_thresholds(X, Y, **kw) == plain.optimize_thresholds(X, Y, **kw)
    assert tm.thresholds._fields == ("prob", "nms")
