"""stardist_torch's 2D network options against stardist_tpu's, on the CPU:
the activations outside the conv kernel's epilogue (tanh, sigmoid, swish,
gelu), U-Net kernel sizes other than 3x3 (5x5; 4x4, whose SAME padding is
asymmetric), batch norm (its statistics seeded, not flax's initial ones),
the weight files with ``batch_stats``, training (one step against
``jax.value_and_grad``; a batch-norm net refused by both packages) and the
TF export's replay of batch norm (tests/test_torch_netconfigs3d.py: 3D).

Both packages run the same variables: the port's seeded weights (and
statistics) written as the flax tree (``weights.flax_variables``), which
flax's ``apply`` takes only if every name and shape is the flax net's.
Tolerances: f32 forwards within 1e-4 (prob absolute, dist relative to its
largest magnitude); bf16 forwards within tests/test_conv_pallas.py's bf16
tolerances; one training step as tests/test_torch_train.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from stardist_torch.models import Config2D, StarDist2D
from stardist_torch.models.model2d import StarDistData2D
from stardist_torch.models.unet import BatchNorm, StarDistNet
from stardist_torch.models.weights import flax_variables, params_from_flax
from stardist_tpu.models import Config2D as Config2DJax, StarDist2D as StarDist2DJax
from stardist_tpu.models import losses as JL
from stardist_tpu.models.unet_chw import chw_forward
from utils import synthetic_nuclei_2d

torch.set_num_threads(2)
BASE = dict(n_rays=8, grid=(2, 2), unet_n_depth=2, unet_n_filter_base=8, net_conv_after_unet=16,
            train_patch_size=(32, 32), train_batch_size=2, train_reduce_lr=None)
ACTS = ("tanh", "sigmoid", "swish", "gelu")
CASES = {
    **{act: dict(unet_activation=act) for act in ACTS},
    "kernel5": dict(unet_kernel_size=(5, 5)),
    "kernel4": dict(unet_kernel_size=(4, 4)),        # even: asymmetric SAME padding
    "batch_norm": dict(unet_batch_norm=True),
    "batch_norm_elu_gelu": dict(unet_batch_norm=True, unet_activation="elu",
                                unet_last_activation="gelu", grid=(1, 1)),
}


def seed_batch_norm(net, seed):
    """Seeded, non-trivial batch norms: scale in [0.8, 1.2], bias and mean
    in +-0.1, var in [0.5, 2]."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                c = m.mean.shape[0]
                for t, lo, hi in ((m.scale, 0.8, 1.2), (m.bias, -0.1, 0.1),
                                  (m.mean, -0.1, 0.1), (m.var, 0.5, 2.0)):
                    t.copy_(torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32)))


def pair(Model, Config, JaxModel, JaxConfig, cfg, seed=0):
    """The port's model of ``cfg`` (seeded batch norms) and the reference's
    with the same variables."""
    tm = Model(Config(**cfg), basedir=None, device="cpu")
    seed_batch_norm(tm.net, seed)
    jm = JaxModel(JaxConfig(**cfg), basedir=None)
    v = flax_variables(tm.net)
    jm.params = v["params"]
    jm._extra_vars = {k: t for k, t in v.items() if k != "params"}
    return tm, jm


def split(outs):
    """(prob, dist channel-major) of flax's batch-of-one outputs."""
    return np.asarray(outs[0][0, ..., 0]), np.moveaxis(np.asarray(outs[1][0]), -1, 0)


def assert_close(prob, dist, prob_ref, dist_ref, tol):
    assert tuple(prob.shape) == prob_ref.shape and tuple(dist.shape) == dist_ref.shape
    assert np.abs(prob - prob_ref).max() < tol
    assert np.abs(dist - dist_ref).max() < tol * max(1.0, np.abs(dist_ref).max())


@pytest.fixture(scope="module")
def pairs():
    """One (port, reference) pair per case, made once for the file."""
    return {name: pair(StarDist2D, Config2D, StarDist2DJax, Config2DJax, dict(BASE, **kw), i)
            for i, (name, kw) in enumerate(CASES.items())}


def _image(shape, seed):
    return np.random.RandomState(seed).rand(*shape, 1).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_f32_matches_flax(pairs, case):
    tm, jm = pairs[case]
    x = _image((48, 64), 1)
    ref = jm.net.apply(jm._variables(), jnp.asarray(x[None]), train=False)
    prob, dist = tm.net(torch.from_numpy(x))
    assert_close(prob.numpy(), dist.numpy(), *split(ref), 1e-4)
    k = tuple(CASES[case].get("unet_kernel_size", (3, 3)))
    assert all(tuple(b.weight.shape[:2]) == k for b in tm.net.unet_blocks())
    assert len(tm.net.conv_blocks()) == (len(tm.net.unet_blocks()) if k == (3, 3) else 0)


@pytest.mark.parametrize("case,tol", [("tanh", 1e-3), ("sigmoid", 2e-2), ("swish", 2e-2),
                                      ("gelu", 2e-2), ("batch_norm", 5e-3),
                                      ("batch_norm_elu_gelu", 5e-3)])
def test_forward_bf16_matches_the_reference(pairs, case, tol, monkeypatch):
    """The activations against the Pallas path, ``chw_forward``: the
    kernel's linear output, then the activation in bf16 (its
    ``_conv_block`` has the branch, unet_chw.py:50-55, but its
    ``supports_chw`` keeps these nets on ``net.apply``: lifted here), at
    tests/test_conv_pallas.py:74-75's 1e-3 for tanh. jax's bf16 sigmoid,
    swish and gelu round about a third of their outputs one bf16 step away
    from torch's (which compute in f32 and round once), and every later
    layer carries that step: those take tests/test_conv_pallas.py:52's 2e-2
    for a bf16 output against a more exact one. Batch norm, which the Pallas
    path does not take, against flax's bf16 ``apply``, at the one-conv bf16
    tolerance of tests/test_conv_pallas.py:35: flax rounds the conv's output
    to bf16 before the batch norm and again after it, the port folds the
    batch norm into the weights."""
    import stardist_tpu.models.unet_chw as unet_chw
    tm, jm = pairs[case]
    x = _image((32, 48), 2)
    net_bf16 = dataclasses.replace(jm.net, dtype=jnp.bfloat16)
    if jm.net.unet_batch_norm:
        ref = split(net_bf16.apply(jm._variables(), jnp.asarray(x[None]), train=False))
    else:
        monkeypatch.setattr(unet_chw, "supports_chw", lambda net: True)
        ref = [np.asarray(a) for a in chw_forward(net_bf16, jm.params, jnp.asarray(x))]
    net = StarDistNet(tm.config, dtype=torch.bfloat16)
    net.load_state_dict(tm.net.state_dict())
    prob, dist = net(torch.from_numpy(x))
    assert_close(prob.numpy(), dist.numpy(), *ref, tol)


def test_batch_norm_placement_and_fold_cache(pairs):
    """Batch norm in the backbone's convs only (not the grid's pre-pooling
    convs or the feature conv, as flax builds them); the folded weights are
    cached, and made anew when the statistics change."""
    tm, _ = pairs["batch_norm"]
    net = tm.net
    assert all(b.bn is not None for b in net.backbone)
    assert all(b.bn is None for b in net.top)
    assert net.batch_norm and not pairs["gelu"][0].net.batch_norm
    blk = net.backbone[0]
    w1, b1 = blk.bn.fold(blk.weight, blk.bias)
    assert blk.bn.fold(blk.weight, blk.bias)[0] is w1
    with torch.no_grad():
        blk.bn.var.mul_(4.0)
    w2, b2 = blk.bn.fold(blk.weight, blk.bias)
    assert w2 is not w1 and torch.allclose(w2, w1 / 2, rtol=1e-3)
    with torch.no_grad():
        blk.bn.var.div_(4.0)


@pytest.mark.parametrize("case", ["batch_norm", "kernel4"])
def test_predict_instances_matches_the_reference(pairs, case):
    """Labels of both packages' predict_instances (f32), at a threshold
    that keeps a tenth of the pixels of the reference's prob map."""
    tm, jm = pairs[case]
    img, _ = synthetic_nuclei_2d((96, 128), n=12, seed=5)
    prob_map, _ = jm.predict(img)
    thresh = float(np.quantile(prob_map, 0.9))
    lab_j, det_j = jm.predict_instances(img, prob_thresh=thresh)
    lab_t, det_t = tm.predict_instances(img, prob_thresh=thresh)
    assert lab_t.max() > 0 and np.array_equal(lab_t, lab_j)
    assert np.array_equal(det_t["points"], det_j["points"])


def test_weight_files_both_ways(pairs, tmp_path):
    """The port writes flax's bytes of {"params", "batch_stats"}; each
    package loads the other's file."""
    tm, jm = pairs["batch_norm"]
    saved = StarDist2D(tm.config, "t", tmp_path, device="cpu")
    saved.net.load_state_dict(tm.net.state_dict())
    saved.save_weights("w.h5")
    want = serialization.to_bytes({"params": jm.params, **jm._extra_vars})
    assert (tmp_path / "t" / "w.h5").read_bytes() == want
    bumped = jax.tree_util.tree_map(lambda a: np.asarray(a) + 1, {"params": jm.params,
                                                                   **jm._extra_vars})
    (tmp_path / "j.h5").write_bytes(serialization.to_bytes(bumped))
    tm2 = StarDist2D(tm.config, basedir=None, device="cpu")
    tm2.load_weights(str(tmp_path / "j.h5"))
    ref = params_from_flax(tm2.net, bumped["params"], bumped["batch_stats"])
    sd = tm2.net.state_dict()
    assert set(sd) == set(ref) and any(k.endswith("bn.var") for k in sd)
    assert all(torch.equal(sd[k], ref[k]) for k in sd)
    jm2 = StarDist2DJax(jm.config, basedir=None)
    jm2.load_weights(str(tmp_path / "t" / "w.h5"))
    got = {"params": jm2.params, **jm2._extra_vars}
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(
            {"params": jm.params, **jm._extra_vars})):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        params_from_flax(tm2.net, bumped["params"])          # the statistics are needed


def _data(n=3, shape=(64, 64)):
    out = [synthetic_nuclei_2d(shape, seed=i) for i in range(n)]
    return [x for x, _ in out], [y.astype(np.int32) for _, y in out]


def one_step_vs_jax(tm, jm, t, n_rays, grad_tol=1e-4):
    """One training step's loss, metrics and gradients of the port against
    the reference's loss under jax.value_and_grad (its prepare_for_training,
    train=True)."""
    batch = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    R = n_rays

    def loss_and_metrics(params):
        prob, dist = jm.net.apply({"params": params}, batch["x"], train=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        dt, dm = batch["dist"][..., :R], batch["dist"][..., R:]
        lp = JL.prob_loss(batch["prob"][..., 0], prob[..., 0])
        ld = JL.dist_loss(dt, dm, dist, kind="mae", reg_weight=1e-4)
        loss = lp + 0.2 * ld
        return loss, {"loss": loss, "prob_loss": lp, "dist_loss": ld,
                      "prob_kld": JL.kld_metric(batch["prob"][..., 0], prob[..., 0]),
                      "dist_relevant_mae": JL.relevant_mae(dt, dm, dist),
                      "dist_relevant_mse": JL.relevant_mse(dt, dm, dist),
                      "dist_dist_iou_metric": JL.dist_iou_metric(dt, dm, dist)}

    (_, mj), gj = jax.value_and_grad(loss_and_metrics, has_aux=True)(jm.params)
    loss, mt = tm._loss_and_metrics(t)
    loss.backward()
    for k, v in mj.items():
        assert abs(float(mt[k]) - float(v)) <= 1e-5 * abs(float(v)), k
    ref = params_from_flax(tm.net, jax.tree_util.tree_map(np.asarray, gj))
    assert set(ref) == {n for n, _ in tm.net.named_parameters()}
    for name, p in tm.net.named_parameters():
        g, r = p.grad.numpy(), ref[name].numpy()
        assert np.abs(g - r).max() <= grad_tol * np.abs(r).max(), name


def test_one_step_equals_jax_value_and_grad_gelu_5x5():
    cfg = dict(BASE, unet_n_depth=1, unet_activation="gelu", unet_kernel_size=(5, 5))
    tm, jm = pair(StarDist2D, Config2D, StarDist2DJax, Config2DJax, cfg)
    tm.prepare_for_training()
    imgs, lbls = _data()
    data = StarDistData2D(imgs, lbls, batch_size=2, n_rays=8, length=1, patch_size=(32, 32),
                          grid=(2, 2), foreground_prob=0.9)
    np.random.seed(3)
    one_step_vs_jax(tm, jm, tm._targets_fn(tm._put_batch(data.raw_item(0))), 8)


def test_batch_norm_training_raises_in_both(pairs):
    """The reference's training applies the net without a mutable
    batch_stats (stardist_tpu/models/base.py:675-677): flax refuses; the
    port refuses up front."""
    from flax.errors import ModifyScopeVariableError
    imgs, lbls = _data(2)
    tm, jm = pairs["batch_norm"]
    with pytest.raises(ModifyScopeVariableError):
        jm.train(imgs, lbls, validation_data=(imgs[:1], lbls[:1]), epochs=1, steps_per_epoch=1)
    with pytest.raises(NotImplementedError):
        tm.train(imgs, lbls, validation_data=(imgs[:1], lbls[:1]), epochs=1, steps_per_epoch=1)
    with pytest.raises(NotImplementedError):
        tm.net.train_forward(torch.zeros(1, 16, 16, 1))


@pytest.mark.parametrize("kw,fails", [
    (dict(grid=(1, 1), net_conv_after_unet=0), False),
    (dict(grid=(2, 2), net_conv_after_unet=0), True),       # the pre-pooling convs
    (dict(grid=(1, 1), net_conv_after_unet=16), True),      # the feature conv
])
def test_export_replay_of_batch_norm_fails_where_the_reference_does(kw, fails):
    """The TF replay of a batch-norm U-Net: the port's and the reference's
    give the port's forward where the net has neither grid pre-pooling nor
    a feature conv, and both raise KeyError('BatchNorm_0') where it has
    one (the reference's replay gives those convs a batch norm that flax
    does not)."""
    pytest.importorskip("tensorflow")
    import tensorflow as tf
    from stardist_torch.models.export_tf import build_tf_forward
    from stardist_tpu.models.export_tf import build_tf_forward as build_tf_forward_jax
    cfg = dict(BASE, unet_batch_norm=True, **kw)
    tm, jm = pair(StarDist2D, Config2D, StarDist2DJax, Config2DJax, cfg, seed=7)
    v = flax_variables(tm.net)
    x = _image((32, 32), 3)
    fwd = build_tf_forward(tm.config, v["params"], v["batch_stats"])
    fwd_jax = build_tf_forward_jax(jm.net, jm.params, jm._extra_vars)
    if fails:
        for f in (fwd, fwd_jax):
            with pytest.raises(KeyError, match="BatchNorm_0"):
                f(tf.constant(x[None]))
        return
    prob, dist = tm.net(torch.from_numpy(x))
    for f in (fwd, fwd_jax):
        out = f(tf.constant(x[None]))
        assert_close(prob.numpy(), dist.numpy(), *split([o.numpy() for o in out]), 1e-4)
