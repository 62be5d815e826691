"""stardist_torch's 2D training against the JAX package's, on the CPU.

Tolerances, with float32 convolutions summed in another order on each side:
one step's loss and metrics within rtol 1e-5 and each parameter's gradient
within 1e-4 of its largest magnitude; a short training's history within rtol
1e-3 and its parameters within 2 * lr * steps (Adam's first steps move a
parameter by about lr * sign(g), so a gradient near 0 whose sign differs
moves it the other way). Weight files are exact both ways. Resume is
bitwise."""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from stardist_torch.models import Config2D, StarDist2D
from stardist_torch.models.model2d import StarDistData2D
from stardist_torch.models.unet import dropout
from stardist_torch.models.weights import params_from_flax
from stardist_torch.ops import conv as tconv
from stardist_tpu.models import Config2D as Config2DJax, StarDist2D as StarDist2DJax
from stardist_tpu.models import losses as JL
from utils import synthetic_nuclei_2d

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
CFG = dict(n_rays=8, grid=(2, 2), unet_n_depth=1, unet_n_filter_base=8, net_conv_after_unet=8,
           train_patch_size=(32, 32), train_batch_size=2, train_reduce_lr=None)


def _data(n=3, shape=(64, 64)):
    out = [synthetic_nuclei_2d(shape, seed=i) for i in range(n)]
    return [x for x, _ in out], [y.astype(np.int32) for _, y in out]


@pytest.fixture(scope="module")
def jax_model():
    """One JAX model of CFG for the file (its construction compiles for
    seconds); the training test, which changes its weights, runs last."""
    return StarDist2DJax(Config2DJax(**CFG), name="j", basedir=None)


def _carry(tm, jm):
    """The JAX model's weights into the port's."""
    tm.net.load_state_dict(params_from_flax(tm.net, jax.tree_util.tree_map(np.asarray, jm.params)))


def test_init_follows_flax_initializers():
    """glorot-uniform conv kernels, lecun-normal (truncated at 2 std) heads,
    zero biases: the bounds and stds of flax's initializers on the same
    shapes; drawn from a seeded CPU generator, so every model starts alike."""
    from flax.linen import initializers
    kw = dict(n_rays=32, grid=(2, 2), unet_n_depth=2, unet_n_filter_base=16,
              net_conv_after_unet=64)
    sd = StarDist2D(Config2D(**kw), basedir=None, device="cpu").net.state_dict()
    key = jax.random.PRNGKey(0)
    for name, w in sd.items():
        if name.endswith("bias"):
            assert not w.any(), name
            continue
        if "head" in name:                 # flax's 1x1 kernels: (1, 1, C, Cout)
            r = initializers.lecun_normal()(key, (1, 1) + tuple(w.shape))
            std = np.sqrt(1.0 / w.shape[0])
            bound = 2 * std / .87962566103423978
        else:
            r = initializers.glorot_uniform()(key, tuple(w.shape))
            bound = np.sqrt(6.0 / (9 * (w.shape[-2] + w.shape[-1])))
            std = bound / np.sqrt(3)
        r = np.asarray(r)
        assert w.abs().max().item() <= bound and np.abs(r).max() <= bound, name
        if w.numel() >= 1000:
            assert abs(w.std().item() / std - 1) < 0.1 and abs(r.std() / std - 1) < 0.1, name
            assert abs(w.std().item() / r.std() - 1) < 0.1, name
    again = StarDist2D(Config2D(**kw), basedir=None, device="cpu").net.state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_construction_writes_config_json(tmp_path):
    cfg = Config2D(**CFG)
    StarDist2D(cfg, "m", tmp_path, device="cpu")
    saved = json.loads((tmp_path / "m" / "config.json").read_text())
    assert saved == json.loads(json.dumps(cfg.to_dict()))
    loaded = StarDist2D(None, "m", tmp_path, device="cpu").config
    assert json.loads(json.dumps(vars(loaded))) == saved


def test_one_step_equals_jax_value_and_grad(jax_model):
    imgs, lbls = _data()
    jm = jax_model
    tm = StarDist2D(Config2D(**CFG), basedir=None, device="cpu")
    tm.prepare_for_training()
    _carry(tm, jm)
    data = StarDistData2D(imgs, lbls, batch_size=2, n_rays=8, length=1, patch_size=(32, 32),
                          grid=(2, 2), foreground_prob=0.9)
    np.random.seed(3)
    raw = data.raw_item(0)
    t = tm._targets_fn(tm._put_batch(raw))        # equal to JAX's: test_torch_targets.py
    batch = {k: jnp.asarray(v.numpy()) for k, v in t.items()}

    def loss_and_metrics(params):        # the reference's prepare_for_training, train=True
        prob, dist = jm.net.apply({"params": params}, batch["x"], train=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        dt, dm = batch["dist"][..., :8], batch["dist"][..., 8:]
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
    for name, p in tm.net.named_parameters():
        g, r = p.grad.numpy(), ref[name].numpy()
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), name


def test_weight_files_both_ways(tmp_path, jax_model):
    jm = jax_model
    tm = StarDist2D(Config2D(**CFG), name="t", basedir=tmp_path, device="cpu")
    _carry(tm, jm)
    tm.save_weights("w.h5")                            # the bytes flax writes
    assert (tmp_path / "t" / "w.h5").read_bytes() == serialization.to_bytes({"params": jm.params})
    (tmp_path / "j").write_bytes(serialization.to_bytes(
        {"params": jax.tree_util.tree_map(lambda a: a + 1, jm.params)}))   # as save_weights
    tm.load_weights(str(tmp_path / "j"))                # an absolute path
    ref = params_from_flax(tm.net, jax.tree_util.tree_map(lambda a: np.asarray(a) + 1, jm.params))
    assert all(torch.equal(v, ref[k]) for k, v in tm.net.state_dict().items())


@pytest.mark.parametrize("foreach", [False, True])
def test_the_packed_weights_follow_adam_and_load_state_dict(foreach):
    """The conv kernel's packed weights are cached on the weight tensor and
    keyed on its version; Adam's in-place updates (either implementation)
    and load_state_dict bump it, so the next pack is of the new weights."""
    tm = StarDist2D(Config2D(**CFG), basedir=None, device="cpu")
    blk = tm.net.backbone[0]
    plan = tconv.conv_plan((16, 16), blk.weight.shape[-2], blk.weight.shape[-1])
    with torch.no_grad():
        first = tconv._packed(blk.weight, blk.bias, plan, 0)[0].clone()
    opt = torch.optim.Adam(tm.net.parameters(), lr=0.1, foreach=foreach)
    x = torch.rand(1, 32, 32, 1)
    tm.net.train_forward(x)[1].sum().backward()
    opt.step()
    with torch.no_grad():
        moved = tconv._packed(blk.weight, blk.bias, plan, 0)[0]
        assert torch.equal(moved, tconv.pack_weights(blk.weight, plan.kc, plan.bn))
        assert not torch.equal(moved, first)
    tm.net.load_state_dict(StarDist2D(Config2D(**CFG), basedir=None, device="cpu").net.state_dict())
    with torch.no_grad():
        assert torch.equal(tconv._packed(blk.weight, blk.bias, plan, 0)[0], first)


def test_dropout_is_flax_dropout_from_the_generator():
    tm = StarDist2D(Config2D(**CFG, unet_dropout=0.5), basedir=None, device="cpu")
    x = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(0))

    def run(seed):
        return tm.net.train_forward(x, torch.Generator().manual_seed(seed))[1]

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    h = torch.ones(1000, 100)
    y = dropout(h, 0.25, torch.Generator().manual_seed(0))
    assert set(y.unique().tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert abs((y > 0).float().mean().item() - 0.75) < 0.01
    prob, _ = tm.net(x[0])                          # inference: no dropout
    assert torch.equal(prob, tm.net(x[0])[0])


def _resume_cfg():
    return Config2D(**CFG)


def test_resume_bitwise(tmp_path):
    imgs, lbls = _data()
    val = (imgs[:1], lbls[:1])
    mA = StarDist2D(_resume_cfg(), name="runA", basedir=tmp_path, device="cpu")
    histA = mA.train(imgs, lbls, validation_data=val, seed=7, epochs=4, steps_per_epoch=3)
    mB = StarDist2D(_resume_cfg(), name="runB", basedir=tmp_path, device="cpu")
    mB.train(imgs, lbls, validation_data=val, seed=7, epochs=2, steps_per_epoch=3)
    mB2 = StarDist2D(_resume_cfg(), name="runB", basedir=tmp_path, device="cpu")
    histB = mB2.train(imgs, lbls, validation_data=val, seed=7, epochs=4, steps_per_epoch=3,
                      resume=True)
    assert len(histB.history["loss"]) == 4
    for k in ("loss", "val_loss", "lr"):
        assert histA.history[k] == histB.history[k], k
    sdA, sdB = mA.net.state_dict(), mB2.net.state_dict()
    assert all(torch.equal(sdA[k], sdB[k]) for k in sdA)
    assert not (tmp_path / "runB" / "train_state.msgpack").exists()


def test_resume_already_complete(tmp_path):
    imgs, lbls = _data()
    m = StarDist2D(_resume_cfg(), name="done", basedir=tmp_path, device="cpu")
    m.train(imgs, lbls, validation_data=(imgs[:1], lbls[:1]), seed=1, epochs=2, steps_per_epoch=2)
    m2 = StarDist2D(_resume_cfg(), name="done", basedir=tmp_path, device="cpu")
    h = m2.train(imgs, lbls, validation_data=(imgs[:1], lbls[:1]), seed=1, epochs=2,
                 steps_per_epoch=2, resume=True)
    assert len(h.history["loss"]) == 2


def test_resume_without_state_warns(tmp_path):
    imgs, lbls = _data()
    m = StarDist2D(_resume_cfg(), name="fresh", basedir=tmp_path, device="cpu")
    with pytest.warns(UserWarning, match="no train_state"):
        m.train(imgs, lbls, validation_data=(imgs[:1], lbls[:1]), seed=1, epochs=1,
                steps_per_epoch=2, resume=True)


def test_step_marks_name_each_stage_of_each_step():
    imgs, lbls = _data()
    m = StarDist2D(Config2D(**CFG), basedir=None, device="cpu")
    stages = []
    m.step_marks = stages.append
    h = m.train(imgs, lbls, validation_data=(imgs[:1], lbls[:1]), seed=0, epochs=1,
                steps_per_epoch=2)
    assert stages == ["start", "wait", "upload", "targets", "forward+backward", "optimizer"] * 2
    assert len(h.steps["loss"]) == 2 and h.steps["loss"][0] != h.steps["loss"][1]


def test_shape_completion_trains_on_the_host_path():
    imgs, lbls = _data()
    m = StarDist2D(Config2D(**dict(CFG, train_patch_size=(48, 48), train_shape_completion=True,
                                   train_completion_crop=8)), basedir=None, device="cpu")
    h = m.train(imgs, lbls, validation_data=(imgs[:1], lbls[:1]), seed=0, epochs=1,
                steps_per_epoch=2)
    assert m._targets_fn is None and np.isfinite(h.history["loss"]).all()


def test_unported_and_missing_device_raise():
    """A batch-norm net builds and serves, and refuses to train (the
    reference cannot train one: tests/test_torch_netconfigs.py); the card
    is the default device."""
    m = StarDist2D(Config2D(**CFG, unet_batch_norm=True), basedir=None, device="cpu")
    prob, dist = m.predict(np.zeros((32, 32), np.float32))
    assert prob.shape == (16, 16) and np.isfinite(dist).all()
    with pytest.raises(NotImplementedError):
        m.prepare_for_training()
    if torch.cuda.is_available():
        return                                      # decided at run time: a card is there
    with pytest.raises(RuntimeError):
        StarDist2D(Config2D(**CFG), basedir=None)   # the card is the default


def test_training_imports_no_jax(tmp_path):
    """Training, saving and reloading leave jax, flax, msgpack and
    stardist_tpu out of sys.modules. (TensorBoard is off: its package pulls
    TensorFlow, and with it jax, where they are installed.)"""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(2)
        sys.path.insert(0, "tests")
        from utils import synthetic_nuclei_2d
        from stardist_torch import Config2D, StarDist2D
        cfg = Config2D(**{CFG!r}, train_tensorboard=False)
        data = [synthetic_nuclei_2d((64, 64), seed=i) for i in range(2)]
        X, Y = [x for x, _ in data], [y.astype(np.int32) for _, y in data]
        m = StarDist2D(cfg, "m", {str(tmp_path)!r}, device="cpu")
        m.train(X, Y, validation_data=(X[:1], Y[:1]), epochs=1, steps_per_epoch=2)
        StarDist2D(None, "m", {str(tmp_path)!r}, device="cpu").predict_instances(X[0])
        bad = [k for k in sys.modules
               if k.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "stardist_tpu")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_training_equals_jax_and_the_weights_serve_in_both(tmp_path, jax_model):
    """train(seed=7, epochs=2, steps_per_epoch=3) in both packages from the
    same weights; then the port's weights_best.h5 in the JAX package."""
    imgs, lbls = _data()
    val = (imgs[:1], lbls[:1])
    jm = jax_model
    jm.basedir = tmp_path                              # its checkpoints go here
    (tmp_path / "j").mkdir()
    tm = StarDist2D(Config2D(**CFG), name="t", basedir=tmp_path, device="cpu")
    _carry(tm, jm)
    hj = jm.train(imgs, lbls, validation_data=val, seed=7, epochs=2, steps_per_epoch=3)
    ht = tm.train(imgs, lbls, validation_data=val, seed=7, epochs=2, steps_per_epoch=3)
    assert set(ht.history) == set(hj.history)
    for k, v in hj.history.items():
        np.testing.assert_allclose(ht.history[k], v, rtol=1e-3, err_msg=k)
    assert len(ht.steps["loss"]) == 6
    lr_steps = 2 * CFG.get("train_learning_rate", 3e-4) * 6
    ref = params_from_flax(tm.net, jax.tree_util.tree_map(np.asarray, jm.params))
    for name, p in tm.net.state_dict().items():
        assert (p - ref[name]).abs().max() <= lr_steps, name
    files = sorted(f.name for f in (tmp_path / "t").iterdir())
    assert files == ["config.json", "logs", "train_state.pt", "weights_best.h5",
                     "weights_last.h5", "weights_now.h5"]
    lines = (tmp_path / "t" / "logs" / "history.jsonl").read_text().splitlines()
    assert [json.loads(l)["epoch"] for l in lines] == [1, 2]

    # the port's file, loaded by both packages: the same weights, the same labels
    jm2 = StarDist2DJax(None, "t", str(tmp_path))
    tm2 = StarDist2D(None, "t", tmp_path, device="cpu")
    ref = params_from_flax(tm2.net, jax.tree_util.tree_map(np.asarray, jm2.params))
    assert all(torch.equal(v, ref[k]) for k, v in tm2.net.state_dict().items())
    img = imgs[2]
    prob, _ = tm2.predict(img)
    thresh = float(np.quantile(prob, 0.9))
    lab_j, det_j = jm2.predict_instances(img, prob_thresh=thresh)
    lab_t, det_t = tm2.predict_instances(img, prob_thresh=thresh)
    assert len(det_t["prob"]) > 3
    assert np.array_equal(lab_t, lab_j)
