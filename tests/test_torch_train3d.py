"""stardist_torch's 3D training and its ResNet backbone against the JAX
package's, on the CPU.

Tolerances, with float32 convolutions summed in another order on each side:
one step's loss and metrics within rtol 1e-5 and each parameter's gradient
within 1e-4 of its largest magnitude (those of tests/test_torch_train.py)
for the U-Net; 1e-3 for the ResNet (that of chip_smoke.py's card against
CPU gradients): on its batch one pre-activation of the feature conv lies
within 1e-6 of 0 and falls on the other side of the ReLU in torch's f32
sums than in XLA's and in float64 (which agree with XLA's within 3e-6),
and that one voxel moves the gradients of the layers below by up to 3e-4
of their largest;
the ResNet's float32 forward within 1e-5 (prob absolute, dist relative to
max(1, |dist|max)); its bfloat16 forward against flax's bfloat16 forward
within 5e-3 (prob, absolute) and 1e-2 of max(1, |dist|max) (dist): twice
the bf16 conv tolerance of tests/test_torch_forward3d.py, because with
these seeded weights each bf16 forward is itself 0.75-1.2e-2 of |dist|max
from the f32 one (the port's no farther than flax's), and the two differ by
4.0-5.4e-3. Weight files are exact both ways. Resume is
bitwise."""
import dataclasses
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

from stardist_torch.models import Config3D, StarDist3D
from stardist_torch.models.model3d import StarDistData3D
from stardist_torch.models.unet import StarDistNet, same_pads
from stardist_torch.models.weights import params_from_flax
from stardist_tpu.models import Config3D as Config3DJax, StarDist3D as StarDist3DJax
from stardist_tpu.models import losses as JL
from utils import synthetic_nuclei_3d

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
PATCH = (16, 32, 32)
UNET = dict(n_rays=16, grid=(1, 2, 2), anisotropy=(2.0, 1.0, 1.0), unet_n_depth=1,
            unet_n_filter_base=8, net_conv_after_unet=8, train_patch_size=PATCH,
            train_batch_size=2, train_reduce_lr=None)
RESNET = dict(n_rays=16, grid=(1, 2, 2), anisotropy=(2.0, 1.0, 1.0), backbone="resnet",
              resnet_n_blocks=2, resnet_n_filter_base=8, net_conv_after_resnet=16,
              train_patch_size=PATCH, train_batch_size=2, train_reduce_lr=None)
CFGS = {"unet": UNET, "resnet": RESNET}


def _data(n=3, shape=(24, 48, 48)):
    out = [synthetic_nuclei_3d(shape, n=14, seed=i) for i in range(n)]
    return [x for x, _ in out], [y.astype(np.int32) for _, y in out]


@pytest.fixture(scope="module")
def jax_models():
    """One JAX model of each backbone for the file (construction compiles)."""
    return {k: StarDist3DJax(Config3DJax(**v), name="j", basedir=None) for k, v in CFGS.items()}


def _carry(tm, jm):
    tm.net.load_state_dict(params_from_flax(tm.net, jax.tree_util.tree_map(np.asarray, jm.params)))


@pytest.mark.parametrize("backbone,grad_tol", [("unet", 1e-4), ("resnet", 1e-3)])
def test_one_step_equals_jax_value_and_grad(jax_models, backbone, grad_tol):
    imgs, lbls = _data()
    jm = jax_models[backbone]
    tm = StarDist3D(Config3D(**CFGS[backbone]), basedir=None, device="cpu")
    tm.prepare_for_training()
    _carry(tm, jm)
    data = StarDistData3D(imgs, lbls, rays=tm.rays, batch_size=2, length=1, patch_size=PATCH,
                          grid=(1, 2, 2), anisotropy=(2.0, 1.0, 1.0), foreground_prob=0.9,
                          device="cpu")
    np.random.seed(3)
    t = tm._targets_fn(tm._put_batch(data.raw_item(0)))   # equal to JAX's: test_torch_targets3d
    batch = {k: jnp.asarray(v.numpy()) for k, v in t.items()}

    def loss_and_metrics(params):        # the reference's prepare_for_training, train=True
        prob, dist = jm.net.apply({"params": params}, batch["x"], train=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        dt, dm = batch["dist"][..., :16], batch["dist"][..., 16:]
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


@pytest.mark.parametrize("shape", [(8, 16, 24), (7, 15, 21), (9, 13, 18)])
def test_resnet_forward_equals_flax(jax_models, shape):
    """Even and odd extents: the strided convs pad as flax's SAME does."""
    jm = jax_models["resnet"]
    tm = StarDist3D(Config3D(**RESNET), basedir=None, device="cpu")
    _carry(tm, jm)
    x = np.random.RandomState(sum(shape)).rand(*shape, 1).astype(np.float32)
    ref = jm.net.apply({"params": jm.params}, jnp.asarray(x[None]), train=False)
    prob_ref, dist_ref = np.asarray(ref[0][0, ..., 0]), np.moveaxis(np.asarray(ref[1][0]), -1, 0)
    prob, dist = tm.net(torch.from_numpy(x))
    out = (shape[0], -(-shape[1] // 2), -(-shape[2] // 2))
    assert tuple(prob.shape) == out and tuple(dist.shape) == (16,) + out
    scale = max(1.0, np.abs(dist_ref).max())
    assert np.abs(prob.numpy() - prob_ref).max() < 1e-5
    assert np.abs(dist.numpy() - dist_ref).max() < 1e-5 * scale
    # bfloat16 inference against flax's bfloat16 forward
    net16 = StarDistNet(tm.config, dtype=torch.bfloat16)
    net16.load_state_dict(tm.net.state_dict())
    ref16 = dataclasses.replace(jm.net, dtype=jnp.bfloat16).apply(
        {"params": jm.params}, jnp.asarray(x[None]), train=False)
    p16, d16 = net16(torch.from_numpy(x))
    assert p16.dtype == d16.dtype == torch.float32
    assert np.abs(p16.numpy() - np.asarray(ref16[0][0, ..., 0])).max() < 5e-3
    d16_ref = np.moveaxis(np.asarray(ref16[1][0]), -1, 0)
    assert np.abs(d16.numpy() - d16_ref).max() < 1e-2 * scale


@pytest.mark.parametrize("n,k,s,want", [(8, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (9, 1, 2, (0, 0)),
                                        (8, 1, 2, (0, 0)), (8, 3, 1, (1, 1)), (6, 7, 1, (3, 3)),
                                        (5, 3, 3, (0, 1))])
def test_strided_same_padding_is_flax_padding(n, k, s, want):
    """flax (lax's SAME): total = max((ceil(n / s) - 1) * s + k - n, 0),
    total // 2 before, as lax computes it."""
    assert same_pads([n], k, [s]) == [want]
    from jax import lax
    assert tuple(lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]) == want


def test_resnet_topology_and_he_normal_init():
    """The stem (7^3, 3^3), the blocks pooled until the grid (filters
    doubling), shortcuts where the block pools; he-normal convs (truncated
    at 2 std), a glorot feature conv and lecun heads: the bounds and stds
    of flax's initializers on the same shapes."""
    from flax.linen import initializers
    cfg = Config3D(n_rays=32, grid=(2, 4, 4), backbone="resnet", resnet_n_filter_base=16)
    net = StarDistNet(cfg)
    net.init_weights(torch.Generator().manual_seed(0))
    assert net.conv_blocks() == []
    assert [tuple(c.weight.shape) for c in net.stem] == [(7, 7, 7, 1, 16), (3, 3, 3, 16, 16)]
    pools = [blk.convs[0].stride for blk in net.blocks]
    assert pools == [(2, 2, 2), (1, 2, 2), (1, 1, 1), (1, 1, 1)]
    assert [blk.convs[0].weight.shape[-1] for blk in net.blocks] == [32, 64, 64, 64]
    assert [blk.shortcut is not None for blk in net.blocks] == [True, True, False, False]
    key = jax.random.PRNGKey(0)
    convs = net.resnet_convs()
    largest = max(convs[:-1], key=lambda c: c.weight.numel())    # flax's draws: one compile each
    for conv in convs:
        w = conv.weight.detach()
        fan_in = int(np.prod(w.shape[:-1]))
        if conv is net.feat:
            r = initializers.glorot_uniform()
            bound = np.sqrt(6.0 / (fan_in + np.prod(w.shape[:-2]) * w.shape[-1]))
            std = bound / np.sqrt(3)
        else:
            r = initializers.he_normal()
            std = np.sqrt(2.0 / fan_in)
            bound = 2 * std / .87962566103423978
        assert not conv.bias.any()
        assert w.abs().max().item() <= bound * (1 + 1e-6)
        if w.numel() >= 5000:
            assert abs(w.std().item() / std - 1) < 0.1
        if conv is net.feat or conv is largest:
            r = np.asarray(r(key, tuple(w.shape)))
            assert np.abs(r).max() <= bound * (1 + 1e-6) and abs(r.std() / std - 1) < 0.1
    x = torch.rand(8, 16, 16, 1, generator=torch.Generator().manual_seed(1))
    prob, dist = net(x)
    assert tuple(prob.shape) == (4, 4, 4) and tuple(dist.shape) == (32, 4, 4, 4)
    with pytest.raises(ValueError):                     # two blocks cannot reach grid 8
        StarDistNet(Config3D(grid=(8, 8, 8), backbone="resnet", resnet_n_blocks=2))
    assert StarDist3D(Config3D(**RESNET), basedir=None,
                      device="cpu")._axes_div_by("ZYX") == (1, 2, 2)


def test_resnet_weight_files_both_ways(tmp_path, jax_models):
    jm = jax_models["resnet"]
    tm = StarDist3D(Config3D(**RESNET), name="t", basedir=tmp_path, device="cpu")
    _carry(tm, jm)
    tm.save_weights("w.h5")                            # the bytes flax writes
    assert (tmp_path / "t" / "w.h5").read_bytes() == serialization.to_bytes({"params": jm.params})
    (tmp_path / "j").write_bytes(serialization.to_bytes(
        {"params": jax.tree_util.tree_map(lambda a: a + 1, jm.params)}))
    tm.load_weights(str(tmp_path / "j"))
    ref = params_from_flax(tm.net, jax.tree_util.tree_map(lambda a: np.asarray(a) + 1, jm.params))
    assert all(torch.equal(v, ref[k]) for k, v in tm.net.state_dict().items())
    # the JAX package loads the port's folder
    tm.save_weights("weights_best.h5")
    jm2 = StarDist3DJax(None, "t", str(tmp_path))
    back = params_from_flax(tm.net, jax.tree_util.tree_map(np.asarray, jm2.params))
    assert all(torch.equal(v, back[k]) for k, v in tm.net.state_dict().items())


def _resume_cfg(backbone):
    return Config3D(**CFGS[backbone])


@pytest.mark.parametrize("backbone", ["unet", "resnet"])
def test_resume_bitwise(tmp_path, backbone):
    imgs, lbls = _data()
    val = (imgs[:1], lbls[:1])
    mA = StarDist3D(_resume_cfg(backbone), name="runA", basedir=tmp_path, device="cpu")
    histA = mA.train(imgs, lbls, validation_data=val, seed=7, epochs=3, steps_per_epoch=2)
    mB = StarDist3D(_resume_cfg(backbone), name="runB", basedir=tmp_path, device="cpu")
    mB.train(imgs, lbls, validation_data=val, seed=7, epochs=1, steps_per_epoch=2)
    mB2 = StarDist3D(_resume_cfg(backbone), name="runB", basedir=tmp_path, device="cpu")
    histB = mB2.train(imgs, lbls, validation_data=val, seed=7, epochs=3, steps_per_epoch=2,
                      resume=True)
    assert len(histB.history["loss"]) == 3 and np.isfinite(histA.history["loss"]).all()
    for k in ("loss", "val_loss", "lr"):
        assert histA.history[k] == histB.history[k], k
    sdA, sdB = mA.net.state_dict(), mB2.net.state_dict()
    assert all(torch.equal(sdA[k], sdB[k]) for k in sdA)
    files = sorted(f.name for f in (tmp_path / "runA").iterdir())
    assert files == ["config.json", "logs", "train_state.pt", "weights_best.h5",
                     "weights_last.h5", "weights_now.h5"]
    lines = (tmp_path / "runA" / "logs" / "history.jsonl").read_text().splitlines()
    assert [json.loads(l)["epoch"] for l in lines] == [1, 2, 3]


def test_train_checks_follow_the_reference():
    imgs, lbls = _data(n=2)
    m = StarDist3D(Config3D(**dict(UNET, train_patch_size=(16, 30, 32))), basedir=None,
                   device="cpu")
    with pytest.raises(ValueError, match="divisible by 4 along axis 'Y'"):
        m.train(imgs, lbls, validation_data=(imgs[:1], lbls[:1]), epochs=1, steps_per_epoch=1)
    with pytest.raises(ValueError):
        m.train(imgs, lbls, validation_data=imgs[:1], epochs=1, steps_per_epoch=1)
    with pytest.raises(ValueError, match="X and classes must have same length"):
        StarDistData3D(imgs, lbls, rays=m.rays, batch_size=1, length=1, n_classes=2,
                       classes=[1], patch_size=PATCH)


def test_training_imports_no_jax(tmp_path):
    """3D training (the ResNet; the U-Net's training route is 2D's, checked
    in tests/test_torch_train.py), saving and reloading leave jax, flax,
    msgpack and stardist_tpu out of sys.modules."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(2)
        sys.path.insert(0, "tests")
        from utils import synthetic_nuclei_3d
        from stardist_torch import Config3D, StarDist3D
        data = [synthetic_nuclei_3d((24, 48, 48), n=14, seed=i) for i in range(2)]
        X, Y = [x for x, _ in data], [y.astype(np.int32) for _, y in data]
        m = StarDist3D(Config3D(**{RESNET!r}, train_tensorboard=False), "r", {str(tmp_path)!r},
                       device="cpu")
        m.train(X, Y, validation_data=(X[:1], Y[:1]), epochs=1, steps_per_epoch=1)
        StarDist3D(None, "r", {str(tmp_path)!r}, device="cpu").predict_instances(
            X[0], prob_thresh=0.4)
        bad = [k for k in sys.modules
               if k.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "stardist_tpu")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
