"""stardist_torch's 3D network options against stardist_tpu's, on the CPU:
batch norm in the 3D U-Net and the ResNet, a non-cubic U-Net and ResNet
kernel (1, 3, 3), the ResNet's initializers (``resnet_kernel_init``), the
weight files with ``batch_stats``, one training step of a swish (1, 3, 3)
he-uniform ResNet against ``jax.value_and_grad`` and the TF export's
replay of a batch-norm ResNet. The 2D cases and the helpers:
tests/test_torch_netconfigs.py; the tolerances are its, and the ResNet's
bf16 ones tests/test_torch_train3d.py's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from stardist_torch.models import Config3D, StarDist3D
from stardist_torch.models.model3d import StarDistData3D
from stardist_torch.models.unet import StarDistNet
from stardist_torch.models.weights import flax_variables, params_from_flax
from stardist_tpu.models import Config3D as Config3DJax, StarDist3D as StarDist3DJax
from test_torch_netconfigs import assert_close, one_step_vs_jax, pair, split
from utils import synthetic_nuclei_3d

torch.set_num_threads(2)
UNET = dict(n_rays=8, grid=(1, 2, 2), anisotropy=(2.0, 1.0, 1.0), unet_n_depth=1,
            unet_n_filter_base=8, net_conv_after_unet=8, train_patch_size=(16, 32, 32),
            train_batch_size=2, train_reduce_lr=None)
RESNET = dict(n_rays=16, grid=(1, 2, 2), anisotropy=(2.0, 1.0, 1.0), backbone="resnet",
              resnet_n_blocks=2, resnet_n_filter_base=8, net_conv_after_resnet=16,
              train_patch_size=(16, 32, 32), train_batch_size=2, train_reduce_lr=None)
CASES = {
    "unet_batch_norm": dict(UNET, unet_batch_norm=True),
    "unet_133_tanh": dict(UNET, unet_kernel_size=(1, 3, 3), unet_activation="tanh"),
    "resnet_batch_norm": dict(RESNET, resnet_batch_norm=True, resnet_kernel_size=(1, 3, 3),
                              resnet_kernel_init="he_uniform"),
}


@pytest.fixture(scope="module")
def pairs():
    return {name: pair(StarDist3D, Config3D, StarDist3DJax, Config3DJax, cfg, 10 + i)
            for i, (name, cfg) in enumerate(CASES.items())}


def _volume(shape, seed):
    return np.random.RandomState(seed).rand(*shape, 1).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", [(8, 16, 24), (7, 15, 22)])
def test_forward_f32_matches_flax(pairs, case, shape):
    """Even and odd extents (the U-Net's need a multiple of its pooling)."""
    tm, jm = pairs[case]
    if not case.startswith("resnet"):
        shape = tuple(2 * (s // 2) for s in shape[:1]) + tuple(4 * (s // 4) for s in shape[1:])
    x = _volume(shape, sum(shape))
    ref = jm.net.apply(jm._variables(), jnp.asarray(x[None]), train=False)
    prob, dist = tm.net(torch.from_numpy(x))
    assert_close(prob.numpy(), dist.numpy(), *split(ref), 1e-4)


@pytest.mark.parametrize("case,tol", [("unet_batch_norm", (5e-3, 5e-3)),
                                      ("resnet_batch_norm", (5e-3, 2e-2))])
def test_forward_bf16_matches_flax_bf16(pairs, case, tol):
    """Against flax's bf16 ``apply``, which rounds each conv's output to
    bf16 before the batch norm and again after it (the port folds the batch
    norm into the conv): the U-Net at the one-conv bf16 tolerance of
    tests/test_conv_pallas.py:35; the ResNet, whose convs are XLA's and
    oneDNN's and whose six batch norms (three per block) add a rounding
    each in flax, at tests/test_conv_pallas.py:52's
    2e-2 for dist (tests/test_torch_train3d.py holds the ResNet without
    batch norm at 1e-2)."""
    tm, jm = pairs[case]
    x = _volume((8, 16, 16), 4)
    ref = split(dataclasses.replace(jm.net, dtype=jnp.bfloat16).apply(
        jm._variables(), jnp.asarray(x[None]), train=False))
    net = StarDistNet(tm.config, dtype=torch.bfloat16)
    net.load_state_dict(tm.net.state_dict())
    prob, dist = net(torch.from_numpy(x))
    scale = max(1.0, np.abs(ref[1]).max())
    assert np.abs(prob.numpy() - ref[0]).max() < tol[0]
    assert np.abs(dist.numpy() - ref[1]).max() < tol[1] * scale


def test_resnet_weight_files_both_ways(pairs, tmp_path):
    tm, jm = pairs["resnet_batch_norm"]
    saved = StarDist3D(tm.config, "t", tmp_path, device="cpu")
    saved.net.load_state_dict(tm.net.state_dict())
    saved.save_weights("w.h5")
    want = serialization.to_bytes({"params": jm.params, **jm._extra_vars})
    assert (tmp_path / "t" / "w.h5").read_bytes() == want
    loaded = StarDist3D(None, "t", tmp_path, device="cpu")            # loads w.h5
    sd = loaded.net.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in tm.net.state_dict().items())
    jm2 = StarDist3DJax(jm.config, basedir=None)
    jm2.load_weights(str(tmp_path / "t" / "w.h5"))
    ref = params_from_flax(tm.net, jax.tree_util.tree_map(np.asarray, jm2.params),
                           jax.tree_util.tree_map(np.asarray, jm2._extra_vars["batch_stats"]))
    assert all(torch.equal(sd[k], ref[k]) for k in sd)


def _data(n=3, shape=(24, 48, 48)):
    out = [synthetic_nuclei_3d(shape, n=14, seed=i) for i in range(n)]
    return [x for x, _ in out], [y.astype(np.int32) for _, y in out]


def test_one_step_equals_jax_value_and_grad_swish_resnet():
    cfg = dict(RESNET, resnet_activation="swish", resnet_kernel_size=(1, 3, 3),
               resnet_kernel_init="he_uniform")
    tm, jm = pair(StarDist3D, Config3D, StarDist3DJax, Config3DJax, cfg)
    tm.prepare_for_training()
    imgs, lbls = _data()
    data = StarDistData3D(imgs, lbls, rays=tm.rays, batch_size=2, length=1,
                          patch_size=(16, 32, 32), grid=(1, 2, 2), anisotropy=(2.0, 1.0, 1.0),
                          foreground_prob=0.9, device="cpu")
    np.random.seed(3)
    # the ResNet's gradient tolerance of tests/test_torch_train3d.py
    one_step_vs_jax(tm, jm, tm._targets_fn(tm._put_batch(data.raw_item(0))), 16, grad_tol=1e-3)


@pytest.mark.parametrize("init", ["he_normal", "he_uniform", "glorot_uniform", "xavier_uniform",
                                  "lecun_normal"])
def test_resnet_initializers_follow_flax(init):
    """Each ResNet conv (stem, blocks, shortcuts) drawn by
    ``resnet_kernel_init`` as flax's ``_kernel_init`` does (an unknown name
    is glorot-uniform): the bound and spread of flax's initializer on the
    same shape; the feature conv glorot-uniform whatever the name."""
    from stardist_tpu.models.unet import _kernel_init
    cfg = Config3D(n_rays=16, grid=(1, 2, 2), backbone="resnet", resnet_n_filter_base=16,
                   resnet_kernel_size=(1, 3, 3), resnet_kernel_init=init)
    net = StarDistNet(cfg)
    net.init_weights(torch.Generator().manual_seed(0))
    key = jax.random.PRNGKey(0)
    convs = net.resnet_convs()
    for conv in convs:
        w = conv.weight.detach().numpy()
        name = "glorot_uniform" if conv is net.feat else init
        r = np.asarray(_kernel_init(name)(key, w.shape))
        fan_in = np.prod(w.shape[:-1])
        fan_out = np.prod(w.shape[:-2]) * w.shape[-1]
        bound = {"he_normal": 2 * np.sqrt(2 / fan_in) / .87962566103423978,
                 "he_uniform": np.sqrt(6 / fan_in)}.get(name, np.sqrt(6 / (fan_in + fan_out)))
        assert np.abs(w).max() <= bound * (1 + 1e-6) and np.abs(r).max() <= bound * (1 + 1e-6)
        if w.size >= 2000:
            assert abs(w.std() / r.std() - 1) < 0.1, tuple(w.shape)
    uniform = init != "he_normal"
    stem = convs[0].weight.detach().numpy()               # 7^3 x 1 x 16: uniform or normal
    assert (np.abs(stem).max() / stem.std() < 1.8) == uniform


@pytest.mark.parametrize("n_feat,fails", [(0, False), (16, True)])
def test_export_replay_of_a_batch_norm_resnet(n_feat, fails):
    """As the 2D U-Net's in tests/test_torch_netconfigs.py: the reference's
    replay gives the feature conv a batch norm that flax does not, so both
    raise KeyError('BatchNorm_0') with one, and agree with the port's
    forward without."""
    pytest.importorskip("tensorflow")
    import tensorflow as tf
    from stardist_torch.models.export_tf import build_tf_forward
    from stardist_tpu.models.export_tf import build_tf_forward as build_tf_forward_jax
    cfg = dict(CASES["resnet_batch_norm"], net_conv_after_resnet=n_feat)
    tm, jm = pair(StarDist3D, Config3D, StarDist3DJax, Config3DJax, cfg, seed=5)
    v = flax_variables(tm.net)
    x = _volume((8, 16, 16), 6)
    fwds = (build_tf_forward(tm.config, v["params"], v["batch_stats"]),
            build_tf_forward_jax(jm.net, jm.params, jm._extra_vars))
    if fails:
        for f in fwds:
            with pytest.raises(KeyError, match="BatchNorm_0"):
                f(tf.constant(x[None]))
        return
    prob, dist = tm.net(torch.from_numpy(x))
    for f in fwds:
        out = f(tf.constant(x[None]))
        assert_close(prob.numpy(), dist.numpy(), *split([o.numpy() for o in out]), 1e-4)
