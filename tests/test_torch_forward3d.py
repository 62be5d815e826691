"""stardist_torch 3D U-Net forward against stardist_tpu on the 3D_demo
weights: flax ``net.apply`` in f32 and the Pallas ``chw_forward`` in bf16;
the 3D_demo checkpoints through the port's own msgpack reader."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import serialization

from stardist_tpu.models import StarDist3D as StarDist3DJax
from stardist_tpu.models.unet_chw import chw_forward
from stardist_torch.models import Config3D, StarDist3D
from stardist_torch.models.unet import StarDistNet
from stardist_torch.models.weights import load_flax_checkpoint, msgpack_loads, params_from_flax

torch.set_num_threads(2)

DEMO = "models/examples/3D_demo"


@pytest.fixture(scope="module")
def models():
    jm = StarDist3DJax(None, "3D_demo", "models/examples")
    tm = StarDist3D(None, "3D_demo", "models/examples", device="cpu")
    return jm, tm


def _volume(shape, seed):
    return np.random.RandomState(seed).rand(*shape, 1).astype(np.float32)


def test_forward_f32_matches_flax(models):
    jm, tm = models
    x = _volume((16, 32, 48), 0)
    ref = jm.net.apply({"params": jm.params}, jnp.asarray(x[None]), train=False)
    prob_ref = np.asarray(ref[0][0, ..., 0])
    dist_ref = np.moveaxis(np.asarray(ref[1][0]), -1, 0)
    prob, dist = tm.net(torch.from_numpy(x))
    assert prob.dtype == dist.dtype == torch.float32
    assert tuple(prob.shape) == (16, 16, 24) and tuple(dist.shape) == dist_ref.shape
    # f32 throughout; sums in another order (the 2D forward's tolerance)
    assert np.abs(prob.numpy() - prob_ref).max() < 1e-4
    assert np.abs(dist.numpy() - dist_ref).max() < 1e-4 * max(1.0, np.abs(dist_ref).max())


def test_forward_bf16_matches_chw_forward(models):
    jm, tm = models
    x = _volume((8, 16, 32), 1)
    net_bf16 = dataclasses.replace(jm.net, dtype=jnp.bfloat16)
    prob_ref, dist_ref = (np.asarray(a) for a in chw_forward(net_bf16, jm.params,
                                                             jnp.asarray(x)))
    net = StarDistNet(tm.config, dtype=torch.bfloat16)
    net.load_state_dict(tm.net.state_dict())
    prob, dist = net(torch.from_numpy(x))
    # bf16 activations with f32 sums in another order. prob: the 1e-3 of
    # tests/test_conv_pallas.py:131-152. dist: with the trained 3D_demo
    # weights the two bf16 forwards each differ from the f32 one by ~5e-3
    # of |dist|max and from each other by ~1.7e-3 (27-tap sums whose bf16
    # roundings flip apart), so dist is held to the bf16 conv tolerance of
    # test_conv_pallas.py, 5e-3 of max(1, |dist|max)
    assert np.abs(prob.numpy() - prob_ref).max() < 1e-3
    assert np.abs(dist.numpy() - dist_ref).max() < 5e-3 * max(1.0, np.abs(dist_ref).max())


@pytest.mark.parametrize("name", ["weights_best.h5", "weights_last.h5", "weights_now.h5"])
def test_params_from_flax_on_3d_checkpoints(models, name):
    """Every 3D_demo checkpoint: the port's reader gives flax's tree, and
    params_from_flax fills every tensor of the 3D net from it."""
    _, tm = models
    raw = open(f"{DEMO}/{name}", "rb").read()
    ref = serialization.msgpack_restore(raw)["params"]
    params = msgpack_loads(raw)["params"]
    sd = params_from_flax(tm.net, params)
    assert set(sd) == set(tm.net.state_dict())
    assert np.array_equal(sd["top.0.weight"].numpy(), ref["ConvBlock_0"]["Conv_0"]["kernel"])
    assert sd["top.0.weight"].shape == (3, 3, 3, 1, 16)          # DHWIO
    bb = ref["UNetBackbone_0"]
    for k in range(len(tm.net.backbone)):
        assert np.array_equal(sd[f"backbone.{k}.weight"].numpy(),
                              bb[f"ConvBlock_{k}"]["Conv_0"]["kernel"])
        assert np.array_equal(sd[f"backbone.{k}.bias"].numpy(),
                              bb[f"ConvBlock_{k}"]["Conv_0"]["bias"])
    head = np.asarray(ref["head_dist"]["kernel"])
    assert np.array_equal(sd["head_dist.weight"].numpy(), head.reshape(head.shape[-2:]))
    if name == "weights_best.h5":                                   # what the model loads
        for k, v in tm.net.state_dict().items():
            assert torch.equal(v, sd[k]), k
    assert load_flax_checkpoint(f"{DEMO}/{name}").keys() == ref.keys()


@pytest.mark.parametrize("grid,depth", [((1, 2, 2), 2), ((1, 1, 1), 1), ((2, 2, 4), 1)])
def test_forward_shapes_and_layers(grid, depth):
    cfg = Config3D(rays=8, grid=grid, unet_n_depth=depth, unet_n_filter_base=4,
                   net_conv_after_unet=8)
    net = StarDistNet(cfg)
    net.init_weights(torch.Generator().manual_seed(0))
    D, H, W = (2 ** depth * g * k for g, k in zip(grid, (1, 2, 3)))
    prob, dist = net(torch.rand(D, H, W, 1, generator=torch.Generator().manual_seed(1)))
    out = (D // grid[0], H // grid[1], W // grid[2])
    assert tuple(prob.shape) == out and tuple(dist.shape) == (8,) + out
    assert torch.isfinite(dist).all() and ((prob > 0) & (prob < 1)).all()
    n_pre = int(np.log2(max(grid)))            # grid pre-pooling stages
    assert len(net.conv_blocks()) == 2 * n_pre + 4 * depth + 2 + 1
    assert all(blk.weight.shape[:3] == (3, 3, 3) for blk in net.conv_blocks())


def test_resnet_backbone_is_not_ported():
    """The ResNet backbone is ported (tests/test_torch_train3d.py), its
    batch norm and non-cubic kernels too (tests/test_torch_netconfigs3d.py):
    a batch norm after every conv of a block but the shortcut, the kernel
    size in every block and the feature conv, the stem's 7^3 and 3^3."""
    assert len(StarDistNet(Config3D(rays=8, backbone="resnet")).resnet_convs()) == 15
    net = StarDistNet(Config3D(rays=8, backbone="resnet", resnet_batch_norm=True,
                               resnet_kernel_size=(1, 3, 3)))
    convs = net.resnet_convs()
    assert len(convs) == 15 and net.batch_norm
    assert sum(c.bn is not None for c in convs) == 3 * len(net.blocks)
    assert all(c.bn is None for c in list(net.stem) + [net.feat]
               + [b.shortcut for b in net.blocks if b.shortcut is not None])
    assert [tuple(c.weight.shape[:3]) for c in net.stem] == [(7, 7, 7), (3, 3, 3)]
    assert all(tuple(c.weight.shape[:3]) == (1, 3, 3)
               for b in net.blocks for c in b.convs) and net.feat.weight.shape[:3] == (1, 3, 3)
    with pytest.raises(NotImplementedError):
        net.train_forward(torch.zeros(1, 8, 8, 8, 1))
