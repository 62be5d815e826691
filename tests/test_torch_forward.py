"""stardist_torch U-Net forward against stardist_tpu on the 2D_demo weights:
flax ``net.apply`` in f32 and the Pallas ``chw_forward`` in bf16."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stardist_tpu.models import StarDist2D as StarDist2DJax
from stardist_tpu.models.unet_chw import chw_forward
from stardist_torch.models import Config2D, StarDist2D
from stardist_torch.models.unet import StarDistNet

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    jm = StarDist2DJax(None, "2D_demo", "models/examples")
    tm = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
    return jm, tm


def _image(shape, seed):
    return np.random.RandomState(seed).rand(*shape, 1).astype(np.float32)


def test_forward_f32_matches_flax(models):
    jm, tm = models
    x = _image((96, 128), 0)
    ref = jm.net.apply({"params": jm.params}, jnp.asarray(x[None]), train=False)
    prob_ref = np.asarray(ref[0][0, ..., 0])
    dist_ref = np.moveaxis(np.asarray(ref[1][0]), -1, 0)
    prob, dist = tm.net(torch.from_numpy(x))
    assert prob.dtype == dist.dtype == torch.float32
    assert tuple(dist.shape) == dist_ref.shape
    # f32 throughout; sums in another order
    assert np.abs(prob.numpy() - prob_ref).max() < 1e-4
    assert np.abs(dist.numpy() - dist_ref).max() < 1e-4 * max(1.0, np.abs(dist_ref).max())


def test_forward_bf16_matches_chw_forward(models):
    jm, tm = models
    x = _image((64, 96), 1)
    net_bf16 = dataclasses.replace(jm.net, dtype=jnp.bfloat16)
    prob_ref, dist_ref = (np.asarray(a) for a in chw_forward(net_bf16, jm.params,
                                                             jnp.asarray(x)))
    net = StarDistNet(tm.config, dtype=torch.bfloat16)
    net.load_state_dict(tm.net.state_dict())
    prob, dist = net(torch.from_numpy(x))
    # bf16 activations with f32 sums in another order: the tolerances of
    # tests/test_conv_pallas.py:74-75
    assert np.abs(prob.numpy() - prob_ref).max() < 1e-3
    assert np.abs(dist.numpy() - dist_ref).max() < 1e-3 * max(1.0, np.abs(dist_ref).max())


@pytest.mark.parametrize("grid,depth", [((2, 2), 3), ((1, 1), 2), ((4, 2), 1)])
def test_forward_shapes_and_layers(grid, depth):
    cfg = Config2D(n_rays=8, grid=grid, unet_n_depth=depth, unet_n_filter_base=4,
                   net_conv_after_unet=8)
    net = StarDistNet(cfg)
    net.init_weights(torch.Generator().manual_seed(0))
    H, W = 2 ** depth * grid[0] * 3, 2 ** depth * grid[1] * 5
    prob, dist = net(torch.rand(H, W, 1, generator=torch.Generator().manual_seed(1)))
    assert tuple(prob.shape) == (H // grid[0], W // grid[1])
    assert tuple(dist.shape) == (8, H // grid[0], W // grid[1])
    assert torch.isfinite(dist).all() and ((prob > 0) & (prob < 1)).all()
    n_pre = int(np.log2(max(grid)))            # grid pre-pooling stages
    assert len(net.conv_blocks()) == 2 * n_pre + 4 * depth + 2 + 1
