"""stardist_torch 3x3 conv (plain version on CPU; the CUDA kernel on the
card) against stardist_tpu's Pallas conv2d_hcw in interpret mode."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stardist_tpu.ops.conv_pallas import conv2d_hcw as conv2d_hcw_jax
from stardist_torch.ops import conv as tconv

torch.set_num_threads(2)

SHAPES = [
    (1, 8, 17, 23),       # first conv (C_in padded to 8), ragged shape
    (8, 8, 32, 64),
    (32, 16, 40, 130),    # ragged width
    (16, 32, 64, 512),
    (16, 64, 32, 256),    # Cout = 64, the non-stacked TPU variant
]


def _inputs(C, Cout, H, W, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(H, C, W).astype(np.float32)
    w = (rng.randn(3, 3, C, Cout) * 0.1).astype(np.float32)
    b = rng.randn(Cout).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("C,Cout,H,W", SHAPES)
def test_conv2d_hcw_plain_matches_pallas(C, Cout, H, W):
    x, w, b = _inputs(C, Cout, H, W, C + Cout + H)
    ref = np.asarray(conv2d_hcw_jax(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    act="relu"), np.float32)
    y = tconv.conv2d_hcw(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), act="relu")
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (H, Cout, W)
    # bf16 outputs of f32 sums taken in another order: the tolerance of
    # tests/test_conv_pallas.py (5e-3 relative to max(1, |ref|max))
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(y.float().numpy() - ref).max() / scale < 5e-3


@pytest.mark.parametrize("act", ["linear", "elu"])
def test_conv2d_hcw_plain_linear_and_elu(act):
    x, w, _ = _inputs(4, 8, 24, 40, 0)
    ref = np.asarray(conv2d_hcw_jax(jnp.asarray(x), jnp.asarray(w), None, act=act),
                     np.float32)
    y = tconv.conv2d_hcw(torch.from_numpy(x), torch.from_numpy(w), None, act=act)
    # the absolute bf16 tolerance of test_conv_pallas.py:52
    assert np.abs(y.float().numpy() - ref).max() < 2e-2


def test_conv3x3_hwc_float32_matches_xla():
    """The f32 plain conv (the f32 forward's conv) against XLA's f32 conv."""
    x, w, b = _inputs(8, 16, 20, 28, 3)
    xh = np.ascontiguousarray(x.transpose(0, 2, 1))              # (H, W, C)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(xh)[None], jnp.asarray(w), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)[0] + b
    ref = np.maximum(np.asarray(ref), 0)
    y = tconv.conv3x3_hwc(torch.from_numpy(xh), torch.from_numpy(w),
                          torch.from_numpy(b), act="relu")
    assert y.dtype == torch.float32
    # f32 sums in another order
    assert np.abs(y.numpy() - ref).max() < 1e-4


def test_conv_rejects_unknown_activation():
    x = torch.zeros(4, 4, 8)
    with pytest.raises(ValueError):
        tconv.conv3x3_hwc(x, torch.zeros(3, 3, 8, 8), None, act="tanh")

