"""stardist_torch 3x3x3 conv (plain version on CPU; the CUDA kernel on the
card) against stardist_tpu's Pallas conv3d_hcw in interpret mode."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stardist_tpu.ops.conv_pallas import conv3d_hcw as conv3d_hcw_jax
from stardist_torch.ops import conv as tconv

torch.set_num_threads(2)

# the ragged shapes of tests/test_conv_pallas.py::test_conv3d_chw_matches_xla
SHAPES = [
    (1, 8, 5, 9, 19),     # first conv (C_in padded to 8), ragged shape
    (8, 8, 4, 16, 40),
    (16, 8, 3, 24, 130),  # ragged width > one tile
]


def _inputs(C, Cout, D, H, W, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(D, H, C, W).astype(np.float32)
    w = (rng.randn(3, 3, 3, C, Cout) * 0.1).astype(np.float32)
    b = rng.randn(Cout).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("C,Cout,D,H,W", SHAPES)
def test_conv3d_hcw_plain_matches_pallas(C, Cout, D, H, W):
    x, w, b = _inputs(C, Cout, D, H, W, C + Cout + H)
    ref = np.asarray(conv3d_hcw_jax(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    act="relu"), np.float32)
    y = tconv.conv3d_hcw(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), act="relu")
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (D, H, Cout, W)
    # bf16 outputs of f32 sums taken in another order: the tolerance of
    # tests/test_conv_pallas.py (5e-3 relative to max(1, |ref|max))
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(y.float().numpy() - ref).max() / scale < 5e-3


@pytest.mark.parametrize("act", ["linear", "elu"])
def test_conv3d_hcw_plain_linear_and_elu(act):
    x, w, _ = _inputs(4, 8, 3, 10, 12, 0)
    ref = np.asarray(conv3d_hcw_jax(jnp.asarray(x), jnp.asarray(w), None, act=act),
                     np.float32)
    y = tconv.conv3d_hcw(torch.from_numpy(x), torch.from_numpy(w), None, act=act)
    # the absolute bf16 tolerance of test_conv_pallas.py:52
    assert np.abs(y.float().numpy() - ref).max() < 2e-2


@pytest.mark.parametrize("act", ["relu", "linear"])
def test_conv3x3x3_dhwc_float32_matches_xla(act):
    """The f32 plain conv (the f32 forward's conv) against XLA's f32 conv."""
    x, w, b = _inputs(8, 16, 6, 10, 14, 3)
    xd = np.ascontiguousarray(x.transpose(0, 1, 3, 2))              # (D, H, W, C)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(xd)[None], jnp.asarray(w), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=jax.lax.Precision.HIGHEST)[0] + b
    ref = np.asarray(ref)
    if act == "relu":
        ref = np.maximum(ref, 0)
    y = tconv.conv3x3x3_dhwc(torch.from_numpy(xd), torch.from_numpy(w),
                             torch.from_numpy(b), act=act)
    assert y.dtype == torch.float32 and tuple(y.shape) == (6, 10, 14, 16)
    # f32 sums in another order
    assert np.abs(y.numpy() - ref).max() < 1e-4


def test_conv3d_rejects_unknown_activation():
    x = torch.zeros(2, 4, 4, 8)
    with pytest.raises(ValueError):
        tconv.conv3x3x3_dhwc(x, torch.zeros(3, 3, 3, 8, 8), None, act="tanh")
