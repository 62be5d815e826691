"""stardist_torch pair_frac (plain version on CPU, CUDA kernel on the card)
against stardist_tpu's Pallas pair_frac in interpret mode."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stardist_tpu.ops.pair_overlap import pair_frac as pair_frac_jax
from stardist_torch.ops import pair_overlap as tpo

torch.set_num_threads(2)


def _pairs(P, R, seed):
    rng = np.random.RandomState(seed)
    d_r = (rng.rand(P, R) * 8 + 4).astype(np.float32)
    d_c = (rng.rand(P, R) * 8 + 4).astype(np.float32)
    p_r = (rng.rand(P, 2) * 10).astype(np.float32)
    p_c = (p_r + rng.randn(P, 2) * 5).astype(np.float32)
    plo = (np.maximum(p_r, p_c) - 6).astype(np.float32)
    ext = (rng.rand(P, 2) * 8 + 0.5).astype(np.float32)
    # a few samples at the exact centre of a polygon (no wedge matches there)
    p_r[:4] = plo[:4] + ext[:4] * np.float32(0.5 / 8)
    return d_r, p_r, d_c, p_c, plo, ext


@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("R", [32, 16])
def test_pair_frac_plain_matches_pallas(S, R):
    args = _pairs(1000, R, S + R)
    ref = np.asarray(pair_frac_jax(*map(jnp.asarray, args), S=S, interpret=True))
    got = tpo.pair_frac(*map(torch.from_numpy, args), S=S).numpy()
    # counts of 0/1 samples: exact. XLA:CPU may contract a mul-sub into an
    # FMA in interpret mode and move a sample within one rounding of an
    # edge; that would show as a difference of exactly 1/S^2 (none so far)
    diff = np.abs(got - ref) * S * S
    assert np.all((diff == 0) | (diff == 1))
    assert np.count_nonzero(diff) <= len(ref) // 1000


def test_pair_frac_frac_values():
    """Identical polygons over their own bbox: every sample inside both."""
    R = 32
    d = torch.full((2, R), 5.0)
    p = torch.tensor([[10.0, 10.0], [20.0, 30.0]])
    plo, ext = p - 3.0, torch.full((2, 2), 6.0)
    out = tpo.pair_frac(d, p, d, p, plo, ext, S=8)
    assert torch.equal(out, torch.ones(2))

