"""The CUDA pair kernel's wedge lookup (``csrc/pair_overlap.cu::inside``),
emulated in PyTorch on the CPU, against the plain twin's walk over every
wedge (``ops/pair_overlap.py::_inside_plain``): bit for bit.

The emulation repeats the kernel's steps with the same f32 operations: the
wedge estimate k0 from the kernel's polynomial arctangent (shifted here by
-1, 0 or +1, as an estimate off by one wedge would shift it), the walk's own
predicate on the window k0 - 1, k0, k0 + 1, the matching wedge's vertex
terms added to 0, and the two guards that take the full walk: |u| outside
[2^-60, 2^64), and a window without exactly one match."""
import numpy as np
import pytest
import torch

import chip_smoke
from stardist_torch.ops.pair_overlap import _inside_plain, _sample_grid, trig_table

torch.set_num_threads(2)

U_LO, U_HI = 2.0 ** -60, 2.0 ** 64
RAYS = [3, 8, 32, 96, 128]


def _cross(ur, uc, trig, k):
    return ur * trig[1][k] - uc * trig[0][k]


def _add_wedge(v, d, k, trig, m):
    """The kernel's add_wedge where ``m`` holds: v += (d[k] s0[k], d[k] c0[k],
    d[k+1] s1[k], d[k+1] c1[k])."""
    R = d.shape[-1]
    a = torch.gather(d, 1, k)
    b = torch.gather(d, 1, (k + 1) % R)
    terms = (a * trig[0][k], a * trig[1][k], b * trig[2][k], b * trig[3][k])
    return [torch.where(m, vi + ti, vi) for vi, ti in zip(v, terms)]


def _side(ur, uc, v):
    v0r, v0c, v1r, v1c = v
    er = v1r - v0r
    ec = v1c - v0c
    cross_p = er * (uc - v0c) - ec * (ur - v0r)
    cross_c = ec * v0r - er * v0c
    return cross_p * cross_c >= 0


def _walk(d, ur, uc, trig):
    R = d.shape[-1]
    zero = torch.zeros_like(ur, dtype=torch.int64)
    cr0 = _cross(ur, uc, trig, zero)
    prev, v = cr0, [torch.zeros_like(ur)] * 4
    for k in range(R):
        nxt = cr0 if k == R - 1 else _cross(ur, uc, trig, zero + (k + 1))
        v = _add_wedge(v, d, zero + k, trig, (prev >= 0) & (nxt < 0))
        prev = nxt
    return _side(ur, uc, v)


def theta_estimate(ur, uc):
    """The kernel's estimate of atan2(ur, uc) (its fast division is a
    plain one here: the estimate only picks the window)."""
    ar, ac = ur.abs(), uc.abs()
    z = torch.minimum(ar, ac) / torch.maximum(ar, ac)
    a = z * (np.float32(0.78539816) + np.float32(0.273) * (1 - z))
    a = torch.where(ar > ac, np.float32(1.57079633) - a, a)
    a = torch.where(uc < 0, np.float32(3.14159265) - a, a)
    return torch.where(ur < 0, -a, a)


def test_theta_estimate_is_within_0_004_rad():
    rng = np.random.RandomState(0)
    ang = np.concatenate([rng.uniform(-np.pi, np.pi, 100_000),
                          np.arange(-8, 9) * (np.pi / 4)]).astype(np.float32)
    r = rng.uniform(1e-3, 1e3, len(ang)).astype(np.float32)
    u = torch.from_numpy(r * np.sin(ang)), torch.from_numpy(r * np.cos(ang))
    err = (theta_estimate(*u) - torch.atan2(*u)).abs()
    err = torch.minimum(err, 2 * np.pi - err)          # +-pi are one angle
    assert err.max() < 0.004 < 2 * np.pi / 128


def inside_lookup(d, p_r, p_c, qr, qc, trig, shift=0):
    """The kernel's inside test of samples (qr, qc) (P, NS) against polygons
    d (P, R) centred at (p_r, p_c) (P, 1). Returns (inside, guard 1 taken,
    guard 2 taken)."""
    R = d.shape[-1]
    ur = qr - p_r
    uc = qc - p_c
    t = theta_estimate(ur, uc) * np.float32(R / (2 * np.pi))
    t = torch.where(t < 0, t + R, t)
    k0 = t.to(torch.int64)
    k0 = torch.where(k0 >= R, k0 - R, k0)
    k0 = (k0 + shift) % R
    ks = [(k0 + o) % R for o in (-1, 0, 1, 2)]
    cr = [_cross(ur, uc, trig, k) for k in ks]
    match = [(cr[j] >= 0) & (cr[j + 1] < 0) for j in range(3)]
    m = torch.maximum(ur.abs(), uc.abs())
    guard1 = ~((m >= U_LO) & (m < U_HI))
    guard2 = ~guard1 & (match[0].int() + match[1].int() + match[2].int() != 1)
    k = torch.where(match[0], ks[0], torch.where(match[1], ks[1], ks[2]))
    v = _add_wedge([torch.zeros_like(ur)] * 4, d, k, trig, torch.ones_like(guard1))
    window = _side(ur, uc, v)
    walk = guard1 | guard2
    if walk.any():
        window = torch.where(walk, _walk(d, ur, uc, trig), window)
    return window, guard1, guard2


def _random_samples(R, seed):
    """Both polygons of chip_smoke's seeded random pairs, each against the
    S = 16 grid of its pair's bbox intersection."""
    d_r, p_r, d_c, p_c, plo, ext = chip_smoke.random_pairs(400, R, "cpu", seed)
    gr, gc = _sample_grid(16, "cpu")
    qr = plo[:, 0:1] + gr[None] * ext[:, 0:1]
    qc = plo[:, 1:2] + gc[None] * ext[:, 1:2]
    return (torch.cat([d_r, d_c]), torch.cat([p_r, p_c]),
            torch.cat([qr, qr]), torch.cat([qc, qc]))


def _adversarial_samples(R, seed):
    """Polygons (random and regular) about the origin and about an
    off-grid centre, each against every offset of
    ``chip_smoke.adversarial_offsets``."""
    rng = np.random.RandomState(seed)
    u = chip_smoke.adversarial_offsets(R)
    d = np.concatenate([rng.uniform(4, 12, (6, R)), np.full((2, R), 6.0)]).astype(np.float32)
    p = np.zeros((8, 2), np.float32)
    p[4:] = [37.25, -12.5]
    q = p[:, None, :] + u[None]
    t = torch.from_numpy
    return t(d), t(p), t(np.ascontiguousarray(q[..., 0])), t(np.ascontiguousarray(q[..., 1]))


@pytest.mark.parametrize("shift", [-1, 0, 1])
@pytest.mark.parametrize("R", RAYS)
@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_lookup_equals_the_walk(kind, R, shift):
    make = _random_samples if kind == "random" else _adversarial_samples
    d, p, qr, qc = make(R, seed=R)
    trig = trig_table(R)
    want = _inside_plain(d, p[:, 0:1], p[:, 1:2], qr, qc, trig)
    got, guard1, guard2 = inside_lookup(d, p[:, 0:1], p[:, 1:2], qr, qc, trig, shift)
    assert torch.equal(got, want)
    if kind == "random":
        # the estimate's window holds the wedge; shifted by one more, it
        # misses where the estimate was already one off (within 0.004 rad
        # of a ray: at most 0.004 R / pi of the samples)
        assert not guard1.any() and want.float().mean() > 0.1
        assert guard2.float().mean() <= (0.0 if shift == 0 else 0.004 * R / np.pi)
    else:
        assert guard1.any()       # the centre, |u| of 1e-30 and 1e-44, and above 2^64


@pytest.mark.parametrize("R", RAYS[1:])     # at R = 3 the window holds every wedge
def test_a_window_that_misses_takes_the_walk(R):
    """With the estimate two or more wedges off, the window holds no match
    (it never finds another wedge than the walk: the walk matches once), and
    the second guard gives the walk's answer."""
    d, p, qr, qc = _random_samples(R, seed=R + 1)
    trig = trig_table(R)
    want = _inside_plain(d, p[:, 0:1], p[:, 1:2], qr, qc, trig)
    for shift in range(2, R - 1):
        got, _, guard2 = inside_lookup(d, p[:, 0:1], p[:, 1:2], qr, qc, trig, shift)
        assert torch.equal(got, want)
        assert guard2.float().mean() > 0.9    # hits only where the estimate was one off
        if shift >= 4:
            break
