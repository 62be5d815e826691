"""The CUDA raster kernel's inside test and boxes (``csrc/raster_tiles.cu``),
emulated in PyTorch on the CPU, against the plain twin
(``ops/raster_tiles.py::rasterize_polygons_tiles_plain``): bit for bit.

The emulation repeats the kernel's steps with the same f32 operations: the
window from the largest dist; per polygon its edges (v0, e, cross_c), its
reach, the well-formed test and its box (or the whole window); per pixel
the centre rule, the wedge estimate of ``wedge.cuh`` (shifted here by -1, 0
or +1, as an estimate off by one wedge would shift it), the walk's own
predicate on the window k0 - 1, k0, k0 + 1 with the raster's own wedge
table (whose last row ends at sin(2 pi) != 0), the matching wedge's edge
test, and the two guards that take the full walk: |u| outside [2^-60,
2^64), and a window without exactly one match; then the 32- or 64-bit
packing and a max per pixel."""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from stardist_torch.ops.raster_tiles import (PACK32_MAX, _inside_wedges, _setup, _tables,
                                             rasterize_polygons_tiles_plain, tile_window)
from test_torch_pair_lookup import theta_estimate

torch.set_num_threads(2)

U_LO, U_HI = 2.0 ** -60, 2.0 ** 64
CC_MIN, BOX_Q = np.float32(2.0 ** -60), np.float32(2.0 ** -10)
BOX_GROW = np.float32(1 + 2.0 ** -6)
RAYS = [3, 8, 32, 96, 128]     # the last wedge's ray psi below ray 0
RAYS_PSI_ABOVE = [25, 100]     # psi above ray 0: the seam's pixels match two wedges
SHAPE = (40, 56)


def kernel_window(dist, shape):
    """The kernel's window from the largest dist (f32 ceil, capped)."""
    cd = torch.ceil(dist.float().max())
    side = max(shape)
    return 2 * int(cd) + 4 if bool(cd < side) else 2 * side + 4


def polygon_edges(dist):
    """Per wedge v0r, v0c, er, ec, cross_c (N, R) each, one rounded op each."""
    feat = _tables(dist.shape[1], torch.device("cpu"))[0]
    d, d1 = dist, torch.roll(dist, -1, 1)
    v0r, v0c = d * feat[0], d * feat[1]
    er, ec = d1 * feat[2] - v0r, d1 * feat[3] - v0c
    return v0r, v0c, er, ec, ec * v0r - er * v0c


def boxes(dist, points, shape, window):
    """The kernel's pixel range per polygon: (origin (N, 2), well-formed
    (N,), [lo, hi) of rows and of columns (N, 2) each): the window clipped
    to the image and, where the polygon is well-formed, to its box."""
    _, _, er, ec, cc = polygon_edges(dist)
    reach = dist.abs().amax(1)
    ok = ((cc.abs() >= CC_MIN)
          & (cc.abs() >= (BOX_Q * reach)[:, None] * torch.sqrt(er * er + ec * ec))).all(1)
    half = reach * BOX_GROW + 1
    origin = torch.round(points).to(torch.int64) - window // 2
    size = torch.tensor(shape)
    lo = origin.clamp_min(0)
    hi = torch.minimum(origin + window, size)
    a = torch.minimum(torch.maximum(torch.ceil(points - half[:, None]), lo.float()), hi.float())
    b = torch.maximum(torch.minimum(torch.floor(points + half[:, None]) + 1, hi.float()), a)
    lo = torch.where(ok[:, None], a.long(), lo)
    hi = torch.where(ok[:, None], b.long(), hi)
    return origin, ok, lo, hi


def _in_wedge(ur, uc, wedge, k):
    return (ur * wedge[1][k] - uc * wedge[0][k] >= 0) & (ur * wedge[3][k] - uc * wedge[2][k] < 0)


def _side(ur, uc, edges, k):
    """The edge test of pixels (n, P) against wedge k (n, P) of their polygons."""
    v0r, v0c, er, ec, cc = (torch.gather(t, 1, k) for t in edges)
    cross_p = er * (uc - v0c) - ec * (ur - v0r)
    return cross_p * cc >= 0


def inside_lookup(ur, uc, edges, R, shift=0):
    """The kernel's inside test of pixels (ur, uc) (n, P) against their
    polygons' ``edges``. Returns (inside, guard 1 taken, guard 2 taken)."""
    wedge = _tables(R, torch.device("cpu"))[1]
    centre = (ur == 0) & (uc == 0)
    t = theta_estimate(ur, uc) * np.float32(R / (2 * np.pi))
    t = torch.where(t < 0, t + R, t)
    k0 = t.to(torch.int64)
    k0 = torch.where(k0 >= R, k0 - R, k0)
    ks = [(k0 + shift + o) % R for o in (-1, 0, 1)]
    match = [_in_wedge(ur, uc, wedge, k) for k in ks]
    m = torch.maximum(ur.abs(), uc.abs())
    guard1 = ~centre & ~((m >= U_LO) & (m < U_HI))
    guard2 = ~centre & ~guard1 & (match[0].int() + match[1].int() + match[2].int() != 1)
    k = torch.where(match[0], ks[0], torch.where(match[1], ks[1], ks[2]))
    inside = centre | _side(ur, uc, edges, k)
    walk = guard1 | guard2
    if walk.any():
        walked = torch.zeros_like(walk)
        for r in range(R):
            kr = torch.full_like(k, r)
            walked |= _in_wedge(ur, uc, wedge, kr) & _side(ur, uc, edges, kr)
        inside = torch.where(walk, walked, inside)
    return inside, guard1, guard2


def emulate(dist, points, shape, order, labels=None, shift=0, pack32=False):
    """The kernel's labels (int32 (H, W)) and what its guards saw."""
    H, W = shape
    dist, points = dist.float(), points.float()
    R = dist.shape[1]
    window = kernel_window(dist, shape)
    origin, ok, lo, hi = boxes(dist, points, shape, window)
    edges = polygon_edges(dist)
    low = order if labels is None else labels.long() + 1
    packed = (order.long() << (16 if pack32 else 32)) | low
    img = torch.zeros(H * W, dtype=torch.int64)
    ar = torch.arange(window)
    stats = dict(full=int((~ok & (order > 0)).sum()), guard1=0, guard2=0, pixels=0)
    chunk = max(1, (1 << 18) // (window * window))
    for i0 in range(0, len(dist), chunk):
        sl = slice(i0, i0 + chunk)
        n = len(dist[sl])
        rr = origin[sl, 0:1] + ar                               # (n, window)
        cc = origin[sl, 1:2] + ar
        use = (((rr >= lo[sl, 0:1]) & (rr < hi[sl, 0:1]))[:, :, None]
               & ((cc >= lo[sl, 1:2]) & (cc < hi[sl, 1:2]))[:, None, :]).reshape(n, -1)
        use &= (order[sl] > 0)[:, None]
        ur = (rr.float()[:, :, None] - points[sl, 0, None, None]).expand(-1, -1, window)
        uc = (cc.float()[:, None, :] - points[sl, 1, None, None]).expand(-1, window, -1)
        inside, g1, g2 = inside_lookup(ur.reshape(n, -1), uc.reshape(n, -1),
                                       [t[sl] for t in edges], R, shift)
        stats["guard1"] += int((g1 & use).sum())
        stats["guard2"] += int((g2 & use).sum())
        stats["pixels"] += int(use.sum())
        inside &= use
        flat = (rr[:, :, None] * W + cc[:, None, :]).reshape(n, -1)
        img.scatter_reduce_(0, flat[inside], packed[sl, None].expand_as(flat)[inside],
                            reduce="amax")
    mask = PACK32_MAX if pack32 else 0xFFFFFFFF
    return (img & mask).to(torch.int32).view(H, W), stats


def _field(kind, R, seed):
    if kind == "random":
        arrays = chip_smoke.polygon_field(300, SHAPE[1], seed, n_rays=R, r_range=(3, 9))
    else:
        arrays = chip_smoke.adversarial_polygons(SHAPE, R, seed, big=14.0, n_each=4)
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@functools.lru_cache(maxsize=4)
def _case(kind, R):
    """A field and the plain twin's labels of it."""
    d, p, o, lab = _field(kind, R, seed=R)
    return (d, p, o, lab), rasterize_polygons_tiles_plain(d, p, SHAPE, o, lab)


@pytest.mark.parametrize("shift", [-1, 0, 1])
@pytest.mark.parametrize("R", RAYS)
@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_lookup_equals_plain(kind, R, shift):
    (d, p, o, lab), want = _case(kind, R)
    got, stats = emulate(d, p, SHAPE, o, lab, shift=shift, pack32=shift == 0)
    assert torch.equal(got, want), int((got != want).sum())
    assert (want > 0).sum() > 200
    if kind == "random":
        # float dists of 3-9 px: every polygon well-formed, no |u| guard; the
        # shifted estimate misses where it was already one off
        assert stats["full"] == 0 and stats["guard1"] == 0
        assert stats["guard2"] <= (0.05 if shift == 0 else 0.45) * stats["pixels"]
    else:
        assert stats["full"] >= 4 and stats["guard1"] > 0 and stats["guard2"] > 0


@pytest.mark.parametrize("R", RAYS_PSI_ABOVE)
@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_lookup_equals_plain_where_the_last_wedge_overlaps_the_first(kind, R):
    """sin(R * (2 pi / R)) > 0 in f64: a pixel whose row lies on its
    polygon's centre row (to the right of it) matches wedges R - 1 and 0,
    and the window's two matches take the walk."""
    wedge = _tables(R, torch.device("cpu"))[1]
    assert wedge[2][R - 1] > 0
    (d, p, o, lab), want = _case(kind, R)
    got, stats = emulate(d, p, SHAPE, o, lab, pack32=True)
    assert torch.equal(got, want)
    assert stats["guard2"] > 0


def _extreme_field(R, seed):
    """Few polygons with dists of 0 (one, or all), 1e-3 beside 1e4 and
    beside 10, all equal: the window is capped by the image."""
    rng = np.random.RandomState(seed)
    d = rng.uniform(4, 12, (8, R))
    d[0, 3 % R] = 0.0
    d[1] = 0.0
    d[2, ::2] = 1e-3
    d[2, 1::2] = 1e4
    d[3, ::2] = 1e-3
    d[3, 1::2] = 10.0
    d[4] = 6.0
    d[5, 1] = 1e-3
    p = np.array([[10, 10], [30.5, 40], [20, 28.25], [5.5, 50], [38, 2], [-3, 20],
                  [44, 60], [20, -2.5]], np.float32)
    t = torch.from_numpy
    return t(d.astype(np.float32)), t(p), t(rng.permutation(8) + 1), t(rng.permutation(8))


@pytest.mark.parametrize("R", [8, 32, 100])
def test_lookup_equals_plain_on_extreme_dists(R):
    d, p, o, lab = _extreme_field(R, seed=R)
    assert kernel_window(d, SHAPE) == tile_window(d.max(), SHAPE) == 2 * max(SHAPE) + 4
    for labels in (lab, None):
        want = rasterize_polygons_tiles_plain(d, p, SHAPE, o, labels)
        for pack32 in (False, True):
            got, stats = emulate(d, p, SHAPE, o, labels, pack32=pack32)
            assert torch.equal(got, want)
    assert stats["full"] >= 3


@pytest.mark.parametrize("kind", ["random", "adversarial", "extreme"])
@pytest.mark.parametrize("R", [3, 32, 100, 128])
def test_no_polygon_draws_outside_its_box(kind, R):
    """On the plain twin alone: every pixel a well-formed polygon draws
    (its window, the image, the plain inside test) lies in the box the
    kernel gives it; some polygons that are not well-formed do draw beyond
    their reach, which is why they take the whole window."""
    d, p, o, lab = _extreme_field(R, R) if kind == "extreme" else _field(kind, R, seed=R + 1)
    feats, pts, origin, _, window = _setup(d, p, SHAPE, o, lab)
    assert window == kernel_window(d, SHAPE)
    _, ok, lo, hi = boxes(d, pts, SHAPE, window)
    reach = d.abs().amax(1)
    ar = torch.arange(window)
    beyond = 0
    for i0 in range(0, len(d), 64):
        sl = slice(i0, i0 + 64)
        n = len(d[sl])
        rows = (origin[sl, 0:1] + ar)[:, :, None].expand(-1, -1, window).reshape(n, -1)
        cols = (origin[sl, 1:2] + ar)[:, None, :].expand(-1, window, -1).reshape(n, -1)
        ur, uc = rows.float() - pts[sl, 0:1], cols.float() - pts[sl, 1:2]
        inside = (_inside_wedges(feats[sl], ur, uc) & (rows >= 0) & (rows < SHAPE[0])
                  & (cols >= 0) & (cols < SHAPE[1]))
        in_box = ((rows >= lo[sl, 0:1]) & (rows < hi[sl, 0:1])
                  & (cols >= lo[sl, 1:2]) & (cols < hi[sl, 1:2]))
        assert not (inside & ~in_box & ok[sl, None]).any()
        in_reach = ((ur.abs() <= reach[sl, None]) & (uc.abs() <= reach[sl, None]))
        beyond += int(((inside & ~in_reach).any(1) & ~ok[sl]).sum())
    assert ok.float().mean() > 0.9 if kind == "random" else ok.float().mean() < 1
    if kind != "random":
        assert beyond > 0


def test_kernel_window_is_tile_window():
    for dmax in (0.0, -0.5, -1.0, 0.25, 3.0, 7.5, 27.999, 28.0, 28.001, 1e4, 3e38):
        d = torch.tensor([[dmax, 0.0, 0.0]], dtype=torch.float32)
        assert kernel_window(d, SHAPE) == tile_window(d.max(), SHAPE), dmax


def test_packings_order_alike():
    """(order << 16) | (label + 1) in 32 bits and (order << 32) | (label +
    1) in 64 bits rank any two polygons alike (ties of order by label)."""
    rng = np.random.RandomState(0)
    order = torch.from_numpy(rng.randint(1, 40, 2000))
    low = torch.from_numpy(rng.randint(1, PACK32_MAX + 1, 2000))
    a, b = (order << 16) | low, (order << 32) | low
    assert torch.equal(torch.argsort(a, stable=True), torch.argsort(b, stable=True))
    assert int(a.max()) < 2 ** 32
