"""stardist_torch's tile raster (``ops/raster_tiles.py``, the plain version of
``csrc/raster_tiles.cu``) against stardist_tpu's Pallas tile kernel (in
interpret mode) and its splat raster, on the CPU. Label images must be
exactly equal."""
import numpy as np
import pytest
import torch

from stardist_tpu.ops.raster_pallas import rasterize_polygons_tiles as jax_tiles
from stardist_tpu.ops.rasterize import rasterize_polygons as jax_splat
from stardist_torch.ops.raster_tiles import (rasterize_polygons_tiles_cuda,
                                             rasterize_polygons_tiles_plain)
from stardist_torch.ops.rasterize import rasterize_polygons, rasterize_polygons_splat

torch.set_num_threads(2)


def _field(n, R, shape, seed, border=True):
    """Random float centres (tests/test_raster_pallas.py's fields)."""
    rng = np.random.RandomState(seed)
    lo = -5 if border else 15
    points = rng.uniform(lo, max(shape) + (5 if border else -15),
                         (n, 2)).astype(np.float32)
    dist = (rng.uniform(3, 12, (n, 1))
            * rng.uniform(0.85, 1.15, (n, R))).astype(np.float32)
    order = rng.permutation(n).astype(np.int32) + 1
    labels = rng.permutation(n).astype(np.int32)
    return dist, points, order, labels


def _int_field(n, R, shape, seed):
    """Integer centres on a grid of 2, as predict_instances gives them,
    some of them beyond the image border."""
    rng = np.random.RandomState(seed)
    points = (2 * rng.randint(-3, max(shape) // 2 + 3, (n, 2))).astype(np.float32)
    dist = (rng.uniform(4, 14, (n, 1)) * rng.uniform(0.8, 1.2, (n, R))).astype(np.float32)
    order = rng.permutation(n).astype(np.int32) + 1
    labels = rng.permutation(n).astype(np.int32)
    return dist, points, order, labels


FIELDS = {
    "float40": (lambda: _field(40, 16, (100, 150), seed=40), (100, 150)),
    "float150": (lambda: _field(150, 32, (256, 256), seed=150), (256, 256)),
    "float3": (lambda: _field(3, 8, (33, 45), seed=3), (33, 45)),
    "int300a": (lambda: _int_field(300, 32, (200, 220), seed=0), (200, 220)),
    "int300b": (lambda: _int_field(300, 32, (200, 220), seed=1), (200, 220)),
    "int300c": (lambda: _int_field(300, 32, (200, 220), seed=2), (200, 220)),
}


def _t(*arrays):
    return tuple(None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("with_labels", [True, False])
@pytest.mark.parametrize("name", list(FIELDS))
def test_plain_equals_jax_tile_kernel_and_splats(name, with_labels):
    make, shape = FIELDS[name]
    dist, points, order, labels = make()
    labels = labels if with_labels else None
    ref, _ = jax_tiles(dist, points, shape, order, labels=labels, interpret=True)
    got = rasterize_polygons_tiles_plain(*_t(dist, points), shape, *_t(order, labels))
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    got = got.numpy()
    assert (got > 0).sum() > 50
    assert np.array_equal(got, ref), (got != ref).sum()
    # the port's atan2 splat (its CPU raster) and the reference's splat
    splat = rasterize_polygons_splat(*_t(dist, points), shape, *_t(order, labels)).numpy()
    assert np.array_equal(got, splat), (got != splat).sum()
    ref_splat, _ = jax_splat(dist, points, shape, order, labels=labels)
    assert np.array_equal(got, ref_splat)


def test_large_order_values_and_labels_equal_jax_splat():
    """Order values >= 2^15 and labels >= 2^16, where the reference's tile
    kernel declines: the int64 packing draws them as the splat does."""
    dist, points, order, labels = _int_field(300, 32, (200, 220), seed=5)
    order = order + 40000
    labels = labels + 70000
    assert jax_tiles(dist, points, (200, 220), order, labels=labels) is None
    ref, _ = jax_splat(dist, points, (200, 220), order, labels=labels)
    got = rasterize_polygons_tiles_plain(*_t(dist, points), (200, 220), *_t(order, labels))
    assert got.numpy().max() > 2 ** 16
    assert np.array_equal(got.numpy(), ref)


def test_empty_field_is_background():
    got = rasterize_polygons_tiles_plain(torch.zeros(0, 32), torch.zeros(0, 2), (17, 23),
                                         torch.zeros(0, dtype=torch.int32))
    assert tuple(got.shape) == (17, 23) and not got.any()
    got = rasterize_polygons_tiles_plain(torch.zeros(0, 32), torch.zeros(0, 2), (5, 6),
                                         torch.zeros(0, dtype=torch.int32),
                                         out_dtype=torch.uint16)
    assert got.dtype == torch.uint16 and tuple(got.shape) == (5, 6) and not got.any()


def test_no_wraparound_at_the_top_border():
    """A polygon near the top border paints no pixel at the bottom
    (tests/test_raster_pallas.py's regression for the splat)."""
    dist = torch.full((1, 16), 8.0)
    points = torch.tensor([[1.0, 50.0]])
    img = rasterize_polygons_tiles_plain(dist, points, (64, 100), torch.tensor([1]))
    assert img[-12:, :].sum() == 0 and img[:9].sum() > 0


def test_order_zero_is_never_drawn_and_uint16_output():
    dist, points, order, labels = _int_field(300, 32, (200, 220), seed=3)
    order[::7] = 0
    d, p, o, lab = _t(dist, points, order, labels)
    a = rasterize_polygons_tiles_plain(d, p, (200, 220), o, lab)
    b = rasterize_polygons_splat(d, p, (200, 220), o, lab)
    assert torch.equal(a, b)
    assert not np.isin(a.numpy(), labels[::7] + 1).any()
    u = rasterize_polygons_tiles_plain(d, p, (200, 220), o, lab, out_dtype=torch.uint16)
    assert u.dtype == torch.uint16 and torch.equal(u.to(torch.int32), a)


def test_dispatch_runs_the_splat_on_cpu_and_refuses_other_devices():
    """rasterize_polygons draws CPU tensors with the atan2 splat; the CUDA
    wrapper takes nothing but CUDA tensors, and no other device has a
    raster."""
    dist, points, order, labels = _field(40, 16, (100, 150), seed=40)
    d, p, o, lab = _t(dist, points, order, labels)
    a = rasterize_polygons(d, p, (100, 150), o, lab)
    assert torch.equal(a, rasterize_polygons_splat(d, p, (100, 150), o, lab))
    assert torch.equal(a, rasterize_polygons_tiles_plain(d, p, (100, 150), o, lab))
    with pytest.raises(ValueError, match="bad input"):
        rasterize_polygons_tiles_cuda(d, p, (100, 150), o, lab)
    with pytest.raises(RuntimeError, match="no raster"):
        rasterize_polygons(d.to("meta"), p.to("meta"), (100, 150), o.to("meta"))
