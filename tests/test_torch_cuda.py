"""stardist_torch's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

This file imports no JAX (the card's machine has none); run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from stardist_torch.matching import matching
from stardist_torch.models import StarDist2D, StarDist3D
from stardist_torch.ops import conv as tconv
from stardist_torch.ops import lattice_overlap as tlk
from stardist_torch.ops import pair_overlap as tpo
from stardist_torch.ops import raster_polyhedra as tr3
from stardist_torch.ops import raster_tiles as trt
from stardist_torch.ops.rasterize import rasterize_polygons

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card; skips the test where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False    # the plain conv in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the full-width model's (C_in, C_out) pairs, ragged sizes, and the
# C_in = 1 first layer; W = 64 and W = 8 (narrower tiles), C = Cout = 256, H = 1,
# Cout below the wgmma width, W not a multiple of the tile's 32 columns
CONV_SHAPES = [(1, 32, 64, 256), (8, 32, 64, 256), (32, 32, 64, 256), (32, 64, 32, 128),
               (64, 128, 32, 128), (128, 256, 16, 64), (256, 128, 16, 64),
               (64, 32, 37, 45), (16, 16, 33, 129), (32, 16, 1, 3),
               (64, 64, 9, 64), (16, 32, 5, 8), (256, 256, 6, 70), (32, 24, 1, 100),
               (8, 8, 3, 33)]


@pytest.mark.parametrize("C,Cout,H,W", CONV_SHAPES)
@pytest.mark.parametrize("act", ["relu", "elu", "linear"])
def test_conv_kernel_matches_plain(cuda_device, C, Cout, H, W, act):
    rng = np.random.RandomState(C * Cout + H)
    x = torch.from_numpy(rng.randn(H, W, C).astype(np.float32)).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy((rng.randn(3, 3, C, Cout) * 0.1).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.randn(Cout).astype(np.float32)).to(cuda_device)
    n0 = tconv.KERNEL.launches
    y = tconv.conv3x3_hwc(x, w, b, act)
    torch.cuda.synchronize()
    assert tconv.KERNEL.launches == n0 + 1
    ref = tconv.conv3x3_hwc_plain(x, w, b, act)
    assert y.dtype == torch.bfloat16 and y.shape == ref.shape
    # bf16 outputs of f32 sums taken in another order
    scale = max(1.0, ref.float().abs().max().item())
    assert (y.float() - ref.float()).abs().max().item() / scale < 1e-2


# 3x3x3: C_in = 1 (padded to 8), 8 and 16; Cout 8 and 128; a ragged W of
# 130 (not a multiple of the tile); D = 3 (every plane touches a face); D = 1,
# W = 64, W = 8, and C = 128 (weights streamed per stage)
CONV3D_SHAPES = [(1, 8, 3, 5, 130), (8, 128, 3, 7, 130), (16, 8, 3, 9, 130),
                 (16, 128, 3, 4, 130), (8, 16, 5, 6, 17),
                 (32, 32, 1, 6, 64), (64, 128, 4, 3, 64), (32, 64, 3, 4, 8),
                 (128, 64, 3, 5, 23)]


@pytest.mark.parametrize("C,Cout,D,H,W", CONV3D_SHAPES)
@pytest.mark.parametrize("act", ["relu", "elu", "linear"])
def test_conv3d_kernel_matches_plain(cuda_device, C, Cout, D, H, W, act):
    rng = np.random.RandomState(C * Cout + H)
    x = torch.from_numpy(rng.randn(D, H, W, C).astype(np.float32)).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy((rng.randn(3, 3, 3, C, Cout) * 0.1).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.randn(Cout).astype(np.float32)).to(cuda_device)
    n0 = tconv.KERNEL3D.launches
    y = tconv.conv3x3x3_dhwc(x, w, b, act)
    torch.cuda.synchronize()
    assert tconv.KERNEL3D.launches == n0 + 1
    ref = tconv.conv3x3x3_dhwc_plain(x, w, b, act)
    assert y.dtype == torch.bfloat16 and y.shape == ref.shape
    # bf16 outputs of f32 sums taken in another order
    scale = max(1.0, ref.float().abs().max().item())
    assert (y.float() - ref.float()).abs().max().item() / scale < 1e-2


@pytest.mark.parametrize("nd,C,Cout,shape", [(2, 8, 32, (40, 100)), (2, 32, 128, (37, 70)),
                                             (2, 256, 128, (20, 45)), (2, 128, 256, (12, 40)),
                                             (3, 32, 32, (6, 20, 40)), (3, 64, 128, (5, 12, 23))])
def test_conv_kernel_is_deterministic_and_independent_of_position(cuda_device, nd, C, Cout,
                                                                   shape):
    """The same input twice gives bitwise equal outputs, and a crop of the
    input gives the crop's interior bitwise (every pixel's sum is taken in
    the same order whatever tile or block holds it)."""
    rng = np.random.RandomState(C + Cout + nd)
    x = torch.from_numpy(rng.randn(*shape, C).astype(np.float32)).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy((rng.randn(*(3,) * nd, C, Cout) * 0.1).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.randn(Cout).astype(np.float32)).to(cuda_device)
    fn = tconv.conv3x3_hwc if nd == 2 else tconv.conv3x3x3_dhwc
    y1, y2 = fn(x, w, b, "relu"), fn(x, w, b, "relu")
    assert torch.equal(y1, y2)
    crop = tuple(slice(s // 4, s // 4 + max(3, s // 2)) for s in shape)
    yc = fn(x[crop].contiguous(), w, b, "relu")
    inner = tuple(slice(1, -1) for _ in shape)
    full_inner = tuple(slice(c.start + 1, c.stop - 1) for c in crop)
    assert torch.equal(yc[inner], y1[full_inner])


def test_conv_kernel_splits_cout_above_256(cuda_device):
    """More than 256 output channels: one launch per 256, written into one
    output."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(6, 40, 32).astype(np.float32)).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy((rng.randn(3, 3, 32, 320) * 0.1).astype(np.float32)).to(cuda_device)
    b = torch.from_numpy(rng.randn(320).astype(np.float32)).to(cuda_device)
    n0 = tconv.KERNEL.launches
    y = tconv.conv3x3_hwc(x, w, b, "linear")
    torch.cuda.synchronize()
    assert tconv.KERNEL.launches == n0 + 2
    ref = tconv.conv3x3_hwc_plain(x, w, b, "linear")
    scale = max(1.0, ref.float().abs().max().item())
    assert (y.float() - ref.float()).abs().max().item() / scale < 1e-2


def test_numpy_inputs_run_on_the_card_by_default(cuda_device):
    """Numpy inputs of the NMS and of polygons_to_label go to the card
    unless the caller asks for the CPU: the card's kernels launch."""
    from stardist_torch.geometry import polygons_to_label
    from stardist_torch.nms import non_maximum_suppression_sparse
    rng = np.random.RandomState(0)
    d = rng.uniform(3, 9, (200, 32)).astype(np.float32)
    p = rng.uniform(8, 120, (200, 2)).astype(np.float32)
    prob = rng.uniform(0.5, 1, 200).astype(np.float32)
    n_pair, n_raster = tpo.KERNEL.launches, trt.KERNEL.launches
    got = non_maximum_suppression_sparse(d, prob, p, nms_thresh=0.3)
    lbl = polygons_to_label(d, p, (128, 128), prob=prob)
    assert tpo.KERNEL.launches > n_pair and trt.KERNEL.launches > n_raster
    ref = non_maximum_suppression_sparse(d, prob, p, nms_thresh=0.3, device="cpu")
    for a, r in zip(got, ref):
        assert isinstance(a, np.ndarray) and np.array_equal(a, r)
    assert isinstance(lbl, np.ndarray) and lbl.max() > 0


def test_conv_kernel_rejects_float32(cuda_device):
    x = torch.zeros(8, 8, 8, device=cuda_device)
    with pytest.raises(TypeError):
        tconv.conv3x3_hwc(x, torch.zeros(3, 3, 8, 8, device=cuda_device))


def _pairs(P, R, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    d_r = torch.rand(P, R, device=dev, generator=g) * 8 + 4
    d_c = torch.rand(P, R, device=dev, generator=g) * 8 + 4
    p_r = torch.rand(P, 2, device=dev, generator=g) * 10
    p_c = p_r + torch.randn(P, 2, device=dev, generator=g) * 5
    plo = torch.maximum(p_r, p_c) - 6
    ext = torch.rand(P, 2, device=dev, generator=g) * 8 + 0.5
    p_r[:4] = plo[:4] + ext[:4] * (0.5 / 8)     # samples at a polygon's exact centre
    return d_r, p_r, d_c, p_c, plo, ext


@pytest.mark.parametrize("S", [8, 16, 3, 10, 12, 24])
@pytest.mark.parametrize("R", [32, 16, 64, 3, 128])
def test_pair_kernel_matches_plain(cuda_device, S, R):
    """Random pairs, and pairs whose samples sit where the kernel's wedge
    lookup is most likely to go wrong (on a ray, +-1 ulp off it, at the
    centre, |u| tiny or huge, theta near +-pi), with S's extent, so that
    the offset is a sample of the grid; at the cascade's two grids (8, 16)
    and at any other S the NMS's samples option sets."""
    from chip_smoke import adversarial_pairs
    args = [torch.cat(ts) for ts in zip(_pairs(20000, R, cuda_device, S + R),
                                         adversarial_pairs(R, cuda_device, extents=(S,)))]
    n0 = tpo.KERNEL.launches
    got = tpo.pair_frac(*args, S=S)
    torch.cuda.synchronize()
    assert tpo.KERNEL.launches == n0 + 1
    ref = tpo.pair_frac_plain(*args, S=S)
    assert torch.equal(got, ref)    # counts of 0/1 samples: bit for bit


def _nuclei(shape, n, seed):
    """Seeded non-overlapping discs, blurred, with noise (+ their labels)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    lbl = np.zeros(shape, np.int32)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for k in range(1, n + 1):
        r = rng.uniform(7, 13)
        cy, cx = rng.uniform(r, shape[0] - r), rng.uniform(r, shape[1] - r)
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
        if not (lbl[mask] > 0).any():
            lbl[mask] = k
    img = gaussian_filter((lbl > 0).astype(np.float32), 1.5)
    img += 0.05 * rng.normal(size=shape).astype(np.float32)
    return img.astype(np.float32), lbl


def test_predict_instances_on_card_agrees_with_cpu(cuda_device):
    img, lbl = _nuclei((256, 320), 40, 0)
    gm = StarDist2D(None, "2D_demo", "models/examples", device=cuda_device)
    n_conv, n_pair = tconv.KERNEL.launches, tpo.KERNEL.launches
    lab, res = gm.predict_instances(img)
    assert tconv.KERNEL.launches - n_conv == len(gm.net.conv_blocks())
    assert tpo.KERNEL.launches > n_pair
    cm = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
    lab_cpu, _ = cm.predict_instances(img)
    # bf16 convs on the card can flip borderline candidates
    assert matching(lab_cpu, lab, thresh=0.5).accuracy >= 0.95
    assert matching(lbl, lab, thresh=0.5).accuracy >= 0.8


def _nuclei3d(shape, n, seed):
    """Seeded non-overlapping balls, blurred, with noise (+ their labels)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    lbl = np.zeros(shape, np.int32)
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    for k in range(1, n + 1):
        r = rng.uniform(4, 7)
        c = [rng.uniform(r, s - r) for s in shape]
        mask = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 < r ** 2
        if not (lbl[mask] > 0).any():
            lbl[mask] = k
    img = gaussian_filter((lbl > 0).astype(np.float32), 1.0)
    img += 0.05 * rng.normal(size=shape).astype(np.float32)
    return img.astype(np.float32), lbl


def test_float32_model_runs_the_plain_convs_on_the_card(cuda_device):
    """inference_dtype="float32" on the card: no conv kernel launches (the
    f32 route is the plain convs, chosen by the net's type), the pair and
    raster kernels still launch, and the labels agree with the CPU port."""
    img, lbl = _nuclei((256, 320), 40, 0)
    gm = StarDist2D(None, "2D_demo", "models/examples", device=cuda_device,
                    inference_dtype="float32")
    n_conv, n_pair, n_raster = tconv.KERNEL.launches, tpo.KERNEL.launches, trt.KERNEL.launches
    lab, _ = gm.predict_instances(img)
    torch.cuda.synchronize()
    assert tconv.KERNEL.launches == n_conv
    assert tpo.KERNEL.launches > n_pair and trt.KERNEL.launches > n_raster
    cm = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
    lab_cpu, _ = cm.predict_instances(img)
    # f32 on both: only the sums' order differs
    assert matching(lab_cpu, lab, thresh=0.5).accuracy >= 0.99
    assert matching(lbl, lab, thresh=0.5).accuracy >= 0.8
    # and back to bfloat16: one kernel launch per conv
    gm.set_inference_precision("bfloat16")
    gm.predict_instances(img)
    assert tconv.KERNEL.launches == n_conv + len(gm.net.conv_blocks())


def test_predict_instances_3d_on_card_agrees_with_cpu(cuda_device):
    img, lbl = _nuclei3d((32, 64, 64), 20, 0)
    gm = StarDist3D(None, "3D_demo", "models/examples", device=cuda_device)
    n_conv = tconv.KERNEL3D.launches
    lab, res = gm.predict_instances(img)
    assert tconv.KERNEL3D.launches - n_conv == len(gm.net.conv_blocks())
    cm = StarDist3D(None, "3D_demo", "models/examples", device="cpu")
    lab_cpu, res_cpu = cm.predict_instances(img)
    # bf16 convs on the card can flip borderline candidates
    assert abs(len(res["prob"]) - len(res_cpu["prob"])) <= 1
    assert matching(lab_cpu, lab, thresh=0.5).accuracy >= 0.9
    assert matching(lbl, lab, thresh=0.1).accuracy >= 0.8


def _polygons(n, R, shape, seed, r_range=(4, 14), grid=None):
    """Seeded star polygons, some crossing the image border: float centres,
    or integer centres on a grid of ``grid`` (as predict_instances gives
    them); seeded order values (a permutation, 1-based) and labels."""
    rng = np.random.RandomState(seed)
    if grid is None:
        points = rng.uniform(-5, np.array(shape) + 5, (n, 2))
    else:
        points = grid * rng.randint(-3, np.array(shape) // grid + 3, (n, 2))
    dist = rng.uniform(*r_range, (n, 1)) * rng.uniform(0.8, 1.2, (n, R))
    order = rng.permutation(n) + 1
    labels = rng.permutation(n)
    return (torch.from_numpy(dist.astype(np.float32)), torch.from_numpy(points.astype(np.float32)),
            torch.from_numpy(order), torch.from_numpy(labels))


@pytest.mark.parametrize("field", ["float", "int", "dense", "large_values", "no_labels"])
def test_raster_kernel_matches_plain(cuda_device, field):
    shape = (300, 411)
    n = {"dense": 4000}.get(field, 400)
    dist, points, order, labels = _polygons(n, 32, shape, seed=len(field),
                                            grid=None if field == "float" else 2)
    if field == "large_values":       # order >= 2^15, labels >= 2^16: 64-bit packing
        order, labels = order + 40000, labels + 70000
    if field == "no_labels":
        labels = None
    order[::9] = 0                    # never drawn
    args = [t.to(cuda_device) for t in (dist, points, order)]
    lab = None if labels is None else labels.to(cuda_device)
    n0 = trt.KERNEL.launches
    got = rasterize_polygons(*args[:2], shape, args[2], lab)
    torch.cuda.synchronize()
    assert trt.KERNEL.launches == n0 + 1
    ref = trt.rasterize_polygons_tiles_plain(*args[:2], shape, args[2], lab)
    assert got.dtype == torch.int32 and got.shape == shape and got.is_cuda
    assert (got > 0).sum().item() > 1000
    assert torch.equal(got, ref)


def test_raster_kernel_empty_field_and_uint16(cuda_device):
    shape = (70, 90)
    n0 = trt.KERNEL.launches
    for value_bound in (None, 0):
        for dtype in (torch.int32, torch.uint16):
            img = rasterize_polygons(torch.zeros(0, 32, device=cuda_device),
                                     torch.zeros(0, 2, device=cuda_device), shape,
                                     torch.zeros(0, dtype=torch.int64, device=cuda_device),
                                     out_dtype=dtype, value_bound=value_bound)
            assert img.shape == shape and img.is_cuda and img.dtype == dtype
            assert not img.to(torch.int32).any()     # torch has no any() of uint16
    assert trt.KERNEL.launches == n0
    dist, points, order, labels = (t.to(cuda_device) for t in _polygons(60, 32, shape, seed=3))
    u = rasterize_polygons(dist, points, shape, order, labels, out_dtype=torch.uint16)
    i = rasterize_polygons(dist, points, shape, order, labels)
    assert u.dtype == torch.uint16 and torch.equal(u.to(torch.int32), i)


@pytest.mark.parametrize("R", [3, 32, 100, 128])
@pytest.mark.parametrize("field", ["random", "adversarial", "capped"])
def test_raster_kernel_matches_plain_with_both_packings(cuda_device, field, R):
    """The kernel's wedge lookup and boxes, with the 32-bit packing (a value
    bound below 2^16) and the 64-bit one, to int32 and to uint16, against
    the plain twin: on random polygons, on polygons where the lookup and
    the boxes are most likely to go wrong (chip_smoke.adversarial_polygons;
    R = 100: the last wedge overlaps the first), and on such a field whose
    dist of 1e4 caps the window at the image."""
    from chip_smoke import adversarial_polygons, polygon_field
    if field == "random":
        shape = (411, 411)
        arrays = polygon_field(3000, 411, seed=R, n_rays=R)
    elif field == "adversarial":
        shape = (300, 411)
        arrays = adversarial_polygons(shape, R, seed=R, big=40.0)
    else:
        shape = (60, 90)
        arrays = adversarial_polygons(shape, R, seed=R, big=1e4, n_each=2)
    d, p, o, lab = (torch.from_numpy(np.asarray(a)).to(cuda_device) for a in arrays)
    ref = trt.rasterize_polygons_tiles_plain(d, p, shape, o, lab)
    assert (ref > 0).sum().item() > 500
    for value_bound in (len(d), None):
        for dtype in (torch.int32, torch.uint16):
            n0 = trt.KERNEL.launches
            got = trt.rasterize_polygons_tiles_cuda(d, p, shape, o, lab, out_dtype=dtype,
                                                    value_bound=value_bound)
            torch.cuda.synchronize()
            assert trt.KERNEL.launches == n0 + 1
            assert got.dtype == dtype and tuple(got.shape) == shape
            assert torch.equal(got.to(torch.int32), ref)


@pytest.mark.parametrize("scale_dist", [(0.5, 0.5), (1.0, 0.5), (2.0, 1.0), (0.7, 1.7)])
@pytest.mark.parametrize("field", ["random", "adversarial"])
def test_scaled_raster_kernel_matches_plain(cuda_device, field, scale_dist):
    """Polygons stretched by scale_dist about non-integer centres
    (chip_smoke.scaled_field): the kernel against the plain twin, both
    packings; unscaled, the same call gives the unscaled twin's labels."""
    from chip_smoke import adversarial_polygons, polygon_field, scaled_field
    shape = (300, 411)
    if field == "random":
        d, p, o, lab = polygon_field(2000, 411, seed=5, n_rays=32)
    else:
        d, p, o, lab = adversarial_polygons(shape, 32, seed=5, big=40.0)
    p = scaled_field(p, scale_dist, seed=6)
    d, p, o, lab = (torch.from_numpy(np.asarray(a)).to(cuda_device) for a in (d, p, o, lab))
    ref = trt.rasterize_polygons_tiles_plain(d, p, shape, o, lab, scale_dist=scale_dist)
    assert (ref > 0).sum().item() > 500
    for value_bound in (len(d), None):
        got = trt.rasterize_polygons_tiles_cuda(d, p, shape, o, lab, scale_dist=scale_dist,
                                                value_bound=value_bound)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    assert torch.equal(trt.rasterize_polygons_tiles_cuda(d, p, shape, o, lab),
                       trt.rasterize_polygons_tiles_plain(d, p, shape, o, lab))


def test_dense_path_and_threshold_search_on_the_card(cuda_device):
    """sparse=False equals sparse=True on the card; the threshold search on
    the card's dense prediction returns what the CPU port returns on the
    same maps; scale=0.5 draws through the raster kernel."""
    from chip_smoke import synthetic_nuclei
    from stardist_torch.utils import optimize_threshold
    m = StarDist2D(None, "2D_demo", "models/examples", device=cuda_device)
    cpu = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
    img, lbl = synthetic_nuclei((256, 256), seed=3)
    lab_s, _ = m.predict_instances(img)
    lab_d, _ = m.predict_instances(img, sparse=False)
    assert np.array_equal(lab_s, lab_d) and lab_s.max() > 5
    n0 = trt.KERNEL.launches
    lab_sc, _ = m.predict_instances(img, scale=0.5)
    assert trt.KERNEL.launches == n0 + 1 and lab_sc.shape == img.shape
    yhat = [m.predict(img)]
    assert (optimize_threshold([lbl], yhat, m, 0.4, verbose=0)
            == optimize_threshold([lbl], yhat, cpu, 0.4, verbose=0))


def test_raster_kernel_makes_no_host_sync(cuda_device):
    dist, points, order, labels = (t.to(cuda_device) for t in _polygons(400, 32, (300, 411), 4))
    trt.rasterize_polygons_tiles_cuda(dist, points, (300, 411), order, labels)   # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for value_bound in (None, 400):
            trt.rasterize_polygons_tiles_cuda(dist, points, (300, 411), order, labels,
                                              out_dtype=torch.uint16, value_bound=value_bound)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_predict_instances_device_equals_predict_instances_on_card(cuda_device):
    img, _ = _nuclei((256, 320), 40, 0)
    gm = StarDist2D(None, "2D_demo", "models/examples", device=cuda_device)
    ref_lab, ref = gm.predict_instances(img)
    n0 = trt.KERNEL.launches
    lab, det = gm.predict_instances_device(img)
    assert trt.KERNEL.launches == n0 + 1
    np.testing.assert_array_equal(lab, ref_lab)
    for k in ("points", "prob", "coord"):
        np.testing.assert_array_equal(det[k], ref[k])
    lab_d, det_d = gm.predict_instances_device(torch.from_numpy(img).to(cuda_device),
                                               fetch=False)
    assert lab_d.is_cuda and lab_d.dtype == torch.uint16 and det_d["dist"].is_cuda
    np.testing.assert_array_equal(lab_d.cpu().numpy().astype(np.int32), ref_lab)


def test_tiled_predict_instances_on_card(cuda_device):
    img, lbl = _nuclei((512, 512), 150, 1)
    gm = StarDist2D(None, "2D_demo", "models/examples", device=cuda_device)
    lab1, _ = gm.predict_instances(img)
    lab2, _ = gm.predict_instances(img, n_tiles=(2, 2))
    assert matching(lab1, lab2, thresh=0.5).accuracy >= 0.99
    assert matching(lbl, lab2, thresh=0.5).accuracy >= 0.8


def _train_models(cuda_device, **kw):
    from stardist_torch.models import Config2D
    cfg = Config2D(n_rays=16, grid=(2, 2), unet_n_depth=2, unet_n_filter_base=16,
                   net_conv_after_unet=32, train_patch_size=(128, 128), train_batch_size=2, **kw)
    return [StarDist2D(cfg, name="t", basedir=None, device=d) for d in (cuda_device, "cpu")]


def test_train_step_on_card_agrees_with_cpu(cuda_device):
    """One step's targets, loss, metrics and gradients on the card against
    the CPU's, same batch and weights, TF32 off (the fixture): dist exact,
    prob 1e-6, metrics rtol 1e-4, gradients 1e-3 of their largest."""
    from stardist_torch.models.model2d import StarDistData2D
    fields = [_nuclei((256, 256), 30, s) for s in range(3)]
    data = StarDistData2D([f[0] for f in fields], [f[1].astype(np.int32) for f in fields],
                          batch_size=2, n_rays=16, length=1, patch_size=(128, 128), grid=(2, 2))
    np.random.seed(0)
    raw = data.raw_item(0)
    outs = []
    for m in _train_models(cuda_device):
        m.prepare_for_training()
        t = m._targets_fn(m._put_batch(raw))
        loss, metrics = m._loss_and_metrics(t)
        loss.backward()
        outs.append((t, {k: float(v) for k, v in metrics.items()},
                     {k: p.grad.cpu() for k, p in m.net.named_parameters()}))
    (tg, mg, gg), (tc, mc, gc) = outs
    assert torch.equal(tg["dist"][..., :16].cpu(), tc["dist"][..., :16])
    assert (tg["prob"].cpu() - tc["prob"]).abs().max() <= 1e-6
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-4 * abs(mc[k]), k
    for k in gc:
        assert (gg[k] - gc[k]).abs().max() <= 1e-3 * gc[k].abs().max(), k


def test_inference_after_training_uses_the_updated_weights(cuda_device):
    """The conv kernel's packed weights are cached on the weight tensor and
    keyed on its version: after Adam's in-place updates, and after
    load_state_dict, the kernel path agrees with the plain path."""
    from stardist_torch.models.model2d import StarDistData2D
    gm, cm = _train_models(cuda_device)
    fields = [_nuclei((256, 256), 30, s) for s in range(2)]
    X, Y = [f[0] for f in fields], [f[1].astype(np.int32) for f in fields]
    x = torch.from_numpy(X[0][:, :, None]).to(cuda_device)
    before = gm.net(x)[1].clone()                    # fills the cache with the initial weights
    gm.train(X, Y, validation_data=(X[:1], Y[:1]), seed=0, epochs=1, steps_per_epoch=3)
    prob, dist = gm.net(x)
    prob_p, dist_p = gm.net(x, plain=True)
    assert (dist - before).abs().max() > 1e-3       # the weights did move
    assert (prob - prob_p).abs().max() < 2e-2
    assert (dist - dist_p).abs().max() < 2e-2 * max(1.0, dist_p.abs().max().item())
    gm.net.load_state_dict(cm.net.state_dict())      # back to the initial weights
    assert (gm.net(x)[1] - before).abs().max() < 1e-6


def test_train_on_card_and_its_step_makes_no_host_sync(cuda_device):
    gm, _ = _train_models(cuda_device)
    fields = [_nuclei((256, 256), 30, s) for s in range(2)]
    X, Y = [f[0] for f in fields], [f[1].astype(np.int32) for f in fields]
    h = gm.train(X, Y, validation_data=(X[:1], Y[:1]), seed=0, epochs=2, steps_per_epoch=2)
    assert len(h.history["loss"]) == 2 and np.isfinite(h.history["loss"]).all()
    gm.prepare_for_training()
    np.random.seed(1)
    raw = {k: torch.from_numpy(v).pin_memory() if isinstance(v, np.ndarray) else v
           for k, v in gm.data_train.raw_item(0).items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")          # a sync in the step raises
    try:
        gm._train_step(gm._put_batch(raw))
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _train3d_models(cuda_device, backbone):
    from stardist_torch.models import Config3D
    kw = (dict(resnet_n_blocks=2, resnet_n_filter_base=8, net_conv_after_resnet=16)
          if backbone == "resnet" else dict(unet_n_depth=1, unet_n_filter_base=8,
                                            net_conv_after_unet=16))
    cfg = Config3D(n_rays=32, grid=(1, 2, 2), anisotropy=(2.0, 1.0, 1.0), backbone=backbone,
                   train_patch_size=(16, 64, 64), train_batch_size=2, **kw)
    return [StarDist3D(cfg, name="t", basedir=None, device=d) for d in (cuda_device, "cpu")]


def test_march_and_edt_3d_on_card_equal_cpu(cuda_device):
    """The 3D star-distance march (bounded by march_steps and not) and the
    EDT with spacing (2, 1, 1): the card's bits are the CPU's."""
    from stardist_torch.ops.edt import edt_prob_batch
    from stardist_torch.ops.stardist3d import march_steps, star_dist3d
    from stardist_torch.rays3d import Rays_GoldenSpiral
    y = np.stack([_nuclei3d((24, 64, 64), 20, s)[1] for s in range(2)])
    labels = np.zeros((2, 21), np.int32)
    for j in range(2):
        u = np.unique(y[j][y[j] > 0])
        labels[j, :len(u)] = u
    rays = Rays_GoldenSpiral(64, anisotropy=(2.0, 1.0, 1.0))
    yc, yg = torch.from_numpy(y), torch.from_numpy(y).to(cuda_device)
    for n_steps in (None, march_steps(y, rays)):
        a = star_dist3d(yg, rays, (1, 2, 2), n_steps=n_steps)
        assert torch.equal(a.cpu(), star_dist3d(yc, rays, (1, 2, 2), n_steps=n_steps))
    lab = torch.from_numpy(labels)
    e = edt_prob_batch(yg, lab.to(cuda_device), (2.0, 1.0, 1.0))
    assert torch.equal(e.cpu(), edt_prob_batch(yc, lab, (2.0, 1.0, 1.0))) and e.max() > 0.99


@pytest.mark.parametrize("backbone", ["unet", "resnet"])
def test_train3d_step_on_card_agrees_with_cpu(cuda_device, backbone):
    """One 3D step's targets (exactly), loss, metrics (rtol 1e-4) and
    gradients (1e-3 of their largest) on the card against the CPU's."""
    from stardist_torch.models.model3d import StarDistData3D
    fields = [_nuclei3d((24, 96, 96), 30, s) for s in range(3)]
    gm, cm = _train3d_models(cuda_device, backbone)
    data = StarDistData3D([f[0] for f in fields], [f[1] for f in fields], rays=cm.rays,
                          batch_size=2, length=1, patch_size=(16, 64, 64), grid=(1, 2, 2),
                          anisotropy=(2.0, 1.0, 1.0), device="cpu")
    np.random.seed(0)
    raw = data.raw_item(0)
    outs = []
    for m in (gm, cm):
        m.prepare_for_training()
        t = m._targets_fn(m._put_batch(raw))
        loss, metrics = m._loss_and_metrics(t)
        loss.backward()
        outs.append((t, {k: float(v) for k, v in metrics.items()},
                     {k: p.grad.cpu() for k, p in m.net.named_parameters()}))
    (tg, mg, gg), (tc, mc, gc) = outs
    for k in ("x", "prob", "dist"):
        assert torch.equal(tg[k].cpu(), tc[k]), k
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-4 * abs(mc[k]), k
    for k in gc:
        assert (gg[k] - gc[k]).abs().max() <= 1e-3 * gc[k].abs().max(), k


def test_resnet_forward_on_card(cuda_device):
    """The ResNet's inference route on the card: bf16 F.conv3d within 2e-2
    of the CPU's f32 forward (the kernel-vs-plain tolerance of chip_smoke),
    f32 on the card (TF32 off) within 1e-4; no conv kernel launch."""
    gm, cm = _train3d_models(cuda_device, "resnet")
    x = torch.from_numpy(_nuclei3d((16, 64, 96), 10, 1)[0][..., None])
    n0 = tconv.KERNEL3D.launches
    prob, dist = gm.net(x.to(cuda_device))
    assert tconv.KERNEL3D.launches == n0 and gm.net.dtype == torch.bfloat16
    prob_c, dist_c = cm.net(x)
    scale = max(1.0, dist_c.abs().max().item())
    assert (prob.cpu() - prob_c).abs().max() < 2e-2
    assert (dist.cpu() - dist_c).abs().max() < 2e-2 * scale
    gm.set_inference_precision("float32")
    prob32, dist32 = gm.net(x.to(cuda_device))
    assert (prob32.cpu() - prob_c).abs().max() < 1e-4
    assert (dist32.cpu() - dist_c).abs().max() < 1e-4 * scale


def test_3d_device_path_fetch_false_returns_cuda_tensors(cuda_device):
    """The 3D device path runs the reference's device lattice, S = 10."""
    img, _ = _nuclei3d((32, 96, 96), 12, 3)
    gm = StarDist3D(None, "3D_demo", "models/examples", device=cuda_device)
    lab, det = gm.predict_instances(img, nms_kwargs={"samples": 10})
    lab_d, det_d = gm.predict_instances_device(img)
    assert np.array_equal(lab_d, lab) and lab.max() > 0
    lab_t, det_t = gm.predict_instances_device(img, fetch=False)
    assert lab_t.is_cuda and lab_t.dtype == torch.int32
    assert all(det_t[k].is_cuda for k in ("dist", "points", "prob"))
    assert np.array_equal(lab_t.cpu().numpy(), lab)
    lab_s, _ = gm.predict_instances(img, sparse=False, nms_kwargs={"samples": 10})
    assert np.array_equal(lab_s, lab)


@pytest.mark.parametrize("S", [6, 10, 12])
def test_3d_nms_at_samples_on_card_equals_cpu(cuda_device, S):
    """The CPU's 3D candidates through the card's and the CPU's NMS and
    render at lattice S: labels and survivors equal."""
    img, _ = _nuclei3d((32, 96, 96), 12, 3)
    cm = StarDist3D(None, "3D_demo", "models/examples", device="cpu")
    gm = StarDist3D(None, "3D_demo", "models/examples", device=cuda_device)
    prob, dist, points = cm._predict_sparse(img)
    lab_c, det_c = cm._instances_from_prediction(img.shape, prob, dist, points, samples=S)
    lab_g, det_g = gm._instances_from_prediction(
        img.shape, *(t.to(cuda_device) for t in (prob, dist, points)), samples=S)
    assert np.array_equal(lab_g, lab_c) and lab_c.max() > 0
    for k in ("points", "prob", "dist"):
        assert np.array_equal(det_g[k], det_c[k])


@pytest.mark.parametrize("S", [1, 6, 10, 12, 24])
def test_lattice_kernel_matches_plain_on_3d_demo_exact_pairs(cuda_device, S):
    """Every pair that 3D_demo's NMS tests exactly on a seeded volume at
    lattice S: the kernel's two counts are the plain version's, and the
    call launched the kernel once per exact round."""
    from chip_smoke import exact_pairs
    img, _ = _nuclei3d((32, 96, 96), 12, 3)
    gm = StarDist3D(None, "3D_demo", "models/examples", device=cuda_device)
    n0 = tlk.KERNEL.launches
    args, rounds = exact_pairs(gm, img, S)
    assert tlk.KERNEL.launches - n0 == rounds > 0 and len(args[3]) > 100
    got = tlk.lattice_counts(*args, S)
    ref = tlk.lattice_counts_plain(*args, S)
    assert torch.equal(got, ref)
    assert int(ref[:, 0 if S == 1 else 1].sum()) > 0     # S = 1: the box's corner only


@pytest.mark.parametrize("S", [1, 6, 10, 12, 24])
@pytest.mark.parametrize("rays", ["golden32", "golden96", "octahedron"])
def test_lattice_kernel_matches_plain_on_adversarial_pairs(cuda_device, rays, S):
    """Seeded pairs with degenerate faces and strides above 1; octahedra
    whose faces pass through lattice points; and one-point lattices whose
    barycentric coordinates lie at, and one f32 ulp either side of, the
    inside test's bounds, beside empty lattices and degenerate faces."""
    from chip_smoke import lattice_bound_cases, lattice_pair_set, octahedron_rays
    from stardist_torch.ops.polyhedron import ray_tensors
    from stardist_torch.rays3d import Rays_GoldenSpiral
    if rays == "octahedron":
        dirs, faces = octahedron_rays()
    else:
        dirs, faces = ray_tensors(Rays_GoldenSpiral(int(rays[6:])))
    args = lattice_pair_set(dirs, faces, 100, S, cuda_device, seed=S,
                            integer=rays == "octahedron")
    got = tlk.lattice_counts(*args, S)
    assert torch.equal(got, tlk.lattice_counts_plain(*args, S))
    assert int(got[:, 0 if S == 1 else 1].sum()) > 0     # S = 1: the box's corner only
    bounds = lattice_bound_cases(len(faces), cuda_device)
    got = tlk.lattice_counts(*bounds[:8], S)
    assert torch.equal(got, bounds[8])
    assert torch.equal(got, tlk.lattice_counts_plain(*bounds[:8], S))


def test_lattice_kernel_makes_no_host_sync(cuda_device):
    from chip_smoke import lattice_pair_set
    from stardist_torch.ops.polyhedron import ray_tensors
    from stardist_torch.rays3d import Rays_GoldenSpiral
    args = lattice_pair_set(*ray_tensors(Rays_GoldenSpiral(32)), 60, 12, cuda_device, seed=0)
    tlk.lattice_counts(*args, 12)                                            # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tlk.lattice_counts(*args, 12)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_3d_predict_instances_runs_the_lattice_kernel(cuda_device):
    """The main 3D path launches the lattice kernel once per exact round,
    and its lattice counters are filled."""
    img, _ = _nuclei3d((32, 96, 96), 12, 3)
    gm = StarDist3D(None, "3D_demo", "models/examples", device=cuda_device)
    n0 = tlk.KERNEL.launches
    _, det = gm.predict_instances(img)
    c = det["nms_counters"]
    assert tlk.KERNEL.launches - n0 == c["n_rounds"] > 0
    assert c["n_lattice_points"] > c["n_lattice_inside_first"] > 0


@pytest.mark.parametrize("mode", ["full", "kernel", "bbox"])
def test_raster3d_kernel_matches_plain_on_3d_demo_survivors(cuda_device, mode):
    """The survivors that a 3D_demo call draws on a seeded volume: the
    kernel's labels and counts, with and without the count, are those of the
    plain version on the same tensors moved to the CPU, in every mode."""
    from chip_smoke import raster3d_args, raster3d_vs_twin
    img, _ = _nuclei3d((48, 128, 128), 40, 3)
    gm = StarDist3D(None, "3D_demo", "models/examples", device=cuda_device)
    args = raster3d_args(gm, img)
    assert len(args[0]) >= 20
    want, _, _ = raster3d_vs_twin("3D_demo", *args, mode)
    assert len(torch.unique(want)) - 1 >= 20


@pytest.mark.parametrize("mode", ["full", "kernel", "bbox"])
@pytest.mark.parametrize("rays", ["golden96", "golden32", "octahedron"])
def test_raster3d_kernel_matches_plain_on_adversarial_polyhedra(cuda_device, rays, mode):
    """Seeded polyhedra, overlapping, cut by the volume's edges, with
    degenerate faces and tied and zero order values (polyhedra_field), with
    and without labels; on the octahedron with integer centres and dists,
    faces through voxels."""
    from chip_smoke import polyhedra_field, raster3d_rays, raster3d_vs_twin
    dirs, faces = raster3d_rays(rays, cuda_device)
    shape = (40, 72, 64)
    dist, points, order, labels = polyhedra_field(dirs, 120, shape, cuda_device, seed=7,
                                                  integer=rays == "octahedron")
    for lab in (labels, None):
        want, want_cnt, _ = raster3d_vs_twin(rays, dist, points, dirs, faces, shape, order, lab,
                                             mode)
        assert want.max() > 0 and want_cnt.max() > 1


def test_raster3d_kernel_capped_window_empty_and_undrawn(cuda_device):
    """A polyhedron larger than the volume (the window capped at 2 max(D,
    H, W) + 4), a call whose every order value is 0, and an empty call: the
    plain version's images, and no launch without polyhedra."""
    from chip_smoke import polyhedra_field, raster3d_rays, raster3d_vs_twin
    dirs, faces = raster3d_rays("golden96", cuda_device)
    shape = (12, 20, 16)
    dist, points, order, labels = polyhedra_field(dirs, 10, shape, cuda_device, seed=3)
    dist[0] = 60.0
    for mode in ("full", "kernel", "bbox"):
        for o, drawn in ((order, True), (order * 0, False)):
            want, _, _ = raster3d_vs_twin("capped", dist, points, dirs, faces, shape, o, labels,
                                          mode)
            assert bool(want.any()) == drawn
    n0 = tr3.KERNEL.launches
    img, cnt = tr3.rasterize_polyhedra_cuda(dist[:0], points[:0], dirs, faces, shape, order[:0],
                                            labels[:0], return_count=True)
    assert tr3.KERNEL.launches == n0
    assert img.shape == cnt.shape == shape and not img.any() and not cnt.any()


def test_raster3d_kernel_makes_no_host_sync(cuda_device):
    from chip_smoke import polyhedra_field, raster3d_rays
    dirs, faces = raster3d_rays("golden96", cuda_device)
    shape = (40, 72, 64)
    dist, points, order, labels = polyhedra_field(dirs, 60, shape, cuda_device, seed=0)
    tr3.rasterize_polyhedra_cuda(dist, points, dirs, faces, shape, order, labels)   # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for mode in ("full", "kernel", "bbox"):
            tr3.rasterize_polyhedra_cuda(dist, points, dirs, faces, shape, order, labels,
                                         return_count=True, mode=mode)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_3d_predict_instances_draws_with_one_raster3d_launch(cuda_device):
    """A 3D predict_instances call on the card launches the 3D raster kernel
    once and records one ``stardist.raster.inside`` span (and no
    ``.scatter``, the CPU's chunks' span)."""
    from torch.profiler import ProfilerActivity, profile
    img, _ = _nuclei3d((32, 96, 96), 12, 3)
    gm = StarDist3D(None, "3D_demo", "models/examples", device=cuda_device)
    gm.predict_instances(img)                                                    # builds
    n0 = tr3.KERNEL.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lab, _ = gm.predict_instances(img)
    names = [e.name for e in prof.events()]
    assert tr3.KERNEL.launches - n0 == 1
    assert names.count("stardist.raster.inside") == 1
    assert "stardist.raster.scatter" not in names
    assert lab.max() > 0


@pytest.mark.parametrize("S", [4, 10, 12, 20])
def test_2d_nms_at_samples_on_card_equals_cpu(cuda_device, S):
    """The CPU's 2D candidates through the card's NMS (the pair kernel at
    the fine grid S) and the CPU's: the same keep flags."""
    from stardist_torch.nms import non_maximum_suppression_inds
    cm = StarDist2D(None, "2D_demo", "models/examples", device="cpu")
    img, _ = _nuclei((512, 512), 120, 5)
    prob, dist, points = cm._predict_sparse(img)
    o = torch.argsort(prob, descending=True, stable=True)
    args = dist[o], points[o], prob[o]
    keep_c = non_maximum_suppression_inds(*args, samples=S)
    n0 = tpo.KERNEL.launches
    keep_g = non_maximum_suppression_inds(*(t.to(cuda_device) for t in args), samples=S)
    assert tpo.KERNEL.launches > n0
    assert torch.equal(keep_g.cpu(), keep_c) and 0 < int(keep_c.sum()) < len(keep_c)


def _graft(cuda_device, Model, Config, name, n_classes):
    """``models/examples/<name>`` with a seeded class branch, on the card,
    and the same model on the CPU."""
    demo = Model(None, name, "models/examples", device=cuda_device)
    cfg = Config(**dict(demo.config.to_dict(), n_classes=n_classes,
                        train_loss_weights=(1, 0.2, 1),
                        train_class_weights=(1,) * (n_classes + 1)))
    gm = Model(cfg, basedir=None, device=cuda_device)
    gm.net.load_state_dict(demo.net.state_dict(), strict=False)
    gm.thresholds = demo.thresholds
    cm = Model(cfg, basedir=None, device="cpu")
    cm.net.load_state_dict({k: v.cpu() for k, v in gm.net.state_dict().items()})
    cm.thresholds = demo.thresholds
    return demo, gm, cm


def test_multiclass_forward_three_channels_kernel_matches_plain(cuda_device):
    """The C = 3 first layer (padded to 8 channels) and the class branch's
    feature conv through the kernel: one launch per conv, prob, dist and
    prob_class within the forward tolerance of the plain path."""
    from stardist_torch.models import Config2D
    from stardist_torch.models.unet import StarDistNet
    net = StarDistNet(Config2D(n_channel_in=3, n_classes=6, grid=(2, 2), unet_n_depth=2,
                               unet_n_filter_base=16, net_conv_after_unet=64),
                      dtype=torch.bfloat16)
    net.init_weights(torch.Generator().manual_seed(0))
    net.to(cuda_device)
    x = torch.rand(256, 320, 3, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    n0 = tconv.KERNEL.launches
    prob, dist, pc = net(x)
    torch.cuda.synchronize()
    assert tconv.KERNEL.launches - n0 == len(net.conv_blocks())
    assert net.conv_blocks()[0].weight.shape[-2] == 3 and net.feat_class in net.conv_blocks()
    prob_p, dist_p, pc_p = net(x, plain=True)
    assert pc.shape == (7, 128, 160)
    assert (prob - prob_p).abs().max() < 2e-2 and (pc - pc_p).abs().max() < 2e-2
    assert (dist - dist_p).abs().max() / dist_p.abs().max().clamp_min(1) < 2e-2


def test_multiclass_predict_on_card(cuda_device):
    """2D_demo with a class branch on the card: labels and survivors those
    of 2D_demo, class rows the class map at the survivors; the card's
    candidates through the card's and the CPU's NMS and raster give the
    same labels and class rows; fetch=False keeps the class rows there."""
    from stardist_torch.models import Config2D
    img, _ = _nuclei((256, 320), 40, 0)
    demo, gm, cm = _graft(cuda_device, StarDist2D, Config2D, "2D_demo", 6)
    lab_d, det_d = demo.predict_instances(img)
    lab, det = gm.predict_instances(img)
    assert np.array_equal(lab, lab_d) and np.array_equal(det["points"], det_d["points"])
    pc = gm.predict(img)[2]
    assert np.array_equal(det["class_prob"], pc[tuple((det["points"] // 2).T)])
    assert np.array_equal(det["class_id"], np.argmax(det["class_prob"], -1))
    prob, dist, pcs, points = gm._predict_sparse(img)
    lab_g, det_g = gm._instances_from_prediction(img.shape, prob, dist, points, pcs)
    lab_c, det_c = cm._instances_from_prediction(img.shape, prob.cpu(), dist.cpu(),
                                                 points.cpu(), pcs.cpu())
    assert np.array_equal(lab_g, lab_c)
    for k in ("points", "class_prob", "class_id"):
        assert np.array_equal(det_g[k], det_c[k]), k
    lab_t, det_t = gm.predict_instances_device(img, fetch=False)
    assert det_t["class_prob"].is_cuda and det_t["class_id"].is_cuda
    assert np.array_equal(det_t["class_id"].cpu().numpy(), det["class_id"])


def test_multiclass_train_step_on_card_agrees_with_cpu(cuda_device):
    """One multiclass step (host targets, class maps with ignored pixels),
    card vs CPU with TF32 off: metrics rtol 1e-4, gradients 1e-3."""
    from stardist_torch.models.model2d import StarDistData2D
    fields = [_nuclei((256, 256), 30, s) for s in range(3)]
    Y = [f[1].astype(np.int32) for f in fields]
    Y[1][Y[1] % 3 == 0] = -1
    classes = [{int(i): int(i) % 3 + 1 for i in np.unique(y[y > 0])} for y in Y]
    outs = []
    for m in _train_models(cuda_device, n_classes=3):
        data = StarDistData2D([f[0] for f in fields], Y, batch_size=2, n_rays=16, length=1,
                              n_classes=3, classes=classes, patch_size=(128, 128), grid=(2, 2),
                              device=m.device)
        np.random.seed(0)
        (x,), targets = data[0]
        m.prepare_for_training()
        batch = m._put_batch(dict(zip(("x", "prob", "dist", "prob_class"), (x, *targets))))
        loss, metrics = m._loss_and_metrics(batch)
        loss.backward()
        outs.append((targets, {k: float(v) for k, v in metrics.items()},
                     {k: p.grad.cpu() for k, p in m.net.named_parameters()}))
    (tg, mg, gg), (tc, mc, gc) = outs
    assert all(np.array_equal(a, b) for a, b in zip(tg, tc))
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-4 * abs(mc[k]), k
    for k in gc:
        assert (gg[k] - gc[k]).abs().max() <= 1e-3 * gc[k].abs().max(), k


def test_multiclass_3d_predict_on_card(cuda_device):
    from stardist_torch.models import Config3D
    img, _ = _nuclei3d((32, 64, 64), 20, 0)
    demo, gm, cm = _graft(cuda_device, StarDist3D, Config3D, "3D_demo", 2)
    n0 = tconv.KERNEL3D.launches
    lab, det = gm.predict_instances(img)
    assert tconv.KERNEL3D.launches - n0 == len(gm.net.conv_blocks())
    lab_d, det_d = demo.predict_instances(img)
    assert np.array_equal(lab, lab_d) and len(det["prob"]) > 0
    pc = gm.predict(img)[2]
    assert np.array_equal(det["class_prob"], pc[tuple((det["points"] // (1, 2, 2)).T)])
    lab_v, det_v = gm.predict_instances_device(img, fetch=False)
    assert det_v["class_id"].is_cuda
    assert np.array_equal(det_v["class_id"].cpu().numpy(), det["class_id"])


def test_predict_instances_big_on_card(cuda_device):
    """Block-wise on the card: every block through the kernels, labels
    1..n, one class row per object, and the same objects as one call."""
    from stardist_torch.models import Config2D
    img, _ = _nuclei((640, 600), 300, 2)
    demo, gm, _ = _graft(cuda_device, StarDist2D, Config2D, "2D_demo", 3)
    gm._axes_tile_overlap("YX")          # the receptive field's two forwards, before counting
    n_conv, n_raster = tconv.KERNEL.launches, trt.KERNEL.launches
    lab, det = gm.predict_instances_big(img, "YX", block_size=256, min_overlap=64, context=32)
    n_blocks = trt.KERNEL.launches - n_raster
    assert n_blocks == 16 and tconv.KERNEL.launches - n_conv == n_blocks * len(gm.net.conv_blocks())
    assert lab.max() == len(det["prob"]) == len(det["class_id"]) == len(det["class_prob"])
    lab_1, _ = demo.predict_instances(img)
    assert matching(lab_1, lab, thresh=0.5).accuracy >= 0.98


def test_sharded_big_on_card(cuda_device):
    """predict_instances_big_sharded with two slots on the card: every
    block through the kernels, labels the block-wise call's."""
    from stardist_torch.parallel import predict_instances_big_sharded
    img, _ = _nuclei((640, 600), 300, 2)
    model = StarDist2D(None, "2D_demo", "models/examples", device=cuda_device)
    kw = dict(block_size=256, min_overlap=64, context=32)
    want, dw = model.predict_instances_big(img, "YX", **kw)
    n_conv, n_raster = tconv.KERNEL.launches, trt.KERNEL.launches
    timings = {}
    got, dg = predict_instances_big_sharded(model, img, "YX", devices=[cuda_device] * 2,
                                            timings=timings, **kw)
    n_blocks = timings["blocks"]
    assert trt.KERNEL.launches - n_raster == n_blocks == 16 and timings["batches"] == 8
    assert tconv.KERNEL.launches - n_conv == n_blocks * len(model.net.conv_blocks())
    assert matching(want, got, thresh=0.99).accuracy == 1.0 and len(dg["prob"]) == len(dw["prob"])


def test_dp_step_on_card(cuda_device):
    """One data-parallel step on two gloo ranks sharing the card, against
    one process on the whole batch (dryrun_multichip)."""
    from stardist_torch.parallel import dryrun_multichip
    out = dryrun_multichip(2, device="cuda", timeout=300)
    assert out["backend"] == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")
    assert out["rows_per_rank"] == [1, 1] and out["max_grad_err"] <= 1e-4


def test_predict_sparse_device_dist_on_card(cuda_device):
    """predict_sparse(device_dist=True) on the card: dist a CUDA tensor on
    the model's device whose rows, with prob and points, are exactly
    device_dist=False's."""
    img, _ = _nuclei((300, 330), 60, 4)
    model = StarDist2D(None, "2D_demo", "models/examples", device=cuda_device)
    prob, dist, points = model.predict_sparse(img, device_dist=True)
    prob0, dist0, points0 = model.predict_sparse(img)
    assert isinstance(dist, torch.Tensor) and dist.device.type == "cuda"
    assert len(prob) > 50 and np.array_equal(dist.cpu().numpy(), dist0)
    assert np.array_equal(prob, prob0) and np.array_equal(points, points0)


def test_cli_2d_on_card(cuda_device, tmp_path, monkeypatch):
    """The 2D CLI on the card (the constructor's default device): the label
    file equals the in-process predict_instances exactly, through the conv,
    pair and raster kernels. Where imageio is not installed, the CLI's
    reader and writer are swapped for np.load / np.save here."""
    import importlib.util
    from stardist_torch.core.normalize import normalize
    from stardist_torch.scripts import predict2d
    img, _ = _nuclei((512, 512), 120, 5)
    img = np.clip(img * 1000 + 100, 0, 65535).astype(np.uint16)
    if importlib.util.find_spec("imageio") is None:
        monkeypatch.setattr(predict2d, "_imread", lambda p, ndim=2: np.load(p))
        monkeypatch.setattr(predict2d, "_imwrite", lambda p, a: np.save(p, a, allow_pickle=False))
        src, out = tmp_path / "f.npy", tmp_path / "f.labels.tif.npy"
        np.save(src, img)
    else:
        import imageio.v2 as imageio
        src, out = tmp_path / "f.tif", tmp_path / "f.labels.tif"
        imageio.imwrite(src, img)
    args = predict2d.make_parser(2).parse_args(["-i", str(src), "-o", str(tmp_path), "-m",
                                                "2D_demo", "--modeldir", "models/examples"])
    n = (tconv.KERNEL.launches, tpo.KERNEL.launches, trt.KERNEL.launches)
    predict2d.run(args, StarDist2D, 2)
    assert all(k.launches > n0 for k, n0 in zip((tconv.KERNEL, tpo.KERNEL, trt.KERNEL), n))
    got = np.load(out) if out.suffix == ".npy" else predict2d._imread(out)
    model = StarDist2D(None, "2D_demo", "models/examples")
    want, _ = model.predict_instances(normalize(img, 1, 99.8))
    assert got.dtype == np.uint16 and want.max() > 10 and np.array_equal(got, want)


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("act,batch_norm", [("tanh", False), ("sigmoid", False),
                                            ("swish", False), ("gelu", True), ("relu", True),
                                            ("elu", True)])
def test_conv_block_options_on_the_kernel_match_plain(cuda_device, nd, act, batch_norm):
    """A block with an activation outside the epilogue (the kernel's linear
    output, then the activation in bf16) or a batch norm (folded into the
    kernel's weights and bias, once): one kernel launch per call against
    the plain twin; the fold and the packed weights made once."""
    from stardist_torch.models.unet import ConvBlock
    rng = np.random.RandomState(nd * 7 + len(act))
    blk = ConvBlock(16, 48, act, nd, batch_norm=batch_norm)
    with torch.no_grad():
        blk.weight.copy_(torch.from_numpy((rng.randn(*blk.weight.shape) * 0.1).astype(np.float32)))
        blk.bias.copy_(torch.from_numpy(rng.randn(48).astype(np.float32)))
        if batch_norm:
            for t, lo, hi in ((blk.bn.scale, 0.8, 1.2), (blk.bn.bias, -0.1, 0.1),
                              (blk.bn.mean, -0.1, 0.1), (blk.bn.var, 0.5, 2.0)):
                t.copy_(torch.from_numpy(rng.uniform(lo, hi, 48).astype(np.float32)))
    blk.to(cuda_device)
    kernel = tconv.KERNEL if nd == 2 else tconv.KERNEL3D
    sp = (40, 70) if nd == 2 else (6, 20, 37)
    x = torch.from_numpy(rng.randn(*sp, 16).astype(np.float32)).to(cuda_device, torch.bfloat16)
    n0 = kernel.launches
    y = blk(x)
    y2 = blk(x)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 2 and torch.equal(y, y2)
    if batch_norm:
        w = blk.bn.fold(blk.weight, blk.bias)[0]
        assert w is blk.bn._folded[1] and len(w._conv_sm90_packed[1]) == 1
    ref = blk(x, plain=True)
    assert y.dtype == torch.bfloat16 and y.shape == ref.shape
    scale = max(1.0, ref.float().abs().max().item())
    assert (y.float() - ref.float()).abs().max().item() / scale < 1e-2


def test_batch_norm_and_gelu_nets_on_the_kernel_match_plain(cuda_device):
    """Small batch-norm and gelu U-Nets and a 5x5 one (cuDNN, no kernel
    launch): the kernel path within the forward tolerance of the plain
    path, the conv kernel launched once per 3x3 conv."""
    from stardist_torch.models import Config2D
    from stardist_torch.models.unet import BatchNorm, StarDistNet
    for kw in (dict(unet_batch_norm=True), dict(unet_activation="gelu"),
               dict(unet_kernel_size=(5, 5))):
        net = StarDistNet(Config2D(grid=(2, 2), unet_n_depth=2, unet_n_filter_base=16,
                                   net_conv_after_unet=64, **kw), dtype=torch.bfloat16)
        net.init_weights(torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(2)
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, BatchNorm):
                    m.mean.copy_(torch.rand(m.mean.shape, generator=g) * 0.2 - 0.1)
                    m.var.copy_(torch.rand(m.var.shape, generator=g) * 1.5 + 0.5)
        net.to(cuda_device)
        x = torch.rand(256, 320, 1, generator=torch.Generator().manual_seed(1)).to(cuda_device)
        n0 = tconv.KERNEL.launches
        prob, dist = net(x)
        torch.cuda.synchronize()
        assert tconv.KERNEL.launches - n0 == len(net.conv_blocks())
        assert len(net.conv_blocks()) == (0 if "unet_kernel_size" in kw else 13)
        prob_p, dist_p = net(x, plain=True)
        assert (prob - prob_p).abs().max() < 2e-2
        assert (dist - dist_p).abs().max() / dist_p.abs().max().clamp_min(1) < 2e-2
