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
from stardist_torch.ops import pair_overlap as tpo
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


@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("R", [32, 16, 64, 3, 128])
def test_pair_kernel_matches_plain(cuda_device, S, R):
    """Random pairs, and pairs whose samples sit where the kernel's wedge
    lookup is most likely to go wrong (on a ray, +-1 ulp off it, at the
    centre, |u| tiny or huge, theta near +-pi)."""
    from chip_smoke import adversarial_pairs
    args = [torch.cat(ts) for ts in zip(_pairs(20000, R, cuda_device, S + R),
                                         adversarial_pairs(R, cuda_device))]
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
