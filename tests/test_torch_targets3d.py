"""stardist_torch's 3D training targets against the JAX package's on the
same inputs: the star-distance march, the min-plus EDT with anisotropy, the
fused targets of the training step and the host path's batches
(StarDistData3D), the public star_dist3D.

Tolerances: all exact. The march, the EDT and the fused targets are the
same float32 operations on both sides; the host path's scipy prob is the
same numpy code."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from stardist_torch.geometry import star_dist3D
from stardist_torch.models import Config3D, StarDist3D
from stardist_torch.models.model3d import StarDistData3D
from stardist_torch.ops import edt as tedt
from stardist_torch.ops import stardist3d as tsd
from stardist_torch.rays3d import Rays_GoldenSpiral
from stardist_tpu.models import Config3D as Config3DJax, StarDist3D as StarDist3DJax
from stardist_tpu.models.model3d import StarDistData3D as StarDistData3DJax
from stardist_tpu.ops.edt import edt_prob_core as edt_prob_core_jax
from stardist_tpu.ops.stardist3d import _star_dist3d_impl, star_dist3d_batch, star_dist3d_numpy
from stardist_tpu.rays3d import Rays_GoldenSpiral as RaysJax
from utils import synthetic_nuclei_3d

torch.set_num_threads(2)


def _volumes(n=2, shape=(16, 32, 40), seed=0):
    out = [synthetic_nuclei_3d(shape, n=12, seed=seed + i) for i in range(n)]
    return [x for x, _ in out], [y.astype(np.int32) for _, y in out]


def _rays(n, anisotropy):
    r, rj = Rays_GoldenSpiral(n, anisotropy=anisotropy), RaysJax(n, anisotropy=anisotropy)
    assert np.array_equal(r.vertices, rj.vertices)
    return r, rj


@pytest.mark.parametrize("anisotropy", [None, (2.0, 1.0, 1.0)])
@pytest.mark.parametrize("grid", [(1, 2, 2), (2, 2, 2)])
def test_march_equals_jax_and_numpy_oracle(grid, anisotropy):
    _, (lbl, _) = _volumes(seed=3)
    rays, rays_j = _rays(32, anisotropy)
    a = tsd.star_dist3d(torch.from_numpy(lbl), rays, grid).numpy()
    assert a.dtype == np.float32 and a.max() > 3
    ref = np.asarray(_star_dist3d_impl(jnp.asarray(lbl), jnp.asarray(rays_j.vertices), grid,
                                       tsd._default_max_dist(lbl.shape)))
    assert np.array_equal(a, ref)
    assert np.array_equal(a, star_dist3d_numpy(lbl, rays_j, grid))
    # bounded by march_steps (no host sync): the same
    b = tsd.star_dist3d(torch.from_numpy(lbl), rays, grid, n_steps=tsd.march_steps(lbl, rays))
    assert np.array_equal(a, b.numpy())


def test_march_batch_with_chunks_and_the_clamped_offsets(monkeypatch):
    """A batch against star_dist3d_batch, several gathers per step range
    and start voxels; and a volume wider than the padding P = max_dist + 1,
    where the reference's shifted slices clamp each offset to P and rays
    alive at the step cap report max_dist."""
    _, lbls = _volumes(n=2, shape=(12, 24, 28), seed=6)
    y = np.stack(lbls)
    rays, rays_j = _rays(16, None)
    ref = star_dist3d_batch(y, rays_j, grid=(1, 2, 2))
    monkeypatch.setattr(tsd, "_BUDGET", 5000)
    assert np.array_equal(tsd.star_dist3d(torch.from_numpy(y), rays, (1, 2, 2)).numpy(), ref)
    big = np.ones((10, 30, 34), np.int32)
    big[:, :, 20:] = 2
    got = tsd.star_dist3d(torch.from_numpy(big), rays, (1, 1, 1), max_dist=5).numpy()
    want = np.asarray(_star_dist3d_impl(jnp.asarray(big), jnp.asarray(rays_j.vertices),
                                        (1, 1, 1), 5))
    assert np.array_equal(got, want) and (got == 5).any()


@pytest.mark.parametrize("extent", [1, 2, 9])
def test_march_steps_bounds_every_ray(extent):
    """Lines along each axis, a diagonal and a cube (the longest rays for
    their box) end within the bound, for unit and anisotropic rays."""
    lbl = np.zeros((24, 24, 24), np.int32)
    lbl[2, 2, 2:2 + extent] = 1
    lbl[4:4 + extent, 20, 20] = 2
    idx = np.arange(extent)
    lbl[12 + idx, 3 + idx, 12 + idx] = 3
    lbl[13:13 + extent, 13:13 + extent, 13:13 + extent][
        lbl[13:13 + extent, 13:13 + extent, 13:13 + extent] == 0] = 4
    for rays in (Rays_GoldenSpiral(32), Rays_GoldenSpiral(32, anisotropy=(3.0, 1.0, 1.0))):
        n = tsd.march_steps(lbl, rays)
        a = tsd.star_dist3d(torch.from_numpy(lbl), rays, n_steps=n).numpy()
        assert np.array_equal(a, star_dist3d_numpy(lbl, rays))


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (2.0, 1.0, 1.0), (2.4, 1.0, 0.7)])
def test_edt_with_spacing_equals_jax_bitwise(spacing):
    _, (lbl, _) = _volumes(seed=8)
    labels = np.concatenate([np.unique(lbl[lbl > 0]), np.zeros(3)]).astype(np.int32)
    a = tedt.edt_prob_core(torch.from_numpy(lbl), torch.from_numpy(labels), spacing).numpy()
    b = np.asarray(edt_prob_core_jax(lbl, labels, spacing))
    assert np.array_equal(a, b) and a.max() > 0.99


def test_edt_chunked_along_the_lines_equals_unchunked(monkeypatch):
    """Label chunks of one, and each axis's lines in chunks of a few (as a
    128^3 patch needs): the same bits."""
    _, lbls = _volumes(n=2, shape=(12, 20, 24), seed=9)
    y = torch.from_numpy(np.stack(lbls))
    labels = torch.from_numpy(np.stack([np.arange(1, 14), np.arange(1, 14)]).astype(np.int32))
    a = tedt.edt_prob_batch(y, labels, (2.0, 1.0, 1.0))
    monkeypatch.setattr(tedt, "_BUDGET", 3 * 24 * 24)
    assert torch.equal(a, tedt.edt_prob_batch(y, labels, (2.0, 1.0, 1.0)))


CFG = dict(n_rays=16, grid=(1, 2, 2), anisotropy=(2.0, 1.0, 1.0), unet_n_depth=1,
           unet_n_filter_base=8, train_patch_size=(16, 32, 32), train_batch_size=2)


def _data_kwargs(rays, grid=(1, 2, 2)):
    return dict(rays=rays, batch_size=2, length=4, patch_size=(16, 32, 32), grid=grid,
                anisotropy=(2.0, 1.0, 1.0), foreground_prob=0.9)


@pytest.mark.parametrize("negative", [False, True])
def test_fused_targets_equal_jax_and_the_host_batch(negative):
    """The raw batch, the fused targets of the training step and the host
    path's batch (StarDistData3D[i], under the same np.random seed), each
    against stardist_tpu's (tests/test_fused_targets.py's 3D case); the
    port's fused targets also equal its own host batch."""
    imgs, lbls = _volumes(n=2, shape=(24, 48, 48), seed=0)
    if negative:
        lbls[0][:, :20, :20] = -1                      # losses off there
    jm = StarDist3DJax(Config3DJax(**CFG), name="t", basedir=None)
    jm.prepare_for_training()
    tm = StarDist3D(Config3D(**CFG), name="t", basedir=None, device="cpu")
    tm.prepare_for_training()
    jdata = StarDistData3DJax(imgs, lbls, **_data_kwargs(jm.rays))
    tdata = StarDistData3D(imgs, lbls, **_data_kwargs(tm.rays), device="cpu")
    jfn = jm._device_targets_fn()
    for i in range(2):
        np.random.seed(300 + i)
        jraw = jdata.raw_item(i)
        np.random.seed(300 + i)
        traw = tdata.raw_item(i)
        assert np.array_equal(jraw["x"], traw["x"]) and np.array_equal(jraw["y"], traw["y"])
        n = traw["labels"].shape[1]
        assert np.array_equal(jraw["labels"][:, :n], traw["labels"])
        ref = {k: np.asarray(v) for k, v in jfn({k: np.asarray(v) for k, v in jraw.items()}).items()}
        out = {k: v.numpy() for k, v in tm._targets_fn(tm._put_batch(traw)).items()}
        for k in ("x", "prob", "dist"):
            assert np.array_equal(out[k], ref[k]), k
        assert (out["prob"] == -1).any() == negative
        np.random.seed(300 + i)
        (xj,), (pj, dj) = jdata[i]
        np.random.seed(300 + i)
        (xt,), (pt, dt) = tdata[i]
        assert np.array_equal(xj, xt) and np.array_equal(pj, pt) and np.array_equal(dj, dt)
        assert np.array_equal(dt[..., :-1], out["dist"][..., :-1])
        assert np.abs(pt - out["prob"]).max() <= 1e-5    # scipy's EDT against the min-plus


def test_star_dist3D_public_api():
    _, (lbl, _) = _volumes(seed=4)
    rays, rays_j = _rays(16, None)
    ref = star_dist3d_numpy(lbl, rays_j, (1, 2, 2))
    for mode in ("torch", "jax", "cpp"):
        d = star_dist3D(lbl, rays, grid=(1, 2, 2), mode=mode, device="cpu")
        assert isinstance(d, np.ndarray) and d.dtype == np.float32 and np.array_equal(d, ref)
    assert np.array_equal(star_dist3D(lbl, rays, (1, 2, 2), mode="numpy"), ref)
    t = star_dist3D(torch.from_numpy(lbl), rays, (1, 2, 2))        # a tensor: on its device
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), ref)
    with pytest.raises(ValueError):
        star_dist3D(lbl, rays, mode="opengl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):                  # numpy goes to the card by default
            star_dist3D(lbl, rays)
