"""The reference's ResNet forward and warped rays against the port on the
CPU: ``reference/resnet.py`` against the port's float32 forward on seeded
weights, at strided sizes whose SAME padding is uneven; the reference's
golden-spiral rays with an anisotropy against the port's
``Rays_GoldenSpiral``; the isotropic rays as they were."""
import numpy as np
import pytest
import torch
from scipy.spatial import ConvexHull

from portbench.reference import star3d
from portbench.reference.resnet import PlainResNet, same_pads

# float32 sums of up to 27 * 128 products, in the convs' own order on each
# side, through 17 convs: a gap of a few units in the last place of the
# maps' largest magnitude, far below this
TOL = 1e-5


def notebook_net(grid):
    """The port's net of the notebook's configuration at ``grid``, its seeded
    weights and seeded biases (the port starts them at zero)."""
    from stardist_torch.models import Config3D
    from stardist_torch.models.unet import StarDistNet
    from stardist_torch.rays3d import Rays_GoldenSpiral
    conf = Config3D(backbone="resnet", rays=Rays_GoldenSpiral(96, (2, 1, 1)), grid=grid,
                    anisotropy=(2, 1, 1))
    net = StarDistNet(conf)
    gen = torch.Generator().manual_seed(sum(grid))
    net.init_weights(gen)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return conf, net


@pytest.mark.parametrize("grid", [(1, 2, 2), (2, 2, 2)])
@pytest.mark.parametrize("shape", [(10, 14, 15), (7, 13, 18)])
def test_resnet_forward_matches_the_port(grid, shape):
    from stardist_torch.models.weights import flax_variables
    torch.set_num_threads(4)
    conf, net = notebook_net(grid)
    ref = PlainResNet(conf.to_dict(), flax_variables(net)["params"], "cpu")
    x = np.random.RandomState(len(shape) + shape[0]).rand(*shape).astype(np.float32)
    prob, dist = net.forward(torch.from_numpy(x)[..., None])
    prob_r, dist_r = ref(x)
    out = tuple(-(-s // g) for s, g in zip(shape, grid))
    assert tuple(prob_r.shape) == out and tuple(dist_r.shape) == (96, *out)
    assert float((prob - prob_r).abs().max()) <= TOL
    assert float((dist - dist_r).abs().max()) <= TOL * float(dist_r.abs().max())


def test_same_padding_is_uneven_at_the_tested_sizes():
    """flax's SAME at stride 2: (0, 1) for an even extent, (1, 1) for an
    odd one; the 1x1 shortcut pads nothing."""
    assert same_pads((10, 14, 15), (3, 3, 3), (2, 2, 2)) == [(0, 1), (0, 1), (1, 1)]
    assert same_pads((7, 13, 18), (3, 3, 3), (1, 2, 2)) == [(1, 1), (1, 1), (0, 1)]
    assert same_pads((10, 14, 15), (1, 1, 1), (2, 2, 2)) == [(0, 0)] * 3
    assert same_pads((10, 14, 15), (7, 7, 7), (1, 1, 1)) == [(3, 3)] * 3


def unordered(faces):
    return {tuple(sorted(int(v) for v in f)) for f in faces}


def test_anisotropic_rays_match_the_port():
    from stardist_torch.rays3d import Rays_GoldenSpiral
    rays = Rays_GoldenSpiral(96, (2, 1, 1))
    dirs, faces = star3d.golden_spiral(96, (2, 1, 1))
    assert np.abs(dirs - rays.vertices).max() <= 1e-6
    assert np.allclose(np.linalg.norm(dirs, axis=-1), 1)
    assert len(faces) == 188 and unordered(faces) == unordered(rays.faces)
    # the warp is linear, so the hull keeps its faces; the directions move
    iso, iso_faces = star3d.golden_spiral(96)
    assert unordered(faces) == unordered(iso_faces)
    assert np.abs(dirs - iso).max() > 0.1


@pytest.mark.parametrize("n", [32, 96])
def test_isotropic_rays_are_unchanged(n):
    """Bit for bit the parent's ``golden_spiral(n)``, and the port's rays."""
    from stardist_torch.rays3d import Rays_GoldenSpiral
    g = (3.0 - np.sqrt(5.0)) * np.pi
    z = np.linspace(-1, 1, n)
    rho = np.sqrt(1.0 - z ** 2)
    verts = np.stack([z, rho * np.sin(g * np.arange(n)), rho * np.cos(g * np.arange(n))]).T
    faces = ConvexHull(verts).simplices
    dirs, got = star3d.golden_spiral(n)
    assert np.array_equal(dirs, verts / np.linalg.norm(verts, axis=-1, keepdims=True))
    assert np.array_equal(got, faces)
    rays = Rays_GoldenSpiral(n)
    assert np.abs(dirs - rays.vertices).max() <= 1e-6
    assert unordered(got) == unordered(rays.faces)


def test_other_networks_still_raise():
    from stardist_torch.models import Config3D
    conf = Config3D(backbone="resnet", grid=(1, 2, 2)).to_dict()
    for change in ({"resnet_batch_norm": True}, {"resnet_activation": "elu"},
                   {"n_classes": 2}, {"backbone": "unet"}):
        with pytest.raises(ValueError):
            PlainResNet(dict(conf, **change), {}, "cpu")
