"""The port's 3D ResNet against the benchmark's plain reference on the CPU:
``StarDistNet.forward`` (the float32 plain route) against
``portbench/reference/resnet.py`` on seeded weights of upstream's 3D
notebook model, at grids (1, 2, 2) and (2, 2, 2) and on extents whose
strided SAME padding is uneven; the reference's anisotropic golden-spiral
rays against ``stardist_torch.rays3d.Rays_GoldenSpiral(96, (2, 1, 1))``."""
import numpy as np
import pytest
import torch

from portbench.reference import star3d
from portbench.reference.resnet import PlainResNet, same_pads
from stardist_torch.models import Config3D
from stardist_torch.models.unet import StarDistNet
from stardist_torch.models.weights import flax_variables
from stardist_torch.rays3d import Rays_GoldenSpiral

# float32 sums of up to 27 * 128 products, in each side's own order, through
# 17 convs: the two differ by a few units in the last place of the maps'
# largest magnitude (~1e-7 relative), far below this
TOL = 1e-5


def notebook_net(grid):
    """The notebook's net at ``grid`` with the port's seeded weights and
    seeded biases (the port starts them at zero)."""
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
def test_port_forward_matches_the_reference(grid, shape):
    torch.set_num_threads(2)
    conf, net = notebook_net(grid)
    # the strided convs pad unevenly (before != after) along some axis here
    pool = (2, 2, 2) if grid == (2, 2, 2) else (1, 2, 2)
    assert any(lo != hi for lo, hi in same_pads(shape, (3, 3, 3), pool))
    ref = PlainResNet(conf.to_dict(), flax_variables(net)["params"], "cpu")
    x = np.random.RandomState(shape[0] + sum(grid)).rand(*shape).astype(np.float32)
    prob, dist = net.forward(torch.from_numpy(x)[..., None])
    prob_r, dist_r = ref(x)
    out = tuple(-(-s // g) for s, g in zip(shape, grid))
    assert tuple(prob.shape) == tuple(prob_r.shape) == out
    assert tuple(dist.shape) == tuple(dist_r.shape) == (96, *out)
    assert float((prob - prob_r).abs().max()) <= TOL
    assert float((dist - dist_r).abs().max()) <= TOL * float(dist_r.abs().max())


def unordered(faces):
    return {tuple(sorted(int(v) for v in f)) for f in faces}


def test_reference_anisotropic_rays_equal_the_ports():
    rays = Rays_GoldenSpiral(96, (2, 1, 1))
    dirs, faces = star3d.golden_spiral(96, (2, 1, 1))
    assert dirs.shape == (96, 3) and len(faces) == 188
    assert np.abs(dirs - rays.vertices).max() <= 1e-6
    assert unordered(faces) == unordered(rays.faces)
