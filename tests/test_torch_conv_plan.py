"""The host-side pieces of the Hopper conv kernel (stardist_torch/ops/conv.py),
on the CPU: the weight packing, the tile and chunk planner, and a numpy
emulation of what the kernel reads (the halo tile through each lane's
ldmatrix row address, the packed weights through the wgmma B descriptor's
core-matrix offsets) held against the plain conv; and conv.py's copies of
the kernel's shared-memory values and layout held to the header's own; and
the kernel libraries' names, which follow the headers they include."""
import re
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from stardist_torch.models import Config2D, Config3D, StarDist2D, StarDist3D
from stardist_torch.models.unet import StarDistNet
from stardist_torch.ops import conv as tconv
from stardist_torch.ops.cuda_build import CudaKernel, local_sources

CHANNELS = [8, 16, 32, 64, 128, 256]


def tile_origins(spatial, plan):
    """(z, row, column) of the first output pixel of every tile, in the
    kernel's order (conv_sm90.cuh: tile t is plane t / (tiles_y * tiles_x),
    then row-major; block b of a grid of G takes tiles b, b + G, ...)."""
    D, H, W = (1,) * (3 - len(spatial)) + tuple(spatial)
    return [(z, r, c) for z in range(D) for r in range(0, H, plan.th)
            for c in range(0, W, plan.tw)]


def unpack_weights(img, nd, C, cout, kc, bn):
    """Inverse of ``pack_weights`` (co0 = 0): the (3,)*nd + (C, cout) bf16
    weights."""
    planes = 3 if nd == 3 else 1
    Cp = -(-C // kc) * kc
    nch, steps = Cp // kc, tconv.steps_per_stage(kc)
    wk = img.reshape(nch, planes, steps, bn // 8, 2, 8, 8).permute(0, 1, 2, 4, 6, 3, 5)
    wk = wk.reshape(nch, planes, 16 * steps, bn)[:, :, :9 * kc]
    wk = wk.reshape(nch, planes, 9, kc, bn).permute(1, 2, 0, 3, 4)
    return wk.reshape((3,) * nd + (Cp, bn))[..., :C, :cout]


@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("Cout", CHANNELS)
def test_pack_weights_round_trips(C, Cout):
    """The packing is a permutation (plus zero padding) of the HWIO / DHWIO
    weights, at the plan's chunk for 2D and 3D, and at every chunk that
    divides C."""
    rng = np.random.RandomState(C + Cout)
    for nd in (2, 3):
        w = torch.from_numpy(rng.randn(*(3,) * nd, C, Cout).astype(np.float32))
        plan = tconv.conv_plan((16,) * nd, C, Cout)
        for kc in sorted({plan.kc} | {k for k in tconv.KCS if C % k == 0}):
            img = tconv.pack_weights(w, kc, plan.bn)
            steps = tconv.steps_per_stage(kc)
            assert img.dtype == torch.bfloat16
            assert img.numel() == (C // kc) * (3 if nd == 3 else 1) * steps * plan.bn * 16
            back = unpack_weights(img, nd, C, Cout, kc, plan.bn)
            # a permutation: every weight comes back exactly (in bf16) and
            # the padding holds only zeros
            assert torch.equal(back, w.to(torch.bfloat16))
            assert img.float().abs().sum().item() == pytest.approx(
                w.to(torch.bfloat16).float().abs().sum().item(), rel=1e-5)


def test_plans_cover_resident_and_streamed_weights():
    """Small layers keep their weights in shared memory, large ones stream a
    slice per stage; every plan fits the block's shared memory with a ring
    of at least 3 stages."""
    seen = set()
    for nd in (2, 3):
        planes = 3 if nd == 3 else 1
        for C in CHANNELS:
            for Cout in CHANNELS:
                p = tconv.conv_plan((64,) * nd, C, Cout)
                seen.add(p.resident)
                assert C % p.kc == 0 and p.bn >= Cout and p.stages >= 3
                assert tconv.smem_bytes(p.kc, p.bn, planes, C // p.kc, p.resident, p.stages,
                                        (p.th + 2) * (p.tw + 2)) <= tconv.smem_limit(p.bn)
    assert seen == {True, False}
    assert tconv.conv_plan((64, 64), 32, 32).resident
    assert not tconv.conv_plan((64, 64), 256, 128).resident
    assert not tconv.conv_plan((8, 64, 64), 64, 128).resident


HEADER = Path(tconv.__file__).resolve().parents[1] / "csrc" / "conv_sm90.cuh"


def _c_to_py(expr):
    """A C expression of conv_sm90.cuh as Python: integer division, no
    casts or unsigned suffixes, ``||``, and ``c ? a : b`` (innermost
    parenthesis level first)."""
    expr = re.sub(r"\(uint32_t\)", "", expr)
    expr = re.sub(r"\b(\d+)u\b", r"\1", expr)
    expr = expr.replace("/", "//").replace("||", " or ")
    while "?" in expr:
        q = expr.index("?")
        lo, depth = q, 0
        while lo > 0 and not (expr[lo - 1] == "(" and depth == 0):
            depth += {")": 1, "(": -1}.get(expr[lo - 1], 0)
            lo -= 1
        colon, hi, depth = None, len(expr), 0
        for j in range(q + 1, len(expr)):
            if expr[j] == ")" and depth == 0:
                hi = j
                break
            depth += {"(": 1, ")": -1}.get(expr[j], 0)
            if expr[j] == ":" and depth == 0 and colon is None:
                colon = j
        expr = (expr[:lo] + f"(({expr[q + 1:colon]}) if ({expr[lo:q]}) else "
                f"({expr[colon + 1:hi]}))" + expr[hi:])
    return expr


def _header():
    """The header's integer constants, its one-line constexpr functions and
    its ``Layout``, as Python: (namespace, layout(kc, bn, p) -> smem bytes)."""
    src = re.sub(r"//[^\n]*", "", HEADER.read_text())
    ns = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    for name, arg, body in re.findall(
            r"constexpr (?:int|bool|uint32_t) (\w+)\((?:int|uint32_t) (\w+)\) \{\s*return "
            r"([^;]+);\s*\}", src):
        ns[name] = eval(f"lambda {arg}: {_c_to_py(body)}", ns)
    body = re.search(r"Layout\(int kc, int bn, const Params& p\) \{(.*?)\}", src, re.S).group(1)
    assigns = [line.strip().split(" = ", 1) for line in body.split(";") if line.strip()]
    assigns = [(name, _c_to_py(rhs)) for name, rhs in assigns]

    def layout(kc, bn, p):
        env = dict(ns, kc=kc, bn=bn, p=p)
        for name, rhs in assigns:
            env[name] = eval(rhs, env)
        return env["smem"]
    return ns, layout


def test_header_values_match_the_planner():
    """conv.py's copies of the kernel's constants and rules (the shared
    memory of a block, blocks per SM, the staged store, the k16 steps of a
    stage) are the header's."""
    ns, _ = _header()
    for name in ("TILE_M", "MAX_STAGES", "SMEM_SM", "SMEM_RESERVED", "SMEM_SLACK", "BAR_BYTES"):
        assert ns[name] == getattr(tconv, name), name
    for bn in tconv.BNS:
        assert ns["smem_limit"](bn) == tconv.smem_limit(bn)
        assert ns["staged_store"](bn) == (bn in tconv.STAGED_STORE_N)
        assert (ns["blocks_per_sm"](bn) == 2) == (bn <= tconv.TWO_BLOCKS_MAX_N)
    for kc in tconv.KCS:
        assert ns["steps_per_stage"](kc) == tconv.steps_per_stage(kc)
        assert ns["align1024"](kc * 1000) == tconv._align1024(kc * 1000)


@pytest.mark.parametrize("nd", [2, 3])
def test_header_layout_matches_smem_bytes(nd):
    """The kernel's shared-memory ``Layout`` (read out of the header) needs
    what :func:`conv.smem_bytes` reckons, for every plan of the channel
    counts and tile shapes, either residency and every ring depth."""
    _, layout = _header()
    planes = 3 if nd == 3 else 1
    for C in CHANNELS:
        for Cout in CHANNELS:
            for W in (8, 16, 64):
                plan = tconv.conv_plan((4,) * (nd - 1) + (W,), C, Cout)
                for resident in (True, False):
                    for stages in range(2, tconv.MAX_STAGES + 1):
                        p = SimpleNamespace(tw=plan.tw, th=plan.th, resident=int(resident),
                                            n_chunks=C // plan.kc, planes=planes, stages=stages)
                        assert layout(plan.kc, plan.bn, p) == tconv.smem_bytes(
                            plan.kc, plan.bn, planes, C // plan.kc, resident, stages,
                            (plan.th + 2) * (plan.tw + 2))


def test_library_names_follow_the_headers_they_include(tmp_path):
    """A kernel library is named by its source and the local headers it
    includes: editing conv_sm90.cuh renames (so rebuilds) the conv
    library and leaves the pair kernel's, which does not include it;
    editing wedge.cuh, which the pair kernel includes, renames the pair
    kernel's library and leaves the conv library's."""
    for name in ("conv3x3.cu", "conv_sm90.cuh", "pair_overlap.cu", "wedge.cuh"):
        shutil.copy(HEADER.parent / name, tmp_path / name)
    conv_k = CudaKernel(str(tmp_path / "conv3x3.cu"), "conv3x3_bf16_hwc", [])
    pair_k = CudaKernel(str(tmp_path / "pair_overlap.cu"), "pair_frac_f32", [])
    assert local_sources(conv_k.source) == [conv_k.source, tmp_path / "conv_sm90.cuh"]
    assert local_sources(pair_k.source) == [pair_k.source, tmp_path / "wedge.cuh"]
    before = conv_k.library_path(), pair_k.library_path()
    with open(tmp_path / "conv_sm90.cuh", "a") as f:
        f.write("// edited\n")
    assert conv_k.library_path() != before[0]
    assert pair_k.library_path() == before[1]
    before = conv_k.library_path(), pair_k.library_path()
    with open(tmp_path / "wedge.cuh", "a") as f:
        f.write("// edited\n")
    assert conv_k.library_path() == before[0]
    assert pair_k.library_path() != before[1]


def _layer_shapes(net, shape):
    """(input shape, Cout) of every conv of ``net``'s forward on ``shape``
    (channels-last), found on the meta device without computing anything."""
    shapes = []
    hooks = [b.register_forward_hook(
        lambda m, a, o: shapes.append((tuple(a[0].shape), m.weight.shape[-1])))
        for b in net.conv_blocks()]
    net.to("meta")
    net(torch.empty(*shape, device="meta"), plain=True)
    for h in hooks:
        h.remove()
    return shapes


def _nets():
    demo2 = StarDist2D(None, "2D_demo", "models/examples", device="cpu").net
    demo3 = StarDist3D(None, "3D_demo", "models/examples", device="cpu").net
    return {"Config2D() 4096^2": (StarDistNet(Config2D(grid=(2, 2))), (4096, 4096, 1)),
            "2D_demo 2048^2": (demo2, (2048, 2048, 1)),
            "Config3D(grid=(1, 2, 2)) 64x512x512": (StarDistNet(Config3D(grid=(1, 2, 2))),
                                                     (64, 512, 512, 1)),
            "3D_demo 64x256x256": (demo3, (64, 256, 256, 1))}


def _assert_tiles_cover(spatial, plan):
    """Every output pixel lies in exactly one tile of the kernel's walk."""
    D, H, W = (1,) * (3 - len(spatial)) + tuple(spatial)
    origins = tile_origins(spatial, plan)
    assert len(set(origins)) == len(origins)
    assert plan.th * plan.tw == tconv.TILE_M
    for size, step, axis in ((H, plan.th, 1), (W, plan.tw, 2)):
        starts = sorted({o[axis] for o in origins})
        cover = np.zeros(size, int)
        for s in starts:
            assert 0 <= s < size
            cover[s:s + step] += 1
        assert (cover == 1).all()
    assert sorted({o[0] for o in origins}) == list(range(D))
    # the tiles are the grid's product, each clipped to the image
    area = sum(min(plan.th, H - r) * min(plan.tw, W - c) for _, r, c in origins)
    assert area == D * H * W


@pytest.mark.parametrize("name", ["Config2D() 4096^2", "2D_demo 2048^2",
                                  "Config3D(grid=(1, 2, 2)) 64x512x512", "3D_demo 64x256x256"])
def test_planner_covers_every_layer_shape(name):
    net, shape = _nets()[name]
    shapes = _layer_shapes(net, shape)
    assert len(shapes) == len(net.conv_blocks())
    for (*spatial, C), Cout in shapes:
        C8 = -(-C // 8) * 8
        plan = tconv.conv_plan(tuple(spatial), C8, -(-Cout // 8) * 8)
        _assert_tiles_cover(tuple(spatial), plan)
        # the chunk (and so every pixel's order of summation) does not
        # depend on the image size: a tile of the same layer agrees
        small = tconv.conv_plan(tuple(min(s, 23) for s in spatial), C8, -(-Cout // 8) * 8)
        assert (small.kc, small.bn, small.resident) == (plan.kc, plan.bn, plan.resident)


@pytest.mark.parametrize("spatial", [(1, 8), (5, 8), (7, 23), (3, 64), (2, 130), (1, 1),
                                     (1, 4, 23), (1, 1, 8), (3, 5, 130), (2, 1, 64)])
def test_planner_covers_ragged_shapes(spatial):
    for C, Cout in ((8, 16), (64, 128), (256, 256)):
        _assert_tiles_cover(spatial, tconv.conv_plan(spatial, C, Cout))


def _emulate_kernel(x, w, b, act, plan):
    """What the kernel computes, read the way it reads: x (*sp, C) with
    C % 8 == 0 (numpy f32 of bf16 values), w (3,)*nd + (C, Cout). Each tile's
    halo box comes from the zero-padded input (TMA's fill), each k16 step's
    A rows from the halo pixel and channels a lane addresses, its B from the
    packed image at the descriptor's core-matrix offsets (128 B between the
    two k halves, 256 B between groups of 8 output channels)."""
    nd = w.dim() - 2
    planes = 3 if nd == 3 else 1
    sp, C = x.shape[:-1], x.shape[-1]
    D, H, W = (1,) * (3 - len(sp)) + tuple(sp)
    xv = x.reshape(D, H, W, C).astype(np.float64)
    pz = 1 if nd == 3 else 0
    xp = np.zeros((D + 2 * pz, H + plan.th + 2, W + plan.tw + 2, C))
    xp[pz:pz + D, 1:H + 1, 1:W + 1] = xv
    kc, bn, th, tw = plan.kc, plan.bn, plan.th, plan.tw
    steps, U = tconv.steps_per_stage(kc), kc // 8
    img = tconv.pack_weights(w, kc, bn).float().numpy().astype(np.float64)
    img = img.reshape(-1, steps, bn * 16)                  # (chunk * planes, step, bn * 16)
    m = np.arange(tconv.TILE_M)
    n = np.arange(bn)
    kk = np.arange(16)
    b_off = ((n[None] // 8) * 2 + kk[:, None] // 8) * 64 + (n[None] % 8) * 8 + kk[:, None] % 8
    bias = np.zeros(bn)
    bias[:w.shape[-1]] = b.numpy()
    out = np.zeros((D, H, W, bn))
    for z, r0, c0 in tile_origins(sp, plan):
        acc = np.zeros((tconv.TILE_M, bn))
        for k in range(img.shape[0]):
            chunk, dz = divmod(k, planes)
            box = xp[z + dz, r0:r0 + th + 2, c0:c0 + tw + 2, chunk * kc:(chunk + 1) * kc]
            for s in range(steps):
                A = np.zeros((tconv.TILE_M, 16))
                for hi in (0, 1):
                    q = 2 * s + hi
                    tap, c8 = (q // U, q % U) if kc >= 16 else (min(q, 8), 0)
                    A[:, 8 * hi:8 * hi + 8] = box[m // tw + tap // 3, m % tw + tap % 3,
                                                  8 * c8:8 * c8 + 8]
                acc += A @ img[k, s][b_off]
        y = acc + bias
        if act == "relu":
            y = np.maximum(y, 0)
        elif act == "elu":
            y = np.where(y > 0, y, np.expm1(y))
        rr, cc = r0 + m // tw, c0 + m % tw
        ok = (rr < H) & (cc < W)
        out[z, rr[ok], cc[ok]] = y[ok]
    return out.reshape(tuple(sp) + (bn,))[..., :w.shape[-1]]


# (spatial, C, Cout, kc): every chunk size, 2D and 3D, ragged W, H = 1, D = 1,
# Cout below the wgmma width and at 256 (two n128 halves)
EMULATED = [((5, 23), 8, 16, 8), ((3, 9), 16, 32, 16), ((6, 40), 64, 64, 64),
            ((2, 33), 32, 256, 32), ((1, 12), 64, 24, 16), ((4, 70), 128, 128, 32),
            ((3, 4, 10), 8, 16, 8), ((1, 5, 17), 32, 64, 32), ((2, 3, 9), 64, 8, 64)]


@pytest.mark.parametrize("spatial,C,Cout,kc", EMULATED)
def test_kernel_addressing_emulation_matches_plain(spatial, C, Cout, kc):
    rng = np.random.RandomState(C + Cout + len(spatial))
    nd = len(spatial)
    x = torch.from_numpy(rng.randn(*spatial, C).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.randn(*(3,) * nd, C, Cout) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.randn(Cout).astype(np.float32))
    plan = tconv.conv_plan(spatial, C, -(-Cout // 8) * 8)._replace(kc=kc)
    got = _emulate_kernel(x.float().numpy(), w, b, "elu", plan)
    ref = tconv._conv_plain(x.float(), w.to(torch.bfloat16).float(), b, "elu").numpy()
    # f64 sums against f32 sums of the same bf16 products
    assert np.abs(got - ref).max() < 1e-4 * max(1.0, np.abs(ref).max())
