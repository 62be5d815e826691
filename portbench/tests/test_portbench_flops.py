"""The FLOP count of 2D_demo, 3D_demo and the 3D training notebook's ResNet
against a count by hand."""
import json

from portbench import flops, manifest

CONFIGS = manifest.HERE / "configs"


def cfg(name):
    return json.loads((CONFIGS / name / "config.json").read_text())


def test_2d_demo():
    # by hand, per input pixel: two convs at full size (1->16, 16->16); the
    # U-Net at 1/4 (16->16, 16->16), 1/16 (16->32, 32->32), 1/64 (32->64,
    # 64->32), 1/16 (64->32, 32->16), 1/4 (32->16, 16->16); the feature conv
    # 16->32 and the 1x1 heads 32->33 at 1/4
    per_px = (18 * (1 * 16 + 16 * 16) + 18 * (2 * 256) / 4 + 18 * (16 * 32 + 32 * 32) / 16
              + 18 * (32 * 64 + 64 * 32) / 64 + 18 * (64 * 32 + 32 * 16) / 16
              + 18 * (32 * 16 + 16 * 16) / 4 + 18 * 16 * 32 / 4 + 2 * 32 * 33 / 4)
    assert per_px == 19248
    assert flops.forward_flops(cfg("2D_demo"), (4096, 4096)) == per_px * 4096 ** 2
    layers = flops.conv_layers(cfg("2D_demo"), (64, 64))
    assert [t for _, _, t in layers] == [9] * 13 + [1]


def test_3d_demo():
    # pre-pool (1->16, 16->16) at full size, pooled (1, 2, 2); the U-Net at
    # 1/4 (16->16, 16->16), 1/32 (16->32, 32->16), 1/4 (32->16, 16->16); the
    # feature conv 16->128 and the heads 128->33 at 1/4
    per_vox = (54 * (16 + 256) + 54 * 512 / 4 + 54 * (512 + 512) / 32 + 54 * (512 + 256) / 4
               + 54 * 16 * 128 / 4 + 2 * 128 * 33 / 4)
    assert per_vox == 63456
    assert flops.forward_flops(cfg("3D_demo"), (64, 256, 256)) == per_vox * 64 * 256 * 256
    assert len(flops.conv_layers(cfg("3D_demo"), (8, 16, 16))) == 10


def notebook(grid):
    """config.json of upstream's 3D training notebook's model at ``grid``:
    96 rays, the ResNet of ``Config3D`` (4 blocks of three 3^3 convs, 32
    base filters, ``net_conv_after_resnet`` 128)."""
    return {"n_dim": 3, "n_channel_in": 1, "n_rays": 96, "grid": list(grid),
            "backbone": "resnet", "resnet_n_blocks": 4, "resnet_kernel_size": [3, 3, 3],
            "resnet_n_filter_base": 32, "resnet_n_conv_per_block": 3,
            "net_conv_after_resnet": 128}


def test_3d_notebook_resnet():
    # at full size the stems 1->32 (7^3) and 32->32 (3^3); at 1/g the first
    # block 32->64 strided, 64->64 twice and its 1x1 shortcut 32->64; three
    # blocks of three 64->64; the feature conv 64->128 and the heads 128->97
    stem = 2 * 343 * 32 + 2 * 27 * 32 * 32
    pooled = (2 * 27 * (32 * 64 + 2 * 64 * 64) + 2 * 32 * 64 + 3 * 3 * 2 * 27 * 64 * 64
              + 2 * 27 * 64 * 128 + 2 * 128 * 97)
    assert stem + pooled / 4 == 830976
    assert stem + pooled / 8 == 454112
    shape = (48, 96, 96)
    assert flops.forward_flops(notebook((1, 2, 2)), shape) == 830976 * 48 * 96 * 96
    assert flops.forward_flops(notebook((2, 2, 2)), shape) == 454112 * 48 * 96 * 96
    layers = flops.conv_layers(notebook((1, 2, 2)), (8, 16, 16))
    assert [t for _, _, t in layers] == [343, 27] + [27] * 3 + [1] + [27] * 10 + [1]
    # a strided conv counts its output grid: ceil(n / 2) at an odd extent
    assert layers[2][0] == (8, 8, 8, 32)
    assert flops.conv_layers(notebook((1, 2, 2)), (7, 13, 15))[2][0] == (7, 7, 8, 32)
