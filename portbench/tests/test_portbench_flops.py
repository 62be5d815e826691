"""The FLOP count of 2D_demo and 3D_demo against a count by hand."""
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
