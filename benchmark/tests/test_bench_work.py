"""The FLOP and byte functions against hand counts."""


import pytest

from benchmark.harness import spec, work


def _config(name="mimamo-bf16"):
    return spec.load_cell("bf16-clips").config if name == "mimamo-bf16" \
        else spec.load_cell("fp32-train").config


def test_resnet50_at_224_by_hand():
    # He et al. count 3.8e9 multiply-adds for ResNet-50 at 224 with the
    # stride in block 0's 1x1 conv, the placement FER+ and the port use;
    # torchvision's v1.5 (the stride in the 3x3 conv) has 4.1e9. Here:
    # conv1 118.0 M, layers 1-4 3,737.9 M, the FER+ head 16 k.
    macs = work.backbone_flops(_config(), 1) / 2
    assert 3.85e9 < macs < 3.86e9
    assert work.stem_work(1, 112, 2)[1] / 2 == 112 * 112 * 64 * 147
    layers = work.conv_flops(1)
    # layer1 at 56^2: block 0 64->64->64->256 plus its 64->256 projection,
    # blocks 1-2 256->64->64->256
    l1 = 56 * 56 * ((64 * 64 + 9 * 64 * 64 + 64 * 256 + 64 * 256)
                    + 2 * (256 * 64 + 9 * 64 * 64 + 64 * 256))
    assert layers["layer1"] == 2 * l1


def test_phase_work_by_hand():
    cfg = _config()
    nbytes, flops = work.phase_work(8, 48, cfg)
    per_frame = 4 * (112 * 112 + 56 * 56 + 28 * 28)       # complex values
    outputs = 8 * 47 * 12 * 48 * 48
    assert nbytes == 8 * (8 * 48 * per_frame) + 4 * outputs
    assert flops == 30 * 8 * 47 * per_frame + 9 * outputs
    assert work.bound_s(nbytes, flops, work.PEAK_FP32_FLOP_PER_S) == \
        pytest.approx(nbytes / 3.35e12)


def test_layer2_and_temporal_by_hand():
    nbytes, flops = work.layer2_work(1)
    assert flops == work.conv_flops(1)["layer2"]
    assert nbytes > 2 * (56 * 56 * 256 + 28 * 28 * 512)
    cfg = _config()
    # per frame: projection 2048x256, two GRUs 3 x 256 x (256 + 256) each,
    # fusion 512x256, head 256x2
    per = 2048 * 256 + 2 * 3 * 256 * 512 + 512 * 256 + 256 * 2
    cnn = (48 * 48 * 12 * 64 * 9 + 24 * 24 * 64 * 128 * 9
           + 12 * 12 * 128 * 256)
    assert work.temporal_flops(cfg, 1, 2) == 2 * (2 * per + cnn)
