"""How the folded backbone routes each dtype, decided once when it is
built and the same on every device: bf16 runs the stem and layer2
kernels, fp32 runs the fp32 stem kernel and layer2 as folded convs (the
JAX package's routing: its Pallas layer2 is bf16-only, so an fp32
backbone runs layer2 as XLA convs). Checked without a card, by what
``FoldedResNet50`` holds; the fp32 forward itself is held against the
JAX package in ``test_torch_runner`` and against the CPU on the card in
``chip_smoke.py``."""

import pytest
import torch

from mimamo_tpu_torch import weights
from mimamo_tpu_torch.backbone import FoldedResNet50, fold_batchnorm
from mimamo_tpu_torch.kernels import layer2_kernel, stem_kernel
from mimamo_tpu_torch.runner import Mimamo

from test_torch_runner import _configs


@pytest.fixture(scope="module")
def folded():
    _, tcfg = _configs("float32")
    model = Mimamo(tcfg, device="cpu")
    model.load_state_dict(weights.init_variables(tcfg, 0))
    return fold_batchnorm(model.backbone)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_per_device_and_dtype(folded, device, dtype):
    spec = _configs(dtype)[1].backbone
    fb = FoldedResNet50({k: (w.to(device), b.to(device))
                         for k, (w, b) in folded.items()}, spec)
    want = torch.float32 if dtype == "float32" else torch.bfloat16
    assert fb.stem[0].dtype == want and fb.stem[0].device.type == device
    if dtype == "float32":
        assert fb.run_layer2 == fb._layer2_convs and fb.layer2 is None
        assert sorted(fb.stages) == [1, 2, 3, 4]
        assert [len(fb.stages[2][b]) for b in range(4)] == [4, 3, 3, 3]
        w, _b, stride, _pad = fb.stages[2][0]["conv1"]
        assert stride == 2 and w.dtype == torch.float32
    else:
        assert fb.run_layer2 == fb._layer2_kernel
        assert sorted(fb.stages) == [1, 3, 4]
        assert len(fb.layer2) == layer2_kernel.BLOCKS


def test_fp32_forward_never_reaches_the_layer2_kernel(folded, monkeypatch):
    """An fp32 forward calls the stem wrapper once and the layer2 wrapper
    never; a bf16 forward calls each once."""
    calls = {"stem": 0, "layer2": 0}
    stem, layer2 = stem_kernel.stem_fused, layer2_kernel.layer2_fused

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(stem_kernel, "stem_fused", count("stem", stem))
    monkeypatch.setattr(layer2_kernel, "layer2_fused",
                        count("layer2", layer2))
    crops = torch.rand((2, 32, 32, 3)) * 255
    for dtype, want in (("float32", {"stem": 1, "layer2": 0}),
                        ("bfloat16", {"stem": 2, "layer2": 1})):
        emb, _ = FoldedResNet50(folded, _configs(dtype)[1].backbone)(crops)
        assert emb.shape == (2, 2048) and calls == want
