"""The PyTorch port stands alone: importing it loads nothing of JAX, Flax
or the JAX package, and its entry points run on the card unless the CPU
is asked for."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
MODULES = (
    "mimamo_tpu_torch",
    "mimamo_tpu_torch.config",
    "mimamo_tpu_torch.pyramid",
    "mimamo_tpu_torch.phase",
    "mimamo_tpu_torch.preprocess",
    "mimamo_tpu_torch.backbone",
    "mimamo_tpu_torch.temporal",
    "mimamo_tpu_torch.runner",
    "mimamo_tpu_torch.streaming",
    "mimamo_tpu_torch.weights",
    "mimamo_tpu_torch.bench_phase",
    "mimamo_tpu_torch.kernels._build",
    "mimamo_tpu_torch.kernels.phase_kernel",
    "mimamo_tpu_torch.kernels.stem_kernel",
    "mimamo_tpu_torch.kernels.layer2_kernel",
    "mimamo_tpu_torch.io",
    "mimamo_tpu_torch.io.decode",
    "mimamo_tpu_torch.io.openface",
    "mimamo_tpu_torch.io.native_loader",
    "mimamo_tpu_torch.data",
    "mimamo_tpu_torch.data.crops",
    "mimamo_tpu_torch.api",
    "mimamo_tpu_torch.batchnorm",
    "mimamo_tpu_torch.losses",
    "mimamo_tpu_torch.checkpoints",
    "mimamo_tpu_torch.train",
    "mimamo_tpu_torch.data.datasets",
    "mimamo_tpu_torch.data.eval",
    "mimamo_tpu_torch.kernels.dots_block",
    "mimamo_tpu_torch.kernels.layer1_dots_kernel",
    "mimamo_tpu_torch.kernels.layer2_dots_kernel",
    "mimamo_tpu_torch.bench",
    "mimamo_tpu_torch.bench._timing",
    "mimamo_tpu_torch.bench.layer1_probe",
    "mimamo_tpu_torch.bench.layer2_probe",
    "mimamo_tpu_torch.bench.fft_invariance",
    "mimamo_tpu_torch.bench.step_turns",
    "mimamo_tpu_torch.bench.train_repeat",
    "mimamo_tpu_torch.corpus",
    "mimamo_tpu_torch.serve",
    "mimamo_tpu_torch.cli",
    "mimamo_tpu_torch.torch_ref",
    "mimamo_tpu_torch.parallel",
    "mimamo_tpu_torch.dryrun",
    "mimamo_tpu_torch.summary",
    "mimamo_tpu_torch.tracing",
    "mimamo_tpu_torch.examples",
    "mimamo_tpu_torch.examples.demo",
    "mimamo_tpu_torch.examples.serve_client",
    "chip_smoke",
)

_PROBE = """
import importlib, json, sys
seen = {}
for name in sys.argv[1:]:
    importlib.import_module(name)
    seen[name] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                               "mimamo_tpu"))
print(json.dumps(seen))
"""


@pytest.fixture(scope="module")
def leaked():
    """One fresh interpreter imports every module in turn and records
    which forbidden modules are loaded after each import."""
    out = subprocess.run([sys.executable, "-c", _PROBE, *MODULES],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_import_loads_no_jax(leaked, module):
    assert leaked[module] == []


def test_default_device_without_cuda_raises(monkeypatch):
    from mimamo_tpu_torch.runner import Mimamo, resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mimamo()


def _small_config():
    from mimamo_tpu_torch.config import (ClipSpec, MimamoConfig, PhaseSpec,
                                         PyramidSpec)
    return MimamoConfig(pyramid=PyramidSpec(input_size=(32, 32)),
                        phase=PhaseSpec(phase_size=16),
                        clip=ClipSpec(crop_size=32))


def test_streaming_session_without_cuda_raises(monkeypatch):
    """A session lives on its model's device, and a model is built on the
    card unless the CPU is asked for: without a card that raises, and a
    model asked onto the CPU gives a session whose state is on the CPU."""
    from mimamo_tpu_torch import Mimamo, StreamingSession
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingSession(Mimamo(_small_config()))
    sess = StreamingSession(Mimamo(_small_config(), device="cpu"),
                            capacity=2, chunk=4)
    assert sess._context.device.type == "cpu"
    assert all(c.device.type == "cpu" for c in sess._gru)


def test_explicit_cpu_device():
    from mimamo_tpu_torch.config import (MimamoConfig, PhaseSpec,
                                         PyramidSpec)
    from mimamo_tpu_torch.runner import Mimamo
    m = Mimamo(MimamoConfig(pyramid=PyramidSpec(input_size=(32, 32)),
                            phase=PhaseSpec(phase_size=16)), device="cpu")
    assert m.device == torch.device("cpu")
    assert all(p.device.type == "cpu" for p in m.parameters())


def test_api_entry_points_without_cuda_raise(monkeypatch, tmp_path):
    """``MimamoAPI``, ``VideoProcessor`` and ``FeatureExtractor`` run on
    the card unless the CPU is asked for: without a card they raise, and
    asked onto the CPU they hold their model (``VideoProcessor``, which
    runs only the crop, its device) there."""
    from mimamo_tpu_torch import api
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _small_config()
    for make in (lambda **kw: api.MimamoAPI(config=cfg, **kw).model,
                 lambda **kw: api.VideoProcessor(32, config=cfg, **kw),
                 lambda **kw: api.FeatureExtractor(config=cfg, **kw).model):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert make(device="cpu").device == torch.device("cpu")


def test_fit_without_cuda_raises(monkeypatch, tmp_path):
    """``train.fit`` trains on the card unless the CPU is asked for."""
    from mimamo_tpu_torch import train
    from mimamo_tpu_torch.data import datasets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _small_config()
    datasets.make_synthetic_affwild2(str(tmp_path), n_videos=1, frames=150,
                                     size=32)
    ds = datasets.AffWild2Dataset(str(tmp_path), clip=cfg.clip)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.fit(cfg, ds)
