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
    "mimamo_tpu_torch.weights",
    "mimamo_tpu_torch.kernels._build",
    "mimamo_tpu_torch.kernels.phase_kernel",
    "mimamo_tpu_torch.kernels.stem_kernel",
    "mimamo_tpu_torch.kernels.layer2_kernel",
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


def test_explicit_cpu_device():
    from mimamo_tpu_torch.config import (MimamoConfig, PhaseSpec,
                                         PyramidSpec)
    from mimamo_tpu_torch.runner import Mimamo
    m = Mimamo(MimamoConfig(pyramid=PyramidSpec(input_size=(32, 32)),
                            phase=PhaseSpec(phase_size=16)), device="cpu")
    assert m.device == torch.device("cpu")
    assert all(p.device.type == "cpu" for p in m.parameters())
