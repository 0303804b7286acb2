"""The import check compares whole top-level module names; a run without a
card fails and prints no result; a run loads nothing of JAX."""

import os
import subprocess
import sys
from pathlib import Path

from benchmark.harness import judge

REPO = Path(__file__).resolve().parents[2]


def test_whole_top_level_names():
    assert judge.forbidden_modules(["mimamo_tpu_torch", "mimamo_tpu_torch.x",
                                    "jaxtyping", "flaxen", "torch"]) == []
    assert judge.forbidden_modules(["mimamo_tpu.runner"]) == ["mimamo_tpu"]
    assert judge.forbidden_modules(["jax", "jaxlib.xla", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "bf16-clips", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "No CPU fallback" in out.stderr


PROBE = """
import sys, time
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
from conftest import tiny
from benchmark.harness import judge, main, spec
cell = spec.load_cell("bf16-clips")
config, mix = tiny(cell)
main.execute(cell, 1, 0.2, True, "cpu", time.perf_counter(), config=config,
             mix=mix)
print(judge.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE, str(REPO),
                          str(Path(__file__).parent)], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
