"""Shared pieces of the benchmark's tests: the cells at small sizes on the
CPU, and the ``card`` marker for tests that need a CUDA device (decided
inside a fixture, never at import)."""

import copy

import pytest
import torch

# Small sizes of each traffic kind, for the CPU: the same code paths.
TINY_MIX = {
    "clips": dict(clips=2, frames=4, pool=2, warmup_calls=1),
    "train": dict(clips=2, frames=4, pool=4, checked_steps=3),
    "streams": dict(streams=3, capacity=4, chunk=4, fps=40.0, pool_chunks=5,
                    check_streams=2, warmup_feeds=1),
}


def tiny_config(cfg: dict) -> dict:
    """A configuration at 32^2 crops, 16^2 phase maps, clips of 8."""
    c = copy.deepcopy(cfg)
    c["pyramid"]["input_size"] = [32, 32]
    c["phase"]["phase_size"] = 16
    c["backbone"]["input_size"] = 64
    c["clip"].update(crop_size=32, clip_len=8, stride=4)
    return c


def tiny(cell):
    """(config, mix) of ``cell`` at the CPU's sizes."""
    return tiny_config(cell.config), dict(cell.mix, **TINY_MIX[cell.kind])


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
