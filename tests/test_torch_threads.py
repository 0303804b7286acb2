"""The port's two pieces of process-wide state under two host threads (the
serving daemon runs a predict on a worker thread beside the stream
feeds): ``preprocess.ieee_fp32_matmul``'s TF32 switches and
``Mimamo``'s folded backbone."""

import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mimamo_tpu_torch import backbone, preprocess, runner, weights
from mimamo_tpu_torch.config import (BackboneSpec, ClipSpec, MimamoConfig,
                                     PhaseSpec, PyramidSpec)

MATMULS = {"mm", "bmm", "addmm", "baddbmm", "matmul"}


def _switches(api):
    """The fp32 matmul switches as the caller's API reads them."""
    if api == "legacy":
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision())
    return torch.backends.cuda.matmul.fp32_precision


IEEE = {"legacy": (False, "highest"), "fp32_precision": "ieee"}
TF32 = {"legacy": (True, "high"), "fp32_precision": "tf32"}


class SwitchRecorder(TorchDispatchMode):
    """Records the switches as they stand at each matmul run inside."""

    def __init__(self, api):
        super().__init__()
        self.api, self.seen = api, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in MATMULS:
            self.seen.append(_switches(self.api))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def restore_tf32():
    """Put the switches back the legacy way after the test (a mix of
    PyTorch's two APIs would make later reads raise)."""
    prec = torch.get_float32_matmul_precision()
    yield
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision(prec)


def _set_tf32(api):
    if api == "legacy":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    else:
        torch.backends.cuda.matmul.fp32_precision = "tf32"


@pytest.mark.parametrize("api", ["legacy", "fp32_precision"])
def test_overlapping_sections_stay_ieee(restore_tf32, api):
    """A enters, B enters, A leaves, B runs a matmul, B leaves: both
    threads see IEEE switches at every point inside their sections (B's
    matmul included), and the caller's TF32 setting is back after both
    have left. Without the shared count A's exit would hand B the caller's
    TF32, and B's exit would then restore A's IEEE for good."""
    _set_tf32(api)
    caller = _switches(api)
    assert caller == TF32[api]
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen, errors = {}, []
    x = torch.randn(8, 8)

    def thread_a():
        try:
            with preprocess.ieee_fp32_matmul():
                seen["a_in"] = _switches(api)
                a_in.set()
                assert b_in.wait(10)
                seen["a_before_exit"] = _switches(api)
            a_out.set()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
            a_out.set()

    def thread_b():
        try:
            assert a_in.wait(10)
            with preprocess.ieee_fp32_matmul():
                b_in.set()
                assert a_out.wait(10)
                rec = SwitchRecorder(api)
                with rec:
                    torch.mm(x, x)
                seen["b_matmul"] = rec.seen
                seen["b_after_a_left"] = _switches(api)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
            b_in.set()

    threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors
    assert seen["a_in"] == seen["a_before_exit"] == IEEE[api]
    assert seen["b_after_a_left"] == IEEE[api]
    assert seen["b_matmul"] == [IEEE[api]]
    assert _switches(api) == caller


@pytest.mark.parametrize("api", ["legacy", "fp32_precision"])
def test_nested_section_in_one_thread(restore_tf32, api):
    """A section inside a section of the same thread leaves the switches
    IEEE until the outer one ends, then restores the caller's."""
    _set_tf32(api)
    with preprocess.ieee_fp32_matmul():
        with preprocess.ieee_fp32_matmul():
            assert _switches(api) == IEEE[api]
        assert _switches(api) == IEEE[api]
    assert _switches(api) == TF32[api]


def _small_model():
    cfg = MimamoConfig(
        pyramid=PyramidSpec(height=2, orientations=2, input_size=(16, 16)),
        phase=PhaseSpec(phase_size=8),
        backbone=BackboneSpec(input_size=32),
        clip=ClipSpec(clip_len=4, stride=2, crop_size=16))
    model = runner.Mimamo(cfg, device="cpu")
    model.load_state_dict(weights.init_variables(cfg, 0))
    return model


def test_backbone_folds_once_under_two_threads(monkeypatch):
    """Two threads calling ``embed_frames`` on a fresh model at once fold
    the backbone exactly once and get the same embeddings; after
    ``load_state_dict`` the next use folds again."""
    calls = []
    barrier = threading.Barrier(2)

    def counting_fold(net):
        calls.append(threading.get_ident())
        return backbone.fold_batchnorm(net)

    monkeypatch.setattr(runner, "fold_batchnorm", counting_fold)
    model = _small_model()
    crops = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (1, 2, 16, 16, 3)).astype(np.float32))
    out, errors = [None, None], []

    def work(i):
        try:
            barrier.wait(10)
            with torch.no_grad():
                out[i] = model.embed_frames(crops)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert len(calls) == 1
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
    model.load_state_dict(model.state_dict())
    with torch.no_grad():
        model.embed_frames(crops)
    assert len(calls) == 2
