"""A run with the timed path broken underneath comes out not correct: the
harness drives the rest of a run on the CPU, at small sizes, with one
fault planted in the program each time. The cells run on one chip, so no
exchange between chips can be left out."""

import time

import pytest
import torch

from mimamo_tpu_torch import runner, streaming, temporal, train

from benchmark.harness import main, spec

from .conftest import tiny


def _run(name):
    cell = spec.load_cell(name)
    config, mix = tiny(cell)
    return main.execute(cell, 99, 0.3, False, "cpu", time.perf_counter(),
                        config=config, mix=mix)


def altered(monkeypatch):
    """An answer altered where it is produced: the head's valence of the
    last frame of every clip (or lane) of a call."""
    forward = temporal.TwoStreamRNN.forward

    def broken(self, *args, **kwargs):
        out, carries = forward(self, *args, **kwargs)
        out = out.clone()
        out[:, -1, 0] += 1.0
        return out, carries
    monkeypatch.setattr(temporal.TwoStreamRNN, "forward", broken)


def half_batch(monkeypatch):
    """Half of the batch left out: its rows answered by the mean of the
    rows computed."""
    forward = runner.Mimamo.forward

    def broken(self, crops, *args, **kwargs):
        out, carries = forward(self, crops, *args, **kwargs)
        h = max(1, out.shape[0] // 2)
        out = torch.cat([out[:h], out[:h].mean(0, keepdim=True).expand_as(
            out[h:])])
        return out, carries
    monkeypatch.setattr(runner.Mimamo, "forward", broken)


def state_unchanged(monkeypatch):
    """A feed that hands back its state unchanged: the GRU carries and the
    pair context stay as they were."""
    feed = streaming.StreamingSession.feed

    def broken(self, frames):
        gru, context = self._gru, self._context
        out = feed(self, frames)
        self._gru, self._context = gru, context
        return out
    monkeypatch.setattr(streaming.StreamingSession, "feed", broken)


def no_update(monkeypatch):
    """A train step that returns its state unchanged: Adam runs, and the
    parameters are put back as they were."""
    step = torch.optim.Adam.step

    def broken(self, closure=None):
        saved = [p.detach().clone() for g in self.param_groups
                 for p in g["params"]]
        step(self, closure)
        with torch.no_grad():
            for p, old in zip((p for g in self.param_groups
                               for p in g["params"]), saved):
                p.copy_(old)
    monkeypatch.setattr(torch.optim.Adam, "step", broken)


def late_no_update(monkeypatch):
    """A train step that updates its state for the first steps and from
    then on returns it unchanged, as a step changed after warm-up could:
    only the check of the window's last step can see it."""
    step = torch.optim.Adam.step
    calls = []

    def broken(self, closure=None):
        calls.append(1)
        if len(calls) <= 3:
            return step(self, closure)
    monkeypatch.setattr(torch.optim.Adam, "step", broken)


def half_loss(monkeypatch):
    """Half of the batch left out of the loss, the mean over the rest."""
    loss = train._loss_and_metrics

    def broken(out, labels, mask, spec_, group=None):
        h = max(1, out.shape[0] // 2)
        return loss(out[:h], labels[:h], mask[:h], spec_, group)
    monkeypatch.setattr(train, "_loss_and_metrics", broken)


CASES = [("bf16-clips", altered), ("bf16-clips", half_batch),
         ("bf16-streams", altered), ("bf16-streams", half_batch),
         ("bf16-streams", state_unchanged),
         ("fp32-train", altered), ("fp32-train", half_loss),
         ("fp32-train", no_update), ("fp32-train", late_no_update)]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f.__name__}" for n, f in CASES])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(name)
    assert result["correct"] is False, result["checks"]
    if fault is late_no_update:
        failed = {k for k, c in result["checks"].items()
                  if not c["value"] <= c["limit"]}
        assert failed and all(k.startswith("last_") for k in failed), failed
