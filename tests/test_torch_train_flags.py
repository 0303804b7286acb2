"""``cli train --tensorboard`` and ``--debug-nans`` against the JAX CLI's,
and the event files of ``summary`` against TensorFlow's reader.

Both CLIs train the micro-only small config (``--streams micro``: the
flags do not depend on the model, and the JAX step compiles in seconds)
on one synthetic Aff-Wild2 corpus, each from its own seeded weights, so
their values differ; what must agree is what each flag does:

  * ``--tensorboard``: each event file holds a file-version event and, at
    step = epoch, one scalar per numeric key of the epoch's row except
    ``epoch``; the tags and steps of the port's file equal the JAX file's
    (in another order within a step: the JAX rows sort their metrics), and
    each file's values equal the rows its own CLI printed (float32).
    The port's file reads the same through ``summary.read_events`` and
    TensorFlow's ``summary_iterator``.
  * ``--debug-nans``: with a NaN planted in the same temporal weight (the
    head's [0, 0]) both CLIs raise ``FloatingPointError``; without it the
    port's run equals its plain run (rows but the wall time, and the
    checkpoint, bit for bit).
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from mimamo_tpu import cli as jcli
from mimamo_tpu import train as jtrain
from mimamo_tpu_torch import checkpoints, cli, summary, weights
from mimamo_tpu_torch.data import datasets

from test_torch_decode import (  # noqa: F401
    drop_if_passed, drop_passed_tmp_path)
from test_torch_finetune_bf16 import two_intra_op_threads  # noqa: F401
from test_torch_serve import CLIP, S, SMALL_FLAGS

FLAGS = SMALL_FLAGS + ["--streams", "micro", "--batch", "2", "--epochs",
                       "2", "--cpu"]


@pytest.fixture(scope="module")
def corpus(request, tmp_path_factory):
    failed = request.session.testsfailed
    root = tmp_path_factory.mktemp("flags")
    datasets.make_synthetic_affwild2(str(root / "aff"), n_videos=2,
                                     frames=2 * CLIP + 5, size=S, seed=6)
    yield str(root / "aff")
    drop_if_passed(root, failed, request.session.testsfailed)


def _train(main, corpus, capsys, extra):
    argv = ["train", "--dataset", "affwild2", "--root", corpus] + FLAGS
    capsys.readouterr()
    main(argv + extra)
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _tf_events(path):
    """(step, tag, value) of every scalar TensorFlow reads from ``path``:
    a ``simple_value`` or a TF2 tensor scalar."""
    import tensorflow as tf
    from tensorflow.python.summary.summary_iterator import summary_iterator
    out = []
    for ev in summary_iterator(path):
        for v in ev.summary.value:
            value = (float(tf.make_ndarray(v.tensor)) if v.HasField("tensor")
                     else v.simple_value)
            out.append((ev.step, v.tag, value))
    return out


def _row_scalars(rows):
    return [(row["epoch"], k, float(np.float32(v))) for row in rows
            for k, v in row.items()
            if isinstance(v, (int, float)) and k != "epoch"]


def _tensorboard_case(corpus, tmp_path, capsys, monkeypatch):
    jdir, tdir = str(tmp_path / "jax_tb"), str(tmp_path / "port_tb")
    jrows = _train(jcli.main, corpus, capsys, ["--tensorboard", jdir])
    trows = _train(cli.main, corpus, capsys, ["--tensorboard", tdir])
    (jfile,), (tfile,) = (glob.glob(os.path.join(d, "events.out.tfevents.*"))
                          for d in (jdir, tdir))
    jevents, tevents = _tf_events(jfile), _tf_events(tfile)
    assert len(trows) == len(jrows) == 2
    assert sorted((s, k) for s, k, _ in tevents) == sorted(
        (s, k) for s, k, _ in jevents)
    assert tevents == _row_scalars(trows)
    assert sorted(jevents) == sorted(_row_scalars(jrows))
    ours = summary.read_events(tfile)
    assert ours[0]["file_version"] == "brain.Event:2"
    assert [(e["step"], k, v) for e in ours[1:]
            for k, v in e["values"].items()] == tevents


def _plant_nan(monkeypatch):
    """NaN in the temporal head's weight [0, 0] of both packages' initial
    weights."""
    init_jax = jtrain.create_train_state

    def jax_state(model, rng, tx=None, variables=None):
        variables = jax.tree_util.tree_map(
            np.array, jax.jit(model.init_variables)(rng))
        variables["temporal"]["params"]["head"]["kernel"][0, 0] = np.nan
        return init_jax(model, rng, tx=tx, variables=variables)

    init_port = weights.init_variables

    def port_state(config, seed):
        sd = init_port(config, seed)
        sd["temporal.head.weight"][0, 0] = float("nan")
        return sd

    monkeypatch.setattr(jtrain, "create_train_state", jax_state)
    monkeypatch.setattr(weights, "init_variables", port_state)


def _debug_nans_case(corpus, tmp_path, capsys, monkeypatch):
    plain, checked = str(tmp_path / "plain"), str(tmp_path / "checked")
    rows = [_train(cli.main, corpus, capsys, ["--ckpt", ckpt] + extra)
            for ckpt, extra in ((plain, []), (checked, ["--debug-nans"]))]
    for a, b in zip(*rows):
        assert {k: v for k, v in a.items() if k != "sec"} == \
            {k: v for k, v in b.items() if k != "sec"}
    sds = [torch.load(os.path.join(ckpt, str(checkpoints.latest_step(ckpt)),
                                   "state.pt"), weights_only=True)["model"]
           for ckpt in (plain, checked)]
    for k, v in sds[0].items():
        assert torch.equal(v, sds[1][k]), k
    _plant_nan(monkeypatch)
    with pytest.raises(FloatingPointError, match="temporal.head"):
        _train(cli.main, corpus, capsys, ["--debug-nans"])
    try:
        with pytest.raises(FloatingPointError):
            _train(jcli.main, corpus, capsys, ["--debug-nans", "--epochs",
                                               "1"])
    finally:
        jax.config.update("jax_debug_nans", False)


@pytest.mark.parametrize("flag", ["tensorboard", "debug-nans"])
def test_train_flags_match_jax(flag, corpus, tmp_path, capsys, monkeypatch):
    """The two train flags against the JAX CLI's (module docstring)."""
    case = {"tensorboard": _tensorboard_case,
            "debug-nans": _debug_nans_case}[flag]
    case(corpus, tmp_path, capsys, monkeypatch)


def test_event_file_round_trip(tmp_path):
    """Scalars written by ``EventWriter`` read back through ``read_events``
    and TensorFlow's reader; a flipped byte fails the checksum."""
    with summary.EventWriter(str(tmp_path)) as w:
        w.scalar("loss", 0.5, 0)
        w.scalar("ccc_v", -0.125, 0)
        w.scalar("loss", 0.25, 3)
    assert os.path.basename(w.path).startswith("events.out.tfevents.")
    events = summary.read_events(w.path)
    assert [(e["step"], e.get("values")) for e in events] == [
        (0, None), (0, {"loss": 0.5}), (0, {"ccc_v": -0.125}),
        (3, {"loss": 0.25})]
    assert _tf_events(w.path) == [(0, "loss", 0.5), (0, "ccc_v", -0.125),
                                  (3, "loss", 0.25)]
    raw = bytearray(open(w.path, "rb").read())
    raw[-6] ^= 1
    bad = tmp_path / "bad"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="checksum"):
        summary.read_events(str(bad))
