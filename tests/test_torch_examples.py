"""The port's examples, ``python -m mimamo_tpu_torch.examples.demo --cpu``
and ``... serve_client --cpu``, run as a user runs them: each exits 0 and
writes the files that ``examples/demo.py`` and ``examples/serve_client.py``
write (the synthesized video; crops, boxes, features and the prediction
CSV; the served prediction CSV)."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytest.importorskip("cv2")


def _run(module, out_dir):
    # two intra-op threads, as tests/test_torch_finetune_bf16.py sets them
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", module, "--cpu", "--out-dir",
                        str(out_dir)], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.splitlines()


def test_demo(tmp_path):
    lines = _run("mimamo_tpu_torch.examples.demo", tmp_path)
    assert sorted(os.listdir(tmp_path)) == [
        "demo.boxes.npy", "demo.feat.npy", "demo.mp4", "demo.npy",
        "predictions.csv"]
    crops = np.load(tmp_path / "demo.npy")
    assert crops.shape == (96, 64, 64, 3) and crops.dtype == np.uint8
    assert np.load(tmp_path / "demo.feat.npy").shape == (96, 2048)
    with open(tmp_path / "predictions.csv") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 1 + 96
    summary = json.loads(lines[-1])
    assert summary["frames"] == 96
    assert np.isfinite(summary["valence"] + summary["arousal"]).all()


def test_serve_client(tmp_path):
    lines = _run("mimamo_tpu_torch.examples.serve_client", tmp_path)
    assert sorted(os.listdir(tmp_path)) == ["preds.csv", "sample.mp4"]
    with open(tmp_path / "preds.csv") as f:
        assert len(list(csv.reader(f))) == 1 + 64
    order = next(line for line in lines if line.startswith("response order"))
    for name in ("vid", "chunk0", "chunk1", "chunk2"):
        assert f"'{name}'" in order
    assert lines[-1].startswith("shutdown:") and "True" in lines[-1]
