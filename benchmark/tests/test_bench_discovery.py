"""A new cell, traffic mix or per-layer metric is added with new files and
one entry in BENCHMARK.json; no file of the harness changes."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark.harness import spec

REPO = Path(__file__).resolve().parents[2]

PROBE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark.harness import spec
cell = spec.load_cell("bf16-clips-2x96")
reader = spec.metric_reader("calls_per_s.clips2")
class Run: counts = {"calls": 30, "window_s": 3.0}
print(json.dumps({"mix": cell.mix, "per_layer": [m["name"] for m in cell.per_layer],
                  "e2e": [m["name"] for m in cell.end_to_end],
                  "limits": cell.limits, "value": reader.read(Run()),
                  "file": spec.__file__}))
"""


def _tree(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in sorted((root / "benchmark").rglob("*.py"))}


def test_new_cell_and_metric_are_files_only(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _tree(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "bf16-clips-2x96",
                               "config": "mimamo-bf16",
                               "traffic": "clips-2x96", "chips": 1,
                               "why": "longer clips"})
    frames = next(m for m in bench["end_to_end"]
                  if m["name"] == "frames_per_s")
    frames["workloads"].append("bf16-clips-2x96")
    bench["per_layer"].append({"name": "calls_per_s.clips2", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "runner", "moves": "frames_per_s",
                               "workloads": ["bf16-clips-2x96"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark/traffic/clips-2x96.json").write_text(json.dumps(
        {"kind": "clips", "clips": 2, "frames": 96, "pool": 4,
         "warmup_calls": 2}))
    (tmp_path / "benchmark/workloads/bf16-clips-2x96.json").write_text(
        json.dumps({"limits": {"out_err": 2.5}}))
    (tmp_path / "benchmark/metrics/calls_per_s.clips2.py").write_text(
        "def read(run):\n"
        "    return run.counts['calls'] / run.counts['window_s']\n")
    after = _tree(tmp_path)
    assert all(after[k] == v for k, v in before.items())   # nothing edited
    out = subprocess.run([sys.executable, "-c", PROBE, str(tmp_path)],
                         capture_output=True, text=True, cwd=tmp_path,
                         check=True)
    got = json.loads(out.stdout)
    assert got["file"].startswith(str(tmp_path))
    assert got["mix"]["frames"] == 96 and got["limits"] == {"out_err": 2.5}
    assert got["per_layer"] == ["calls_per_s.clips2"]
    assert got["e2e"] == ["frames_per_s", "setup_s"]
    assert got["value"] == 10.0


def test_every_cell_finds_its_pieces():
    bench = spec.benchmark_file()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        spec.traffic_kind(cell.kind)
        assert cell.per_layer, w["name"]
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        assert len(cell.end_to_end) >= 2
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]).read)
