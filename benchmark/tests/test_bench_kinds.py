"""Each traffic kind driven end to end through the port's CPU path at small
sizes: set-up, the window, the metrics and the check, and the keys of the
result's line."""

import json
import time

import pytest

from benchmark.harness import main, spec

from .conftest import tiny

CELLS = [w["name"] for w in spec.benchmark_file()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_on_the_cpu(name, traced):
    cell = spec.load_cell(name)
    config, mix = tiny(cell)
    result = main.execute(cell, 2**31 + 12345, 0.3, traced, "cpu",
                          time.perf_counter(), config=config, mix=mix)
    assert result.pop("_forbidden") == []
    keys = list(result)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert ("breakdown" in keys) == traced
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == set(cell.limits)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    if traced:
        assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in result["metrics"].values())
    json.dumps(result)                      # the line is plain JSON


def test_same_seed_same_inputs():
    """The same seed gives the same weights and inputs."""
    from benchmark.harness import data
    cell = spec.load_cell("bf16-clips")
    config, _ = tiny(cell)
    a = data.make_weights(config, 7, "cpu")
    b = data.make_weights(config, 7, "cpu")
    c = data.make_weights(config, 8, "cpu")
    assert all((a[k] == b[k]).all() for k in a)
    assert any((a[k] != c[k]).any() for k in a if a[k].dim())
    x = data.make_clips(7, "cpu", 1, 2, 3, 32)
    assert (x == data.make_clips(7, "cpu", 1, 2, 3, 32)).all()
