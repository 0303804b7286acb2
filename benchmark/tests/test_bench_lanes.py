"""``lane_use_pct.streams``: the session's own lane counters over the
window, in a traced run of the streams cell on the CPU, and nothing from
a session without them."""

import time
import types

from benchmark.harness import main, spec

from .conftest import tiny


def test_reads_the_sessions_counters():
    cell = spec.load_cell("bf16-streams")
    config, mix = tiny(cell)
    result = main.execute(cell, 2**31 + 777, 0.3, True, "cpu",
                          time.perf_counter(), config=config, mix=mix,
                          keep=True)
    run = result["_run"]
    assert result["correct"] is True, result["checks"]
    got = result["metrics"]["lane_use_pct.streams"]
    assert got["unit"] == "%" and 0 < got["value"] <= 100
    # the harness's count of slots fed is the session's, over the window
    assert run.counts["lanes_fed"] > 0


def test_silent_without_counters():
    reader = spec.metric_reader("lane_use_pct.streams")
    run = types.SimpleNamespace(program=object(), scratch={})
    reader.install(run)
    assert reader.read(run) is None
    session = types.SimpleNamespace(lanes_fed=3, lanes_run=4)
    run = types.SimpleNamespace(program=session, scratch={})
    reader.install(run)
    assert reader.read(run) is None            # no lane in the window
    session.lanes_fed, session.lanes_run = 6, 8
    assert reader.read(run) == 75.0
