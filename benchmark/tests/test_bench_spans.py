"""The helper of the metrics that read the program's spans
(``harness/spans.py``): the device's idle time inside a span against a
hand-built trace, the median of the spans' device times, and spans on in
the traced window only."""

import types

import pytest

from benchmark.harness import spans
from benchmark.harness.trace import Trace
from mimamo_tpu_torch import tracing

# kernels at 1-2, 4-6 and 8-9 s; a copy alone at 2-3 s is idle, as in
# idle_pct
DEVICE = [("kernel_a", 1.0, 2.0), ("Memcpy HtoD (Pageable -> Device)",
                                    2.0, 3.0),
          ("kernel_b", 4.0, 6.0), ("kernel_c", 8.0, 9.0)]
HOST = [
    # two overlapping feeds merge into 0.5-5: idle 0.5-1 and 2-4 (the copy
    # inside), and a third that the window cuts at 10: idle 9.5-10
    ("feed", 0.5, 3.0), ("feed", 2.5, 5.0), ("feed", 9.5, 11.0),
    # the idle gap 6-8 lies half inside it: idle 7-8, then a kernel
    ("optimizer", 7.0, 8.5),
    ("aten::add", 1.2, 1.3),
]


def _run(device=DEVICE, host=HOST, records=()):
    return types.SimpleNamespace(trace=Trace(device, host, (0.0, 10.0)),
                                 scratch={"spans": list(records)})


@pytest.mark.parametrize("name, idle", [("feed", 3.0), ("optimizer", 1.0),
                                        ("aten::add", 0.0)])
def test_idle_in_a_span(name, idle):
    assert spans.idle_in(_run(), name) == pytest.approx(idle)


def test_idle_in_finds_nothing_to_read():
    """No such span, no kernel, or no trace: None, never 0."""
    assert spans.idle_in(_run(), "train.backward") is None
    copies = [d for d in DEVICE if d[0].startswith("Memcpy")]
    assert spans.idle_in(_run(device=copies), "feed") is None
    run = _run()
    run.trace = None
    assert spans.idle_in(run, "feed") is None


def test_median_ms_of_the_spans():
    rec = tracing.Record
    run = _run(records=[rec("backbone", None, 0, device_ms=3.0),
                        rec("backbone", None, 1, device_ms=1.0),
                        rec("backbone", None, 2, device_ms=2.5),
                        rec("micro", None, 2)])
    assert spans.median_ms(run, "backbone") == 2.5
    assert spans.median_ms(run, "micro") is None          # the CPU's
    assert spans.median_ms(run, "temporal") is None


def test_spans_on_between_install_and_the_first_read():
    run = types.SimpleNamespace(scratch={})
    tracing.collect()
    try:
        spans.install(run)
        assert tracing.enabled()
        with tracing.span("a"):
            with tracing.span("b"):
                pass
        got = spans.records(run)
        assert not tracing.enabled()
        assert [(r.name, r.parent) for r in got] == [("a", None), ("b", 0)]
        with tracing.span("c"):
            pass
        assert spans.records(run) is got and tracing.collect() == []
    finally:
        tracing.enable(False)
        tracing.collect()
