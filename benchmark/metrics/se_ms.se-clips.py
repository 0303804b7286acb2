"""Device time (ms) of the SE gates in a clip call: the summed
``device_ms`` of the call's ``backbone.se`` spans (squeeze, excitation and
scale of each of the 16 bottlenecks), median over the window's calls. A
program without the span reads nothing."""

import statistics
from collections import defaultdict

from benchmark.harness import spans

install = spans.install


def read(run):
    per_call = defaultdict(float)
    for r in spans.records(run):
        if r.name == "backbone.se" and r.device_ms is not None:
            per_call[r.request] += r.device_ms
    return statistics.median(per_call.values()) if per_call else None
