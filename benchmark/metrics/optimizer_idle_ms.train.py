"""Device idle (ms) inside the train step's optimizer, per step: the time
the host spent inside the program's ``train.optimizer`` spans (the
gradient average, Adam's step and the schedule) while no kernel ran on
the device, from torch.profiler, over the window's steps."""

from benchmark.harness import spans

install = spans.install


def read(run):
    idle = spans.idle_in(run, "train.optimizer")
    steps = run.counts.get("steps")
    return None if idle is None or not steps else 1e3 * idle / steps
