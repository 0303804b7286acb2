"""Device idle (ms) inside a feed: the time the host spent inside the
program's ``streaming.feed`` spans while no kernel ran on the device, from
torch.profiler, over the window's feeds. The scheduler's sleep between
due chunks lies outside every feed and is left out."""

from benchmark.harness import spans

install = spans.install


def read(run):
    idle = spans.idle_in(run, "streaming.feed")
    feeds = run.counts.get("feeds")
    return None if idle is None or not feeds else 1e3 * idle / feeds
