"""Host time (ms) of one ``StreamingSession.feed``, chunks in to
predictions on the host: the median over the feeds of the window."""

import statistics


def read(run):
    feeds = run.counts.get("feed_s")
    return statistics.median(feeds) * 1e3 if feeds else None
