"""Device time (ms) of the micro stream's phase stage in a clip call: the
median ``device_ms`` of the program's ``micro`` spans (grey conversion,
the cuFFT pyramid's bands and the phase kernel) over the window's calls."""

from benchmark.harness import spans

install = spans.install


def read(run):
    return spans.median_ms(run, "micro")
