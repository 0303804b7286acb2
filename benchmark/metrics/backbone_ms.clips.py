"""Device time (ms) of the backbone in a clip call: the median
``device_ms`` of the program's ``backbone`` spans (``Mimamo.embed_frames``:
the folded ResNet-50 from the stem to pool5, conv epilogues included) over
the window's calls."""

from benchmark.harness import spans

install = spans.install


def read(run):
    return spans.median_ms(run, "backbone")
