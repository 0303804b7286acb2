"""Device time (ms) of the frozen backbone in a train step: the median
``device_ms`` of the program's ``backbone`` spans, one a step (the fp32
convs with TF32 off, cuDNN's layout transposes around them and the
epilogues), over the window's steps."""

from benchmark.harness import spans

install = spans.install


def read(run):
    return spans.median_ms(run, "backbone")
