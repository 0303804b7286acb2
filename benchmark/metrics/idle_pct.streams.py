"""The share (%) of the traced window of the streams cell in which no kernel
ran on the device, from torch.profiler: copies and fills alone count as
idle."""

from benchmark.harness import readers


def read(run):
    return readers.idle_pct(run)
