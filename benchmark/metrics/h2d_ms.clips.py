"""Device time (ms) of the host-to-device copies per clip call (the
pageable uint8 source crossing to the card), from torch.profiler."""

from benchmark.harness import readers


def read(run):
    return readers.h2d_ms_per_call(run)
