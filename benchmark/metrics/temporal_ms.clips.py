"""Time (ms) of the temporal model in a clip call: CUDA events recorded
by a forward pre-hook and a forward hook on ``model.temporal`` (an
``nn.Module``), the median over the calls of the window."""

import statistics

import torch


def install(run):
    if run.device.type != "cuda":
        return
    pairs = run.scratch.setdefault("temporal_events", [])

    def before(module, args):
        pairs.append([torch.cuda.Event(enable_timing=True), None])
        pairs[-1][0].record()

    def after(module, args, out):
        pairs[-1][1] = torch.cuda.Event(enable_timing=True)
        pairs[-1][1].record()

    run.model.temporal.register_forward_pre_hook(before)
    run.model.temporal.register_forward_hook(after)


def read(run):
    pairs = [p for p in run.scratch.get("temporal_events", [])
             if p[1] is not None]
    if not pairs:
        return None
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)
