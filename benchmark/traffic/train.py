"""Training: the step of ``train.make_train_step`` in a closed loop.

Set-up builds one train state (the model, Adam and its schedule) and one
step, and drives them through the first ``checked_steps`` steps on
distinct batches of the pool, recording what the check compares: each
step's loss, the first gradient as Adam holds it after one step (its
first moment over 1 - beta1), and the trained parameters before the
first step and after the last. The same state and step then run the
window over the rest of the pool, in turn; ``train_step_ms`` is the
window, synchronised at its end, over the steps it ran.

Before each step of the window the trained parameters and Adam's moments
are copied aside on the device (three multi-tensor copies, no sync), so
that once the window has closed the copies hold the state its last step
started from, and that step, timed like every other, is checked too: its
gradient (worked out from the moments before and after) and its change of
the parameters.

Correct: the reference's first steps from the same weights on the same
batches (``loss1_gap``, ``grad_gap``, ``change_gap``), and the
reference's step from the state the window's last step started from, on
its batch (``last_grad_gap``, ``last_change_gap``; ``harness/judge.py``).
"""

from __future__ import annotations

import time

import torch

from mimamo_tpu_torch import train

from ..harness import data, judge, program


def _batches(run):
    p = run.mix
    clips = data.make_clips(run.seed, run.device, p["pool"], p["clips"],
                            p["frames"], run.config["clip"]["crop_size"]
                            ).cpu().numpy()
    labels, mask = data.make_labels(run.seed, p["pool"], p["clips"],
                                    p["frames"])
    return [{"clips": clips[i], "labels": labels[i], "mask": mask[i]}
            for i in range(p["pool"])]


def _trained(state, model):
    """The trained parameters in the optimizer's order, and their names
    in the model's ``state_dict``."""
    named = {id(p): f"temporal.{n}"
             for n, p in model.temporal.named_parameters()}
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    return params, [named[id(p)] for p in params]


def _moments(state, params, key):
    return [state.optimizer.state[p][key] for p in params]


def setup(run) -> None:
    run.model = program.build_model(run.config, run.state, run.device)
    run.inputs = _batches(run)
    state = train.create_train_state(run.model)
    step = train.make_train_step(run.model)
    params, names = _trained(state, run.model)
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    record = {"losses": [], "first_grad": {},
              "start": {n: p.detach().clone() for n, p in zip(names, params)}}
    for i in range(run.mix["checked_steps"]):
        state, metrics = step(state, run.inputs[i])
        record["losses"].append(float(metrics["loss"]))
        if i == 0:
            record["first_grad"] = {
                n: m / (1 - beta1)
                for n, m in zip(names, _moments(state, params, "exp_avg"))}
    record["end"] = {n: p.detach().clone() for n, p in zip(names, params)}
    run.observed = {"first": record}
    # the copies aside of the window, made once here so that their kernels
    # are loaded before it opens
    live = [params, _moments(state, params, "exp_avg"),
            _moments(state, params, "exp_avg_sq")]
    before = [[t.detach().clone() for t in ts] for ts in live]
    _copy_aside(before, live)
    run.program = (state, step, live, before)


def _copy_aside(before, live) -> None:
    with torch.no_grad(), torch.profiler.record_function(
            "benchmark.train_state_copy"):
        for dst, src in zip(before, live):
            torch._foreach_copy_(dst, src)


def window(run) -> None:
    state, step, live, before = run.program
    pool, first = run.inputs, run.mix["checked_steps"]
    params, names = _trained(state, run.model)
    steps, metrics = 0, None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        _copy_aside(before, live)
        with torch.profiler.record_function("train.step"):
            _, metrics = step(state, pool[(first + steps) % len(pool)])
        steps += 1
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    elapsed = time.perf_counter() - t0
    run.counts.update(attempted=steps, steps=steps, window_s=elapsed)
    run.values["train_step_ms"] = elapsed / steps * 1e3
    # the window's last step: the state it started from, and what it made
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    after = _moments(state, params, "exp_avg")
    run.observed["last"] = {
        "batch": (first + steps - 1) % len(pool),
        "count": int(state.optimizer.state[params[0]]["step"]) - 1,
        "params": dict(zip(names, before[0])),
        "exp_avg": dict(zip(names, before[1])),
        "exp_avg_sq": dict(zip(names, before[2])),
        "losses": [float(metrics["loss"])],
        "first_grad": {n: (a - beta1 * b) / (1 - beta1)
                       for n, a, b in zip(names, after, before[1])},
        "start": dict(zip(names, before[0])),
        "end": {n: p.detach().clone() for n, p in zip(names, params)}}


def outputs(run, ref, fault=None):
    """The reference's first steps on the same batches, and its step from
    the state the window's last step started from, on that step's batch;
    ``fault`` plants one of the run's reference's ``FAULTS`` in both."""
    def batches(indices):
        return [{k: torch.from_numpy(v) for k, v in run.inputs[i].items()}
                for i in indices]

    lr = run.config["train"]["learning_rate"]
    last = run.observed["last"]
    steps = run.reference.train_steps
    return {"first": steps(
                ref, batches(range(run.mix["checked_steps"])), lr=lr,
                fault=fault),
            "last": steps(
                ref, batches([last["batch"]]), lr=lr, fault=fault,
                resume=last)}


expected = outputs


def numbers(observed, want) -> dict:
    return dict(judge.training_numbers(observed["first"], want["first"]),
                **judge.training_numbers(
                    observed["last"], want["last"],
                    (None, "last_grad_gap", "last_change_gap")))


def as_observed(want):
    """The reference's outputs in the form of the program's, so that a
    reference put in the program's place (the control) is judged alike."""
    return want
