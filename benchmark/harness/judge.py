"""The training cell's numbers, the verdict, and the import check.

Each number compares the program's outputs with the plain reference's on
the same inputs and weights (the serving kinds' in ``serving.py``), and
has a limit of its own, kept in the cell's ``workloads/<cell>.json``, set
from the readings that ``PERF.md`` gives. A run is correct when every
number is finite and within its limit.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# Modules a run may not load, compared by the whole top-level name: the
# port's package, ``mimamo_tpu_torch``, begins with the JAX package's name.
FORBIDDEN = ("jax", "jaxlib", "flax", "mimamo_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                        else modules)}
    return sorted(names & set(FORBIDDEN))


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep: Sequence[str]) -> List[float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    median = float(np.median([want[k] for k in keep]))
    return [abs(got[k] - want[k]) / max(want[k], median, 1e-30)
            if math.isfinite(got[k]) else math.inf for k in keep]


def training_numbers(got: dict, want: dict,
                     names: Sequence[Optional[str]] = ("loss1_gap",
                                                       "grad_gap",
                                                       "change_gap")
                     ) -> Dict[str, float]:
    """The training cell's numbers from a run of steps on both sides
    (``losses``, ``first_grad``, ``start``, ``end``), under ``names`` (a
    number whose name is None is left out):

    * ``loss1_gap``: the first step's loss, relative gap;
    * ``grad_gap``: the worst leaf's gap of the first gradient's norm;
    * ``change_gap``: the median leaf's gap of the norm of its change over
      the steps, leaving out the leaves whose reference gradient is under a
      thousandth of the median leaf's (Adam moves those by round-off
      alone).

    The first step and the median leaf, because Adam turns round-off in a
    near-zero gradient element into a step of the full rate, so the losses
    of later steps run from drifted weights, and they and the worst leaf's
    change swing from seed to seed with round-off alone (``PERF.md``, §2).
    A single step from a state both sides share (the window's last step)
    has no such drift; its loss is left out there, as its gradient and its
    change separate the lower precision more widely."""
    loss1 = abs(got["losses"][0] - want["losses"][0]) / max(
        abs(want["losses"][0]), 1e-30)
    if not all(math.isfinite(x) for x in got["losses"]):
        loss1 = math.inf
    leaves = sorted(want["first_grad"])
    g_want = _norms(want["first_grad"])
    g_got = _norms({k: got["first_grad"][k] for k in leaves})
    median = float(np.median([g_want[k] for k in leaves]))
    moved = [k for k in leaves if g_want[k] >= 1e-3 * median]
    c_want = _norms({k: want["end"][k] - want["start"][k] for k in leaves})
    c_got = _norms({k: got["end"][k].to(want["end"][k])
                    - got["start"][k].to(want["end"][k]) for k in leaves})
    values = (loss1, max(leaf_gaps(g_got, g_want, leaves)),
              float(np.median(leaf_gaps(c_got, c_want, moved))))
    return {n: v for n, v in zip(names, values) if n}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, dict]:
    """Each number beside its limit. A number without a limit is an error
    of the cell's files, not a pass."""
    missing = set(numbers) ^ set(limits)
    if missing:
        raise KeyError(f"numbers and limits differ: {sorted(missing)}")
    return {k: {"value": numbers[k], "limit": limits[k],
                "ok": bool(math.isfinite(numbers[k])
                           and numbers[k] <= limits[k])}
            for k in sorted(numbers)}
