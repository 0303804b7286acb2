"""The check shared by the serving kinds (clips, streams).

Random weights make the outputs' sensitivity to rounding differ from seed
to seed by a factor of ten, in the program and in any reference alike, so
a gap measured in the outputs' own units swings with the seed. The number
compared is therefore the program's error against the fp32 reference in
units of the error of the same model computed plainly in the precision
the configuration states (its backbone in bf16), on the same weights and
inputs: ``out_err`` = rms(program - fp32) / rms(plain bf16 - fp32).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np



def expected(outputs: Callable, run, ref) -> dict:
    """The fp32 reference's outputs and the stated-precision one's."""
    return {"ref": outputs(run, ref), "plain": outputs(run, ref.stated())}


def rms_error(pairs) -> float:
    sq, n = 0.0, 0
    for got, want in pairs:
        d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
        if not np.all(np.isfinite(d)):
            return math.inf
        sq += float((d * d).sum())
        n += d.size
    return math.sqrt(sq / max(n, 1))


def numbers(pairs: Callable, as_observed: Callable, observed, want) -> dict:
    plain = rms_error(pairs(as_observed(want["plain"]), want["ref"]))
    return {"out_err": rms_error(pairs(observed, want["ref"]))
            / max(plain, 1e-30)}
