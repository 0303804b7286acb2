"""Plain references that decide whether a run's outputs are correct.
They import nothing of the program.

A configuration names its reference at the top level of its file,
``"reference": "<module>"``, a module of this package; without the key it
is ``mimamo``. ``for_config`` finds it, and every part of the harness
reaches the reference through the module it returns (``main.execute``
keeps it as ``run.reference``), so a new architecture is a new
configuration file and a new module here, and no file of the harness
changes.

What a reference module defines, and who calls it:

* ``schema(cfg)``: (name, shape, kind, fan_in) of every tensor of the
  model's ``state_dict``, in the order the weights are drawn
  (``harness/data.make_weights``). ``kind`` is one of the kinds
  ``make_weights`` draws (``data.NORMAL``, ``data.UNIFORM``,
  ``bn_count``); it refuses any other.
* ``check_supported(cfg)``: raises on any configuration the module does
  not compute, naming what it refuses (``main.execute``, before set-up;
  ``Reference`` again when it is built).
* ``Reference(cfg, state, device, low=None)``: the model of one
  configuration with one set of weights, in fp32 with TF32 off, or with
  ``low`` one of ``"bf16"``, ``"fp8"``, ``"tf32"`` (the controls,
  ``tools/readings.py``). ``main.execute`` builds it once the window has
  closed and hands it to the traffic kind. Its methods that the kinds
  call:

  - ``clips(crops)``: [B, T, S, S, 3] uint8 crops -> [B, T, outputs] in
    clip mode (the ``clips`` and ``streams`` kinds);
  - ``stated()``: the same model plainly in the precision the
    configuration states, the yardstick of ``out_err``
    (``harness/serving.py``);
  - what ``train_steps`` calls on it (``phase``, ``embed``,
    ``micro_sequence``, ``temporal``, ``precision``, ``p``, ``cfg``,
    ``device``), where the module's own ``train_steps`` is inherited.
* ``train_steps(ref, batches, lr, fault=None, resume=None)``: the
  reference's training steps (the ``train`` kind), and ``FAULTS``, the
  faults it can plant (``fault=``; the ``train`` kind and
  ``tools/readings.py``).

A new module may import ``mimamo`` and subclass its ``Reference``,
overriding only what its model changes; ``Reference.stated`` builds
``type(self)``, and ``Reference.__init__`` checks with the class's
``check_supported``, so a subclass that accepts more keys sets its own.
"""

from __future__ import annotations

import importlib
import pkgutil
from types import ModuleType
from typing import List

DEFAULT = "mimamo"


def names() -> List[str]:
    """The reference modules of this package."""
    return sorted(m.name for m in pkgutil.iter_modules(__path__)
                  if not m.ispkg)


def for_config(cfg: dict) -> ModuleType:
    """The reference module that ``cfg`` names (``"reference"``, or
    ``mimamo`` without the key)."""
    name = cfg.get("reference", DEFAULT)
    known = names()
    if name not in known:
        raise KeyError(f"the configuration names the reference {name!r}, "
                       f"which is no module of benchmark/reference/; "
                       f"references: {known}")
    return importlib.import_module(f"{__name__}.{name}")
