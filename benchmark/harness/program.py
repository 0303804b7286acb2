"""The system under test: the port's configuration and model, built from a
configuration file and the benchmark's weights. This is the only place
outside the traffic kinds that imports the program, and it refuses a
program found outside the checkout the benchmark runs from (an installed
copy would measure other code than the checkout's)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict

import torch

import mimamo_tpu_torch
from mimamo_tpu_torch import config as C
from mimamo_tpu_torch.runner import Mimamo

from .spec import ROOT

if ROOT not in Path(mimamo_tpu_torch.__file__).resolve().parents:
    raise ImportError(f"mimamo_tpu_torch was found at "
                      f"{mimamo_tpu_torch.__file__}, outside the checkout "
                      f"{ROOT}")

SECTIONS = {"pyramid": C.PyramidSpec, "phase": C.PhaseSpec,
            "backbone": C.BackboneSpec, "temporal": C.TemporalSpec,
            "clip": C.ClipSpec, "train": C.TrainSpec}


def mimamo_config(cfg: dict) -> C.MimamoConfig:
    """``MimamoConfig`` from a configuration file's sections; a key the
    program does not know raises, a key the file leaves out keeps the
    program's default."""
    parts = {}
    for section, cls in SECTIONS.items():
        values = dict(cfg.get(section, {}))
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(values) - fields
        if unknown:
            raise KeyError(f"{section}: unknown keys {sorted(unknown)}")
        parts[section] = cls(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in values.items()})
    return C.MimamoConfig(**parts)


def build_model(cfg: dict, state: Dict[str, torch.Tensor], device) -> Mimamo:
    """The port's model on ``device`` with the benchmark's weights (its own
    default init runs on ``device`` and is overwritten)."""
    with torch.device(device):
        model = Mimamo(mimamo_config(cfg), device=device)
    model.load_state_dict(state)
    return model
