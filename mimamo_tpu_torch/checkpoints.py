"""Checkpoints: training state on disk, and PyTorch ``.pth`` readers.

Counterpart of ``mimamo_tpu/checkpoints.py``:

  * :func:`save` / :func:`restore` / :func:`latest_step`: the training
    state (model ``state_dict`` in the canonical schema of
    docs/WEIGHTS.md, optimizer ``state_dict``, step) under
    ``<path>/<step>/state.pt``, one directory per step as orbax lays them
    out. It replaces orbax and reads no orbax directory.
  * :func:`load_pth` / :func:`load_pth_all` / :func:`load_pth_meta`: a
    torch checkpoint file as name -> numpy arrays, and the preprocessing
    meta of a MatConvNet-converted FER+ ``.pth``.
  * the backbone meta sidecar (:func:`save_backbone_meta`,
    :func:`load_backbone_meta`, :func:`apply_backbone_meta`).
  * :func:`load_temporal_state_dict`: a reference two-stream
    ``state_dict`` checked against the canonical temporal schema. The
    port's parameters already carry those names, so this is a rename
    (``prefix_map``) and a check; :func:`merge_temporal` checks the result
    against the config's shapes and merges it over initialized weights.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_STATE_FILE = "state.pt"
_BACKBONE_META_FILE = "backbone_meta.json"


def _step_dir(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), str(int(step)))


def save(path: str, state, step: Optional[int] = None) -> str:
    """Write a ``train.TrainState`` (model, optimizer, step) under
    ``path/<step>``, replacing a directory of that step; returns it. The
    file is written in a temporary directory beside it and renamed, so a
    reader never sees half a checkpoint."""
    step = int(state.step if step is None else step)
    os.makedirs(os.path.abspath(path), exist_ok=True)
    final = _step_dir(path, step)
    tmp = tempfile.mkdtemp(dir=os.path.abspath(path), prefix=".tmp-")
    try:
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": step}, os.path.join(tmp, _STATE_FILE))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return final


def latest_step(path: str) -> Optional[int]:
    """The largest step saved under ``path``, or None."""
    if not path or not os.path.isdir(path):
        return None
    steps = [int(d) for d in os.listdir(path) if d.isdigit()
             and os.path.exists(os.path.join(path, d, _STATE_FILE))]
    return max(steps) if steps else None


def load(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """``{"model", "optimizer", "step"}`` of step ``step`` (default: the
    latest) under ``path``, tensors on the CPU."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint steps found under {path}")
    return torch.load(os.path.join(_step_dir(path, step), _STATE_FILE),
                      map_location="cpu", weights_only=True)


def restore(path: str, state, step: Optional[int] = None):
    """Load a checkpoint written by :func:`save` into ``state`` (a
    ``train.TrainState`` that supplies the model, the optimizer and the
    schedule) and return it: weights through ``Mimamo.load_state_dict``
    (which drops the folded inference copy), optimizer moments, step, and
    the learning rate at that step."""
    ckpt = load(path, step)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    state.sync_schedule()
    return state


# -- torch .pth files --------------------------------------------------------

def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _extract_state_dict(obj) -> Dict[str, np.ndarray]:
    for key in ("state_dict", "model", "model_state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(
                obj[key], dict):
            obj = obj[key]
            break
    out = {}
    for k, v in obj.items():
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().numpy()
    return out


def load_pth(path: str) -> Dict[str, np.ndarray]:
    """A torch ``.pth``/``.pt`` checkpoint as name -> numpy arrays: a raw
    ``state_dict`` or a dict holding one under ``state_dict``, ``model`` or
    ``model_state_dict``."""
    return _extract_state_dict(_torch_load(path))


def load_pth_all(path: str
                 ) -> Tuple[Dict[str, np.ndarray], Optional[Dict]]:
    """(state_dict, meta) in one deserialization (a FER+ ``.pth`` is
    ~100 MB)."""
    obj = _torch_load(path)
    return _extract_state_dict(obj), _extract_meta(obj)


def load_pth_meta(path: str) -> Optional[Dict[str, Any]]:
    """Preprocessing meta of a MatConvNet-converted ``.pth`` (albanie
    conversions carry ``meta`` with ``mean``, ``std``, ``imageSize`` and
    sometimes ``imageOrder``) as ``{"mean": [r, g, b], "std": [...],
    "image_size": int, "channel_order": "rgb"|"bgr"}`` (absent fields
    left out), or None for a bare state_dict."""
    return _extract_meta(_torch_load(path))


def _extract_meta(obj) -> Optional[Dict[str, Any]]:
    if not isinstance(obj, dict):
        return None
    meta = obj.get("meta")
    if not isinstance(meta, dict):
        return None
    out: Dict[str, Any] = {}
    for key in ("mean", "std"):
        v = meta.get(key)
        if v is not None:
            v = np.asarray(v, np.float64).reshape(-1)
            if v.size == 3:
                out[key] = [float(x) for x in v]
    size = meta.get("imageSize")
    if size is not None:
        size = np.asarray(size).reshape(-1)
        out["image_size"] = int(size[0])
    order = meta.get("imageOrder", meta.get("channel_order"))
    if isinstance(order, str) and order.lower() in ("rgb", "bgr"):
        out["channel_order"] = order.lower()
    return out or None


# -- backbone preprocessing meta ----------------------------------------------

def save_backbone_meta(ckpt_dir: str, mean_rgb, channel_order: str) -> str:
    """Record the backbone's preprocessing (mean, channel order) beside a
    checkpoint, so whoever loads it preprocesses as it was trained."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), _BACKBONE_META_FILE)
    with open(path, "w") as f:
        json.dump({"mean_rgb": [float(x) for x in mean_rgb],
                   "channel_order": str(channel_order)}, f)
    return path


def load_backbone_meta(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(os.path.abspath(ckpt_dir), _BACKBONE_META_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def apply_backbone_meta(config, ckpt_dir: Optional[str]):
    """``config`` with the checkpoint's recorded ``mean_rgb`` and
    ``channel_order``; unchanged when ``ckpt_dir`` is empty or has no
    meta."""
    if not ckpt_dir:
        return config
    meta = load_backbone_meta(ckpt_dir)
    if not meta:
        return config
    return dataclasses.replace(
        config, backbone=dataclasses.replace(
            config.backbone,
            mean_rgb=tuple(meta["mean_rgb"]),
            channel_order=meta["channel_order"]))


# -- reference two-stream checkpoints ------------------------------------------

_GRU_KEY = re.compile(
    r"^(gru_micro|gru_macro)\.(weight_ih|weight_hh|bias_ih|bias_hh)_l\d+$")
_MICRO_KEY = re.compile(
    r"^micro_cnn\.(conv\d+\.weight|bn\d+\.(weight|bias|running_mean|"
    r"running_var))$")
_DENSE_KEY = re.compile(r"^(macro_proj|fusion|head|micro_cnn\.fc)\."
                        r"(weight|bias)$")


def micro_fc_input_shape(spec, phase_size: int) -> Tuple[int, int, int]:
    """(H, W, C) of the micro-CNN activation flattened into its fc layer:
    each conv block halves the side with a 2x2 max pool, and the last
    conv's width is the channel count."""
    side = phase_size >> len(spec.micro_cnn_features)
    return side, side, spec.micro_cnn_features[-1]


def apply_prefix_map(state_dict: Dict[str, Any],
                     prefix_map: Optional[Dict[str, str]]) -> Dict[str, Any]:
    """``state_dict`` with each key that starts with a source prefix of
    ``prefix_map`` renamed to start with its canonical prefix, the values
    as they are."""
    sd = dict(state_dict)
    for src, dst in (prefix_map or {}).items():
        for k in list(sd):
            if k.startswith(src):
                sd[dst + k[len(src):]] = sd.pop(k)
    return sd


def load_temporal_state_dict(state_dict: Dict[str, Any],
                             prefix_map: Optional[Dict[str, str]] = None,
                             spec=None,
                             phase_size: Optional[int] = None,
                             strict: bool = True
                             ) -> Dict[str, torch.Tensor]:
    """A torch two-stream ``state_dict`` (tensors or numpy arrays) -> the
    port's ``TwoStreamRNN`` entries it maps onto, as float32 tensors.

    Canonical schema (translate foreign names with ``prefix_map``,
    source prefix -> canonical prefix): ``gru_micro.{weight_ih, weight_hh,
    bias_ih, bias_hh}_l<i>`` (one set per stacked layer), the same for
    ``gru_macro``, ``micro_cnn.conv<i>.weight``, ``micro_cnn.bn<i>.{weight,
    bias, running_mean, running_var}``, ``micro_cnn.fc.*``,
    ``macro_proj.*``, ``fusion.*``, ``head.*`` (``num_batches_tracked`` is
    skipped). The port
    flattens the micro CNN NCHW as torch
    does, so ``micro_cnn.fc.weight`` loads as it is; with ``spec`` and
    ``phase_size`` its input width is checked against
    :func:`micro_fc_input_shape`. ``strict`` raises ``KeyError`` on keys
    that map to nothing (a foreign schema without ``prefix_map`` would
    otherwise load nothing and leave random weights in place).
    """
    sd = apply_prefix_map(state_dict, prefix_map)
    out: Dict[str, torch.Tensor] = {}
    unconsumed = []
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        if not (_GRU_KEY.match(k) or _MICRO_KEY.match(k)
                or _DENSE_KEY.match(k)):
            unconsumed.append(k)
            continue
        arr = torch.as_tensor(np.asarray(v))
        if k == "micro_cnn.fc.weight" and spec is not None \
                and phase_size is not None:
            h, w, c = micro_fc_input_shape(spec, phase_size)
            if arr.shape[1] != h * w * c:
                raise ValueError(
                    f"micro_cnn.fc.weight in-dim {arr.shape[1]} != "
                    f"H*W*C = {h}*{w}*{c} from spec/phase_size: the "
                    f"checkpoint's CNN layout differs from the config")
        out[k] = arr.to(torch.float32)
    if strict and unconsumed:
        raise KeyError(
            f"unmapped state_dict keys (pass prefix_map to translate, or "
            f"strict=False to skip): {sorted(unconsumed)}")
    return out


def merge_temporal(base: Dict[str, torch.Tensor],
                   overlay: Dict[str, torch.Tensor], strict: bool = True
                   ) -> Tuple[Dict[str, torch.Tensor], int]:
    """``base`` (the config's ``TwoStreamRNN`` ``state_dict``) with the
    entries of ``overlay`` (:func:`load_temporal_state_dict`) put over it;
    returns (merged, dropped).

    An overlay entry the config has no tensor for (a micro conv past the
    config's depth, a GRU layer past ``gru_layers``, the inactive stream of
    a ``streams`` ablation) is dropped and counted, so no dangling tensor
    reaches the checkpoint. One whose shape differs from
    the config's is an error under ``strict`` (``ValueError`` naming every
    such tensor); without it it is dropped and counted too.
    """
    merged = dict(base)
    dropped, mismatches = 0, []
    for k, v in overlay.items():
        if k not in base:
            dropped += 1
        elif tuple(v.shape) != tuple(base[k].shape):
            mismatches.append(f"{k}: checkpoint {tuple(v.shape)} vs config "
                              f"{tuple(base[k].shape)}")
            dropped += 1
        else:
            merged[k] = v.to(base[k].dtype)
    if mismatches and strict:
        raise ValueError("tensor shapes incompatible with this config (pass "
                         "--no-strict to drop them): "
                         + "; ".join(mismatches))
    return merged, dropped
