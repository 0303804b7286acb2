"""Weights and inputs made from the run's seed, on the device.

Every draw comes from one ``torch.Generator`` on the run's device, seeded
from ``--seed`` and a purpose, in a few large calls: the same seed gives
the same weights and inputs on the same kind of device. The weights
follow the scheme of the port's own random init (convs normal with std
1/sqrt(fan_in), Linear and GRU uniform in +-1/sqrt(fan), BatchNorm near
identity), in fp32, the type the model loads them in.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import reference

# Each purpose's stream of draws; the numbers are part of what a seed
# means, so a purpose keeps its number and a new one takes a new number.
PURPOSES = {"weights": 0, "crops": 1, "labels": 4, "order": 5}

# The leaf kinds of a reference's ``schema`` that ``make_weights`` draws:
# from the normal draw, from the uniform draw, and BatchNorm's counter.
NORMAL = ("conv", "bn_weight", "bn_bias", "bn_mean")
UNIFORM = ("linear", "gru", "bn_var")
DRAWN = NORMAL + UNIFORM + ("bn_count",)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    """A generator on ``device`` for one purpose of one seed."""
    mixed = np.random.SeedSequence([int(seed), PURPOSES[purpose]])
    g = torch.Generator(device=device)
    g.manual_seed(int(mixed.generate_state(1, np.uint64)[0]))
    return g


def rng(seed: int, purpose: str) -> np.random.Generator:
    """A host generator for bookkeeping draws (orders, phases, samples)."""
    return np.random.default_rng([int(seed), 100 + PURPOSES[purpose]])


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` (the ``schema`` of the configuration's
    reference) drawn from the seed: one normal and one uniform draw for
    the whole model. A leaf of a kind not in ``DRAWN`` raises."""
    leaves = reference.for_config(cfg).schema(cfg)
    for name, _, kind, _ in leaves:
        if kind not in DRAWN:
            raise ValueError(f"leaf {name!r} is of kind {kind!r}, which "
                             f"make_weights does not draw; kinds: {DRAWN}")
    g = generator(seed, "weights", device)
    n_normal = sum(math.prod(s) for _, s, k, _ in leaves if k in NORMAL)
    n_uniform = sum(math.prod(s) for _, s, k, _ in leaves if k in UNIFORM)
    z = torch.randn(n_normal, generator=g, device=device)
    u = torch.rand(n_uniform, generator=g, device=device)
    out, iz, iu = {}, 0, 0
    for name, shape, kind, fan in leaves:
        n = math.prod(shape)
        if kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
            continue
        if kind in NORMAL:
            x = z[iz:iz + n].view(shape)
            iz += n
            out[name] = {"conv": x / math.sqrt(fan), "bn_weight": 1 + 0.1 * x,
                         "bn_bias": 0.1 * x, "bn_mean": 0.1 * x}[kind]
        else:
            x = u[iu:iu + n].view(shape)
            iu += n
            out[name] = 0.5 + x if kind == "bn_var" else (
                (2 * x - 1) / math.sqrt(fan))
    return out


def _moving(base: torch.Tensor, n: int, size: Tuple[int, int],
            start: torch.Tensor, velocity: torch.Tensor, noise: float,
            g: torch.Generator) -> torch.Tensor:
    """``n`` frames of ``size`` sampled from a smooth [C, H0, W0] texture,
    the window moving by ``velocity`` (pixels a frame of the texture's
    grid, [2]) from ``start`` ([2], in -1..1 of the texture), plus
    Gaussian sensor noise; uint8 [n, H, W, C]."""
    c, h0, w0 = base.shape
    h, w = size
    dev = base.device
    ys = torch.linspace(-1, 1, h, device=dev) * (h / h0)
    xs = torch.linspace(-1, 1, w, device=dev) * (w / w0)
    t = torch.arange(n, device=dev, dtype=torch.float32)
    oy = start[0] + t * velocity[0] * 2 / h0
    ox = start[1] + t * velocity[1] * 2 / w0
    grid = torch.stack(torch.broadcast_tensors(
        xs[None, None, :] + ox[:, None, None],
        ys[None, :, None] + oy[:, None, None]), dim=-1)        # [n, H, W, 2]
    frames = F.grid_sample(base[None].expand(n, c, h0, w0), grid,
                           mode="bilinear", padding_mode="reflection",
                           align_corners=True)
    frames = frames + noise * torch.randn(frames.shape, generator=g,
                                          device=dev)
    return frames.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)


def _texture(g: torch.Generator, device, size: Tuple[int, int],
             cells: int = 12) -> torch.Tensor:
    """A smooth random RGB texture [3, H, W] in 0..255: coarse random
    values upsampled bicubically, so that it has structure at every
    pyramid scale."""
    coarse = torch.rand((1, 3, cells, cells), generator=g, device=device)
    fine = torch.rand((1, 3, 4 * cells, 4 * cells), generator=g,
                      device=device)
    x = (0.75 * F.interpolate(coarse, size=size, mode="bicubic",
                              align_corners=False)
         + 0.25 * F.interpolate(fine, size=size, mode="bicubic",
                                align_corners=False))
    return (x[0] * 255.0).clamp(0, 255)


@torch.no_grad()
def make_clips(seed: int, device, batches: int, clips: int, frames: int,
               size: int) -> torch.Tensor:
    """``batches`` x ``clips`` clips of ``frames`` aligned face-crop-like
    frames, uint8 [batches, clips, frames, size, size, 3] on ``device``:
    each clip a smooth texture drifting by under a pixel a frame (the
    micro-motion the phase stream measures) with sensor noise."""
    g = generator(seed, "crops", device)
    out = torch.empty((batches, clips, frames, size, size, 3),
                      dtype=torch.uint8, device=device)
    for i in range(batches):
        for j in range(clips):
            base = _texture(g, device, (2 * size, 2 * size))
            start = (torch.rand(2, generator=g, device=device) - 0.5) * 0.5
            vel = (torch.rand(2, generator=g, device=device) - 0.5) * 1.0
            out[i, j] = _moving(base, frames, (size, size), start, vel, 4.0, g)
    return out


def make_labels(seed: int, batches: int, clips: int, frames: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Smooth valence and arousal targets in -1..1, [batches, clips,
    frames, 2] float32, and frame masks [batches, clips, frames]: the last
    clip of a batch ends early (padding), by 0 to 12 frames."""
    r = rng(seed, "labels")
    t = np.arange(frames)[None, None, :, None]
    freq = r.uniform(0.02, 0.2, (batches, clips, 1, 2))
    phase = r.uniform(0, 2 * np.pi, (batches, clips, 1, 2))
    amp = r.uniform(0.3, 0.9, (batches, clips, 1, 2))
    labels = (amp * np.sin(2 * np.pi * freq * t + phase)).astype(np.float32)
    mask = np.ones((batches, clips, frames), np.float32)
    for i in range(batches):
        cut = int(r.integers(0, 13))
        if cut:
            mask[i, -1, -cut:] = 0.0
    return labels, mask
