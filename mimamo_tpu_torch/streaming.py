"""Batch-of-streams serving: many concurrent videos, one forward per chunk.

Counterpart of ``mimamo_tpu/streaming.py``. A session holds a fixed
capacity of independent video streams, each with its own GRU carries and
one frame of pair context, all on the model's device; ``feed`` advances
any subset of them by one fixed-size chunk through a single batched
forward, so the kernels always see the same shapes.

Slot lifecycle: ``add_stream`` claims a free slot and zeroes its carries,
``feed`` advances the fed slots (the lanes of the others run on zero
frames and their state does not move), ``remove_stream`` frees the slot.
A fresh stream's first chunk takes its own first frame as pair context
and is marked in ``first_pair_invalid``, so its step 0 equals clip mode.

The state is replaced, never written in place, and everything runs on the
current CUDA stream. A session spans one device; the weights are the
model's own. With stacked GRUs the carries are [L, capacity, H] and the
slots are their axis 1. With ``appearance_stride`` k > 1 each chunk
(after its context frame) is anchored on its own grid, as the JAX session
anchors it: streamed outputs then drift slightly from batch prediction of
the same frames where the grids differ at the chunk seams.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .runner import Mimamo
from .temporal import init_carries


class StreamingSession:
    def __init__(self, model: Mimamo, capacity: int = 8, chunk: int = 16,
                 dtype=np.float32):
        """``dtype=np.uint8`` ships chunks to the device as uint8 (a quarter
        of the float32 transfer; the model casts on the device, so integral
        pixel values give identical outputs)."""
        self.model = model
        self.capacity = capacity
        self.chunk = chunk
        self.dtype = np.dtype(dtype)
        cfg = model.config
        s = cfg.clip.crop_size
        self._gru = init_carries(cfg.temporal, capacity, model.device)
        self._context = torch.from_numpy(
            np.zeros((capacity, 1, s, s, 3), self.dtype)).to(model.device)
        self._free = list(range(capacity))
        self._fresh = np.zeros(capacity, bool)
        # slots are axis 0 of [B, H] carries, axis 1 of stacked [L, B, H]
        self._slot_axis = 0 if cfg.temporal.gru_layers == 1 else 1

    def _slot_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """[capacity] bool -> broadcastable over the carries' layout."""
        return mask[:, None] if self._slot_axis == 0 else mask[None, :, None]

    # -- slot management -----------------------------------------------------

    def add_stream(self) -> int:
        """Claim a slot for a new stream; returns its id."""
        if not self._free:
            raise RuntimeError(f"all {self.capacity} stream slots in use")
        slot = self._free.pop(0)
        keep = torch.ones(self.capacity, dtype=torch.bool,
                          device=self.model.device)
        keep[slot] = False
        keep = self._slot_mask(keep)
        self._gru = tuple(torch.where(keep, c, torch.zeros_like(c))
                          for c in self._gru)
        self._fresh[slot] = True
        return slot

    def _is_active(self, slot) -> bool:
        return (isinstance(slot, (int, np.integer))
                and 0 <= slot < self.capacity and slot not in self._free)

    def remove_stream(self, slot: int) -> None:
        if not self._is_active(slot):
            raise ValueError(f"slot {slot} is not active")
        self._free.append(slot)

    @property
    def active_slots(self) -> List[int]:
        return [i for i in range(self.capacity) if i not in self._free]

    @property
    def free_slots(self) -> int:
        """Number of unclaimed slots."""
        return len(self._free)

    # -- inference -----------------------------------------------------------

    @torch.no_grad()
    def feed(self, frames_by_slot: Dict[int, np.ndarray]
             ) -> Dict[int, np.ndarray]:
        """Advance streams by one chunk.

        Args:
          frames_by_slot: slot -> [chunk, S, S, 3] aligned crops in 0..255.
            Slots not present do not advance, but their lanes still run, so
            group arrivals when possible.

        Returns:
          slot -> [chunk, 2] per-frame (valence, arousal), on the host.
        """
        if not frames_by_slot:
            return {}
        s = self.model.config.clip.crop_size
        batch = np.zeros((self.capacity, self.chunk, s, s, 3), self.dtype)
        for slot, f in frames_by_slot.items():
            if not self._is_active(slot):
                raise ValueError(f"slot {slot} is not active")
            if f.shape != (self.chunk, s, s, 3):
                raise ValueError(f"slot {slot}: expected "
                                 f"{(self.chunk, s, s, 3)}, got {f.shape}")
            batch[slot] = f
        device = self.model.device
        x = torch.from_numpy(batch).to(device)
        fed = sorted(frames_by_slot)
        fed_mask = torch.zeros(self.capacity, dtype=torch.bool)
        fed_mask[fed] = True
        fed_mask = fed_mask.to(device)
        fresh = torch.from_numpy(self._fresh.copy()).to(device)

        # Fresh slots use their own first frame as pair context.
        context = torch.where(fresh[:, None, None, None, None],
                              x[:, :1], self._context)
        out, new_gru = self.model(torch.cat([context, x], dim=1), self._gru,
                                  include_first_pair=True,
                                  first_pair_invalid=fresh)
        # Commit state only for the slots that were fed.
        fed_slots = self._slot_mask(fed_mask)
        self._gru = tuple(torch.where(fed_slots, n, o)
                          for n, o in zip(new_gru, self._gru))
        self._context = torch.where(fed_mask[:, None, None, None, None],
                                    x[:, -1:], self._context)
        self._fresh[fed] = False
        out_np = out.cpu().numpy()
        return {slot: out_np[slot] for slot in frames_by_slot}
