"""Batch-of-streams serving: many concurrent videos, one forward per chunk.

Counterpart of ``mimamo_tpu/streaming.py``. A session holds a fixed
capacity of independent video streams, each with its own GRU carries and
one frame of pair context, all on the model's device; ``feed`` advances
any subset of them by one fixed-size chunk through a single batched
forward.

Only the fed lanes run the frame stages (the phase stage and the
backbone). A feed of at most k slots on any rank runs the smallest of the
session's lane counts that is at least k: the fed slots first, then unfed
slots on zero frames as padding. The temporal model then runs on all of a
rank's slots (``Mimamo.forward``'s ``rows``), as every feed's does, and
only the fed slots' new state is kept. A stream's outputs are thus bit for bit
those of a feed of every slot, whichever other slots are fed: the lane
counts are the candidates of :func:`candidates` (1, 3, the powers of two
and the capacity: few shapes, since a session's build checks and
captures each one; 3 serves feeds of 2 where 2 lanes give other bits)
whose frame stages give the model the bits they give at the full
capacity. cuDNN
chooses its convolution kernels by the batch, and on an H100 the bf16
backbone's bits at 32 or 64 frames differ from those at 16, 48 or 128 and
up. A session on a CUDA device checks this on seeded frames when it is
built, once per model, capacity, chunk and dtype in a process (over
ranks, a count must pass on all of them). Elsewhere every candidate runs
(:func:`checks_bits`). ``lanes_fed`` and ``lanes_run`` count the slots
fed and the lanes run, padding included, over the session's feeds (every
rank's, on every rank).

On a CUDA device a feed's work (:func:`step`: the gather, the forward and
the commit) is one CUDA graph a lane count, captured once per model in
the process (by the check above, so a session's construction builds
every plan and graph its feeds need) and replayed under the model's lock:
a feed of a few lanes is otherwise bound by the host's ~150 kernel
launches and ~1,200 PyTorch calls, and its time then follows the host's
speed. The check compares the graphs' outputs, so the bits it vouches
for are those the feeds get. A replayed feed has the spans
``streaming.feed``, ``.assemble`` and ``.d2h`` (the forward's and the
commit's spans are those of an eager feed), and each replay adds the
launches its capture held to ``Kernel.launches``.

Slot lifecycle: ``add_stream`` claims a free slot and zeroes its carries,
``feed`` advances the fed slots (an unfed slot's state does not move),
``remove_stream`` frees the slot. A fresh stream's first chunk takes its
own first frame as pair context and is marked in ``first_pair_invalid``,
so its step 0 equals clip mode.

The state is replaced, never written in place, and everything runs on the
current CUDA stream. The weights are the model's own. Over the ranks of a
``parallel.DataGroup`` the slot axis is split, as the JAX session shards
it over a mesh: each rank keeps the carries and the context of its block
of ``capacity / W`` slots, the slot bookkeeping is the same on every rank,
and ``feed`` is collective (every rank passes the same chunks and gets
every slot's outputs). Every rank runs the lane count of the rank with the
most fed slots, which each rank knows from the chunks alone, so that the
ranks gather equal shapes. With stacked GRUs the carries are [L, slots, H]
and the slots are their axis 1. With ``appearance_stride`` k > 1 each chunk
(after its context frame) is anchored on its own grid, as the JAX session
anchors it: streamed outputs then drift slightly from batch prediction of
the same frames where the grids differ at the chunk seams.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from . import parallel, tracing
from .kernels import _build
from .parallel import DataGroup
from .runner import Mimamo
from .temporal import Carries, init_carries

# model -> {(slots a rank, chunk, dtype): the lane counts its feeds run}
_checked: "weakref.WeakKeyDictionary[Mimamo, dict]" = (
    weakref.WeakKeyDictionary())
# CUDA model -> {"lock", "pool", (slots a rank, chunk, dtype, lanes): _Graph}
_graphs: "weakref.WeakKeyDictionary[Mimamo, dict]" = (
    weakref.WeakKeyDictionary())
_graphs_lock = threading.Lock()


def candidates(local: int) -> List[int]:
    """Lane counts a rank of ``local`` slots may run: 3 and the powers of
    two below ``local``, then ``local``."""
    return sorted({n for n in [3] + [1 << i for i in range(local.bit_length())]
                   if n < local} | {local})


def checks_bits(device: torch.device) -> bool:
    """Whether sessions on ``device`` check their lane counts' bits: on a
    CUDA device, where cuDNN and cuBLAS choose their kernels by the batch.
    (On the CPU at the tests' sizes every candidate gives the same bits,
    and a check of a full-size model there would take minutes.)"""
    return device.type == "cuda"


def _slots(mask: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """[slots] bool -> broadcastable over ``carry``: slots are axis 0 of
    [B, H] carries, axis 1 of stacked [L, B, H] ones."""
    return mask[:, None] if carry.dim() == 2 else mask[None, :, None]


def step(model: Mimamo, x: torch.Tensor, idx: torch.Tensor,
         fresh: torch.Tensor, fed: torch.Tensor, gru: Carries,
         context: torch.Tensor):
    """A feed's work on the device. ``x`` [b, chunk, S, S, 3]: the frames
    of the lanes ``idx`` [b] (local slots: the fed ones, then padding on
    zero frames); ``fresh`` and ``fed`` [local] bool; ``gru`` and
    ``context`` the state. Returns (outputs [local, chunk, 2], new carries,
    new context), the state replaced at the fed slots only."""
    lane_fresh = fresh.index_select(0, idx)[:, None, None, None, None]
    old = context.index_select(0, idx)
    # Fresh slots use their own first frame as pair context.
    pair = torch.where(lane_fresh, x[:, :1], old)
    out, new = model(torch.cat([pair, x], dim=1), gru,
                     include_first_pair=True, first_pair_invalid=fresh,
                     rows=idx)
    # Commit state only for the slots that were fed.
    with tracing.span("streaming.commit", model.device):
        new = tuple(torch.where(_slots(fed, o), n, o)
                    for n, o in zip(new, gru))
        lane_fed = fed.index_select(0, idx)[:, None, None, None, None]
        context = context.index_copy(
            0, idx, torch.where(lane_fed, x[:, -1:], old))
    return out, new, context


class _Graph:
    """:func:`step` at one shape, captured as a CUDA graph on the model's
    shared pool. A call copies its arguments into the graph's own input
    buffers, replays it, adds its kernels' launches to ``Kernel.launches``
    and returns copies of its outputs, so the caller's state is replaced,
    never written in place. It keeps the folded backbone it was captured
    on (whose weights it reads): a model whose weights were loaded again
    folds anew, and the graph is then stale."""

    def __init__(self, model: Mimamo, pool, *args):
        dev = model.device
        self.inputs = [t.to(dev, copy=True) for t in _flat(args)]
        self.graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # plans and lazy state are built outside the capture
            step(model, *_nest(self.inputs))
            self.folded = model._folded
            before = _build.launch_counts()
            # not torch.cuda.graph, which empties the allocator's cache
            # before every capture
            self.graph.capture_begin(pool, capture_error_mode="thread_local")
            try:
                self.outputs = step(model, *_nest(self.inputs))
            finally:
                self.graph.capture_end()
            after = _build.launch_counts()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.launches = {k: n - before[k] for k, n in after.items()
                         if n != before[k]}
        _build.count({k: -n for k, n in self.launches.items()})

    def __call__(self, *args):
        for buf, arg in zip(self.inputs, _flat(args)):
            buf.copy_(arg)
        self.graph.replay()
        _build.count(self.launches)
        out, gru, context = self.outputs
        return out.clone(), tuple(c.clone() for c in gru), context.clone()


def _flat(args) -> List[torch.Tensor]:
    """:func:`step`'s tensor arguments, the carries unpacked."""
    x, idx, fresh, fed, gru, context = args
    return [x, idx, fresh, fed, *gru, context]


def _nest(flat: List[torch.Tensor]) -> tuple:
    """Inverse of :func:`_flat`."""
    return (*flat[:4], tuple(flat[4:-1]), flat[-1])


class StreamingSession:
    def __init__(self, model: Mimamo, capacity: int = 8, chunk: int = 16,
                 dtype=np.float32, group: Optional[DataGroup] = None):
        """``dtype=np.uint8`` ships chunks to the device as uint8 (a quarter
        of the float32 transfer; the model casts on the device, so integral
        pixel values give identical outputs). ``group``: split the slots
        over its ranks (``capacity`` divisible by W)."""
        self.model = model
        self.capacity = capacity
        self.chunk = chunk
        self.dtype = np.dtype(dtype)
        self.group = group
        world, rank = (1, 0) if group is None else (group.world, group.rank)
        if capacity % world:
            raise ValueError(f"capacity {capacity} must be divisible by the "
                             f"group size {world}")
        self._world, self._local = world, capacity // world
        self._lo, self._hi = rank * self._local, (rank + 1) * self._local
        cfg = model.config
        s = cfg.clip.crop_size
        self._gru = init_carries(cfg.temporal, self._local, model.device)
        self._context = torch.from_numpy(
            np.zeros((self._local, 1, s, s, 3), self.dtype)).to(model.device)
        self._free = list(range(capacity))
        self._fresh = np.zeros(capacity, bool)
        # slots are axis 0 of [B, H] carries, axis 1 of stacked [L, B, H]
        self._slot_axis = 0 if cfg.temporal.gru_layers == 1 else 1
        self.lanes_fed = 0
        self.lanes_run = 0
        self._lane_counts = self._check_lane_counts()

    def _check_lane_counts(self) -> List[int]:
        """The lane counts this session's feeds run: where
        :func:`checks_bits`, :meth:`_same_bits`, once per model, local
        capacity, chunk and dtype in the process; elsewhere every
        candidate."""
        if not checks_bits(self.model.device):
            return candidates(self._local)
        done = _checked.setdefault(self.model, {})
        key = (self._local, self.chunk, self.dtype)
        if key not in done:
            with torch.no_grad():
                done[key] = self._same_bits()
        return done[key]

    def _same_bits(self) -> List[int]:
        """The candidates at which a feed's work (:meth:`_run`) of their
        lanes gives those slots' outputs of a feed of every slot bit for
        bit, on seeded frames; over ranks, those at which it does on every
        rank. On a CUDA device this captures every candidate's graph."""
        n, s = self._local, self.model.config.clip.crop_size
        frames = torch.from_numpy(torch.randint(
            0, 256, (n, self.chunk + 1, s, s, 3),
            generator=torch.Generator().manual_seed(0),
            dtype=torch.uint8).numpy().astype(self.dtype))
        context = frames[:, :1].to(self.model.device)
        fresh = torch.zeros(n, dtype=torch.bool)
        fed = torch.ones(n, dtype=torch.bool)

        def run(b):
            return self._run(b, frames[:b, 1:], torch.arange(b), fresh, fed,
                             self._gru, context)[0][:b]

        want, counts = run(n), candidates(n)
        same = torch.tensor([torch.equal(run(b), want[:b])
                             for b in counts[:-1]] + [True],
                            dtype=torch.uint8)
        same = parallel.all_gather(same[None], self.group).min(0).values
        return [b for b, ok in zip(counts, same.tolist()) if ok]

    def _run(self, lanes: int, x: torch.Tensor, idx: torch.Tensor,
             fresh: torch.Tensor, fed: torch.Tensor, gru: Carries,
             context: torch.Tensor):
        """:func:`step` of host ``x``, ``idx``, ``fresh`` and ``fed`` on the
        state ``gru`` and ``context``: on a CUDA device the replay of its
        graph at this lane count (captured on first use, and again once
        the model's weights were loaded anew), elsewhere eagerly."""
        model = self.model
        args = (x, idx, fresh, fed, gru, context)
        if model.device.type != "cuda":
            return step(model, *_nest([t.to(model.device)
                                       for t in _flat(args)]))
        with _graphs_lock:
            graphs = _graphs.setdefault(model, {"lock": threading.Lock(),
                                                "pool": None})
        key = (self._local, self.chunk, self.dtype, lanes)
        with graphs["lock"]:
            graph = graphs.get(key)
            if graph is None or graph.folded is not model._folded:
                with tracing.suspended():
                    graph = graphs[key] = _Graph(model, graphs["pool"],
                                                 *args)
                graphs["pool"] = graph.graph.pool()
            return graph(*args)

    # -- slot management -----------------------------------------------------

    def add_stream(self) -> int:
        """Claim a slot for a new stream; returns its id."""
        if not self._free:
            raise RuntimeError(f"all {self.capacity} stream slots in use")
        slot = self._free.pop(0)
        if self._lo <= slot < self._hi:
            keep = torch.ones(self._hi - self._lo, dtype=torch.bool,
                              device=self.model.device)
            keep[slot - self._lo] = False
            keep = _slots(keep, self._gru[0])
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

    def _lanes(self, fed: List[int], lanes: int) -> List[int]:
        """This rank's local slots in the order its ``lanes`` lanes run
        them: its fed slots, then unfed ones as padding."""
        mine = [s - self._lo for s in fed if self._lo <= s < self._hi]
        taken = set(mine)
        return mine + [i for i in range(self._local)
                       if i not in taken][:lanes - len(mine)]

    @torch.no_grad()
    def feed(self, frames_by_slot: Dict[int, np.ndarray]
             ) -> Dict[int, np.ndarray]:
        """Advance streams by one chunk.

        Args:
          frames_by_slot: slot -> [chunk, S, S, 3] aligned crops in 0..255.
            Slots not present do not advance. For at most k fed slots on a
            rank the frame stages run the smallest of the session's lane
            counts that is at least k (module docstring).

        Returns:
          slot -> [chunk, 2] per-frame (valence, arousal), on the host.
        """
        if not frames_by_slot:
            return {}
        device = self.model.device
        with tracing.span("streaming.feed", device):
            with tracing.span("streaming.assemble", device):
                s = self.model.config.clip.crop_size
                for slot, f in frames_by_slot.items():
                    if not self._is_active(slot):
                        raise ValueError(f"slot {slot} is not active")
                    if f.shape != (self.chunk, s, s, 3):
                        raise ValueError(f"slot {slot}: expected "
                                         f"{(self.chunk, s, s, 3)}, got "
                                         f"{f.shape}")
                fed = sorted(frames_by_slot)
                most = np.bincount(np.asarray(fed) // self._local,
                                   minlength=self._world).max()
                lanes = next(n for n in self._lane_counts if n >= most)
                order = self._lanes(fed, lanes)
                mine = sum(self._lo <= slot < self._hi for slot in fed)
                batch = np.zeros((lanes, self.chunk, s, s, 3), self.dtype)
                for j, i in enumerate(order[:mine]):
                    batch[j] = frames_by_slot[self._lo + i]
                x = torch.from_numpy(batch)
                idx = torch.tensor(order)
                fed_mask = torch.from_numpy(
                    np.isin(np.arange(self._lo, self._hi), fed))
                fresh = torch.from_numpy(
                    self._fresh[self._lo:self._hi].copy())

            out, self._gru, self._context = self._run(
                lanes, x, idx, fresh, fed_mask, self._gru, self._context)
            self._fresh[fed] = False
            self.lanes_fed += len(fed)
            self.lanes_run += self._world * lanes
            with tracing.span("streaming.d2h", device):
                out_np = parallel.all_gather(out, self.group).cpu().numpy()
            return {slot: out_np[slot] for slot in frames_by_slot}
