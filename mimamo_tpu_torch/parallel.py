"""Data parallelism over ``torch.distributed``: one process per card.

Counterpart of ``mimamo_tpu/parallel.py``. Where the JAX package shards a
batch over a mesh of devices and lets GSPMD insert the reductions, the port
runs one process (a rank) per device and reduces by hand: a JAX "mesh of N
devices" is a world of N ranks here, and each rank holds one device,
``cuda:(process_id % device_count)``, or the CPU when the caller asks for
it (:func:`initialize_distributed`, which returns a :class:`DataGroup`).
Without a coordinator the world has one rank and every function below
reduces to the local path, as the JAX code does on one device.

The backend follows the devices: NCCL where every rank has a card of its
own, gloo on the CPU or where ranks share a card (NCCL refuses two ranks on
one device). A group that does not form raises; nothing falls back to
fewer ranks or to the CPU.

Gradients through the collectives (:func:`all_reduce`, :func:`all_gather`).
Every rank computes the same global loss from globally reduced sums and
calls ``backward()`` on it. The backward of a summed all-reduce sums the
identical upstream gradients of all W ranks, so below a collective each
rank holds W times the gradient of the global loss along its own rows; the
all-gather's backward (an all-reduce of the gradient, then this rank's
rows) does the same. :func:`average_gradients` divides the parameters'
summed gradients by W, and that division is the one place where the factor
is taken out: the averaged gradient is the gradient of the global loss.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Any, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# How long a rank waits for the others to join or to reach a collective.
TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The data-parallel world as this rank sees it: ``world`` ranks, this
    one ``rank`` on ``device``; ``backend`` is "nccl", "gloo", or None for a
    world of one without a process group. The collectives run on the
    default process group, which :func:`initialize_distributed` forms."""

    world: int
    rank: int
    device: torch.device
    backend: Optional[str] = None

    def barrier(self) -> None:
        if self.world > 1:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()

    def close(self) -> None:
        """Leave the process group (a no-op for a world of one)."""
        if self.backend is not None and dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self) -> "DataGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None,
                           timeout: float = TIMEOUT_S) -> DataGroup:
    """Join the world of ``num_processes`` ranks whose rank 0 listens at
    ``coordinator`` ("host:port"); every rank calls this with the same
    coordinator and count and its own ``process_id``.

    ``device``: None puts rank r on ``cuda:(r % device_count)`` and raises
    without a card; "cpu" makes a CPU rank. The ranks tell each other their
    cards through the coordinator's store before the group forms: NCCL
    when every rank holds a card of its own, gloo otherwise. Raises when
    the group does not form within ``timeout`` seconds.

    Rank 0 serves the coordinator's store, unless the environment holds
    ``TORCHELASTIC_USE_AGENT_STORE=True``: then a launcher serves it (as
    torchrun's agent does, and ``dryrun.Ranks``) and every rank is a client.

    Without a coordinator: a world of one on ``device`` (None: the card,
    as ``runner.resolve_device``), with no process group."""
    if coordinator is None:
        from .runner import resolve_device   # runner imports this module
        if num_processes not in (None, 1) or process_id not in (None, 0):
            raise ValueError("num_processes / process_id need a coordinator")
        return DataGroup(1, 0, resolve_device(device))
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} out of range for "
                         f"{num_processes}")
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator must be host:port, got "
                         f"{coordinator!r}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' (--cpu) for a CPU rank")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    wait = datetime.timedelta(seconds=timeout)
    try:
        held = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
        store = dist.TCPStore(host, int(port), num_processes,
                              is_master=process_id == 0 and not held,
                              timeout=wait)
        card = (f"{socket.gethostname()}/{dev}" if dev.type == "cuda"
                else "cpu")
        store.set(f"card/{process_id}", card)
        cards = [store.get(f"card/{i}").decode()
                 for i in range(num_processes)]
        own_card = "cpu" not in cards and len(set(cards)) == num_processes
        backend = "nccl" if own_card else "gloo"
        dist.init_process_group(backend, store=store, rank=process_id,
                                world_size=num_processes, timeout=wait)
    except (RuntimeError, ValueError) as e:     # DistStoreError included
        raise RuntimeError(f"rank {process_id} of {num_processes}: the "
                           f"data-parallel group at {coordinator} did not "
                           f"form: {e}") from e
    return DataGroup(num_processes, process_id, dev, backend)


# -- collectives ----------------------------------------------------------


def _wire(t: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """A contiguous copy of ``t`` where the backend takes it: the rank's
    card for NCCL, the CPU for gloo (which then needs no CUDA support)."""
    where = group.device if group.backend == "nccl" else torch.device("cpu")
    return t.detach().to(where, copy=True).contiguous()


def _sum(t: torch.Tensor, group: DataGroup) -> torch.Tensor:
    w = _wire(t, group)
    dist.all_reduce(w)
    return w.to(t.device)


def _gather(t: torch.Tensor, group: DataGroup) -> torch.Tensor:
    w = _wire(t, group)
    parts = [torch.empty_like(w) for _ in range(group.world)]
    dist.all_gather(parts, w)
    return torch.cat(parts).to(t.device)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.group.rank * ctx.rows
        return _sum(grad, ctx.group)[lo:lo + ctx.rows], None


def all_reduce(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank (``x`` itself for a
    world of one). Differentiable: the backward sums the gradients of all
    ranks (see the module's docstring for the factor W this leaves)."""
    if group is None or group.world == 1:
        return x
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """The ranks' [N, ...] blocks concatenated in rank order, [W * N, ...],
    on every rank; every rank passes the same N. Differentiable: a rank's
    rows get the sum of all ranks' gradients of them."""
    if group is None or group.world == 1:
        return x
    return _AllGather.apply(x, group)


def broadcast_module(module: nn.Module, group: DataGroup) -> None:
    """Copy rank 0's parameters and buffers into every rank's ``module``."""
    if group.world == 1:
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            w = _wire(t, group)
            dist.broadcast(w, src=0)
            t.copy_(w)


def average_gradients(params: Iterable[torch.Tensor],
                      group: Optional[DataGroup]) -> None:
    """Replace each parameter's gradient by its mean over the ranks, in one
    all-reduce. This division by W takes out the factor W that the
    collectives' backward leaves (module docstring). Parameters without a
    gradient are skipped; they are the same on every rank, whose graphs
    are the same."""
    if group is None or group.world == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _sum(torch.cat([g.reshape(-1) for g in grads]), group)
    flat /= group.world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


# -- the JAX package's helpers ------------------------------------------------


def pad_to_multiple(batch: Any, multiple: int) -> Any:
    """Zero-pad the leading dim of an array or tensor, or of every one in a
    dict, list or tuple, to a multiple of ``multiple``."""
    if isinstance(batch, dict):
        return {k: pad_to_multiple(v, multiple) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(pad_to_multiple(v, multiple) for v in batch)
    rem = (-batch.shape[0]) % multiple
    if rem == 0:
        return batch
    if isinstance(batch, torch.Tensor):
        return torch.cat([batch, batch.new_zeros((rem,) + batch.shape[1:])])
    x = np.asarray(batch)
    return np.pad(x, [(0, rem)] + [(0, 0)] * (x.ndim - 1))


def shard_paths(paths: Sequence[str], process_id: int = 0,
                process_count: int = 1) -> list:
    """Disjoint round-robin slice of a work list for one of
    ``process_count`` processes; every process passes the same list."""
    if not 0 <= process_id < process_count:
        raise ValueError(f"process_id {process_id} out of range for "
                         f"{process_count}")
    return list(paths[process_id::process_count])


def host_allgather_f64(x) -> np.ndarray:
    """A small float64 host array of every process, stacked: [P, ...], bit
    for bit (an all-gather of float64 tensors, a copy in both backends).
    One process (no process group): ``x[None]``. With a group it is a
    collective: every process must call it."""
    x = np.ascontiguousarray(np.atleast_1d(x), np.float64)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x[None]
    where = (torch.device("cuda", torch.cuda.current_device())
             if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.from_numpy(x.copy()).to(where)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def sharded_ccc(preds: torch.Tensor, golds: torch.Tensor,
                group: Optional[DataGroup], mask=None,
                eps: float = 1e-8) -> torch.Tensor:
    """CCC [D] of the ranks' rows together, every rank passing its own
    [N, D] ``preds`` and ``golds``: the masked moment sums are all-reduced,
    with population (1/N) moments as ``data.eval.ccc_np``. ``mask`` [N] (1
    = a real row) must be given where the batch was padded
    (:func:`pad_to_multiple`), or the zero rows bias every moment. The
    count is summed in float32 whatever the dtype (a bf16 sum cannot hold
    257); the moments are summed in the inputs' dtype and the CCC is
    float32."""
    if mask is None:
        mask = torch.ones(preds.shape[0], device=preds.device)
    mask = torch.as_tensor(mask, device=preds.device)
    w1 = mask.to(preds.dtype)[:, None]
    n = mask.to(torch.float32).sum()[None]
    sums = torch.cat([n] + [s.to(torch.float32) for s in (
        (preds * w1).sum(0), (golds * w1).sum(0), (preds * preds * w1).sum(0),
        (golds * golds * w1).sum(0), (preds * golds * w1).sum(0))])
    with torch.no_grad():
        sums = all_reduce(sums, group)
    d = preds.shape[1]
    n, (sp, sy, spp, syy, spy) = sums[0], sums[1:].view(5, d)
    mp, my = sp / n, sy / n
    vp = spp / n - mp * mp
    vy = syy / n - my * my
    cov = spy / n - mp * my
    return 2.0 * cov / (vp + vy + (mp - my) ** 2 + eps)
