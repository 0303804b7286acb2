"""Training: Adam on the CCC loss, the train step, and the training loop.

Counterpart of ``mimamo_tpu/train.py`` (``make_optimizer``,
``create_train_state``, ``make_train_step``, ``make_eval_step``,
``variables_from_state``) and of the body of ``cli.cmd_train``
(:func:`fit`), on one device or data-parallel over a
``parallel.DataGroup``.

The step follows the JAX package's: clips cast to float32 before any math;
per-clip flip and brightness deterministic in (seed, step); the micro
stream's phase stacks from the phase kernel (none for a macro-only
model); the appearance embeddings (none for a micro-only model) from
cached features, from the folded inference backbone under
``freeze_backbone`` (stem and layer2 kernels, no gradient: JAX's
``stop_gradient``; ``embed_frames``, so ``appearance_stride`` applies),
or, ignoring the stride, from the unfolded backbone in training mode
(``ResNet50.forward``, plain autograd, activations recomputed under
``remat_backbone``); the temporal model in training mode (batch
statistics, Flax's running-stat update); the CCC loss per clip over time
("time") or over the batch of clip means ("batch"), all-padding clips
weighted out. The kernels are inference-only: no gradient flows through
them, as none flows through the Pallas kernels in JAX.

Optimizer parity with optax: Adam/AdamW with optax's defaults (b1 0.9, b2
0.999, eps 1e-8 outside the square root, decoupled weight decay scaled by
the learning rate), and a ``LambdaLR`` that gives optax's schedule value at
the update count before each update (so the first warmup step has lr 0).
Under ``freeze_backbone`` the optimizer holds the temporal parameters only:
the backbone gets no update and no moments.

Fine-tuning changes backbone parameters in place; the step drops the
model's folded inference copy after each such update, so that later
inference (eval, ``predict_clips``) folds the new weights.

Data parallelism (a group of W > 1 ranks, one device each) follows the
JAX package's sharded step, where GSPMD reduces over the global batch:
each rank holds batch / W clips; rank 0's weights are broadcast when the
step is made; the BatchNorms take global statistics
(``batchnorm.synced``); the loss and the CCC metrics are those of the
global batch (:func:`_loss_and_metrics`); the gradients are averaged over
the ranks (``parallel.average_gradients``, which also takes out the factor
W that the collectives' backward leaves), so Adam makes the same update on
every rank; the augmentation draws for the global batch and each rank
takes its rows. A world of one runs the local path.

``debug_nans`` is the counterpart of the JAX package's ``jax_debug_nans``
(``cli train --debug-nans``): the step runs under autograd's anomaly mode
with a forward hook on every module of the model (:func:`nan_checks`), and
checks the loss and every gradient; the first module output, backward
function, loss or gradient that holds a NaN raises ``FloatingPointError``
naming it. Off, the step runs none of it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import batchnorm, checkpoints, parallel, preprocess, tracing, weights
from .config import MimamoConfig, TrainSpec
from .losses import ccc, ccc_loss
from .parallel import DataGroup
from .runner import Mimamo

Batch = Dict[str, object]       # numpy arrays or tensors


def _linear_schedule(init: float, end: float, steps: int
                     ) -> Callable[[int], float]:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine_decay(init: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with alpha 0 and exponent 1."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        return init * 0.5 * (1 + math.cos(math.pi * count / decay_steps))
    return schedule


def lr_schedule(spec: TrainSpec, total_steps: Optional[int] = None
                ) -> Callable[[int], float]:
    """The learning rate at update count ``c`` (0 for the first update), as
    ``mimamo_tpu.train.make_optimizer`` builds it: constant, constant after
    a linear warmup from 0, or linear warmup then cosine decay to 0 over
    ``total_steps`` (required for "cosine")."""
    lr = spec.learning_rate
    if spec.lr_schedule == "cosine":
        if not total_steps:
            raise ValueError("lr_schedule='cosine' needs total_steps")
        warmup = min(spec.warmup_steps, max(total_steps - 1, 1))
        head = _linear_schedule(0.0, lr, warmup)
        tail = _cosine_decay(lr, total_steps - warmup)
        return lambda c: head(c) if c < warmup else tail(c - warmup)
    if spec.lr_schedule == "constant":
        if spec.warmup_steps:
            return _linear_schedule(0.0, lr, spec.warmup_steps)
        return lambda c: lr
    raise ValueError(f"unknown lr_schedule {spec.lr_schedule!r}")


def make_optimizer(model: Mimamo, total_steps: Optional[int] = None
                   ) -> Tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.LambdaLR]:
    """Adam (AdamW with ``weight_decay``) over the trained parameters (the
    temporal model's under ``freeze_backbone``, all otherwise), and its
    per-update schedule (:func:`lr_schedule`). The base rate is 1, so the
    ``LambdaLR`` factor is the rate itself."""
    spec = model.config.train
    params = (model.temporal.parameters() if spec.freeze_backbone
              else model.parameters())
    if spec.weight_decay:
        opt = torch.optim.AdamW(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=spec.weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lr_schedule(spec, total_steps))


@dataclasses.dataclass
class TrainState:
    """The training state: update count, model (weights and BN running
    stats), optimizer (moments) and its schedule. Steps update it in
    place."""

    step: int
    model: Mimamo
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR

    def sync_schedule(self) -> None:
        """Set the learning rate to the schedule's value at ``step`` (after
        a restore, or after the schedule was replaced)."""
        self.scheduler.last_epoch = self.step
        for group, base, fn in zip(self.optimizer.param_groups,
                                   self.scheduler.base_lrs,
                                   self.scheduler.lr_lambdas):
            group["lr"] = base * fn(self.step)
        self.scheduler._last_lr = [g["lr"] for g in
                                   self.optimizer.param_groups]

    def set_schedule(self, total_steps: int) -> None:
        """Rebuild the schedule over ``total_steps`` (a resumed cosine run);
        the optimizer's moments are kept."""
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lr_schedule(self.model.config.train, total_steps))
        self.sync_schedule()


def create_train_state(model: Mimamo, total_steps: Optional[int] = None
                       ) -> TrainState:
    """Step 0, ``model``'s current weights, a fresh optimizer."""
    opt, sched = make_optimizer(model, total_steps)
    return TrainState(0, model, opt, sched)


def augment_clips(clips: torch.Tensor, spec: TrainSpec, step: int,
                  first: int = 0, total: Optional[int] = None
                  ) -> torch.Tensor:
    """Per-clip augmentation of [B, T, H, W, 3] float clips, the same for
    every frame of a clip (the micro stream needs temporally consistent
    crops): a horizontal flip with probability 1/2 under ``augment``, and
    a brightness scale uniform in [1 - j, 1 + j] clipped to 0..255 under
    ``brightness_jitter`` j. The draws come from a CPU ``torch.Generator``
    seeded from (``spec.seed``, ``step``), so a step's augmentation is
    reproducible on any device (the numbers differ from JAX's
    ``jax.random``). The draws are made for a global batch of ``total``
    clips (default: these) and ``clips`` are its rows ``first`` onward, so
    the ranks of a data-parallel step augment as one process would."""
    seed = int(np.random.SeedSequence([spec.seed, step]).generate_state(
        1, np.uint64)[0])
    g = torch.Generator().manual_seed(seed)
    b = clips.shape[0]
    total = b if total is None else total
    u_flip = torch.rand(total, generator=g)[first:first + b]
    u_bright = torch.rand(total, generator=g)[first:first + b]
    if spec.augment:
        flip = (u_flip < 0.5).to(clips.device)[:, None, None, None, None]
        clips = torch.where(flip, clips.flip(3), clips)
    j = spec.brightness_jitter
    if j > 0:
        scale = (1.0 - j + 2.0 * j * u_bright).to(clips.device, clips.dtype)
        clips = (clips * scale[:, None, None, None, None]).clamp(0.0, 255.0)
    return clips


@contextlib.contextmanager
def _training(*modules: nn.Module) -> Iterator[None]:
    for m in modules:
        m.train()
    try:
        yield
    finally:
        for m in modules:
            m.eval()


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device).to(torch.float32)


def _loss_and_metrics(out: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor, spec: TrainSpec,
                      group: Optional[DataGroup] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, [2] CCC of valence and arousal) of [B, T, 2] predictions over
    the global batch of ``group`` (these rows for a world of one);
    all-padding clips weigh 0. Frame-level ("time"): the clip-weighted sum
    of the per-clip losses and CCCs over the global clip weight, both
    all-reduced (the ranks may hold different numbers of padding clips).
    Batch-level ("batch"): the CCC of the gathered [B, 2] clip means."""
    clip_w = (mask.sum(dim=1) > 0).to(torch.float32)
    if spec.loss_axis == "batch":
        m = mask[..., None]
        p = parallel.all_gather((out * m).sum(dim=1) / (m.sum(dim=1) + 1e-8),
                                group)
        y = parallel.all_gather(labels[:, 0], group)
        w = parallel.all_gather(clip_w, group)
        return (ccc_loss(p, y, mask=w, mse_weight=spec.mse_weight),
                ccc(p, y, mask=w))
    per_clip = torch.stack([
        ccc_loss(out[i], labels[i], mask=mask[i],
                 mse_weight=spec.mse_weight) for i in range(out.shape[0])])
    per_ccc = torch.stack([ccc(out[i], labels[i], mask=mask[i])
                           for i in range(out.shape[0])])       # [B, 2]
    sums = parallel.all_reduce(torch.cat([
        (per_clip * clip_w).sum()[None],
        (per_ccc * clip_w[:, None]).sum(dim=0), clip_w.sum()[None]]), group)
    denom = sums[3] + 1e-8
    return sums[0] / denom, sums[1:3] / denom


def _has_nan(x) -> bool:
    """Does a module output (a tensor, or nested tuples of them, as a GRU
    returns) hold a NaN?"""
    if isinstance(x, torch.Tensor):
        return x.is_floating_point() and bool(torch.isnan(x).any())
    if isinstance(x, (tuple, list)):
        return any(_has_nan(v) for v in x)
    return False


@contextlib.contextmanager
def nan_checks(model: nn.Module) -> Iterator[None]:
    """Inside, autograd's anomaly mode is on and every module of ``model``
    raises ``FloatingPointError`` naming itself when its output holds a
    NaN."""
    def hook(name: str):
        def check(module, inputs, output):
            if _has_nan(output):
                raise FloatingPointError(
                    f"NaN in the output of module {name!r}")
        return check

    handles = [m.register_forward_hook(hook(name or type(m).__name__))
               for name, m in model.named_modules()]
    try:
        with torch.autograd.set_detect_anomaly(True):
            yield
    finally:
        for h in handles:
            h.remove()


def _backward_checked(loss: torch.Tensor, params) -> None:
    """``loss.backward()`` under :func:`nan_checks`: a NaN loss, a backward
    function that returns a NaN (anomaly mode) or a NaN gradient raises
    ``FloatingPointError``."""
    if torch.isnan(loss).any():
        raise FloatingPointError("NaN in the loss")
    try:
        loss.backward()
    except RuntimeError as e:
        if "nan values" not in str(e):
            raise
        raise FloatingPointError(str(e)) from e
    for name, p in params:
        if p.grad is not None and torch.isnan(p.grad).any():
            raise FloatingPointError(f"NaN in the gradient of {name!r}")


def make_train_step(model: Mimamo, group: Optional[DataGroup] = None,
                    debug_nans: bool = False) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: one update of
    ``state`` in place (returned for the JAX package's call shape).

    batch: ``clips`` [B, T, S, S, 3] 0..255 crops (uint8 or float),
    ``labels`` [B, T, 2], ``mask`` [B, T] and, optionally, ``features``
    [B, T, F] cached appearance embeddings (frozen backbone and no
    augmentation only). metrics: ``loss``, ``ccc_v``, ``ccc_a`` as
    0-d tensors on the model's device.

    ``group`` (W > 1 ranks): every rank calls the step with its own B
    clips of the global batch of W x B, in rank order; rank 0's weights
    are broadcast here, and the metrics are the global batch's on every
    rank (module docstring). ``debug_nans``: the NaN checks of the module
    docstring."""
    cfg = model.config
    spec = cfg.train
    freeze = spec.freeze_backbone
    augmenting = spec.augment or spec.brightness_jitter > 0
    trained = ((model.temporal,) if freeze
               else (model.backbone, model.temporal))
    world = 1 if group is None else group.world
    if world > 1:
        parallel.broadcast_module(model, group)

    def train_step(state: TrainState, batch: Batch):
        with tracing.span("train.step", model.device):
            return _step(state, batch)

    def _step(state: TrainState, batch: Batch):
        dev = model.device
        clips = _as_tensor(batch["clips"], dev)       # cast before any math
        if augmenting:
            if "features" in batch:
                raise ValueError(
                    "augmentation requires the online appearance stream: "
                    "cached features cannot reflect augmented crops (drop "
                    "batch['features'] or disable augment/"
                    "brightness_jitter)")
            b = clips.shape[0]
            clips = augment_clips(clips, spec, state.step,
                                  first=b * (group.rank if world > 1 else 0),
                                  total=b * world)
        if "features" in batch and not freeze and cfg.temporal.use_macro:
            raise ValueError(
                "cached features cannot be used with freeze_backbone=False "
                "(fine-tuning must run the real backbone)")
        phase_stacks = None
        if cfg.temporal.use_micro:
            with torch.no_grad(), tracing.span("micro", dev):
                phase_stacks = model._micro_motion(
                    preprocess.to_grayscale(clips))
        b, t = clips.shape[:2]
        # training mode and the synced BatchNorms until after the backward
        # pass: a rematerialized backbone runs its forward again inside it
        checks = (nan_checks(model) if debug_nans
                  else contextlib.nullcontext())
        with _training(*trained), batchnorm.synced(model, group), checks:
            if not cfg.temporal.use_macro:
                emb = None
            elif "features" in batch:
                emb = _as_tensor(batch["features"], dev)
            elif freeze:
                with torch.no_grad():
                    emb = model.embed_frames(clips)
            else:
                imgs = preprocess.for_backbone(
                    clips.reshape((b * t,) + clips.shape[2:]), cfg.backbone)
                emb, _ = model.backbone(imgs, remat=spec.remat_backbone)
                emb = emb.reshape(b, t, -1)
            with tracing.span("temporal", dev):
                out, _ = model.temporal(phase_stacks, emb, num_frames=t)
            with tracing.span("train.loss", dev):
                loss, ccc_vec = _loss_and_metrics(
                    out, _as_tensor(batch["labels"], dev),
                    _as_tensor(batch["mask"], dev), spec, group)
            with tracing.span("train.backward", dev):
                state.optimizer.zero_grad(set_to_none=True)
                if debug_nans:
                    _backward_checked(loss, model.named_parameters())
                else:
                    loss.backward()
        with tracing.span("train.optimizer", dev):
            parallel.average_gradients(
                (p for g in state.optimizer.param_groups for p in g["params"]),
                group)
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        if not freeze:
            model._folded = None         # backbone weights moved: refold
        return state, {"loss": loss.detach(), "ccc_v": ccc_vec[0].detach(),
                       "ccc_a": ccc_vec[1].detach()}

    return train_step


def make_eval_step(model: Mimamo) -> Callable:
    """``eval_step(state, batch) -> [B, T, 2]`` predictions of
    ``batch["clips"]`` with the state's weights."""

    def eval_step(state: TrainState, batch: Batch) -> torch.Tensor:
        return state.model.predict_clips(batch["clips"])

    return eval_step


def variables_from_state(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state's weights as the port's ``state_dict``."""
    return state.model.state_dict()


def fit(config: MimamoConfig, dataset, ckpt: Optional[str] = None,
        resume: bool = False, eval_dataset=None,
        epochs: Optional[int] = None, eval_every: int = 1,
        log: Optional[str] = None, device=None,
        on_epoch: Optional[Callable[[dict], None]] = None,
        group: Optional[DataGroup] = None, debug_nans: bool = False
        ) -> Tuple[TrainState, List[dict]]:
    """Train a model from ``weights.init_variables(config,
    config.train.seed)`` on ``dataset`` (``data.datasets``), on ``device``
    or data-parallel over ``group``; returns (final state, one metrics row
    per epoch).

    The body of ``mimamo_tpu.cli.cmd_train``: per epoch, steps over a
    shuffle seeded with ``seed + epoch`` (stratified across sources for
    ``loss_axis="batch"``), from cached ``.feat.npy`` features when the
    dataset has them and the appearance stream need not run online (no
    augmentation, frozen backbone). ``ckpt``: a checkpoint directory, with
    the backbone meta applied to ``config`` first and written beside every
    save; the state is saved after each epoch, the best eval's under
    ``<ckpt>_best``. ``resume`` restores the latest step from ``ckpt``; a
    cosine schedule keeps the horizon of the first run
    (``<ckpt>.plan.json``) and extends it only once the restored step has
    passed it. ``eval_dataset`` is scored every ``eval_every`` epochs
    (``evaluate_omg`` for an ``OMGEmotionDataset``, ``evaluate_affwild2``
    otherwise). The rows go to ``log`` (default ``<ckpt>.metrics.jsonl``)
    as JSON lines, and to ``on_epoch`` as each epoch ends.

    ``group`` (``parallel.DataGroup``; ``device`` is then its device):
    every rank calls ``fit`` alike. Each draws ``batch_size / W`` clips a
    step from its own slice of the clip index (``dataset.batches`` with
    ``process_id`` / ``process_count``), ``(len(dataset) // W) //
    (batch_size / W)`` steps an epoch on every rank; training batches are
    never padded (padding would taint the BatchNorm statistics), so
    ``batch_size`` must be divisible by W. Every rank resumes from
    ``ckpt`` and evaluates its slice of ``eval_dataset`` (the metrics are
    the whole set's on every rank); rank 0 writes the checkpoints, the plan
    and the log, and the others wait for it at a barrier.

    ``debug_nans``: every step runs the NaN checks (:func:`make_train_step`).
    """
    from .data import eval as eval_mod
    from .data.datasets import OMGEmotionDataset

    if group is None:
        group = parallel.initialize_distributed(device=device)
    world, rank = group.world, group.rank
    writer = rank == 0
    config = checkpoints.apply_backbone_meta(config, ckpt)
    spec = config.train
    epochs = spec.epochs if epochs is None else epochs
    if len(dataset) == 0:
        raise ValueError("dataset produced 0 clips (too short sequences?)")
    if spec.batch_size % world:
        raise ValueError(f"batch_size {spec.batch_size} must be divisible "
                         f"by the process count {world}")
    local_batch = spec.batch_size // world
    steps_per_epoch = (len(dataset) // world) // local_batch
    if steps_per_epoch == 0:
        raise ValueError(f"dataset has {len(dataset)} clips, fewer than one "
                         f"batch of {spec.batch_size}; shrink batch_size or "
                         f"add data")
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    model = Mimamo(config, device=group.device)
    model.load_state_dict(weights.init_variables(config, spec.seed))
    planned = max(epochs * steps_per_epoch, 1)
    state = create_train_state(model, total_steps=planned)
    augmenting = (spec.augment or spec.brightness_jitter > 0
                  or not spec.freeze_backbone)
    plan_path = ckpt.rstrip("/") + ".plan.json" if ckpt else None
    horizon = planned
    if resume and checkpoints.latest_step(ckpt) is not None:
        state = checkpoints.restore(ckpt, state)
        resumed = state.step
        if resumed and spec.lr_schedule == "cosine":
            horizon = resumed + planned
            if plan_path and os.path.exists(plan_path):
                with open(plan_path) as f:
                    saved = int(json.load(f)["total_steps"])
                horizon = saved if resumed < saved else resumed + planned
            state.set_schedule(horizon)
    group.barrier()              # every rank has read the plan
    if writer and plan_path and spec.lr_schedule == "cosine":
        with open(plan_path, "w") as f:
            json.dump({"total_steps": horizon}, f)
    step_fn = make_train_step(model, group, debug_nans)
    evaluate = (eval_mod.evaluate_omg
                if isinstance(eval_dataset, OMGEmotionDataset)
                else eval_mod.evaluate_affwild2)
    log_path = log or (ckpt.rstrip("/") + ".metrics.jsonl" if ckpt else None)
    best_ccc, history = -2.0, []

    def save(path: str) -> None:
        if writer:
            checkpoints.save(path, state)
            checkpoints.save_backbone_meta(path, config.backbone.mean_rgb,
                                           config.backbone.channel_order)
        group.barrier()

    for epoch in range(epochs):
        t0 = time.time()
        n, agg = 0, {}
        for batch in dataset.batches(local_batch, shuffle=True,
                                     seed=spec.seed + epoch,
                                     drop_remainder=True,
                                     process_id=rank, process_count=world,
                                     stratify=spec.loss_axis == "batch",
                                     features=not augmenting):
            if n >= steps_per_epoch:
                break
            state, metrics = step_fn(state, batch)
            for k, v in metrics.items():
                agg[k] = agg.get(k, 0.0) + v
            n += 1
        row = {"epoch": epoch, "steps": n, "sec": round(time.time() - t0, 2),
               **{k: round(float(v) / max(n, 1), 4) for k, v in agg.items()}}
        if eval_dataset is not None and (epoch + 1) % eval_every == 0:
            ev = evaluate(model, eval_dataset, chunk=config.clip.clip_len,
                          process_id=rank, process_count=world)
            row.update({"val_" + k: round(v, 4)
                        for k, v in ev.items() if k.endswith("_ccc")})
            if ckpt and ev["mean_ccc"] > best_ccc:
                best_ccc = ev["mean_ccc"]
                save(ckpt.rstrip("/") + "_best")
                row["best"] = True
        history.append(row)
        if on_epoch is not None:
            on_epoch(row)
        if writer and log_path:
            with open(log_path, "a") as f:
                f.write(json.dumps(row) + "\n")
        if ckpt:
            save(ckpt)
    return state, history
