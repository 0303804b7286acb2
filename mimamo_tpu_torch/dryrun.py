"""Data-parallel dry run: N ranks on this host through every sharded path.

    python -m mimamo_tpu_torch.dryrun --world N [--cpu]

Counterpart of ``__graft_entry__.dryrun_multichip`` at its small shapes.
Starts N rank processes (each on ``cuda:(rank % device_count)``, or on the
CPU with ``--cpu``; ranks that share a card talk over gloo, see
``parallel.initialize_distributed``) through :class:`Ranks`, the launcher
that the tests and ``chip_smoke.py`` also use. Each rank, with the same
weights:

  * runs one frame-level train step (``loss_axis="time"``), one
    batch-level step (``"batch"``, OMG) and one fine-tune step
    (``freeze_backbone=False`` with ``remat_backbone``: the backbone's
    BatchNorms synced, their collectives reissued by the recompute inside
    ``backward()``) from its process-local block of a global batch of 2N
    clips whose last clip is all padding, and the same step at a world of
    one over the whole global batch beside it;
  * ``predict_batch`` of 5 clips (padded to a multiple of N), also at
    ``appearance_stride`` 2 and for the micro-only ablation, against
    ``predict_clips``, and in bf16 against ``predict_clips`` of each rank's
    block;
  * feeds a ``StreamingSession`` of 2N slots split over the ranks (1 and
    2 GRU layers; 3 streams, 2 chunks) against an unsplit session;
  * ``sharded_ccc`` of a padded, masked ragged batch against the host CCC,
    and ``host_allgather_f64`` of every rank's float64 array, bit for bit.

Its row also holds the kernels' launches in the rank's frame-level step
(``launches_train``) and in its ``predict_batch`` per dtype
(``launches_predict_batch``), each counted from 0 just before the call (all
0 on the CPU, where the wrappers run their plain versions).

The launcher prints each rank's JSON line, then exits non-zero if a rank
failed, a check missed its bound, or the ranks' parameters differ after a
step. ``--weights DIR`` takes each variant's ``state_dict`` from
``DIR/<variant>.pt`` (else ``weights.init_variables`` from seed 0);
``--out DIR`` saves each rank's raw results to ``DIR/rank<r>.pt`` (the
tests hold them against the JAX package's sharded functions).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import parallel, train, weights
from .config import (BackboneSpec, ClipSpec, MimamoConfig, PhaseSpec,
                     PyramidSpec, TemporalSpec, TrainSpec)
from .data.eval import ccc_np
from .kernels import (bottleneck_epilogue, layer2_kernel, phase_kernel,
                      stem_kernel)
from .runner import Mimamo
from .streaming import StreamingSession

SEED = 0
S, T = 32, 4                   # crops, frames a clip (and a session chunk)
PREDICT_B = 5                  # clips of predict_batch (ragged for N > 1)
VARIANTS = {"flagship": {}, "gru2": {"gru_layers": 2},
            "stride2": {"appearance_stride": 2}, "micro": {"streams": "micro"},
            "bf16": {"dtype": "bfloat16"}}
# The train steps: (labels, TrainSpec fields); "finetune" trains the
# backbone too, recomputed in backward().
STEPS = {"time": ("labels", {}),
         "batch": ("omg_labels", {"loss_axis": "batch"}),
         "finetune": ("labels", {"freeze_backbone": False,
                                 "remat_backbone": True})}
# Bounds of the rank-local checks, against the same computation at a world
# of one (the sums run in another order): loss and CCCs; each temporal
# gradient, max |d| / its max |g|; outputs. The train-mode backbone at this
# size is ill-conditioned (a 1e-6 relative change of its input moves a
# layer's gradient by up to 25% of its max; ``tests/test_torch_train.py``),
# so the fine-tune step's gradient is held as a whole (cosine and norm
# ratio, as against JAX there) and its BN running stats by max-rel.
LOSS_ATOL = 1e-5
GRAD_REL_TOL = 1e-4
FINETUNE_GRAD_COS = 0.99
FINETUNE_GRAD_NORM_TOL = 1e-2
FINETUNE_BN_REL_TOL = 1e-3
OUT_ATOL = 1e-5
TIMEOUT_S = 600.0
# The kernels of the path, by the names of chip_smoke.py's records.
KERNELS = {"phase_diff_resize": phase_kernel.KERNEL,
           "stem_fused": stem_kernel.KERNEL,
           "layer2_fused": layer2_kernel.KERNEL,
           "stem_fused[f32]": stem_kernel.KERNEL_F32,
           "bottleneck_epilogue": bottleneck_epilogue.KERNEL,
           "se_squeeze": bottleneck_epilogue.SQUEEZE,
           "se_scale": bottleneck_epilogue.SCALE}


def config(variant: str = "flagship", step: str = "time") -> MimamoConfig:
    """The dry run's small config (crops of 32, backbone input 64, a 2 x 2
    pyramid, 16-wide temporal model, clips of 4) for ``variant``, trained
    as train step ``step`` of :data:`STEPS`."""
    kw = VARIANTS[variant]
    return MimamoConfig(
        pyramid=PyramidSpec(height=2, orientations=2, input_size=(S, S)),
        phase=PhaseSpec(phase_size=16),
        backbone=BackboneSpec(input_size=2 * S, appearance_stride=kw.get(
            "appearance_stride", 1), dtype=kw.get("dtype", "float32")),
        temporal=TemporalSpec(micro_cnn_features=(8,), micro_embed_dim=16,
                              macro_embed_dim=16, gru_hidden=16,
                              fusion_hidden=16,
                              gru_layers=kw.get("gru_layers", 1),
                              streams=kw.get("streams", "both")),
        clip=ClipSpec(clip_len=T, stride=T // 2, crop_size=S),
        train=TrainSpec(**STEPS[step][1]))


def inputs(world: int) -> Dict[str, np.ndarray]:
    """The seeded inputs of a world of ``world`` ranks: the global train
    batch (``clips``, ``labels``, ``omg_labels`` constant over each clip,
    ``mask``: one masked frame in clip 0, the last clip all padding), the
    ``predict`` clips, 3 session ``videos`` of 2 chunks, the ``ccc`` rows
    (N + 3 of them, padded to a multiple of N with ``ccc_mask``), and
    ``f64``: each rank's array for ``host_allgather_f64``."""
    rng = np.random.default_rng(SEED)
    b = 2 * world
    mask = np.ones((b, T), np.float32)
    mask[0, 1] = 0
    mask[-1] = 0
    n = world + 3
    preds = rng.standard_normal((n, 2)).astype(np.float32)
    golds = (0.6 * preds + 0.4 * rng.standard_normal((n, 2))).astype(
        np.float32)
    ccc_mask = parallel.pad_to_multiple(np.ones(n, np.float32), world)
    f64 = rng.standard_normal((world, 3, 2))
    f64[:, 0] = [-0.0, 5e-324]                  # signed zero, a subnormal
    f64[:, 1] = [np.inf, np.nan]
    return {
        "clips": rng.integers(0, 256, (b, T, S, S, 3)).astype(np.float32),
        "labels": np.tanh(rng.standard_normal((b, T, 2))).astype(np.float32),
        "omg_labels": np.repeat(np.tanh(rng.standard_normal(
            (b, 1, 2))).astype(np.float32), T, axis=1),
        "mask": mask,
        "predict": rng.integers(0, 256, (PREDICT_B, T, S, S, 3)).astype(
            np.float32),
        "videos": rng.integers(0, 256, (3, 2 * T, S, S, 3)).astype(
            np.float32),
        "ccc_preds": parallel.pad_to_multiple(preds, world),
        "ccc_golds": parallel.pad_to_multiple(golds, world),
        "ccc_mask": ccc_mask, "ccc_real": np.int64(n), "f64": f64}


def counted(fn: Callable):
    """(``fn()``, the launches of each of :data:`KERNELS` in it): the
    counts are set to 0 just before the call and read just after."""
    for kern in KERNELS.values():
        kern.launches = 0
    out = fn()
    return out, {name: kern.launches for name, kern in KERNELS.items()}


def _state(variant: str, weights_dir: Optional[str]) -> dict:
    path = weights_dir and os.path.join(weights_dir, f"{variant}.pt")
    if path and os.path.exists(path):
        return torch.load(path, map_location="cpu")
    return weights.init_variables(config(variant), SEED)


def _model(variant, state, device, step="time") -> Mimamo:
    model = Mimamo(config(variant, step), device=device)
    model.load_state_dict(state)
    return model


def _step(state, device, batch, group, step) -> dict:
    """One train step: its metrics, every parameter's gradient, the new
    weights, and the kernels' launches in it."""
    model = _model("flagship", state, device, step)
    st = train.create_train_state(model)
    fn = train.make_train_step(model, group)
    (_, metrics), launches = counted(lambda: fn(st, batch))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.detach().cpu() for n, p in
                      model.named_parameters() if p.grad is not None},
            "state": {k: v.detach().cpu() for k, v in
                      model.state_dict().items()},
            "launches": launches}


def _grad_rel(a: dict, b: dict) -> float:
    return max(((a[k] - g).abs().max() / g.abs().max().clamp_min(1e-30))
               .item() for k, g in b.items())


def grad_agreement(a: dict, b: dict) -> tuple:
    """(cosine, |a| / |b|) of the gradients ``a`` and ``b``, each taken as
    one vector over all its tensors."""
    dot = sum(float((a[k] * g).sum()) for k, g in b.items())
    na = sum(float((a[k] ** 2).sum()) for k in b) ** 0.5
    nb = sum(float((g ** 2).sum()) for g in b.values()) ** 0.5
    return dot / (na * nb), na / nb


def _session(model: Mimamo, videos: np.ndarray, capacity: int,
             group) -> Dict[int, List[np.ndarray]]:
    """Each slot's outputs, chunk by chunk, of 3 streams fed 2 chunks."""
    sess = StreamingSession(model, capacity=capacity, chunk=T, group=group)
    slots = [sess.add_stream() for _ in videos]
    outs: Dict[int, List[np.ndarray]] = {s: [] for s in slots}
    for start in (0, T):
        got = sess.feed({s: v[start:start + T] for s, v in zip(slots,
                                                             videos)})
        for s in slots:
            outs[s].append(got[s])
    return outs


def _sha(state: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].contiguous().numpy().tobytes())
    return h.hexdigest()


def run_rank(rank: int, world: int, coordinator: str, cpu: bool,
             weights_dir: Optional[str] = None,
             out_dir: Optional[str] = None) -> dict:
    """Everything one rank does (module docstring); returns its row."""
    t0 = time.perf_counter()
    group = parallel.initialize_distributed(
        coordinator, world, rank, device="cpu" if cpu else None)
    with group:
        dev = group.device
        data = inputs(world)
        b = data["clips"].shape[0] // world
        mine = slice(rank * b, (rank + 1) * b)
        flagship = _state("flagship", weights_dir)
        row = {"rank": rank, "world": world, "backend": group.backend,
               "device": str(dev)}
        raw, refs = {}, {}
        for step, (labels, _) in STEPS.items():
            batch = {"clips": data["clips"], "labels": data[labels],
                     "mask": data["mask"]}
            got = _step(flagship, dev, {k: v[mine] for k, v in batch.items()},
                        group, step)
            refs[step] = ref = _step(flagship, dev, batch, None, step)
            raw[step] = got
            row[f"{step}_loss"] = got["metrics"]["loss"]
            row[f"{step}_loss_world1_abs"] = max(
                abs(got["metrics"][k] - ref["metrics"][k])
                for k in got["metrics"])
            if step == "finetune":
                (row["finetune_grad_world1_cos"],
                 row["finetune_grad_world1_norm_ratio"]) = grad_agreement(
                    got["grads"], ref["grads"])
                row["finetune_bn_world1_rel"] = max(
                    ((got["state"][k] - v).abs().max() / v.abs().max())
                    .item() for k, v in ref["state"].items()
                    if "running" in k)
            else:
                row[f"{step}_grad_world1_rel"] = _grad_rel(got["grads"],
                                                            ref["grads"])
            row[f"{step}_params_sha256"] = _sha(got["state"])
        row["launches_train"] = raw["time"]["launches"]

        model = _model("flagship", flagship, dev)
        raw["predict_batch"], fp32_launches = counted(
            lambda: model.predict_batch(data["predict"], group))
        raw["predict_batch"] = raw["predict_batch"].cpu()
        row["predict_batch_abs"] = (raw["predict_batch"] - model.predict_clips(
            data["predict"]).cpu()).abs().max().item()
        for variant in ("stride2", "micro"):
            m = _model(variant, _state(variant, weights_dir), dev)
            got = m.predict_batch(data["predict"], group).cpu()
            want = m.predict_clips(data["predict"]).cpu()
            row[f"{variant}_predict_batch_abs"] = (got - want).abs().max(
                ).item()
        # bf16: each rank's block against predict_clips of that block (a
        # bf16 forward of another batch size may round otherwise)
        m = _model("bf16", flagship, dev)
        got, bf16_launches = counted(
            lambda: m.predict_batch(data["predict"], group))
        padded = parallel.pad_to_multiple(data["predict"], world)
        rows = padded.shape[0] // world
        want = torch.cat([m.predict_clips(padded[i:i + rows]).cpu()
                          for i in range(0, padded.shape[0], rows)])
        row["bf16_predict_batch_abs"] = (got.cpu() - want[:PREDICT_B]).abs(
            ).max().item()
        row["launches_predict_batch"] = {"float32": fp32_launches,
                                         "bfloat16": bf16_launches}
        del model, m

        raw["sessions"] = {}
        for variant in ("flagship", "gru2"):
            m = _model(variant, flagship if variant == "flagship"
                       else _state(variant, weights_dir), dev)
            got = _session(m, data["videos"], 2 * world, group)
            plain = _session(m, data["videos"], 2 * world, None)
            raw["sessions"][variant] = got
            row[f"session_{variant}_abs"] = max(
                float(np.abs(g - p).max()) for s in got
                for g, p in zip(got[s], plain[s]))

        rows_per = data["ccc_preds"].shape[0] // world
        blk = slice(rank * rows_per, (rank + 1) * rows_per)
        raw["sharded_ccc"] = parallel.sharded_ccc(
            torch.from_numpy(data["ccc_preds"][blk]).to(dev),
            torch.from_numpy(data["ccc_golds"][blk]).to(dev), group,
            mask=torch.from_numpy(data["ccc_mask"][blk])).cpu()
        n = int(data["ccc_real"])
        row["sharded_ccc_abs"] = float(np.abs(raw["sharded_ccc"].numpy(
            ) - ccc_np(data["ccc_preds"][:n], data["ccc_golds"][:n])).max())

        raw["allgather"] = parallel.host_allgather_f64(data["f64"][rank])
        row["allgather_bit_exact"] = bool(np.array_equal(
            raw["allgather"].view(np.uint64), data["f64"].view(np.uint64)))
        group.barrier()
    row["seconds"] = time.perf_counter() - t0
    row["ok"] = bool(
        max(row[f"{s}_loss_world1_abs"] for s in STEPS) <= LOSS_ATOL
        and max(row["time_grad_world1_rel"], row["batch_grad_world1_rel"])
        <= GRAD_REL_TOL
        and row["finetune_grad_world1_cos"] >= FINETUNE_GRAD_COS
        and abs(row["finetune_grad_world1_norm_ratio"] - 1)
        <= FINETUNE_GRAD_NORM_TOL
        and row["finetune_bn_world1_rel"] <= FINETUNE_BN_REL_TOL
        and max(row["predict_batch_abs"], row["stride2_predict_batch_abs"],
                row["micro_predict_batch_abs"], row["bf16_predict_batch_abs"],
                row["session_flagship_abs"], row["session_gru2_abs"],
                row["sharded_ccc_abs"]) <= OUT_ATOL
        and row["allgather_bit_exact"])
    if out_dir:
        torch.save(raw, os.path.join(out_dir, f"rank{rank}.pt"))
    return row


# -- the launcher -------------------------------------------------------------


@dataclasses.dataclass
class RankResult:
    """A rank process's exit code (None: stopped by the launcher), its
    stdout's JSON lines, and its stderr's tail."""

    rc: Optional[int]
    lines: List[dict]
    err: str


class Ranks:
    """``world`` processes of one data-parallel group, started at once:
    rank r runs ``python *argv_of(r, coordinator)`` from the repo's root.

    The launcher serves the group's store itself, on a port the system
    picks and keeps bound until :meth:`wait` returns, and the ranks join it
    as clients (``TORCHELASTIC_USE_AGENT_STORE=True``, see
    ``parallel.initialize_distributed``): no other run on the host can take
    the port between its choice and the group's forming. A rank's stdout
    and stderr go to files, so a rank never blocks on a full pipe."""

    def __init__(self, world: int, argv_of: Callable[[int, str], list],
                 env: Optional[dict] = None, timeout: float = TIMEOUT_S):
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ if env is None else env)
        env["PYTHONPATH"] = os.pathsep.join(
            [repo] + [p for p in [env.get("PYTHONPATH")] if p])
        env["TORCHELASTIC_USE_AGENT_STORE"] = "True"
        self._store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                                    wait_for_workers=False)
        self.coordinator = f"127.0.0.1:{self._store.port}"
        self._deadline = time.monotonic() + timeout
        self._files, self._procs = [], []
        for r in range(world):
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile(
                "w+")
            self._files.append((out, err))
            self._procs.append(subprocess.Popen(
                [sys.executable] + [str(a) for a in argv_of(
                    r, self.coordinator)],
                cwd=repo, env=env, stdout=out, stderr=err, text=True))

    def wait(self) -> List[RankResult]:
        """Wait for every rank and return each one's result. When one rank
        fails the others are stopped, not left waiting in a collective;
        every rank still running at the deadline is stopped."""
        procs = self._procs
        try:
            while any(p.poll() is None for p in procs):
                if (any(p.returncode not in (None, 0) for p in procs)
                        or time.monotonic() > self._deadline):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            results = []
            for p, (out, err) in zip(procs, self._files):
                out.seek(0)
                err.seek(0)
                lines = [json.loads(x) for x in out.read().splitlines()
                         if x.startswith("{")]
                results.append(RankResult(p.returncode if p.returncode >= 0
                                          else None, lines,
                                          err.read()[-3000:]))
                out.close()
                err.close()
            del self._store
        return results


def cli_ranks(argv: list, world: int, env: Optional[dict] = None,
              timeout: float = TIMEOUT_S) -> Ranks:
    """``python -m mimamo_tpu_torch.cli argv`` in ``world`` ranks of one
    group (``--data-parallel --coordinator ... --num-processes world
    --process-id r``)."""
    return Ranks(world, lambda r, c: [
        "-m", "mimamo_tpu_torch.cli"] + list(argv) + [
        "--data-parallel", "--coordinator", c, "--num-processes", world,
        "--process-id", r], env, timeout)


def start(world: int, cpu: bool = False, weights_dir: Optional[str] = None,
          out_dir: Optional[str] = None, timeout: float = TIMEOUT_S,
          env: Optional[dict] = None) -> Ranks:
    """The dry run's ``world`` ranks, started (:class:`Ranks`)."""
    extra = (["--cpu"] if cpu else []) + (
        ["--weights", weights_dir] if weights_dir else []) + (
        ["--out", out_dir] if out_dir else [])
    return Ranks(world, lambda r, c: [
        "-m", "mimamo_tpu_torch.dryrun", "--world", world, "--coordinator",
        c, "--rank", r] + extra, env, timeout)


def rows(results: List[RankResult]) -> List[Optional[dict]]:
    """Each rank's row, None for a rank that failed."""
    return [res.lines[-1] if res.rc == 0 and res.lines else None
            for res in results]


def same_params(rows_: List[Optional[dict]]) -> bool:
    """Whether every rank holds the same parameters after each step."""
    return all(len({row[f"{s}_params_sha256"] for row in rows_
                    if row is not None}) == 1 for s in STEPS)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mimamo_tpu_torch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, required=True,
                    help="number of ranks")
    ap.add_argument("--cpu", action="store_true",
                    help="CPU ranks (default: each on a card)")
    ap.add_argument("--weights", default=None,
                    help="directory of <variant>.pt state_dicts")
    ap.add_argument("--out", default=None,
                    help="directory for each rank's raw results")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:                    # one rank's process
        try:
            row = run_rank(args.rank, args.world, args.coordinator, args.cpu,
                           args.weights, args.out)
        except Exception:  # noqa: BLE001 — report, exit non-zero
            traceback.print_exc()
            return 1
        print(json.dumps(row), flush=True)
        return 0
    results = start(args.world, cpu=args.cpu, weights_dir=args.weights,
                    out_dir=args.out).wait()
    got = rows(results)
    for row in got:
        if row is not None:
            print(json.dumps(row), flush=True)
    failed = [r for r, row in enumerate(got) if row is None or not row["ok"]]
    for r in failed:
        print(f"rank {r} (exit {results[r].rc}):\n{results[r].err}",
              file=sys.stderr)
    if failed or not same_params(got):
        print(f"dryrun: ranks failed or missed a bound: {failed}; "
              f"parameters identical: {same_params(got)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
