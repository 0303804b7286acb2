"""Evaluation: CCC per protocol.

Counterpart of ``mimamo_tpu/data/eval.py``. OMG-Emotion scores
utterance-level CCC (the mean prediction of an utterance against its
label); Aff-Wild2 scores frame-level CCC over the valid frames of all
videos. Up to ``batch_streams`` sequences advance together through one
``streaming.StreamingSession``, one batched forward per chunk, so a
sequence of any length needs the memory of one chunk. The JAX package's
dispatch pipeline has no counterpart here.

Across processes (``process_id`` / ``process_count``, the ranks of a
``parallel.DataGroup``): each process streams a disjoint round-robin slice
of the sequences on its own device, and the exact moment sums of all
processes are gathered (``parallel.host_allgather_f64``), so every process
returns the same global metrics.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from .. import parallel
from ..runner import Mimamo
from ..streaming import StreamingSession
from .datasets import AffWild2Dataset, OMGEmotionDataset


def ccc_np(pred: np.ndarray, target: np.ndarray,
           eps: float = 1e-8) -> np.ndarray:
    """Population-moment CCC on the host, over axis 0, in float64."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    mp, mt = pred.mean(0), target.mean(0)
    vp, vt = pred.var(0), target.var(0)
    cov = ((pred - mp) * (target - mt)).mean(0)
    return 2.0 * cov / (vp + vt + (mp - mt) ** 2 + eps)


def ccc_moment_sums(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """[6, D] float64 sufficient statistics of a CCC: rows (n, Σp, Σy, Σp²,
    Σy², Σpy), n broadcast over D. Sums over disjoint row slices add up to
    the sums of their union (:func:`ccc_from_moment_sums`); zero rows give
    all zeros (default D = 2)."""
    p = np.asarray(pred, np.float64)
    y = np.asarray(target, np.float64)
    if len(p) == 0:
        return np.zeros((6, p.shape[-1] if p.ndim > 1 else 2))
    p, y = p.reshape(len(p), -1), y.reshape(len(y), -1)
    d = p.shape[1]
    return np.stack([np.full(d, float(len(p))), p.sum(0), y.sum(0),
                     (p * p).sum(0), (y * y).sum(0), (p * y).sum(0)])


def ccc_from_moment_sums(sums: np.ndarray,
                         eps: float = 1e-8) -> np.ndarray:
    """CCC from (summed) :func:`ccc_moment_sums` rows: population moments
    as E[x²] − E[x]², equal to :func:`ccc_np` to float64 rounding."""
    n, sp, sy, spp, syy, spy = np.asarray(sums, np.float64)
    n = np.maximum(n, 1.0)
    mp, my = sp / n, sy / n
    vp = spp / n - mp * mp
    vy = syy / n - my * my
    cov = spy / n - mp * my
    return 2.0 * cov / (vp + vy + (mp - my) ** 2 + eps)


def _read_piece(src, start: int, count: int) -> np.ndarray:
    """A chunk of an in-memory array or of a chunk-readable source."""
    if hasattr(src, "read"):
        return np.asarray(src.read(start, count))
    return np.asarray(src[start:start + count])


def stream_predict_many(model: Mimamo,
                        items: Iterable[Tuple[object, np.ndarray]],
                        chunk: int = 48, batch_streams: int = 8
                        ) -> Iterator[Tuple[object, np.ndarray]]:
    """(key, [T_i, 2] series) for each (key, crops) of ``items``, batched
    over streams, in completion order.

    ``crops`` is a [T_i, S, S, 3] array or a chunk-readable source
    (``__len__`` and ``read(start, count)``, e.g. ``data.crops.
    CropSource``), read one chunk per feed. Items are pulled lazily, at
    most ``batch_streams`` at a time, each into a slot of one
    ``StreamingSession``; every feed advances all active sequences by
    ``chunk`` frames in one forward. A sequence's last chunk is padded by
    repeating its last frame and its outputs are cut back, so every feed
    has one shape. A zero-frame source gives an empty series at once.
    """
    it = iter(items)
    session = StreamingSession(model, capacity=batch_streams, chunk=chunk)
    active: Dict[int, dict] = {}   # slot -> {key, src, len, off, parts}
    exhausted = False
    while True:
        while not exhausted and session.free_slots:
            try:
                key, crops = next(it)
            except StopIteration:
                exhausted = True
                break
            if len(crops) == 0:
                yield key, np.zeros((0, 2), np.float32)
                continue
            slot = session.add_stream()
            active[slot] = {"key": key, "src": crops, "len": len(crops),
                            "off": 0, "parts": []}
        if not active:
            return
        feeds = {}
        for slot, st in active.items():
            k = min(chunk, st["len"] - st["off"])
            piece = _read_piece(st["src"], st["off"], k)
            if k < chunk:
                piece = np.concatenate(
                    [piece, np.repeat(piece[-1:], chunk - k, axis=0)])
            feeds[slot] = piece.astype(np.float32)
        outs = session.feed(feeds)
        for slot in list(active):
            st = active[slot]
            k = min(chunk, st["len"] - st["off"])
            st["parts"].append(outs[slot][:k])
            st["off"] += k
            if st["off"] >= st["len"]:
                session.remove_stream(slot)
                del active[slot]
                yield st["key"], np.concatenate(st["parts"], axis=0)


def _process_slice(it, process_id: Optional[int],
                   process_count: Optional[int]):
    """The items of ``it`` whose index is ``process_id`` modulo
    ``process_count``: disjoint work, the same enumeration everywhere."""
    if not process_count or process_count == 1:
        yield from it
        return
    if process_id is None or not 0 <= process_id < process_count:
        # a missing id would select nothing and report a plausible CCC
        raise ValueError(
            f"process_count={process_count} requires process_id in "
            f"[0, {process_count}), got {process_id!r}")
    for j, item in enumerate(it):
        if j % process_count == process_id:
            yield item


def _reduce_ccc(preds: np.ndarray, golds: np.ndarray,
                process_count: Optional[int]):
    """(CCC [D], rows) of the local [N, D] rows, or of every process's
    rows by the gathered moment sums (a collective: every process must
    reach it). One process with no rows is a mis-pointed root; an empty
    slice is legitimate only with more than one process."""
    if not process_count or process_count == 1:
        if len(preds) == 0:
            raise ValueError("eval produced zero sequences: empty or "
                             "mis-pointed dataset root?")
        return ccc_np(preds, golds), len(preds)
    sums = parallel.host_allgather_f64(
        ccc_moment_sums(preds, golds)).sum(axis=0)
    return ccc_from_moment_sums(sums), int(round(sums[0, 0]))


def evaluate_omg(model: Mimamo, dataset: OMGEmotionDataset,
                 chunk: int = 48, batch_streams: int = 8,
                 process_id: Optional[int] = None,
                 process_count: Optional[int] = None) -> Dict[str, float]:
    """Utterance-level CCC of valence and arousal; with ``process_count``
    > 1, of every process's slice together (module docstring)."""
    labels = {}

    def items():
        for i, src, label in _process_slice(dataset.utterance_sources(),
                                            process_id, process_count):
            labels[i] = label
            yield i, src

    preds, golds = [], []
    for i, series in stream_predict_many(model, items(), chunk=chunk,
                                         batch_streams=batch_streams):
        preds.append(series.mean(axis=0))
        golds.append(labels[i])
    ccc, n = _reduce_ccc(
        np.stack(preds) if preds else np.zeros((0, 2)),
        np.stack(golds) if golds else np.zeros((0, 2)), process_count)
    return {"valence_ccc": float(ccc[0]), "arousal_ccc": float(ccc[1]),
            "mean_ccc": float(ccc.mean()), "n_utterances": int(n)}


def evaluate_affwild2(model: Mimamo, dataset: AffWild2Dataset,
                      chunk: int = 48, batch_streams: int = 8,
                      process_id: Optional[int] = None,
                      process_count: Optional[int] = None
                      ) -> Dict[str, float]:
    """Frame-level CCC over all valid frames of all videos; with
    ``process_count`` > 1, of every process's slice together."""
    meta = {}

    def items():
        for vid, src, labels, mask in _process_slice(
                dataset.video_sources(), process_id, process_count):
            meta[vid] = (labels, mask)
            yield vid, src

    preds, golds = [], []
    for vid, series in stream_predict_many(model, items(), chunk=chunk,
                                           batch_streams=batch_streams):
        labels, mask = meta[vid]
        valid = mask > 0
        preds.append(series[valid])
        golds.append(labels[valid])
    ccc, n = _reduce_ccc(
        np.concatenate(preds) if preds else np.zeros((0, 2)),
        np.concatenate(golds) if golds else np.zeros((0, 2)),
        process_count)
    return {"valence_ccc": float(ccc[0]), "arousal_ccc": float(ccc[1]),
            "mean_ccc": float(ccc.mean()), "n_frames": int(n)}
