"""Evaluation: CCC per protocol.

Counterpart of ``mimamo_tpu/data/eval.py`` on one process. OMG-Emotion
scores utterance-level CCC (the mean prediction of an utterance against
its label); Aff-Wild2 scores frame-level CCC over the valid frames of all
videos. Each sequence runs through ``Mimamo.predict_stream`` chunk by
chunk, so a sequence of any length needs the memory of one chunk; the
sequences go one after another (the JAX package's batch of streams and
its dispatch pipeline have no counterpart here). The moment sums are the
exact reduction a multi-process eval would add up.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Tuple

import numpy as np

from ..runner import Mimamo
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
                        chunk: int = 48
                        ) -> Iterator[Tuple[object, np.ndarray]]:
    """(key, [T_i, 2] series) for each (key, crops) of ``items``, in order.

    ``crops`` is a [T_i, S, S, 3] array or a chunk-readable source
    (``__len__`` and ``read(start, count)``, e.g. ``data.crops.
    CropSource``), read one chunk at a time. Each sequence streams through
    ``model.predict_stream`` in chunks of ``chunk`` frames; the last chunk
    is padded by repeating its last frame and its outputs are cut back, so
    every call has one shape. A zero-frame source gives an empty series.
    """
    for key, crops in items:
        t = len(crops)
        outs, carries = [], None
        for start in range(0, t, chunk):
            piece = _read_piece(crops, start, chunk)
            n = len(piece)
            if n < chunk:
                piece = np.concatenate(
                    [piece, np.repeat(piece[-1:], chunk - n, axis=0)])
            out, carries = model.predict_stream(piece[None], carries)
            outs.append(out[0, :n].cpu().numpy())
        yield key, (np.concatenate(outs) if outs
                    else np.zeros((0, 2), np.float32))


def _reduce_ccc(preds: np.ndarray, golds: np.ndarray):
    if len(preds) == 0:
        raise ValueError("eval produced zero sequences: empty or "
                         "mis-pointed dataset root?")
    return ccc_np(preds, golds), len(preds)


def evaluate_omg(model: Mimamo, dataset: OMGEmotionDataset,
                 chunk: int = 48) -> Dict[str, float]:
    """Utterance-level CCC of valence and arousal."""
    labels = {}

    def items():
        for i, src, label in dataset.utterance_sources():
            labels[i] = label
            yield i, src

    preds, golds = [], []
    for i, series in stream_predict_many(model, items(), chunk=chunk):
        preds.append(series.mean(axis=0))
        golds.append(labels[i])
    ccc, n = _reduce_ccc(
        np.stack(preds) if preds else np.zeros((0, 2)),
        np.stack(golds) if golds else np.zeros((0, 2)))
    return {"valence_ccc": float(ccc[0]), "arousal_ccc": float(ccc[1]),
            "mean_ccc": float(ccc.mean()), "n_utterances": int(n)}


def evaluate_affwild2(model: Mimamo, dataset: AffWild2Dataset,
                      chunk: int = 48) -> Dict[str, float]:
    """Frame-level CCC over all valid frames of all videos."""
    meta = {}

    def items():
        for vid, src, labels, mask in dataset.video_sources():
            meta[vid] = (labels, mask)
            yield vid, src

    preds, golds = [], []
    for vid, series in stream_predict_many(model, items(), chunk=chunk):
        labels, mask = meta[vid]
        valid = mask > 0
        preds.append(series[valid])
        golds.append(labels[valid])
    ccc, n = _reduce_ccc(
        np.concatenate(preds) if preds else np.zeros((0, 2)),
        np.concatenate(golds) if golds else np.zeros((0, 2)))
    return {"valence_ccc": float(ccc[0]), "arousal_ccc": float(ccc[1]),
            "mean_ccc": float(ccc.mean()), "n_frames": int(n)}
