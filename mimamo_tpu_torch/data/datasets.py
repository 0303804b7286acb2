"""Datasets: OMG-Emotion (utterance-level) and Aff-Wild2 (frame-level).

An own copy of ``mimamo_tpu/data/datasets.py`` (numpy only; the port
imports nothing of the JAX package): sliding-window clip sampling over
variable-length crop sequences, emitting dict batches ``{"clips",
"labels", "mask"}`` (plus ``"features"`` when every source has a cached
``.feat.npy``). With the same seed it gives the same batches as the JAX
copy. Crops are read through ``data.crops.CropSource``.

Layouts:
  OMG manifest CSV: columns ``video,utterance,valence,arousal`` where
    ``<root>/<video>/<utterance>.npy`` holds [T, S, S, 3] uint8 crops.
  Aff-Wild2: ``<root>/crops/<video>.npy`` [T, S, S, 3] uint8 +
    ``<root>/annotations/<video>.txt`` with a ``valence,arousal`` header
    and one "v,a" line per frame (-5 marks invalid frames, masked out).
  Cached appearance features: a ``.feat.npy`` [T, F] next to each crop
    source (``api.FeatureExtractor`` output naming). When every sequence
    has one, batches carry ``"features"`` and the train step skips the
    frozen backbone.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import ClipSpec
from .crops import CropSource, open_npy_mmap

Batch = Dict[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class ClipIndex:
    """One sample: a window of a source sequence."""
    source: int        # index into the dataset's sequence table
    start: int         # first frame of the window


def _resolve_crops(base_without_ext: str,
                   crop_size: Optional[int]) -> CropSource:
    """Prefer ``<base>.npy``; fall back to the ``<base>/`` image dir."""
    npy = base_without_ext + ".npy"
    if os.path.exists(npy):
        return CropSource(npy, crop_size)
    return CropSource(base_without_ext, crop_size)


def _resolve_features(base_without_ext: str,
                      n_frames: int) -> Optional[str]:
    """``<base>.feat.npy`` cached-feature sidecar, if present.

    Length is validated HERE (a stale/short sidecar must fail at
    dataset construction, not as a mid-epoch crash on some shuffled
    window — or worse, train silently on misaligned features)."""
    path = base_without_ext + ".feat.npy"
    if not os.path.exists(path):
        return None
    rows = int(np.load(path, mmap_mode="r").shape[0])
    if rows != n_frames:
        raise ValueError(
            f"{path}: {rows} feature rows but {n_frames} crop frames — "
            f"stale cache? re-run the feature extraction")
    return path


class _ClipDataset:
    """Shared sliding-window clip sampling over variable-length sequences."""

    def __init__(self, clip: ClipSpec):
        self.clip = clip
        self._index: List[ClipIndex] = []
        # per-source cached-feature file paths (all-or-nothing: batches
        # carry "features" only when every source has a sidecar)
        self._features: List[Optional[str]] = []

    def _build_index(self, lengths: Sequence[int]) -> None:
        c, s = self.clip.clip_len, self.clip.stride
        self._index = []
        for src, t in enumerate(lengths):
            if t < c:
                continue
            starts = list(range(0, t - c + 1, s))
            if starts[-1] != t - c:
                starts.append(t - c)
            self._index.extend(ClipIndex(src, st) for st in starts)

    def __len__(self) -> int:
        return len(self._index)

    # subclasses implement _load(ClipIndex) -> (clips, labels, mask)

    def batches(self, batch_size: int, shuffle: bool = False,
                seed: int = 0, drop_remainder: bool = False,
                process_id: int = 0, process_count: int = 1,
                stratify: bool = False,
                features: bool = True) -> Iterator[Batch]:
        """``process_id``/``process_count`` give each process a disjoint
        interleaved slice of the (identically shuffled) clip index, of
        the same length on every process: the per-process input of data
        parallelism, where each process draws ``batch_size`` clips and
        the global batch is their concatenation.

        ``stratify=True`` interleaves clips round-robin across source
        sequences (after shuffling), so consecutive clips — and hence
        batches — span as many distinct sources as possible. This
        matters for the utterance-level protocol (``loss_axis="batch"``,
        OMG): a batch whose clips are windows of ONE utterance has zero
        label variance, making the batch-CCC loss identically 1 and its
        gradient uninformative. ``train.fit`` enables it for that
        protocol.
        """
        order = np.arange(len(self._index))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        if process_count > 1:
            if not 0 <= process_id < process_count:
                raise ValueError(f"process_id {process_id} out of range "
                                 f"for {process_count}")
            order = order[process_id::process_count]
            # the same length on every process (drop <= process_count - 1
            # clips): a process with one clip more would run a step, and a
            # collective, that the others never join
            order = order[:len(self._index) // process_count]
        if stratify:
            # after the per-process split: a strided slice of a
            # round-robin sequence is periodic and would hand each process
            # a single source whenever gcd(sources, processes) > 1.
            # Each process stratifies its own (random) subset.
            by_src: Dict[int, list] = {}
            for j in order:
                by_src.setdefault(self._index[j].source, []).append(j)
            queues = list(by_src.values())   # shuffled within; insertion
            if shuffle:                      # order of sources shuffled
                np.random.default_rng(seed + 1).shuffle(queues)
            # Greedy most-remaining-first, never repeating the previous
            # source while an alternative exists: plain round-robin
            # clusters the majority source at the tail when per-source
            # counts are uneven (always the case after a per-process
            # split), re-creating single-source batches.
            interleaved: list = []
            prev = -1
            while queues:
                pick = max(
                    (qi for qi in range(len(queues))
                     if qi != prev or len(queues) == 1),
                    key=lambda qi: (len(queues[qi]), -qi))
                interleaved.append(queues[pick].pop(0))
                if queues[pick]:
                    prev = pick
                else:       # source exhausted: no repeat possible
                    queues.pop(pick)
                    prev = -1
            order = np.asarray(interleaved)
        # ``features=False`` skips cached .feat.npy attachment even when
        # every sequence has a sidecar — needed when the appearance
        # stream must run online (e.g. crop augmentation, fine-tuning).
        with_feats = (features and len(self._features) > 0
                      and all(f is not None for f in self._features))
        for i in range(0, len(order), batch_size):
            sel = order[i:i + batch_size]
            if drop_remainder and len(sel) < batch_size:
                return
            clips, labels, masks = zip(*(self._load(self._index[j])
                                         for j in sel))
            batch = {"clips": np.stack(clips).astype(np.float32),
                     "labels": np.stack(labels).astype(np.float32),
                     "mask": np.stack(masks).astype(np.float32)}
            if with_feats:
                batch["features"] = np.stack([
                    self._load_features(self._index[j]) for j in sel
                ]).astype(np.float32)
            yield batch

    def _load_features(self, ci: ClipIndex) -> np.ndarray:
        # through the bounded mmap LRU (open_npy_mmap)
        arr = open_npy_mmap(self._features[ci.source])
        out = np.asarray(arr[ci.start:ci.start + self.clip.clip_len])
        if len(out) != self.clip.clip_len:
            # same fail-fast as CropSource.read: a feature sidecar
            # rewritten shorter mid-run must not surface as an opaque
            # ragged-batch shape error downstream
            raise RuntimeError(
                f"{self._features[ci.source]}: short read "
                f"({len(out)} < {self.clip.clip_len} rows at "
                f"{ci.start}) — source changed after dataset "
                f"construction; rebuild the dataset")
        return out


class OMGEmotionDataset(_ClipDataset):
    """OMG-Emotion: utterance-level (v, a) regression.

    Each utterance has ONE label; every clip sampled from it carries that
    label broadcast over time; evaluation is utterance-level.
    """

    def __init__(self, root: str, manifest_csv: str, clip: ClipSpec):
        super().__init__(clip)
        import csv
        self.root = root
        self.rows: List[Tuple[str, str, float, float]] = []
        with open(manifest_csv, newline="") as f:
            for row in csv.DictReader(f):
                self.rows.append((row["video"], row["utterance"],
                                  float(row["valence"]),
                                  float(row["arousal"])))
        self._sources = []
        for video, utt, _v, _a in self.rows:
            base = os.path.join(root, video, utt)
            src = _resolve_crops(base, clip.crop_size)
            self._sources.append(src)
            self._features.append(_resolve_features(base, len(src)))
        self._build_index([len(s) for s in self._sources])

    def _load(self, ci: ClipIndex):
        t = self.clip.clip_len
        clips = self._sources[ci.source].read(ci.start, t)
        _video, _utt, v, a = self.rows[ci.source]
        labels = np.tile(np.asarray([v, a], np.float32), (t, 1))
        return clips, labels, np.ones(t, np.float32)

    def utterances(self) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """(row index, full crop sequence, (v, a) label) per utterance —
        the evaluation granularity (materialized; prefer
        :meth:`utterance_sources` for memory-bounded eval)."""
        for i, src, label in self.utterance_sources():
            yield i, src.read_all(), label

    def utterance_sources(self) -> Iterator[
            Tuple[int, CropSource, np.ndarray]]:
        """(row index, chunk-readable CropSource, label) per utterance.

        The eval harness reads sources one chunk per feed
        (``eval.stream_predict_many``), keeping host memory
        O(streams x chunk) instead of O(streams x T)."""
        for i, (video, utt, v, a) in enumerate(self.rows):
            yield i, self._sources[i], np.asarray([v, a], np.float32)


class AffWild2Dataset(_ClipDataset):
    """Aff-Wild2: frame-level (v, a) regression with invalid-frame masks."""

    INVALID = -5.0

    def __init__(self, root: str, videos: Optional[Sequence[str]] = None,
                 clip: Optional[ClipSpec] = None):
        super().__init__(clip or ClipSpec())
        self.root = root
        crops_dir = os.path.join(root, "crops")
        if not os.path.isdir(crops_dir):
            # Reference Aff-Wild2 layout uses cropped_aligned/<video>/
            alt = os.path.join(root, "cropped_aligned")
            if os.path.isdir(alt):
                crops_dir = alt
        if videos is None:
            entries = os.listdir(crops_dir)
            # sidecars live next to the crop arrays and are not videos:
            # .feat.npy appearance features (api.FeatureExtractor),
            # .boxes.npy / .landmarks.npy tracker outputs
            # (api.VideoProcessor)
            sidecars = (".feat.npy", ".boxes.npy", ".landmarks.npy")
            videos = sorted(
                {os.path.splitext(f)[0] for f in entries
                 if f.endswith(".npy")
                 and not f.endswith(sidecars)}
                | {f for f in entries
                   if os.path.isdir(os.path.join(crops_dir, f))})
        self.videos = list(videos)
        self._labels: List[np.ndarray] = []
        self._sources: List[CropSource] = []
        lengths = []
        for vid in self.videos:
            ann = os.path.join(root, "annotations", vid + ".txt")
            labels = _read_affwild2_annotations(ann)
            base = os.path.join(crops_dir, vid)
            src = _resolve_crops(base, self.clip.crop_size)
            if len(labels) != len(src):
                raise ValueError(
                    f"{vid}: {len(src)} crops but {len(labels)} "
                    f"annotation rows")
            self._sources.append(src)
            self._features.append(_resolve_features(base, len(src)))
            self._labels.append(labels)
            lengths.append(len(src))
        self._build_index(lengths)

    def _load(self, ci: ClipIndex):
        t = self.clip.clip_len
        clips = self._sources[ci.source].read(ci.start, t)
        labels = self._labels[ci.source][ci.start:ci.start + t]
        mask = (labels != self.INVALID).all(axis=-1).astype(np.float32)
        return clips, np.where(labels == self.INVALID, 0.0, labels), mask

    def full_videos(self) -> Iterator[
            Tuple[str, np.ndarray, np.ndarray, np.ndarray]]:
        """(name, crops, labels, mask) per video — frame-level eval
        (materialized; prefer :meth:`video_sources`)."""
        for vid, src, labels, mask in self.video_sources():
            yield vid, src.read_all(), labels, mask

    def video_sources(self) -> Iterator[
            Tuple[str, CropSource, np.ndarray, np.ndarray]]:
        """(name, chunk-readable CropSource, labels, mask) per video —
        memory-bounded counterpart of :meth:`full_videos`."""
        for i, vid in enumerate(self.videos):
            labels = self._labels[i]
            mask = (labels != self.INVALID).all(axis=-1).astype(np.float32)
            yield (vid, self._sources[i],
                   np.where(labels == self.INVALID, 0.0, labels), mask)


def _read_affwild2_annotations(path: str) -> np.ndarray:
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if lines:
        # Header detection by parse attempt: first-character heuristics
        # misclassify data rows like ".5,.3" or "+0.2,0.1" as headers.
        try:
            [float(x) for x in lines[0].split(",")]
        except ValueError:
            lines = lines[1:]  # "valence,arousal" header
    return np.asarray([[float(x) for x in ln.split(",")] for ln in lines],
                      np.float32)


# ---------------------------------------------------------------------------
# Synthetic fixture generation (tests / offline demos)
# ---------------------------------------------------------------------------

def make_synthetic_omg(root: str, n_videos: int = 2, n_utts: int = 2,
                       frames: int = 20, size: int = 32,
                       seed: int = 0) -> str:
    """Write a synthetic OMG-layout corpus; returns the manifest path."""
    rng = np.random.default_rng(seed)
    rows = ["video,utterance,valence,arousal"]
    for v in range(n_videos):
        vdir = os.path.join(root, f"video{v}")
        os.makedirs(vdir, exist_ok=True)
        for u in range(n_utts):
            arr = rng.uniform(0, 255, (frames, size, size, 3)).astype(
                np.uint8)
            np.save(os.path.join(vdir, f"utt{u}.npy"), arr)
            val, ar = np.tanh(rng.standard_normal(2)).astype(np.float32)
            rows.append(f"video{v},utt{u},{val:.4f},{ar:.4f}")
    manifest = os.path.join(root, "manifest.csv")
    with open(manifest, "w") as f:
        f.write("\n".join(rows) + "\n")
    return manifest


def make_synthetic_affwild2(root: str, n_videos: int = 2, frames: int = 24,
                            size: int = 32, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "crops"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for v in range(n_videos):
        arr = rng.uniform(0, 255, (frames, size, size, 3)).astype(np.uint8)
        np.save(os.path.join(root, "crops", f"vid{v}.npy"), arr)
        labels = np.tanh(rng.standard_normal((frames, 2))).astype(
            np.float32)
        labels[rng.uniform(size=frames) < 0.1] = AffWild2Dataset.INVALID
        lines = ["valence,arousal"] + [
            f"{a:.4f},{b:.4f}" for a, b in labels]
        with open(os.path.join(root, "annotations", f"vid{v}.txt"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
