"""User-facing API: video or precomputed crops in, per-frame series out.

Counterpart of ``mimamo_tpu/api.py``. Three entry points:
``MimamoAPI.predict(video) -> [T, 2]`` (valence, arousal) with an
optional CSV, and ``predict_crops`` for precomputed aligned crops;
``VideoProcessor.process(video) -> <name>.npy`` uint8 crops (the
two-step workflow's first step); ``FeatureExtractor.extract(crops.npy)
-> <root>.feat.npy`` pool5 features. Decoding a video file needs OpenCV
(``io.decode``); ``predict_crops`` and ``runner.Mimamo.predict_video``
(frames already decoded) do not.

The video decodes in bounded windows on the host; each window's crops
are made on the device (``preprocess.crop_video_chunked``) and stay
there. Every class runs on the card unless ``device="cpu"`` is passed;
without a card and without a device it raises
(``runner.resolve_device``).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch

from . import weights
from .backbone import FERPLUS_CLASSES
from .config import MimamoConfig
from .data.crops import CropSource
from .io import decode
from .preprocess import crop_video_chunked, pad_short_clip
from .runner import Mimamo, resolve_device


def _iter_crop_chunks(video_path: str, crop_size: int, device,
                      boxes_path: Optional[str] = None,
                      max_frames: Optional[int] = None,
                      align: bool = False,
                      landmarks_path: Optional[str] = None,
                      decode_window: int = 256,
                      want_boxes: bool = False) -> Iterator:
    """Windowed decode -> track -> (align) -> device crop: only
    ``decode_window`` source frames are ever on the host at once.

    Yields (crops [n, S, S, 3] float32 on ``device``, boxes
    [n, 4] | None, landmarks [n, K, 2] | None) per window; every window
    has exactly ``decode_window`` frames except the last. The sidecar /
    tracker / alignment convention is ``decode.WindowParams``'s.
    ``want_boxes`` forces box tracking even when alignment comes from a
    landmark sidecar (the two-step workflow saves the boxes).
    """
    wp = decode.WindowParams(video_path, crop_size,
                             boxes_path=boxes_path,
                             landmarks_path=landmarks_path, align=align,
                             max_frames=max_frames,
                             want_boxes=want_boxes)
    for frames, start in decode.iter_video(video_path,
                                           window=decode_window,
                                           max_frames=max_frames):
        boxes, lm, params = wp.resolve(frames, start)
        yield (crop_video_chunked(frames, params, crop_size, device,
                                  align=align), boxes, lm)


def _windowed_crop_pipeline(video_path: str, crop_size: int, device,
                            boxes_path: Optional[str] = None,
                            max_frames: Optional[int] = None,
                            align: bool = False,
                            landmarks_path: Optional[str] = None,
                            decode_window: int = 256,
                            want_boxes: bool = False):
    """All windows of :func:`_iter_crop_chunks`, joined: (crops
    [T, S, S, 3] on the device, boxes [T, 4] | None, landmarks
    [T, K, 2] | None). Host memory stays bounded; the device crops
    accumulate."""
    crops_parts, boxes_parts, lm_parts = [], [], []
    for crops, boxes, lm in _iter_crop_chunks(
            video_path, crop_size, device, boxes_path=boxes_path,
            max_frames=max_frames, align=align,
            landmarks_path=landmarks_path, decode_window=decode_window,
            want_boxes=want_boxes):
        crops_parts.append(crops)
        if boxes is not None:
            boxes_parts.append(boxes)
        if lm is not None:
            lm_parts.append(lm)
    return (torch.cat(crops_parts),
            np.concatenate(boxes_parts) if boxes_parts else None,
            np.concatenate(lm_parts) if lm_parts else None)


def _model(config: Optional[MimamoConfig], state_dict, device,
           seed: int) -> Mimamo:
    """A model on ``device`` with ``state_dict``, or random weights from
    ``seed`` (``weights.init_variables``)."""
    config = config or MimamoConfig()
    model = Mimamo(config, device=device)
    model.load_state_dict(state_dict if state_dict is not None
                          else weights.init_variables(config, seed))
    return model


class VideoProcessor:
    """Decode + face boxes + crop or alignment on the device; writes
    [T, S, S, 3] uint8 crops as ``<name>.npy``, the boxes as
    ``<name>.boxes.npy`` and, when aligning, the landmarks used as
    ``<name>.landmarks.npy``."""

    def __init__(self, save_size: int = 112,
                 config: Optional[MimamoConfig] = None, device=None):
        # only the crop runs here, at ``save_size``: nothing of ``config``
        # is read (it stays for the JAX package's signature)
        del config
        self.save_size = save_size
        self.device = resolve_device(device)

    def process(self, video_path: str, out_dir: str,
                boxes_path: Optional[str] = None,
                max_frames: Optional[int] = None,
                align: bool = False,
                landmarks_path: Optional[str] = None,
                decode_window: int = 256) -> str:
        """``align=True`` writes similarity-aligned crops from landmarks
        (priority: explicit file -> ``<video>.landmarks.npy`` /
        ``<video>.openface.csv`` sidecar -> built-in tracker). Dense
        (68-point) landmark sets get the Procrustes fit, eye pairs the
        2-point fit. The video decodes in ``decode_window``-frame
        windows. Returns the path of the crops file."""
        align = align or bool(landmarks_path)
        crops, boxes, landmarks = _windowed_crop_pipeline(
            video_path, self.save_size, self.device, boxes_path=boxes_path,
            max_frames=max_frames, align=align,
            landmarks_path=landmarks_path, decode_window=decode_window,
            want_boxes=True)
        os.makedirs(out_dir, exist_ok=True)
        name = os.path.splitext(os.path.basename(video_path))[0]
        if landmarks is not None:
            np.save(os.path.join(out_dir, name + ".landmarks.npy"),
                    landmarks)
        out = os.path.join(out_dir, name + ".npy")
        # round, don't truncate: truncation would bias every
        # interpolated pixel ~0.5 LSB dark
        np.save(out, np.clip(np.rint(crops.cpu().numpy()), 0,
                             255).astype(np.uint8))
        np.save(os.path.join(out_dir, name + ".boxes.npy"), boxes)
        return out


class FeatureExtractor:
    """ResNet-50 FER+ pool5 features of precomputed crops: a crops
    ``.npy`` in, [T, 2048] float32 features out (``<root>.feat.npy``),
    in fixed batches through ``Mimamo.embed_frames``."""

    def __init__(self, config: Optional[MimamoConfig] = None,
                 state_dict=None, batch_size: int = 64, device=None,
                 seed: int = 0):
        self.model = _model(config, state_dict, device, seed)
        self.batch = batch_size

    @torch.no_grad()
    def extract(self, crops_npy: str, out_path: Optional[str] = None
                ) -> str:
        crops = np.load(crops_npy)          # uint8; cast on the device
        feats = []
        for i in range(0, len(crops), self.batch):
            piece = torch.from_numpy(crops[i:i + self.batch])
            n = piece.shape[0]
            piece = pad_short_clip(piece, self.batch).to(self.model.device)
            emb = self.model.embed_frames(piece.to(torch.float32)[None])
            feats.append(emb[0, :n].cpu().numpy())
        feats = np.concatenate(feats, axis=0)
        if out_path is None:
            # suffix the basename only
            root, ext = os.path.splitext(crops_npy)
            out_path = root + ".feat" + (ext or ".npy")
        np.save(out_path, feats)
        return out_path


class MimamoAPI:
    """End-to-end ``predict(video) -> per-frame (valence, arousal)``,
    optionally written as CSV.

    ``MimamoAPI(config=None, state_dict=None, device=None, seed=0)``:
    the weights are ``state_dict`` (the port's schema, e.g.
    ``weights.from_jax_variables``) or random ones from ``seed``.
    """

    def __init__(self, config: Optional[MimamoConfig] = None,
                 state_dict=None, device=None, seed: int = 0,
                 checkpoint_dir: Optional[str] = None):
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoint_dir: checkpoints are not ported yet "
                "(ROADMAP.md, Queue A11); pass state_dict")
        self.model = _model(config, state_dict, device, seed)
        self.last_peak_crop_frames: Optional[int] = None

    def predict(self, video_path: str, out_csv: Optional[str] = None,
                boxes_path: Optional[str] = None,
                max_frames: Optional[int] = None,
                align: bool = False,
                landmarks_path: Optional[str] = None,
                smooth: int = 1,
                decode_window: int = 256,
                emotions: bool = False,
                streaming_threshold: Optional[int] = 4096):
        """``align=True`` similarity-aligns crops from landmarks
        (explicit ``landmarks_path`` (.npy or OpenFace .csv) ->
        ``<video>.landmarks.npy`` / ``<video>.openface.csv`` sidecar ->
        built-in Haar eye tracker); 68-point sets use the Procrustes fit.
        ``smooth``: odd moving-average window over the output series
        (1 = off).

        The video decodes in ``decode_window``-frame host windows. Up to
        ``streaming_threshold`` crops, the series is the overlap average
        of sliding windows (``predict_from_crops``); once the crop count
        passes it, the rest of the video runs through ``predict_stream``
        chunk by chunk (equal to one long-clip forward, which differs
        slightly from the window average), so crop residency stays at
        O(threshold + decode_window) frames. ``None`` forces the first,
        ``0`` the second.

        ``emotions=True`` also runs the FER+ classifier head: returns
        ``(series, probs [T, 8])`` (``backbone.FERPLUS_CLASSES`` order)
        and adds per-class CSV columns. Needs OpenCV to decode.
        """
        if smooth > 1 and smooth % 2 == 0:
            # validate before decode and inference are spent
            raise ValueError(f"smooth window must be odd, got {smooth}")
        align = align or bool(landmarks_path)
        chunks = (c for c, _b, _l in _iter_crop_chunks(
            video_path, self.model.config.clip.crop_size, self.model.device,
            boxes_path=boxes_path,
            max_frames=max_frames, align=align,
            landmarks_path=landmarks_path, decode_window=decode_window))
        return self._predict_from_chunks(
            chunks, decode_window, f"no frames decoded from "
            f"{video_path}", smooth, emotions, out_csv,
            streaming_threshold)

    def predict_crops(self, crops_path: str,
                      out_csv: Optional[str] = None,
                      max_frames: Optional[int] = None,
                      smooth: int = 1,
                      emotions: bool = False,
                      streaming_threshold: Optional[int] = 4096,
                      chunk: int = 256):
        """Predict from precomputed aligned crops: a packed
        ``[T, S, S, 3]`` ``.npy`` (what ``VideoProcessor`` writes) or a
        per-frame image directory (OpenFace ``cropped_aligned`` style; an
        image directory needs OpenCV, a ``.npy`` does not). The source is
        read in ``chunk``-frame windows; smoothing, ``emotions`` and the
        ``streaming_threshold`` switch-over behave as in :meth:`predict`.
        """
        if smooth > 1 and smooth % 2 == 0:
            raise ValueError(f"smooth window must be odd, got {smooth}")
        src = CropSource(crops_path,
                         crop_size=self.model.config.clip.crop_size)
        t = len(src) if max_frames is None else min(len(src), max_frames)

        def chunks():
            for s in range(0, t, chunk):
                yield src.read(s, min(chunk, t - s))

        return self._predict_from_chunks(
            chunks(), chunk, f"no frames in {crops_path}", smooth,
            emotions, out_csv, streaming_threshold)

    def _predict_from_chunks(self, chunks, window: int, empty_msg: str,
                             smooth: int, emotions: bool,
                             out_csv: Optional[str],
                             streaming_threshold: Optional[int]):
        """The accumulate-or-stream consumer behind :meth:`predict` and
        :meth:`predict_crops`. Every chunk has exactly ``window`` frames
        except the last."""
        prefix, t_total, exhausted = [], 0, False
        while (streaming_threshold is None
               or t_total <= streaming_threshold):
            try:
                crops = next(chunks)
            except StopIteration:
                exhausted = True
                break
            prefix.append(crops)
            t_total += int(crops.shape[0])
        # the crop frames held at once: the whole prefix
        self.last_peak_crop_frames = t_total
        if exhausted:
            if not prefix:
                raise ValueError(empty_msg)
            # video chunks are device tensors, crop-file chunks host arrays
            crops = (np.concatenate(prefix)
                     if isinstance(prefix[0], np.ndarray)
                     else torch.cat(prefix))
            series = self.model.predict_from_crops(crops)
            probs = self._classify_crops(crops) if emotions else None
        else:
            series, probs = self._stream_predict(prefix, chunks, window,
                                                 emotions)
        series = smooth_series(series, smooth)
        if out_csv:
            _write_csv(out_csv, series, probs)
        return (series, probs) if emotions else series

    def _stream_predict(self, prefix_chunks, rest, window: int,
                        emotions: bool):
        """Feeds each crop chunk through ``predict_stream`` (GRU state
        and one frame of pair context carried across calls) and drops it.
        The tail chunk is padded to ``window`` by its last frame and its
        outputs trimmed (a causal scan: the kept outputs are unaffected),
        so every chunk has one shape."""
        def gen():
            while prefix_chunks:
                yield prefix_chunks.pop(0)   # drop refs as consumed
            yield from rest

        carries = None
        outs, probs = [], []
        for piece in gen():
            n = int(piece.shape[0])
            out, carries = self.model.predict_stream(
                pad_short_clip(piece, window)[None], carries)
            outs.append(out[0, :n].cpu().numpy())
            if emotions:
                probs.append(self._classify_crops(piece))
        return (np.concatenate(outs),
                np.concatenate(probs) if emotions else None)

    def _classify_crops(self, crops, batch: int = 64) -> np.ndarray:
        """[T, S, S, 3] crops -> [T, C] FER+ probabilities on the host, in
        fixed batches of ``batch`` (the tail padded and trimmed)."""
        probs = []
        for i in range(0, crops.shape[0], batch):
            piece = crops[i:i + batch]
            n = int(piece.shape[0])
            probs.append(self.model.classify_frames(
                pad_short_clip(piece, batch)[None])[0, :n].cpu().numpy())
        return np.concatenate(probs)


def smooth_series(series: np.ndarray, window: int) -> np.ndarray:
    """Edge-padded moving average over the time axis of [T, D]."""
    if window <= 1:
        return series
    if window % 2 == 0:
        raise ValueError(f"smooth window must be odd, got {window}")
    pad = window // 2
    padded = np.pad(series, ((pad, pad), (0, 0)), mode="edge")
    kernel = np.ones(window) / window
    return np.stack([np.convolve(padded[:, d], kernel, mode="valid")
                     for d in range(series.shape[1])], axis=-1)


def _write_csv(path: str, series: np.ndarray,
               emotion_probs: Optional[np.ndarray] = None) -> None:
    with open(path, "w") as f:
        header = "frame,valence,arousal"
        if emotion_probs is not None:
            header += "," + ",".join(
                FERPLUS_CLASSES[:emotion_probs.shape[1]])
        f.write(header + "\n")
        for i, (v, a) in enumerate(series):
            row = f"{i},{v:.6f},{a:.6f}"
            if emotion_probs is not None:
                row += "," + ",".join(f"{p:.4f}"
                                      for p in emotion_probs[i])
            f.write(row + "\n")
