"""OpenFace ``FeatureExtraction`` CSV ingestion (68-point landmarks).

An own copy of ``mimamo_tpu/io/openface.py`` (numpy only; the port
imports nothing of the JAX package). OpenFace writes a per-video CSV with
per-frame tracking results -- ``frame, face_id, timestamp, confidence,
success`` plus 2-D landmark columns ``x_0..x_67, y_0..y_67`` (iBUG
68-point scheme); this module reads it for the port's on-device
alignment (``preprocess.similarity_from_landmarks``).

Conventions handled: header tokens may carry leading spaces (OpenFace
writes ``, face_id, timestamp, ...``); frames are 1-based; multiple faces
per frame appear as repeated frame indices with distinct ``face_id`` (we
keep the successful row with the highest confidence); failed frames
(``success=0``) and missing frame indices inherit the last good landmarks
(hold-last no-face policy).
"""

from __future__ import annotations

import csv
from typing import Optional, Tuple

import numpy as np

# iBUG 68-point indices: image-left eye (subject's right) 36..41,
# image-right eye 42..47.
LEFT_EYE = slice(36, 42)
RIGHT_EYE = slice(42, 48)


def read_landmarks_csv(path: str, num_frames: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OpenFace FeatureExtraction CSV.

    Args:
      path: the per-video CSV written by OpenFace.
      num_frames: expected video length; landmarks are hold-last padded /
        truncated to it. Default: the maximum frame index in the file.

    Returns:
      (landmarks [T, 68, 2] float32 in (y, x) source pixels,
       success [T] bool — False where the row was missing or success=0).
    """
    with open(path, newline="") as f:
        reader = csv.reader(f)
        try:
            header = [h.strip() for h in next(reader)]
        except StopIteration:
            raise ValueError(f"{path}: empty file") from None
        col = {name: i for i, name in enumerate(header)}
        if "frame" not in col:
            raise ValueError(
                f"{path}: no 'frame' column — not an OpenFace CSV "
                f"(header starts {header[:5]})")
        try:
            x_cols = [col[f"x_{i}"] for i in range(68)]
            y_cols = [col[f"y_{i}"] for i in range(68)]
        except KeyError as e:
            raise ValueError(
                f"{path}: missing 2-D landmark column {e} — export with "
                f"OpenFace's -2Dfp option") from None
        conf_col = col.get("confidence")
        succ_col = col.get("success")

        # frame -> (confidence, landmarks); best face per frame
        best = {}
        for lineno, row in enumerate(reader, start=2):
            if not row:
                continue
            try:
                idx = int(float(row[col["frame"]]))
                ok = (succ_col is None
                      or float(row[succ_col]) >= 0.5)
                if not ok:
                    # mark the frame as seen-failed
                    best.setdefault(idx, None)
                    continue
                conf = (float(row[conf_col]) if conf_col is not None
                        else 1.0)
                prev = best.get(idx)
                if prev is not None and prev[0] >= conf:
                    continue
                xs = np.asarray([float(row[i]) for i in x_cols],
                                np.float32)
                ys = np.asarray([float(row[i]) for i in y_cols],
                                np.float32)
            except (ValueError, IndexError) as e:
                raise ValueError(
                    f"{path}:{lineno}: malformed row ({len(row)} fields "
                    f"vs {len(header)} header columns): {e}") from None
            best[idx] = (conf, np.stack([ys, xs], axis=-1))

    if not best:
        raise ValueError(f"{path}: no data rows")
    max_frame = max(best)
    one_based = 0 not in best  # OpenFace frames start at 1
    t = num_frames if num_frames is not None else max_frame + (
        0 if one_based else 1)

    landmarks = np.zeros((t, 68, 2), np.float32)
    success = np.zeros((t,), bool)
    last: Optional[np.ndarray] = None
    # forward fill; frames before the first success inherit it (backfill)
    for i in range(t):
        entry = best.get(i + 1 if one_based else i)
        if entry is not None:
            last = entry[1]
            success[i] = True
        if last is not None:
            landmarks[i] = last
    if last is None:
        raise ValueError(f"{path}: every row has success=0")
    first = int(np.argmax(success))
    landmarks[:first] = landmarks[first]
    return landmarks, success


def eyes_from_landmarks68(landmarks: np.ndarray) -> np.ndarray:
    """[T, 68, 2] -> [T, 2, 2] ((left_y,left_x),(right_y,right_x)) eye
    centers (mean of the 6 eye contour points each), the format
    ``preprocess.similarity_from_eyes`` takes."""
    lm = np.asarray(landmarks, np.float32)
    return np.stack([lm[:, LEFT_EYE].mean(axis=1),
                     lm[:, RIGHT_EYE].mean(axis=1)], axis=1)


def boxes_from_landmarks68(landmarks: np.ndarray,
                           img_h: int, img_w: int,
                           margin: float = 0.25) -> np.ndarray:
    """[T, 68, 2] -> [T, 4] (y0, x0, h, w) squared face boxes.

    The landmark hull expanded by ``margin`` and squared — the same box
    convention ``io.decode.face_boxes`` produces, so OpenFace CSVs can
    drive the plain box-crop path too.
    """
    lm = np.asarray(landmarks, np.float64)
    lo = lm.min(axis=1)                       # [T, 2]
    hi = lm.max(axis=1)
    center = (lo + hi) / 2
    side = (hi - lo).max(axis=1) * (1.0 + margin)
    side = np.minimum(side, min(img_h, img_w))
    y0 = np.clip(center[:, 0] - side / 2, 0, img_h - 1)
    x0 = np.clip(center[:, 1] - side / 2, 0, img_w - 1)
    side = np.minimum(side, np.minimum(img_h - y0, img_w - x0))
    return np.stack([y0, x0, side, side], axis=-1).astype(np.float32)
