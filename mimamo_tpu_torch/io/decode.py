"""Host-side video decode and face-box / landmark provisioning.

An own copy of ``mimamo_tpu/io/decode.py`` (numpy and OpenCV; the port
imports nothing of the JAX package). The host decodes frames and supplies
face boxes or landmarks; crop, alignment and everything after run on the
device (``preprocess.crop_and_resize`` / ``warp_similarity``).

Box sources, in priority order:
  1. precomputed boxes file (``<video>.boxes.npy`` [T, 4] or explicit path)
  2. Haar cascade face detector (OpenCV's, or the native library's where
     the OpenCV wheel lacks the API) with Lucas-Kanade tracking between
     detections
  3. centered square fallback covering the frame

OpenCV is imported softly: without it, decoding, the trackers and image
directories raise, while sidecar files and the array entry points work.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

try:  # cv2 is present in this image; keep the import soft for portability.
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def decode_video(path: str, max_frames: Optional[int] = None
                 ) -> np.ndarray:
    """Decode a video file to [T, H, W, 3] RGB uint8 frames."""
    if cv2 is None:
        raise RuntimeError("OpenCV is required for video decode")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    frames = []
    while max_frames is None or len(frames) < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


def iter_video(path: str, window: int = 256,
               max_frames: Optional[int] = None
               ) -> Iterator[Tuple[np.ndarray, int]]:
    """Decode a video in bounded windows: ([n<=window, H, W, 3] RGB
    uint8, start_frame_index) per chunk.

    The memory-bounded counterpart of :func:`decode_video`: a long
    1080p video is GBs fully decoded, but
    only ``window`` source frames are ever resident here. Raises
    ValueError (on exhaustion) if no frame decodes.
    """
    if cv2 is None:
        raise RuntimeError("OpenCV is required for video decode")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    buf, start, total = [], 0, 0
    try:
        while max_frames is None or total < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            buf.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            total += 1
            if len(buf) == window:
                yield np.stack(buf), start
                start, buf = total, []
        if buf:
            yield np.stack(buf), start
    finally:
        cap.release()
    if total == 0:
        raise ValueError(f"no frames decoded from {path}")


class LandmarkSource:
    """Chunk-readable per-frame landmarks for the streaming-decode path.

    Matches :func:`load_landmarks` semantics without knowing the video
    length up front: ``.npy`` sidecars must cover every decoded frame
    (reading past the end raises, as the full-array path errors on a
    short sidecar), while OpenFace ``.csv`` sidecars hold-last pad past
    their final row (``read_landmarks_csv(num_frames=...)`` behavior).
    """

    def __init__(self, path: str):
        self.path = path
        if path.endswith(".csv"):
            from .openface import read_landmarks_csv
            self.lm, _success = read_landmarks_csv(path)
            self.pad = True
        else:
            lm = np.load(path).astype(np.float32)
            if lm.ndim != 3 or lm.shape[-1] != 2:
                raise ValueError(
                    f"{path}: expected [T, K, 2] landmarks (K=2 eye "
                    f"points or a dense set), got {lm.shape}")
            self.lm = lm
            self.pad = False

    def read(self, start: int, count: int) -> np.ndarray:
        end = start + count
        if end <= len(self.lm):
            return self.lm[start:end]
        if not self.pad:
            raise ValueError(
                f"{self.path}: {len(self.lm)} landmark rows but the "
                f"video has at least {end} frames — expected "
                f"[>= T, K, 2] per frame")
        return self.lm[hold_pad_indices(start, count, len(self.lm))]


def hold_pad_indices(start: int, count: int, length: int) -> np.ndarray:
    """Row indices [start, start+count) clamped to ``length - 1``.

    THE hold-last padding convention for sidecars shorter than the
    decoded video (a video that outruns its OpenFace CSV repeats the
    last row). One definition shared by :meth:`LandmarkSource.read`
    and :meth:`WindowParams.resolve` (the single param resolver of the
    api's windowed decode) — their windowed-vs-array parity is tested,
    so the convention must not drift between hand-maintained copies.
    """
    return np.minimum(np.arange(start, start + count), length - 1)


def resolve_landmarks_path(video_path: str,
                           landmarks_path: Optional[str] = None
                           ) -> Optional[str]:
    """Resolve the landmark sidecar for a video: explicit path (must
    exist) -> ``<video>.landmarks.npy`` -> ``<video>.openface.csv`` ->
    None. The single definition of the probing precedence used by both
    :func:`load_landmarks` (array-at-once) and :func:`landmark_source`
    (streaming) — divergent copies would silently resolve different
    files for the same video."""
    if landmarks_path is None:
        for candidate in (video_path + ".landmarks.npy",
                          video_path + ".openface.csv"):
            if os.path.exists(candidate):
                return candidate
        return None
    if not os.path.exists(landmarks_path):
        raise FileNotFoundError(
            f"landmarks file not found: {landmarks_path}")
    return landmarks_path


def has_landmark_sidecar(video_path: str) -> bool:
    """Existence-only probe for landmark sidecars.

    Routing decisions (native-vs-Python corpus loader) must not parse
    the sidecar: a corrupt file would abort the whole corpus run at
    routing time instead of failing just its own video. Parsing
    happens per-video inside the stream,
    where errors are recorded and skipped.
    """
    return any(os.path.exists(video_path + ext)
               for ext in (".landmarks.npy", ".openface.csv"))


def landmark_source(video_path: str,
                    landmarks_path: Optional[str] = None
                    ) -> Optional[LandmarkSource]:
    """Sidecar probing for :class:`LandmarkSource` (same priority as
    :func:`load_landmarks`: explicit path -> ``.landmarks.npy`` ->
    ``.openface.csv`` -> None)."""
    landmarks_path = resolve_landmarks_path(video_path, landmarks_path)
    if landmarks_path is None:
        return None
    return LandmarkSource(landmarks_path)


def write_video(path: str, frames_rgb: np.ndarray, fps: float = 25.0
                ) -> None:
    """Write [T, H, W, 3] RGB uint8 frames (tests/demos)."""
    if cv2 is None:
        raise RuntimeError("OpenCV is required for video write")
    t, h, w, _ = frames_rgb.shape
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    out = cv2.VideoWriter(path, fourcc, fps, (w, h))
    for f in frames_rgb:
        out.write(cv2.cvtColor(f.astype(np.uint8), cv2.COLOR_RGB2BGR))
    out.release()


IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def frame_sort_key(name: str):
    """Numeric-aware filename sort key: digit runs compare as integers,
    so ``frame_2.jpg`` < ``frame_10.jpg`` even without zero padding.
    Plain lexicographic sorting silently misorders such directories —
    temporally wrong phase-diff pairs and misaligned per-frame labels
    with NO error raised. Zero-padded layouts
    (the OpenFace convention) sort identically under both keys."""
    import re
    return tuple(int(p) if p.isdigit() else p
                 for p in re.split(r"(\d+)", name.lower()))


def list_frame_images(path: str) -> list:
    """Frame-image filenames of a crop directory, in frame order."""
    names = sorted((f for f in os.listdir(path)
                    if f.lower().endswith(IMAGE_EXTS)),
                   key=frame_sort_key)
    if not names:
        raise ValueError(f"no images found in {path}")
    return names


def read_frame_images(path: str, names, size: Optional[int] = None
                      ) -> np.ndarray:
    """Read the named frames of an image dir -> [N, H, W, 3] RGB uint8,
    optionally resized to ``size``. The single reader shared by
    :func:`load_image_dir` and ``data.datasets.CropSource`` (the frame
    -dir decode convention must not fork)."""
    if cv2 is None:
        raise RuntimeError("OpenCV is required to read image dirs")
    frames = []
    for name in names:
        img = cv2.imread(os.path.join(path, name))
        if img is None:
            raise ValueError(f"unreadable image: {name} in {path}")
        if size is not None and img.shape[:2] != (size, size):
            img = cv2.resize(img, (size, size),
                             interpolation=cv2.INTER_LINEAR)
        frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    shapes = {f.shape for f in frames}
    if len(shapes) > 1:
        raise ValueError(
            f"{path}: inconsistent frame shapes {sorted(shapes)}; pass "
            f"size= to normalize")
    return np.stack(frames)


def load_image_dir(path: str, size: Optional[int] = None) -> np.ndarray:
    """Directory of per-frame images -> [T, H, W, 3] RGB uint8.

    OpenFace writes one aligned-crop image per frame into a directory
    (``cropped_aligned``); this reads that layout (sorted filenames =
    frame order), optionally resizing to ``size``.
    """
    return read_frame_images(path, list_frame_images(path), size)


# Haar cascade XMLs: OpenCV python wheels ship them under cv2.data, but
# the OpenCV 5 wheel in some environments ships the dir empty AND
# removed the legacy CascadeClassifier API entirely; the
# system OpenCV 4 install still carries both the files and (via our C++
# loader) the API, so detection works wherever either is present.
_CASCADE_DIR_CANDIDATES = (
    "/usr/share/opencv4/haarcascades",
    "/usr/share/opencv/haarcascades",
    "/usr/local/share/opencv4/haarcascades",
)


def find_cascade_xml(name: str) -> Optional[str]:
    """Locate a Haar cascade file by name (cv2.data, then system dirs)."""
    dirs = []
    if cv2 is not None and hasattr(cv2, "data"):
        dirs.append(cv2.data.haarcascades)
    dirs.extend(_CASCADE_DIR_CANDIDATES)
    for d in dirs:
        path = os.path.join(d, name)
        if os.path.exists(path):
            return path
    return None


def _cascade_detector(name: str):
    """A detectMultiScale-capable Haar detector, or None.

    Prefers the Python cv2 API; when the wheel lacks CascadeClassifier
    (OpenCV 5), falls back to the native C++ loader's ml_detect
    (``native_loader.cascade`` — same cv2-compatible call surface), so
    the built-in tracker actually detects instead of silently running
    center-box + LK only.
    """
    if cv2 is None:
        return None
    xml = find_cascade_xml(name)
    if xml is None:
        return None
    cls = getattr(cv2, "CascadeClassifier", None)
    if cls is not None:
        det = cls(xml)
        if not det.empty():
            return det
        # fall through: the wheel's loader may reject an XML the
        # system OpenCV 4 (native path) parses fine
    from . import native_loader
    return native_loader.cascade(xml)


def _haar_detector():
    return _cascade_detector("haarcascade_frontalface_default.xml")


def _center_box(h: int, w: int) -> np.ndarray:
    side = min(h, w)
    return np.asarray([(h - side) / 2, (w - side) / 2, side, side],
                      np.float32)


def _shift_box(box: np.ndarray, dy: float, dx: float, h: int,
               w: int) -> np.ndarray:
    y0, x0, bh, bw = box
    y0 = float(np.clip(y0 + dy, 0, h - bh))
    x0 = float(np.clip(x0 + dx, 0, w - bw))
    return np.asarray([y0, x0, bh, bw], np.float32)


def _lk_shift(prev_gray: np.ndarray, cur_gray: np.ndarray,
              box: np.ndarray) -> Optional[Tuple[float, float]]:
    """Median sparse-LK displacement of good features inside ``box``."""
    y0, x0, bh, bw = box.astype(int)
    roi = prev_gray[y0:y0 + bh, x0:x0 + bw]
    if roi.size == 0:
        return None
    pts = cv2.goodFeaturesToTrack(roi, maxCorners=32, qualityLevel=0.05,
                                  minDistance=5)
    if pts is None or len(pts) < 4:
        return None
    pts = pts.reshape(-1, 2) + np.asarray([x0, y0], np.float32)
    nxt, ok, _err = cv2.calcOpticalFlowPyrLK(
        prev_gray, cur_gray, pts.astype(np.float32), None,
        winSize=(15, 15), maxLevel=2)
    ok = ok.reshape(-1).astype(bool)
    if ok.sum() < 4:
        return None
    d = (nxt.reshape(-1, 2) - pts)[ok]
    dx, dy = np.median(d[:, 0]), np.median(d[:, 1])
    return float(dy), float(dx)


class BoxTracker:
    """Stateful per-frame face-box tracker (Haar re-detect + LK flow).

    One ``update(frame)`` call per frame, in order; :func:`face_boxes`
    is the array-at-once wrapper, and the streaming-decode path
    (``api.MimamoAPI.predict`` over :func:`iter_video` windows) feeds
    frames incrementally — both produce identical boxes (tested).
    """

    def __init__(self, height: int, width: int, detect_every: int = 8,
                 margin: float = 0.25, track: str = "lk"):
        if track not in ("lk", "hold"):
            raise ValueError(f"track must be 'lk' or 'hold', got {track!r}")
        self.h, self.w = height, width
        self.detect_every = detect_every
        self.margin = margin
        self.track = track
        self.det = _haar_detector()
        self.last = _center_box(height, width)
        self.prev_gray: Optional[np.ndarray] = None
        self.i = 0

    def update(self, frame_rgb: np.ndarray,
               gray: Optional[np.ndarray] = None) -> np.ndarray:
        h, w, det, i = self.h, self.w, self.det, self.i
        # hold mode only needs gray on detection frames; lk needs every
        # frame for the flow pyramid. A caller driving BOTH this and an
        # EyeTracker passes the frame's gray plane once (the native
        # loader shares it the same way).
        need_gray = (self.track == "lk"
                     or (det is not None and i % self.detect_every == 0))
        if gray is None and need_gray:
            gray = cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2GRAY)
        detected = False
        if det is not None and i % self.detect_every == 0:
            m = min(h, w) // 8  # cv2 Size is (width, height); use min side
            found = det.detectMultiScale(gray, scaleFactor=1.2,
                                         minNeighbors=4, minSize=(m, m))
            if len(found):
                x, y, bw, bh = max(found, key=lambda b: b[2] * b[3])
                side = max(bw, bh) * (1.0 + self.margin)
                cy, cx = y + bh / 2, x + bw / 2
                y0 = np.clip(cy - side / 2, 0, h - 1)
                x0 = np.clip(cx - side / 2, 0, w - 1)
                side_y = min(side, h - y0)
                side_x = min(side, w - x0)
                side = min(side_y, side_x)
                self.last = np.asarray([y0, x0, side, side], np.float32)
                detected = True
        if (self.track == "lk" and not detected
                and self.prev_gray is not None):
            shift = _lk_shift(self.prev_gray, gray, self.last)
            if shift is not None:
                self.last = _shift_box(self.last, shift[0], shift[1], h, w)
        self.prev_gray = gray
        self.i += 1
        return self.last


def face_boxes(frames_rgb: np.ndarray,
               boxes_path: Optional[str] = None,
               detect_every: int = 8,
               margin: float = 0.25,
               track: str = "lk") -> np.ndarray:
    """Per-frame (y0, x0, height, width) face boxes for [T, H, W, 3] frames.

    Re-detects every ``detect_every`` frames; between detections the box
    follows the face via sparse Lucas-Kanade optical flow
    (``track="lk"``, the default) instead of a hold-last policy
    (``track="hold"`` restores it: the last box is reused until the next
    detection). Flow tracking closes part of the capability gap vs
    OpenFace's CE-CLM tracking for moving faces without any native
    dependency beyond OpenCV. Boxes are squared and expanded by
    ``margin`` to approximate OpenFace's aligned crop extent.
    """
    t, h, w, _ = frames_rgb.shape
    if boxes_path:
        boxes = load_boxes_file(boxes_path=boxes_path)
        if boxes.shape != (t, 4):
            raise ValueError(
                f"{boxes_path}: expected shape {(t, 4)}, got {boxes.shape}")
        return boxes
    tracker = BoxTracker(h, w, detect_every=detect_every, margin=margin,
                         track=track)
    return np.stack([tracker.update(f) for f in frames_rgb])


def load_boxes_file(video_path: Optional[str] = None,
                    boxes_path: Optional[str] = None
                    ) -> Optional[np.ndarray]:
    """Precomputed [T, 4] face boxes, or None when no file applies.

    Explicit ``boxes_path`` must exist; otherwise the
    ``<video>.boxes.npy`` sidecar is probed. Length-vs-video checks are
    the caller's job (the streaming-decode path learns T as it goes).
    """
    if boxes_path is None:
        if video_path is None:
            return None
        candidate = video_path + ".boxes.npy"
        if not os.path.exists(candidate):
            return None
        boxes_path = candidate
    elif not os.path.exists(boxes_path):
        raise FileNotFoundError(
            f"boxes file not found: {boxes_path} (explicit paths must "
            f"exist; omit the argument to use the built-in detector)")
    boxes = np.load(boxes_path).astype(np.float32)
    if boxes.ndim != 2 or boxes.shape[1] != 4:
        raise ValueError(
            f"{boxes_path}: expected [T, 4] boxes, got {boxes.shape}")
    return boxes


def _eye_detector():
    return _cascade_detector("haarcascade_eye.xml")


class EyeTracker:
    """Stateful per-frame eye landmark tracker (Haar eye cascade + LK).

    Detection inside the upper half of each face box, SANITY-GATED:
    a candidate pair must have a plausible interocular distance
    relative to the box and be roughly horizontal, which rejects the
    eyebrow/nostril false pairs a bare two-largest-detections policy
    accepts. Between detections the eye
    POINTS follow sparse Lucas-Kanade flow (``track="lk"``, the
    default — mirroring :class:`BoxTracker`'s policy; ``track="hold"``
    restores the old hold-last behavior), with a per-frame gate on the
    interocular-distance change so a flow failure degrades to hold-last
    instead of dragging a point off the face. When no eyes were ever
    found the canonical in-box positions are used (alignment then
    degenerates to the plain box crop — same fallback policy as the box
    tracker). :func:`eye_landmarks` is the array-at-once wrapper; the
    streaming decode path feeds frames incrementally with identical
    output.
    """

    def __init__(self, detect_every: int = 8, track: str = "lk"):
        if track not in ("lk", "hold"):
            raise ValueError(f"track must be 'lk' or 'hold', got "
                             f"{track!r}")
        self.det = _eye_detector()
        self.detect_every = detect_every
        self.track = track
        self.last: Optional[np.ndarray] = None
        self.prev_gray: Optional[np.ndarray] = None
        self.i = 0

    @staticmethod
    def _canonical(box):
        y0, x0, bh, bw = box
        return np.asarray([[y0 + 0.38 * bh, x0 + 0.22 * bw],
                           [y0 + 0.38 * bh, x0 + 0.78 * bw]], np.float32)

    @staticmethod
    def _plausible(pts: np.ndarray, box: np.ndarray) -> bool:
        """Eye-pair sanity gate: interocular distance 15–80% of the box
        width and the pair within 30 degrees of horizontal."""
        d = pts[1] - pts[0]
        dist = float(np.hypot(d[0], d[1]))
        bw = float(box[3])
        return (0.15 * bw <= dist <= 0.8 * bw
                and abs(float(d[0])) <= 0.5 * dist)

    def _detect(self, gray: np.ndarray, box: np.ndarray
                ) -> Optional[np.ndarray]:
        y0, x0, bh, bw = box.astype(int)
        roi = gray[max(y0, 0):y0 + bh // 2, max(x0, 0):x0 + bw]
        if not roi.size:
            return None
        found = self.det.detectMultiScale(roi, 1.1, 3)
        if len(found) < 2:
            return None
        # consider pairs among the top-4 detections by area (largest-
        # area-sum first) and take the first that passes the gate — the
        # two biggest boxes are often an eyebrow + one eye
        found = sorted(found, key=lambda r: -r[2] * r[3])[:4]
        ry0, rx0 = max(y0, 0), max(x0, 0)
        centers = [(ry0 + fy + fh / 2.0, rx0 + fx + fw / 2.0)
                   for fx, fy, fw, fh in found]
        pairs = sorted(
            ((a, b) for a in range(len(found))
             for b in range(a + 1, len(found))),
            key=lambda ab: -(found[ab[0]][2] * found[ab[0]][3]
                             + found[ab[1]][2] * found[ab[1]][3]))
        for a, b in pairs:
            pts = np.asarray(sorted((centers[a], centers[b]),
                                    key=lambda p: p[1]), np.float32)
            if self._plausible(pts, box):
                return pts
        return None

    def _lk_points(self, gray: np.ndarray) -> Optional[np.ndarray]:
        pts_xy = self.last[:, ::-1].reshape(-1, 1, 2).astype(np.float32)
        nxt, ok, _err = cv2.calcOpticalFlowPyrLK(
            self.prev_gray, gray, pts_xy, None, winSize=(21, 21),
            maxLevel=3)
        if not ok.reshape(-1).astype(bool).all():
            return None
        new = nxt.reshape(-1, 2)[:, ::-1].astype(np.float32)
        # per-frame gates — a point that slid off the face (or a flow
        # "success" on unrelated content) fails here and we hold:
        # interocular distance must not jump, and neither point may
        # move more than half the interocular distance in one frame
        # (far above real per-frame head motion)
        d0 = float(np.hypot(*(self.last[1] - self.last[0])))
        d1 = float(np.hypot(*(new[1] - new[0])))
        if not (0.8 * d0 <= d1 <= 1.25 * d0):
            return None
        step = np.hypot(*(new - self.last).T).max()
        if step > 0.5 * d0:
            return None
        return new

    def update(self, frame_rgb: np.ndarray, box: np.ndarray,
               gray: Optional[np.ndarray] = None) -> np.ndarray:
        detect_now = (self.det is not None
                      and self.i % self.detect_every == 0)
        need_gray = self.track == "lk" or detect_now
        if gray is None and need_gray:
            # callers that also run a BoxTracker on the same frame
            # should pass its gray plane instead (track_boxes_and_eyes)
            gray = cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2GRAY)
        detected = False
        if detect_now:
            pts = self._detect(gray, box)
            if pts is not None:
                self.last = pts
                detected = True
        if (self.track == "lk" and not detected
                and self.last is not None
                and self.prev_gray is not None):
            moved = self._lk_points(gray)
            if moved is not None:
                self.last = moved
        self.prev_gray = gray if self.track == "lk" else None
        self.i += 1
        return (self.last if self.last is not None
                else self._canonical(box))


def eye_landmarks(frames_rgb: np.ndarray, boxes: np.ndarray,
                  detect_every: int = 8, track: str = "lk") -> np.ndarray:
    """Per-frame ((left_y, left_x), (right_y, right_x)) eye landmarks.

    The landmark *interface* is the contract: precomputed landmarks
    from a stronger tracker can be passed straight to
    preprocess.similarity_from_eyes. See :class:`EyeTracker` for the
    tracking policy (``track="lk"`` default, ``"hold"`` = the old
    hold-last-between-detections behavior).
    """
    tracker = EyeTracker(detect_every=detect_every, track=track)
    return np.stack([tracker.update(f, b)
                     for f, b in zip(frames_rgb, boxes)])


def track_boxes_and_eyes(frames_rgb: np.ndarray, tracker: "BoxTracker",
                         eyes: "EyeTracker"):
    """Run box + eye tracking over a frame window with ONE grayscale
    conversion per frame shared by both trackers.

    Running the two trackers in separate passes converts every source
    frame to gray twice (both default to LK, which needs gray per
    frame) — a measurable cost on a decode-bound host; the native C++
    loader shares the plane the same way. When BOTH trackers are in
    hold mode, gray is only needed on detection frames, so each tracker
    keeps its own lazy conversion.

    Returns (boxes [T, 4], landmarks [T, 2, 2]) float32. Output is
    identical to the two-pass form (tested): each tracker sees exactly
    the gray plane it would have computed itself.
    """
    share = tracker.track == "lk" or eyes.track == "lk"
    boxes_l, lm_l = [], []
    for f in frames_rgb:
        g = cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) if share else None
        b = tracker.update(f, gray=g)
        boxes_l.append(b)
        lm_l.append(eyes.update(f, b, gray=g))
    return np.stack(boxes_l), np.stack(lm_l)


def load_landmarks(video_path: str, t: int,
                   landmarks_path: Optional[str] = None
                   ) -> Optional[np.ndarray]:
    """Precomputed eye landmarks for a video, if available.

    File contracts (documented for external trackers):

    * ``<video>.landmarks.npy`` — float [T, 2, 2] per-frame
      ((left_y, left_x), (right_y, right_x)) eye points, or [T, K>=3, 2]
      dense landmark sets, in source pixels.
    * ``<video>.openface.csv`` (or any explicit ``.csv`` path) — raw
      OpenFace ``FeatureExtraction`` output; parsed by
      :mod:`.openface` into [T, 68, 2].

    An explicit ``landmarks_path`` must exist; without one, the sidecar
    paths are probed (npy first) and None returned when absent (callers
    then fall back to the built-in Haar eye tracker).
    """
    landmarks_path = resolve_landmarks_path(video_path, landmarks_path)
    if landmarks_path is None:
        return None
    if landmarks_path.endswith(".csv"):
        from .openface import read_landmarks_csv
        lm, _success = read_landmarks_csv(landmarks_path, num_frames=t)
        return lm
    lm = np.load(landmarks_path).astype(np.float32)
    # Accept full-length sidecars for truncated (max_frames) runs.
    if lm.ndim != 3 or lm.shape[-1] != 2 or lm.shape[0] < t:
        raise ValueError(
            f"{landmarks_path}: expected shape [>= {t}, K, 2] "
            f"(K=2 eye points or a dense landmark set) per frame, got "
            f"{lm.shape}")
    return lm[:t]


def load_video_with_boxes(path: str,
                          boxes_path: Optional[str] = None,
                          max_frames: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode + box in one call. Default boxes file: ``<path>.boxes.npy``."""
    frames = decode_video(path, max_frames=max_frames)
    if boxes_path is None:
        candidate = path + ".boxes.npy"
        boxes_path = candidate if os.path.exists(candidate) else None
    return frames, face_boxes(frames, boxes_path=boxes_path)


class WindowParams:
    """Stateful per-decode-window resolver of (boxes, landmarks, crop
    params) — THE single definition of the sidecar/tracker/alignment
    convention behind ``api._iter_crop_chunks`` (windowed decode for
    ``MimamoAPI.predict`` and ``VideoProcessor.process``), whose
    windowed-vs-array parity is test-load-bearing.

    Construction resolves the sidecars once (boxes file, landmark
    source, and — for dense landmark sets — ONE whole-sidecar
    Procrustes template fit, trimmed to ``max_frames``: per-window
    fits would give each window a different template, i.e. seam jumps
    and decode_window-dependent crops). ``resolve(frames, start)`` is
    then called per decode window, threading the box/eye trackers
    across windows.

    ``want_boxes`` forces box tracking even when alignment comes from
    a landmark sidecar (the two-step workflow persists boxes for
    provenance).
    """

    def __init__(self, video_path: str, crop_size: int,
                 boxes_path: Optional[str] = None,
                 landmarks_path: Optional[str] = None,
                 align: bool = False,
                 max_frames: Optional[int] = None,
                 want_boxes: bool = False):
        from .. import preprocess
        self.align = align
        self.want_boxes = want_boxes
        self.crop_size = crop_size
        self.boxes_file = load_boxes_file(video_path, boxes_path)
        self.lm_src = (landmark_source(video_path, landmarks_path)
                       if align else None)
        self.params_all = None
        if self.lm_src is not None and self.lm_src.lm.shape[1] > 2:
            lm_all = (self.lm_src.lm if max_frames is None
                      else self.lm_src.lm[:max_frames])
            self.params_all = preprocess.similarity_from_landmarks(
                lm_all, crop_size)
        self._tracker = self._eyes = None

    def resolve(self, frames: np.ndarray, start: int):
        """[n, H, W, 3] frames at absolute frame index ``start`` ->
        (boxes [n, 4] | None, landmarks [n, K, 2] | None, params).

        ``params`` is what ``runner.crop_video_chunked`` consumes:
        [n, 4] boxes when not aligning, [n, 2, 3] similarity
        transforms when aligning. A boxes sidecar SHORTER than the
        decoded video raises here, before further decode work; a
        LONGER one is fine (max_frames-truncated runs — same >= T
        allowance as load_landmarks). Landmark sidecars hold-pad past
        their end (:func:`hold_pad_indices`).
        """
        from .. import preprocess
        n = frames.shape[0]
        boxes = lm = None
        if self.boxes_file is not None:
            if len(self.boxes_file) < start + n:
                raise ValueError(
                    f"boxes file: {len(self.boxes_file)} rows but the "
                    f"video has at least {start + n} frames")
            boxes = self.boxes_file[start:start + n]
        elif self.want_boxes or not (self.align
                                     and self.lm_src is not None):
            if self._tracker is None:
                self._tracker = BoxTracker(frames.shape[1],
                                           frames.shape[2])
            if self.align and self.lm_src is None:
                # both trackers run on this window: share ONE gray
                # conversion per frame
                if self._eyes is None:
                    self._eyes = EyeTracker()
                boxes, lm = track_boxes_and_eyes(frames, self._tracker,
                                                 self._eyes)
            else:
                boxes = np.stack([self._tracker.update(f)
                                  for f in frames])
        if not self.align:
            return boxes, None, boxes
        if self.lm_src is not None:
            lm = self.lm_src.read(start, n)
        elif lm is None:           # boxes came from a sidecar file
            if self._eyes is None:
                self._eyes = EyeTracker()
            lm = np.stack([self._eyes.update(f, b)
                           for f, b in zip(frames, boxes)])
        if self.params_all is not None:    # dense: whole-video fit
            # hold_pad_indices == a plain slice while the sidecar
            # covers the window; hold-last past its end (CSV sidecars
            # shorter than the video — npy would have raised in
            # lm_src.read above)
            params = self.params_all[hold_pad_indices(
                start, n, len(self.params_all))]
        else:                              # eye pairs: per-frame fit
            params = preprocess.similarity_from_landmarks(
                lm, self.crop_size)
        return boxes, lm, params
