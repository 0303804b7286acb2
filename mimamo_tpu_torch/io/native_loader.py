"""ctypes bindings for the repo's native C++ library (native/loader.cpp).

An own copy of ``mimamo_tpu/io/native_loader.py``: the ABI-checked load of
``native/libmimamo_native.so`` (built by ``make -C native``; nothing here
builds it), and over it

  * ``NativeCorpusLoader``: decode -> Haar face detect/track -> crop or
    eye alignment -> a bounded queue of uint8 clips, on C++ threads (the
    corpus runner's loader);
  * ``decode_video_native``: one video -> crops, boxes and eye points;
  * a ``cv2.CascadeClassifier``-compatible wrapper over ``ml_detect``.
    OpenCV 5 python wheels removed the Haar API while the system OpenCV 4
    that the library links still has it, so ``io.decode`` falls back to
    it to keep detecting faces there.

Without the library, ``available()`` is False and the loader raises.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_LIB_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libmimamo_native.so"),
    "libmimamo_native.so",
)

_ABI_VERSION = 9


def _cascade_xml(name: str = "haarcascade_frontalface_default.xml") -> str:
    from . import decode
    return decode.find_cascade_xml(name) or ""


def _load_lib() -> Optional[ctypes.CDLL]:
    for p in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(os.path.abspath(p) if os.path.sep in p else p)
        except OSError:
            continue
        # A stale .so (built from older sources) must never be called
        # with the current signatures: check the ABI stamp.
        try:
            lib.ml_abi_version.restype = ctypes.c_int
            if lib.ml_abi_version() != _ABI_VERSION:
                continue
        except AttributeError:
            continue
        lib.ml_corpus_open.restype = ctypes.c_void_p
        lib.ml_corpus_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        lib.ml_corpus_next.restype = ctypes.c_int
        lib.ml_corpus_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.ml_corpus_frames_decoded.restype = ctypes.c_long
        lib.ml_corpus_frames_decoded.argtypes = [ctypes.c_void_p]
        lib.ml_corpus_close.restype = None
        lib.ml_corpus_close.argtypes = [ctypes.c_void_p]
        lib.ml_decode_video.restype = ctypes.c_int
        lib.ml_decode_video.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
        lib.ml_detect.restype = ctypes.c_int
        lib.ml_detect.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_double,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        return lib
    return None


_LIB = _load_lib()


def available() -> bool:
    return _LIB is not None


class _NativeCascade:
    """cv2.CascadeClassifier-compatible wrapper over ``ml_detect``: the
    tracker code in ``io.decode`` calls ``detectMultiScale`` and gets
    cv2-convention ``(x, y, w, h)`` rows either way."""

    _MAX = 64

    def __init__(self, xml_path: str):
        self._xml = xml_path.encode()

    def ok(self) -> bool:
        probe = np.zeros((8, 8), np.uint8)
        return self._call(probe, 1.1, 1, 0) is not None

    def _call(self, gray, scale, neighbors, min_size):
        gray = np.ascontiguousarray(gray, np.uint8)
        if gray.ndim != 2:
            raise ValueError(f"expected a grayscale image, got shape "
                             f"{gray.shape}")
        out = np.empty((self._MAX, 4), np.float32)
        n = _LIB.ml_detect(
            gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            gray.shape[0], gray.shape[1], gray.shape[1], self._xml,
            float(scale), int(neighbors), int(min_size),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._MAX)
        return None if n < 0 else out[:n]

    def detectMultiScale(self, gray, scaleFactor=1.1, minNeighbors=3,
                         minSize=(0, 0)):  # noqa: N802 — cv2 interface
        rows = self._call(gray, scaleFactor, minNeighbors,
                          int(minSize[0]) if minSize else 0)
        if rows is None:
            raise RuntimeError(f"cascade failed to load: {self._xml!r}")
        # native rows are (y, x, h, w); cv2 returns (x, y, w, h)
        return [(int(x), int(y), int(w), int(h)) for y, x, h, w in rows]


def cascade(xml_path: str):
    """A ``detectMultiScale``-capable detector backed by the native
    library, or None when the library is unbuilt / the XML unloadable."""
    if _LIB is None or not xml_path:
        return None
    det = _NativeCascade(xml_path)
    return det if det.ok() else None


class NativeCorpusLoader:
    """Threaded C++ clip stream over a list of video files.

    Yields (clip [clip_len, crop, crop, 3] uint8, video_idx, start_frame).
    """

    def __init__(self, paths: Sequence[str], clip_len: int, stride: int,
                 crop: int, queue_cap: int = 16, n_threads: int = 4,
                 detect_every: int = 8, track: str = "lk",
                 align: bool = False):
        if _LIB is None:
            raise RuntimeError(
                "native loader not built; run `make -C native`")
        if track not in ("lk", "hold"):
            raise ValueError(f"track must be 'lk' or 'hold', got "
                             f"{track!r}")
        self.clip_len, self.crop = clip_len, crop
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._handle = _LIB.ml_corpus_open(
            arr, len(paths), clip_len, stride, crop, queue_cap, n_threads,
            _cascade_xml().encode(), detect_every,
            1 if track == "lk" else 0,
            _cascade_xml("haarcascade_eye.xml").encode(),
            1 if align else 0)
        if not self._handle:
            raise RuntimeError("ml_corpus_open failed (bad args?)")
        self._lock = threading.Lock()
        self._closed = False

    def __iter__(self) -> Iterator[Tuple[Optional[np.ndarray], int, int]]:
        """Yields ``(clip, video_idx, start_frame)``.

        Sentinel contract (``loader.cpp``): ``video_idx < 0`` marks the end
        of video ``~video_idx``; ``start_frame`` is then its frame count,
        or -1 for a decode failure, and ``clip`` is None (the C side ships
        no payload for sentinels). Real records (``video_idx >= 0``)
        carry a fresh copy of the clip.
        """
        buf = np.empty((self.clip_len, self.crop, self.crop, 3), np.uint8)
        vi = ctypes.c_int32()
        sf = ctypes.c_int32()
        while True:
            with self._lock:
                if self._closed:
                    return
                ok = _LIB.ml_corpus_next(
                    self._handle,
                    buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    ctypes.byref(vi), ctypes.byref(sf))
            if not ok:
                return
            v = int(vi.value)
            yield (buf.copy() if v >= 0 else None), v, int(sf.value)

    def frames_decoded(self) -> int:
        with self._lock:
            if self._closed:
                return 0
            return int(_LIB.ml_corpus_frames_decoded(self._handle))

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                _LIB.ml_corpus_close(self._handle)
                self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def decode_video_native(path: str, crop: int, max_frames: int = 100000,
                        detect_every: int = 8, track: str = "lk",
                        align: bool = False,
                        init_eyes: Optional[np.ndarray] = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Single video -> ([T, crop, crop, 3] uint8 crops, [T, 4] boxes,
    [T, 2, 2] eye landmarks).

    Landmarks are ((left_y, left_x), (right_y, right_x)) in source pixels,
    the contract of ``<video>.landmarks.npy`` sidecars and of
    ``decode.eye_landmarks``. ``init_eyes`` ([2, 2] first-frame eye
    points, same layout) seeds the eye tracker.
    """
    if _LIB is None:
        raise RuntimeError("native loader not built; run `make -C native`")
    out = np.empty((max_frames, crop, crop, 3), np.uint8)
    boxes = np.empty((max_frames, 4), np.float32)
    eyes = np.empty((max_frames, 4), np.float32)
    seed = None
    if init_eyes is not None:
        seed = np.ascontiguousarray(
            np.asarray(init_eyes, np.float32).reshape(4))
    n = _LIB.ml_decode_video(
        path.encode(), crop, _cascade_xml().encode(),
        _cascade_xml("haarcascade_eye.xml").encode(), detect_every,
        1 if track == "lk" else 0, 1 if align else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_frames,
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        eyes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        None if seed is None else
        seed.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if n < 0:
        raise FileNotFoundError(f"cannot open video: {path}")
    if n == 0:
        raise ValueError(f"no frames decoded from {path}")
    return (out[:n].copy(), boxes[:n].copy(),
            eyes[:n].reshape(n, 2, 2).copy())
