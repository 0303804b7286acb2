"""ctypes bindings for the repo's native C++ library (native/loader.cpp).

An own copy of ``mimamo_tpu/io/native_loader.py``: the ABI-checked load of
the library, and over it

  * ``NativeCorpusLoader``: decode -> Haar face detect/track -> crop or
    eye alignment -> a bounded queue of uint8 clips, on C++ threads (the
    corpus runner's loader);
  * ``decode_video_native``: one video -> crops, boxes and eye points;
  * a ``cv2.CascadeClassifier``-compatible wrapper over ``ml_detect``.
    OpenCV 5 python wheels removed the Haar API while the system OpenCV 4
    that the library links still has it, so ``io.decode`` falls back to
    it to keep detecting faces there.

The library is built here, at first use (the first ``available()``, or
the first loader or detector asked for): ``g++`` compiles
``native/loader.cpp`` where it lies, with the flags and OpenCV libraries
of ``native/Makefile``, into the gitignored ``mimamo_tpu_torch/_build/``
under a name keyed by the source's hash, so an edited source rebuilds and
an unchanged one loads at once. Nothing is written into ``native/``. A
file lock serializes the build between processes (test workers, a daemon
and its CLI). A library that ``make -C native`` built is the fallback when
the build fails. Where neither loads (no ``g++``, no OpenCV headers),
``available()`` is False, ``build_error()`` says why, and the loader and
``decode_video_native`` raise with that text.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile's CXXFLAGS, OPENCV_INC and OPENCV_LIBS
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
OPENCV_INC = Path("/usr/include/opencv4")
OPENCV_LIBS = ("-lopencv_core", "-lopencv_imgproc", "-lopencv_objdetect",
               "-lopencv_video", "-lopencv_videoio")

# built by `make -C native`, or on the loader's search path
_LIB_PATHS = (
    str(_REPO / "native" / "libmimamo_native.so"),
    "libmimamo_native.so",
)

_ABI_VERSION = 9


def build() -> Path:
    """Compile ``native/loader.cpp`` into ``BUILD_DIR`` (if not yet built
    from this source) and return the library's path; raises
    ``RuntimeError`` saying what is missing or what the compiler said."""
    if not SOURCE.exists():
        raise RuntimeError(f"native source not found: {SOURCE}")
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native library is compiled "
                           "from native/loader.cpp at first use")
    if not (OPENCV_INC / "opencv2" / "objdetect.hpp").exists():
        raise RuntimeError(f"OpenCV 4 headers not found under "
                           f"{OPENCV_INC}: the native library needs them")
    h = hashlib.sha256(" ".join(CXX_FLAGS + OPENCV_LIBS).encode())
    h.update(SOURCE.read_bytes())
    lib = BUILD_DIR / f"libmimamo_native_{h.hexdigest()[:16]}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # released when closed
        if lib.exists():
            return lib
        tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        try:
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, f"-I{OPENCV_INC}", str(SOURCE), "-o",
                 str(tmp / lib.name), *OPENCV_LIBS],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode:
                raise RuntimeError(f"g++ failed on {SOURCE.name}:\n"
                                   f"{proc.stdout}")
            os.replace(tmp / lib.name, lib)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return lib


def _cascade_xml(name: str = "haarcascade_frontalface_default.xml") -> str:
    from . import decode
    return decode.find_cascade_xml(name) or ""


def _bind(path: str) -> Optional[ctypes.CDLL]:
    """The library at ``path`` with its signatures declared, or None when
    it does not load or carries another ABI stamp (a stale .so built from
    older sources must never be called with the current signatures)."""
    try:
        lib = ctypes.CDLL(os.path.abspath(path) if os.path.sep in path
                          else path)
    except OSError:
        return None
    try:
        lib.ml_abi_version.restype = ctypes.c_int
        if lib.ml_abi_version() != _ABI_VERSION:
            return None
    except AttributeError:
        return None
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


class _Library:
    """The native library of this process, built and loaded once, on the
    first :meth:`get`: the built one first, then ``_LIB_PATHS``."""

    def __init__(self, build: Callable[[], Path] = build):
        self._build = build
        self._lock = threading.Lock()
        self._done = False
        self.lib: Optional[ctypes.CDLL] = None
        self.error: Optional[str] = None       # why ``lib`` is None

    def get(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if not self._done:
                paths, why = list(_LIB_PATHS), []
                try:
                    paths.insert(0, str(self._build()))
                except RuntimeError as e:
                    why.append(str(e))
                for path in paths:
                    self.lib = _bind(path)
                    if self.lib is not None:
                        break
                else:
                    self.error = "; ".join(
                        why + [f"no library with ABI {_ABI_VERSION} "
                               f"loads from {paths}"])
                self._done = True
            return self.lib


_NATIVE = _Library()


def available() -> bool:
    """Whether the library builds (or was built) and loads."""
    return _NATIVE.get() is not None


def build_error() -> Optional[str]:
    """Why the library is not available, or None when it is."""
    _NATIVE.get()
    return _NATIVE.error


def _lib() -> ctypes.CDLL:
    lib = _NATIVE.get()
    if lib is None:
        raise RuntimeError(f"native library not available: {_NATIVE.error}")
    return lib


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
        n = _lib().ml_detect(
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
    if not xml_path or not available():
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
        lib = _lib()
        if track not in ("lk", "hold"):
            raise ValueError(f"track must be 'lk' or 'hold', got "
                             f"{track!r}")
        self.clip_len, self.crop = clip_len, crop
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._lib = lib
        self._handle = lib.ml_corpus_open(
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
                ok = self._lib.ml_corpus_next(
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
            return int(self._lib.ml_corpus_frames_decoded(self._handle))

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._lib.ml_corpus_close(self._handle)
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
    lib = _lib()
    out = np.empty((max_frames, crop, crop, 3), np.uint8)
    boxes = np.empty((max_frames, 4), np.float32)
    eyes = np.empty((max_frames, 4), np.float32)
    seed = None
    if init_eyes is not None:
        seed = np.ascontiguousarray(
            np.asarray(init_eyes, np.float32).reshape(4))
    n = lib.ml_decode_video(
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
