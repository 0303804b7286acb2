"""Haar face/eye detection through the repo's native C++ library.

An own copy of the detection part of ``mimamo_tpu/io/native_loader.py``:
the ABI-checked load of ``native/libmimamo_native.so`` (built by
``make -C native``), its ``ml_detect`` entry point and a
``cv2.CascadeClassifier``-compatible wrapper over it. OpenCV 5 python
wheels removed the Haar API while the system OpenCV 4 that the library
links still has it, so ``io.decode`` falls back to this module to keep
detecting faces there. The corpus loader of the same library is not
ported yet (ROADMAP.md, Queue A13).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libmimamo_native.so"),
    "libmimamo_native.so",
)

_ABI_VERSION = 9


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
