"""Readers of precomputed face crops: a packed ``.npy`` or an image dir.

An own copy of ``open_npy_mmap`` and ``CropSource`` from
``mimamo_tpu/data/datasets.py`` (numpy; the port imports nothing of the
JAX package). ``api.MimamoAPI.predict_crops`` and the datasets of
``data.datasets`` read their input through :class:`CropSource`.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np


@functools.lru_cache(maxsize=128)
def _mmap_npy(path: str, _mtime_ns: int, _size: int) -> np.ndarray:
    return np.load(path, mmap_mode="r")


def open_npy_mmap(path: str) -> np.ndarray:
    """Read-only mmap of a ``.npy``, through a bounded process-wide LRU.

    Re-opening per read costs a file open and a header parse each time,
    while an unbounded cache would hold one file descriptor per source
    for the life of the process. The LRU keeps at most 128 mmaps open
    (evicted ones close when their last array view is released) and keys
    on (mtime, size), so a rewritten file is never served stale.
    """
    st = os.stat(path)
    return _mmap_npy(path, st.st_mtime_ns, st.st_size)


class CropSource:
    """Uniform reader over the two crop storage layouts: a packed
    ``.npy`` array [T, S, S, 3], or a per-frame image directory (OpenFace
    ``cropped_aligned`` style)."""

    def __init__(self, path: str, crop_size: Optional[int] = None):
        self.path = path
        self.crop_size = crop_size
        from ..io import decode
        self._decode = decode
        if os.path.isdir(path):
            self.kind = "dir"
            self._names = decode.list_frame_images(path)
            self._len = len(self._names)
        elif path.endswith(".npy") and os.path.exists(path):
            self.kind = "npy"
            arr = open_npy_mmap(path)
            self._len = int(arr.shape[0])
            if (crop_size is not None and arr.ndim >= 3
                    and tuple(arr.shape[1:3]) != (crop_size,) * 2):
                # fail fast: a wrong-sized packed array would otherwise
                # surface deep inside the forward as a shape error
                raise ValueError(
                    f"{path}: crops are {tuple(arr.shape[1:3])} "
                    f"but the config expects "
                    f"({crop_size}, {crop_size})")
        else:
            raise FileNotFoundError(
                f"crops not found (tried npy file / image dir): {path}")

    def __len__(self) -> int:
        return self._len

    def read(self, start: int, count: int) -> np.ndarray:
        if self.kind == "npy":
            arr = open_npy_mmap(self.path)
            if int(arr.shape[0]) != self._len:
                # the LRU re-resolves by (mtime, size), so a file
                # rewritten mid-run would be read against windows built
                # from the old length, and slicing past the new end
                # silently returns fewer rows: fail fast instead
                raise RuntimeError(
                    f"{self.path}: source changed length "
                    f"{self._len} -> {int(arr.shape[0])} after the "
                    f"source was opened; open it again")
            # a writable copy: torch takes no read-only arrays
            return np.array(arr[start:start + count])
        return self._decode.read_frame_images(
            self.path, self._names[start:start + count], self.crop_size)

    def read_all(self) -> np.ndarray:
        return self.read(0, self._len)
