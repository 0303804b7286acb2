"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, into ``mimamo_tpu_torch/_build/`` (listed in
``.gitignore``), under a name keyed by the sources' content, so an edited
source rebuilds and an unchanged one loads at once. A build failure raises.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :class:`Kernel` raises when that is not 0 and
counts the launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Sequence

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# libcuda for cuTensorMapEncodeTiled (TMA descriptors, built on the host)
LINK_FLAGS = ("-lcuda",)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under /usr/local/cuda")


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc`` into the shared library (if not yet built) and
    return its path. The ptxas report (registers, shared memory, spills
    of each kernel) is kept beside it as ``<name>.log``."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    headers = sorted(SRC_DIR.glob("*.cuh"))
    lib = BUILD_DIR / f"libmimamo_kernels_{_digest(sources + headers)}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = [(src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
             str(tmp / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in sources]
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(logs))
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp / lib.name),
             *(str(tmp / (src.stem + ".o")) for src in sources),
             *LINK_FLAGS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        lib.with_suffix(".log").write_text("\n".join(logs))
        os.replace(tmp / lib.name, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.mimamo_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mimamo_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class Kernel:
    """One C entry point of the library: declares its argument types,
    raises on a launch error, and counts its launches in ``launches``."""

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._count_lock = threading.Lock()   # launches from two threads

    def __call__(self, *args) -> None:
        lib = library()
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        if err:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {err} "
                f"({lib.mimamo_cuda_error_string(err).decode()})")
        with self._count_lock:
            self.launches += 1


P = ctypes.c_void_p    # device pointer or stream handle
I = ctypes.c_int
LL = ctypes.c_longlong
