"""Cut-down variants of the dots kernels, timed on the card.

Each variant compiles the dots sources (``csrc/layer1_dots.cu`` and
``csrc/layer2_dots.cu``) with a set of ``-D`` switches of
``csrc/dots_block.cuh``, all into one library under ``_build/variants/``,
and times ``layer1_dots`` and the layer2 dots through
it at 384 frames (median of 5 batches of 10 back-to-back calls, as
``chip_smoke.py`` times them). Every variant is timed twice, in turns
(a, b, ..., b, a), and the first one is held against the plain versions at
1, 3, 5 and 384 frames; the first turn of each also times every launch of
the chain alone.
What a variant leaves out tells what holds the kernel back:

- ``full``: the kernel as built for the port;
- ``no_load``: no TMA load (the producer arrives on each slot): products
  and epilogues alone, on whatever shared memory holds;
- ``no_mma``: no ``wgmma``: loads and epilogues alone;
- ``no_store``: no output store; ``no_epi``: no epilogue work at all;
- ``name:-DX,-DY``: any other set of switches.

    python -m mimamo_tpu_torch.bench.dots_variants [--variants "full;no_mma"]
        [--frames 384] [--src DIR]

``--src`` compiles the ``csrc`` of another checkout whose C entries take
the same arguments. To compare two revisions in one run, run each
checkout's own copy of this script in turns. Prints one JSON line per
variant and timing, with the card's name and power limit, each kernel's
ptxas report (registers, spills) and its persistent grid.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from mimamo_tpu_torch.bench import layer1_probe, layer2_probe
from mimamo_tpu_torch.bench._timing import card, max_rel, time_ms
from mimamo_tpu_torch.kernels import _build, dots_block
from mimamo_tpu_torch.kernels import layer1_dots_kernel as l1
from mimamo_tpu_torch.kernels import layer2_dots_kernel as l2d

VARIANTS = {"full": (), "no_load": ("-DDOTS_NO_LOAD",),
            "no_mma": ("-DDOTS_NO_MMA",), "no_store": ("-DDOTS_NO_STORE",),
            "no_epi": ("-DDOTS_NO_EPI",)}
CHECK_FRAMES = (1, 3, 5)       # and --frames: the full variant's checks
SOURCES = ("layer1_dots.cu", "layer2_dots.cu", "errors.cu")
SEED = 0


class VariantKernel:
    """A C entry point of a variant's library, called as ``_build.Kernel``
    is (raises on a launch error)."""

    def __init__(self, lib: ctypes.CDLL, symbol: str):
        self.fn = getattr(lib, symbol)
        self.fn.argtypes = dots_block.ARGTYPES
        self.fn.restype = ctypes.c_int
        lib.mimamo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mimamo_cuda_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def __call__(self, *args) -> None:
        err = self.fn(*args)
        if err:
            text = self.lib.mimamo_cuda_error_string(err).decode()
            raise RuntimeError(f"CUDA error {err} ({text})")


ENTRIES = ("mimamo_layer1_dots_block", "mimamo_layer2_dots_block",
           "mimamo_layer1_dots_plan", "mimamo_layer2_dots_plan")


def build(variants: dict, src: Path, out: Path) -> tuple:
    """Compile every variant (all ``nvcc`` processes at once) into one
    library, variant i's namespace and C entries renamed with ``_v<i>``
    so that they live side by side. Returns (library path, {name: ptxas
    report})."""
    nvcc = _build._nvcc()
    out.mkdir(parents=True, exist_ok=True)
    jobs, objs = [], []
    for i, (name, flags) in enumerate(variants.items()):
        rename = [f"-Ddots=dots_v{i}"] + [f"-D{e}={e}_v{i}" for e in ENTRIES]
        for s in SOURCES[:2]:
            obj = out / f"{Path(s).stem}_v{i}.o"
            objs.append(obj)
            jobs.append((name, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, *flags, *rename, "-c",
                 str(src / s), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs.append(out / "errors.o")
    jobs.append((None, subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-c", str(src / SOURCES[2]), "-o",
         str(objs[-1])], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)))
    logs = {name: "" for name in variants}
    for name, proc in jobs:
        text, _ = proc.communicate()
        if name is not None:
            logs[name] += text
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
    lib = out / "libdots_variants.so"
    subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o",
         str(lib), *map(str, objs), *_build.LINK_FLAGS],
        check=True, capture_output=True, text=True)
    return lib, logs


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill stores, spill loads, serialized) of each
    dots kernel in a ptxas report; serialized: ptxas made its wgmma wait
    one for another (C7510-C7520 performance notes)."""
    rows, kernel, spills = [], None, (0, 0)
    serialized = {m.group(1) for m in re.finditer(
        r"wgmma.mma_async instructions are serialized.*function '(\w+)'",
        log)}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel and "dots" in kernel:
            rows.append((kernel, int(m.group(1)), *spills,
                         kernel in serialized))
    return rows


def block_ms(kernel, mod, x, blocks) -> list:
    """Each launch of the chain timed alone (ms), on the inputs the chain
    gives it."""
    rows, n, out_w = mod.source_rows(), x.shape[0], blocks[-1].w3.shape[0]
    src, times = x, []
    for b, blk in enumerate(blocks):
        last = b == len(blocks) - 1
        crop = mod.CROP if last else (0, 0, 0, 0)
        out = torch.empty((n, *mod.CROP[:2], out_w) if last
                          else (n, mod.P, out_w), dtype=x.dtype,
                          device=x.device)
        call = lambda s=src, r=rows[b], o=out, c=crop, k=blk: \
            dots_block.launch(kernel, s, r, k, o, mod.GRID_W, mod.P, c)
        call()
        times.append(time_ms(call))
        src = out
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=";".join(VARIANTS),
                    help="';'-separated entries: a name of VARIANTS, or "
                         "name:-DX,-DY")
    ap.add_argument("--frames", type=int, default=384)
    ap.add_argument("--src", type=Path, default=_build.SRC_DIR)
    ap.add_argument("--build-only", action="store_true",
                    help="build the variants and print their ptxas reports")
    ap.add_argument("--log-dir", type=Path,
                    help="write each variant's whole nvcc report here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the variants are timed on the "
                           "card")
    variants = {}
    for item in args.variants.split(";"):
        if ":" in item:
            name, flags = item.split(":", 1)
            variants[name] = tuple(f for f in flags.split(",") if f)
        else:
            variants[item] = VARIANTS[item]
    line = card()
    path, logs = build(variants, args.src.resolve(),
                       _build.BUILD_DIR / "variants")
    cdll = ctypes.CDLL(str(path))
    for i, name in enumerate(variants):
        grids = {}
        for probe in ("layer1", "layer2"):
            fn = getattr(cdll, f"mimamo_{probe}_dots_plan_v{i}")
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            ctas = ctypes.c_int()
            err = fn(args.frames, ctypes.byref(ctas))
            grids[probe] = (ctas.value, err)
        print(json.dumps({"variant": name, "flags": variants[name],
                          "ptxas": ptxas_report(logs[name]),
                          "ctas_err": grids}), flush=True)
        if args.log_dir:
            args.log_dir.mkdir(parents=True, exist_ok=True)
            (args.log_dir / f"{name}.log").write_text(logs[name])
    if args.build_only:
        return 0

    n = args.frames
    probes = {
        "layer1_dots": (
            "mimamo_layer1_dots_block", l1,
            l1.pack_layer1_dots(layer1_probe.dots_weights(), "cuda"),
            layer1_probe.inputs(n, SEED, "cuda"), l1.layer1_dots_plain),
        "layer2_g4_dots": (
            "mimamo_layer2_dots_block", l2d,
            layer2_probe.prepare(layer2_probe.probe_weights(SEED)[1],
                                 "cuda").dots,
            layer2_probe.inputs(n, SEED, "cuda").reshape(n, 28, 2, 28, 512),
            l2d.layer2_dots_plain)}
    kernels = {name: {probe: VariantKernel(cdll, f"{sym}_v{i}")
                      for probe, (sym, *_) in probes.items()}
               for i, name in enumerate(variants)}
    order = list(variants) + list(variants)[::-1]
    with torch.no_grad():
        for turn, name in enumerate(order):
            rec = {"variant": name, "turn": turn, "frames": n, "card": line}
            for probe, (_, mod, blocks, x, plain) in probes.items():
                k = kernels[name][probe]
                run = lambda: dots_block.run(k, x, blocks, mod.source_rows(),
                                             mod.GRID_W, mod.P, mod.CROP)
                if turn == 0:
                    for m in CHECK_FRAMES + (n,):
                        xm = x[:m]
                        got = dots_block.run(k, xm, blocks, mod.source_rows(),
                                             mod.GRID_W, mod.P, mod.CROP)
                        rec[f"{probe}_max_rel_{m}"] = max_rel(
                            got, plain(xm, blocks))
                        rec[f"{probe}_finite_{m}"] = bool(
                            torch.isfinite(got.float()).all())
                try:
                    rec[f"{probe}_ms"] = time_ms(run)
                    if turn < len(variants):
                        rec[f"{probe}_block_ms"] = block_ms(k, mod, x, blocks)
                except RuntimeError as e:      # a refused launch: go on
                    rec[f"{probe}_error"] = str(e)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
