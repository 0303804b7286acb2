"""Is ``cli train`` on the card the same from run to run?

    python3 mimamo_tpu_torch/bench/train_repeat.py [ROOT ...]

For each checkout ROOT (this one when none is given), in a process of its
own that imports that root's ``mimamo_tpu_torch`` and ``chip_smoke.py``:
``cli train --epochs 1`` at the default fp32 config on ``chip_smoke``'s
seeded synthetic Aff-Wild2 corpus, twice plainly and once as a world of
one (``--data-parallel --coordinator 127.0.0.1:0 --num-processes 1
--process-id 0``), all in that process, as ``chip_smoke.py``'s
``parallel`` phase runs the two; then the same three under
``torch.use_deterministic_algorithms`` (warnings only) and cuDNN's
deterministic switch. Prints, per run, the largest |difference| of its
checkpoint from the first plain run's of the same setting, the tensor it
is in and every tensor past 1e-6, its rows, and the warnings of
operations that have no deterministic form. Needs one CUDA card. Run it
as a file, not with ``-m``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

WORLD1 = ["--data-parallel", "--coordinator", "127.0.0.1:0",
          "--num-processes", "1", "--process-id", "0"]
# (name, flags, deterministic algorithms)
RUNS = (("plain", [], False), ("plain", [], False), ("world1", WORLD1, False),
        ("plain", [], True), ("plain", [], True), ("world1", WORLD1, True))


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import warnings

    import torch

    import chip_smoke as cs
    from mimamo_tpu_torch import checkpoints

    out = {"root": root, "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        aff = cs.slice_media(tmp)["aff"]
        first = {}
        for i, (name, flags, det) in enumerate(RUNS):
            ckpt = os.path.join(tmp, f"{name}{i}")
            torch.use_deterministic_algorithms(det, warn_only=True)
            torch.backends.cudnn.deterministic = det
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                rows = cs.run_cli(["train", "--dataset", "affwild2",
                                   "--root", aff, "--epochs", "1",
                                   "--ckpt", ckpt] + flags)
            model = checkpoints.load(ckpt)["model"]
            ref = first.setdefault(det, model)
            diffs = {k: float((model[k].float() - ref[k].float()).abs()
                              .max()) for k in ref}
            worst = max(diffs, key=diffs.get)
            out["runs"].append({
                "run": name, "deterministic": det, "rows": rows,
                "ckpt_max_abs": diffs[worst], "tensor": worst,
                "over_1e-6": sorted(k for k, v in diffs.items() if v > 1e-6),
                "warnings": sorted({str(w.message)[:200] for w in caught})})
    return out


def main(argv: list) -> int:
    if argv[:1] == ["--measure"]:
        print(json.dumps(measure(os.path.abspath(argv[1]))), flush=True)
        return 0
    roots = [os.path.abspath(r) for r in argv] or [os.getcwd()]
    for root in roots:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure", root],
            cwd=root, capture_output=True, text=True, timeout=900,
            env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
