"""One run of one benchmark cell on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is the
result (``benchmark/harness/main.py``). Without a CUDA device the run
fails; it never falls back to the CPU.
"""

import time

T0 = time.perf_counter()     # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and compile caches stay inside the checkout, at fixed paths: the
# port builds its kernels into mimamo_tpu_torch/_build/; these catch any
# extension or Triton build a later program adds.
CACHE = os.path.join(ROOT, "benchmark", ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
sys.path[0] = ROOT

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
