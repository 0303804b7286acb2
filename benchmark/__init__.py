"""The benchmark of the PyTorch and CUDA port, ``mimamo_tpu_torch``: one
command runs one cell once (``python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``). See ``benchmark/README.md``."""
