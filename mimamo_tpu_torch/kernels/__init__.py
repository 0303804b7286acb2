"""Hand-written CUDA kernels of the port, each beside its plain version.

``phase_kernel`` (phase difference + resize), ``stem_kernel`` (upscale +
conv1 + pool) and ``layer2_kernel`` (ResNet-50 layer2). Sources live in
``../csrc``; ``_build`` compiles them with nvcc at first use.
"""
