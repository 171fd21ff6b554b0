"""SHACIRA in PyTorch and CUDA for NVIDIA Hopper (H100).

A port of the JAX package ``shacira_tpu`` that mirrors its module tree
(``ops/hashgrid.py`` -> ``shacira_tpu_torch/ops/hashgrid.py`` and so on).
The JAX package is the reference; this package never imports it or JAX.
Every Pallas kernel of the JAX package on a ported path is a hand-written
CUDA kernel here (``csrc/``), built with ``nvcc`` at first use
(``kernels/build.py``).  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
