"""PyTorch/CUDA port of the pointfoot-tpu stack for one NVIDIA H100.

The layout mirrors the JAX package (``pointfoot_tpu/``), which stays the
reference: each module here has a counterpart of the same path there.
Plain tensor code is PyTorch; the TPU's Pallas kernels become CUDA C++
kernels under ``csrc/``, each with a plain PyTorch version beside it that
the CPU tests and ``chip_smoke.py`` hold it against.
"""
