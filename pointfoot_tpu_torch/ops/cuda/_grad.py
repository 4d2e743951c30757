"""The CUDA kernels are forward-only, as their TPU kernels are.

A wrapper fills its output over ctypes, so autograd cannot see the kernel:
a result built on an input that requires grad would come back without a
`grad_fn`, and a loss through it would get no gradient and no error.  The
JAX reference refuses instead (`jax.grad` through a `pallas_call` raises),
and so does each wrapper's CUDA branch, through `refuse_grad`.  The CPU
branches run the plain versions, which differentiate.
"""

from __future__ import annotations

from typing import Optional

import torch


def refuse_grad(kernel: str, plain: str,
                *tensors: Optional[torch.Tensor]) -> None:
    """Raise RuntimeError if grad mode is on and any of `tensors` (None
    skipped) requires grad: `kernel` has no backward pass."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward pass, just as its TPU kernel has "
            f"none, and an input requires grad.  For a gradient, call "
            f"`{plain}` (the plain PyTorch version) or run on the CPU, where "
            f"the wrapper is the plain version; otherwise call it under "
            f"torch.no_grad() or torch.inference_mode(), or detach the "
            f"inputs.")
