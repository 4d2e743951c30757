"""The CUDA kernels are forward-only, as their TPU kernels are.

A wrapper fills its output over ctypes, so autograd cannot see the kernel:
a result built on an input that requires grad would come back without a
`grad_fn`, and a loss through it would get no gradient and no error; an
input carrying a forward-mode tangent (a dual tensor of
`torch.autograd.forward_ad`) would lose it the same way.  The JAX reference
refuses instead (`jax.grad` and `jax.jvp` through a `pallas_call` raise),
and so does each wrapper's CUDA branch, through `refuse_grad`.  The CPU
branches run the plain versions, which differentiate in both modes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.autograd.forward_ad as fwAD


def refuse_grad(kernel: str, plain: str,
                *tensors: Optional[torch.Tensor]) -> None:
    """Raise RuntimeError if grad mode is on and any of `tensors` (None
    skipped) requires grad, or if any carries a forward-mode tangent:
    `kernel` has no backward pass and no forward derivative."""
    given = [t for t in tensors if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in given):
        why = "an input requires grad"
    elif any(fwAD.unpack_dual(t).tangent is not None for t in given):
        why = "an input carries a forward-mode tangent"
    else:
        return
    raise RuntimeError(
        f"{kernel} has no backward pass, just as its TPU kernel has "
        f"none, and {why}.  For a gradient, call "
        f"`{plain}` (the plain PyTorch version) or run on the CPU, where "
        f"the wrapper is the plain version; otherwise call it under "
        f"torch.no_grad() or torch.inference_mode(), or detach the "
        f"inputs.")
