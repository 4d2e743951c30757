"""Device choice for the port's entry points, and constants kept on a
device."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when no device is named and no GPU is present, so a run meant for
    the card never drops silently to the CPU.  Matrix products run in full
    float32 (no TF32), as the JAX reference pins
    ``jax_default_matmul_precision="highest"`` in its tests.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


_CONSTS: Dict[tuple, torch.Tensor] = {}


def const(values: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    """`like.new_tensor(values)`, made once a device and dtype and shared
    by every caller, who must not write to it.  A tensor made from host
    data is copied to the card and waited for, which a CUDA graph cannot
    capture (envs/step_graph.py); the shared one is made at the first call,
    outside any capture, and never in inference mode, so that autograd may
    save it."""
    key = (tuple(values), like.device, like.dtype)
    t = _CONSTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTS[key] = like.new_tensor(values)
    return t
