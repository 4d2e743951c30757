"""Profiling and timing (pointfoot_tpu/utils/profiling.py).

`trace()` wraps `torch.profiler` so any block of the training or MPC loop
can be captured as a Chrome / TensorBoard trace; `timed` gives wall-clock
seconds that wait for the device, as `jax.block_until_ready` does;
`flops_estimate` counts the floating-point operations of a call.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "torch-trace")):
    """Capture a profiler trace of the block, CPU and (where there is one)
    CUDA activity; at exit a `<worker>.<ns>.pt.trace.json` lands in
    `log_dir` (Chrome's trace format, which TensorBoard's profile plugin
    reads).

    >>> with trace("/tmp/tr"):
    ...     runner.train_iteration(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir


def _sync(out) -> None:
    """Wait for the devices that hold the tensors of `out`."""
    devices = {t.device for t in tree_leaves(out)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 1,
          **kwargs) -> float:
    """Mean wall-clock seconds a call, the device's queue drained before
    the clock starts and before it stops."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _sync(out)
    return (time.perf_counter() - t0) / iters


def flops_estimate(fn: Callable, *args) -> dict:
    """{"flops": ...} of one call, by `torch.utils.flop_counter`.

    Use with `timed` for roofline checks:
    achieved_flops = flops_estimate(...)["flops"] / timed(...).
    Unlike XLA's cost analysis of the JAX package, it reports no bytes, it
    counts only the operations torch has formulas for (matrix products,
    convolutions, attention), and it cannot see into the hand-written CUDA
    kernels of `ops/cuda/`.
    """
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return {"flops": int(fc.get_total_flops())}
