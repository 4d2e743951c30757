"""Batched small-matrix Cholesky solve (pointfoot_tpu/ops/pallas/cholesky.py).

Thousands of independent SPD systems of size n <= 18 (the velocity solve
of physics/dynamics.step_batched), each solved by a group of lanes of
csrc/cholesky.cu with the system in a slab of shared memory.  The batch is
the minor axis: A is staged as (n·n, B) with A[i, j] in row i·n + j and b
as (n, B), so a block's loads of one entry are adjacent.

`chol_solve_lanes` is the kernel's wrapper: the kernel for CUDA tensors,
the plain version (`chol_solve_lanes_plain`, i.e. ops/linalg.chol_solve)
for CPU tensors.  It counts its launches in `.launches`; `chol_solve` and
`chol_solve_best` launch through it.  The kernel has no backward pass: the
wrapper raises for CUDA inputs that require grad while grad mode is on.
"""

from __future__ import annotations

import torch

from pointfoot_tpu_torch.ops import linalg
from pointfoot_tpu_torch.ops.cuda import build
from pointfoot_tpu_torch.ops.cuda._grad import refuse_grad

# sizes the kernel is instantiated for: PointFoot (nv 12), the quadrupeds
# and Cassie (nv 18)
SIZES = (12, 18)
# the kernel's route starts at one 128-lane block of the TPU kernel
# (pointfoot_tpu/ops/pallas/cholesky.py:32, :130 and
# pointfoot_tpu/physics/dynamics.py:514)
CHOL_MIN_BATCH = 128


def chol_solve_bytes(n: int, B: int) -> int:
    """The bytes a launch at B systems of size n must move: A's lower
    triangle (all that the factor reads) and b in, x out."""
    return 4 * B * (n * (n + 1) // 2 + 2 * n)


def chol_solve_lanes_plain(A_t: torch.Tensor, b_t: torch.Tensor
                           ) -> torch.Tensor:
    """x_t (n, B) solving A x = b per column, from A_t (n·n, B) and b_t
    (n, B), on any device."""
    n, B = b_t.shape
    return linalg.chol_solve(A_t.t().reshape(B, n, n), b_t.t()).t()


def chol_solve_lanes(A_t: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """Batch-minor entry: A_t (n·n, B), b_t (n, B) -> x_t (n, B)."""
    n, B = b_t.shape
    if A_t.shape != (n * n, B):
        raise ValueError(f"chol_solve_lanes: A_t {tuple(A_t.shape)} does not "
                         f"match b_t {tuple(b_t.shape)}")
    dev = A_t.device
    if dev.type == "cpu":
        return chol_solve_lanes_plain(A_t, b_t)
    if dev.type != "cuda":
        raise ValueError(f"chol_solve_lanes: unsupported device {dev}")
    if n not in SIZES:
        raise ValueError(f"chol_solve_lanes: no kernel for n = {n} "
                         f"(built for {SIZES})")
    for name, t in (("A_t", A_t), ("b_t", b_t)):
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"chol_solve_lanes: {name} must be contiguous "
                             f"float32 on {dev}, got {t.dtype} on {t.device}")
    refuse_grad("chol_solve_kernel", "chol_solve_lanes_plain", A_t, b_t)
    x_t = torch.empty_like(b_t)
    lib = build.load_cholesky()
    err = lib.lib.pf_chol_solve(A_t.data_ptr(), b_t.data_ptr(),
                                x_t.data_ptr(), n, B,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"chol_solve_kernel: CUDA launch failed with error {err}")
    chol_solve_lanes.launches += 1
    return x_t


chol_solve_lanes.launches = 0


def chol_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for a batch of SPD systems, A (B, n, n), b (B, n),
    through `chol_solve_lanes`."""
    B, n, _ = A.shape
    x_t = chol_solve_lanes(A.reshape(B, n * n).t().contiguous(),
                           b.t().contiguous())
    return x_t.t()


def chol_solve_best(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA from CHOL_MIN_BATCH systems, the plain unrolled
    solve otherwise."""
    if A.device.type == "cuda" and A.shape[0] >= CHOL_MIN_BATCH:
        return chol_solve(A, b)
    return linalg.chol_solve(A, b)
