"""Small-matrix batched linear algebra (pointfoot_tpu/ops/linalg.py).

`chol_solve` unrolls the Cholesky factor and both substitutions over the
static size n into elementwise operations on the batch: it is the plain
version of the batched Cholesky kernel (csrc/cholesky.cu) and the solve of
the plain physics step.  All functions take (..., n, n) / (..., n).
"""

from __future__ import annotations

import torch


def _factor(A: torch.Tensor):
    """Lower Cholesky factor as a dict {(i, j): (...,)} with
    d = sqrt(max(s, 1e-12)) on the diagonal and the exact reciprocal of d
    below it."""
    n = A.shape[-1]
    L = {}
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[(j, k)] * L[(j, k)]
        d = torch.sqrt(torch.clamp_min(s, 1e-12))
        L[(j, j)] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[(i, k)] * L[(j, k)]
            L[(i, j)] = s * inv_d
    return L


def cholesky_unrolled(A: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor of SPD matrices."""
    n = A.shape[-1]
    L = _factor(A)
    zeros = torch.zeros_like(A[..., 0, 0])
    return torch.stack([
        torch.stack([L[(i, j)] if j <= i else zeros for j in range(n)],
                    dim=-1)
        for i in range(n)], dim=-2)


def solve_factored(L, rows, expand=lambda l: l):
    """Both substitutions for the factor `L` of `_factor`: `rows[i]` is row i
    of the right-hand side, a tensor that `expand(L[(i, j)])` broadcasts
    against (one vector, or several right-hand sides side by side).  Returns
    the rows of the solution as a list."""
    n = len(rows)
    y = [None] * n
    for i in range(n):
        s = rows[i]
        for k in range(i):
            s = s - expand(L[(i, k)]) * y[k]
        y[i] = s / expand(L[(i, i)])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - expand(L[(k, i)]) * x[k]
        x[i] = s / expand(L[(i, i)])
    return x


def chol_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive definite A (..., n, n)."""
    n = A.shape[-1]
    return torch.stack(
        solve_factored(_factor(A), [b[..., i] for i in range(n)]), dim=-1)


def chol_solve_matrix(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B with B (..., n, m): one factorization, then every
    column through the substitutions of `chol_solve` at once."""
    n = A.shape[-1]
    return torch.stack(
        solve_factored(_factor(A), [B[..., i, :] for i in range(n)],
                       expand=lambda l: l[..., None]), dim=-2)


def inv3(A: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Analytic 3x3 inverse (adjugate / det), batched."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / torch.where(torch.abs(det) < eps,
                                torch.full_like(det, eps), det)
    adj = torch.stack([
        co_a, -(b * i - c * h), (b * f - c * e),
        co_b, (a * i - c * g), -(a * f - c * d),
        co_c, -(a * h - b * g), (a * e - b * d),
    ], dim=-1).reshape(A.shape)
    return adj * inv_det[..., None, None]
