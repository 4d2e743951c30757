"""Batched iLQR with a regularized Riccati backward pass and a parallel line
search (pointfoot_tpu/mpc/ilqr.py).

Where the JAX package `vmap`s a one-scenario solver, every function here
takes the scenarios as the leading dim: x0 (B, n), controls (B, T, m),
trajectories (B, T+1, n).  Contracts:

* dynamics `dyn(x (R, n), u (R, m)) -> x' (R, n)` over any number of rows;
* stage cost `cost_fn(x, u, t)` elementwise over leading dims, x (B, ..., n),
  u (B, ..., m), t broadcasting against the last leading dim; written
  without in-place writes, so `torch.func` differentiates it.

Derivatives: the dynamics Jacobian by forward-mode AD, one `lin_dyn` call on
the (n+m)·B·T rows of the trajectory replicated once per input coordinate,
copy k carrying the unit tangent e_k (the port's physics writes into
buffers, so `torch.func.vmap` cannot batch it; rows are independent, so
replication does the batching); the cost gradient by `torch.func.grad` of
the sum over rows (rows are independent, so it is every row's gradient)
and its Hessian by forward-over-reverse, one `jvp` of that gradient per
input coordinate under `torch.func.vmap`.

Backward pass: a reversed loop computing gains (K, k) with
Levenberg-Marquardt regularization on Q_uu, or the associative scan of
mpc/riccati.py.  Forward pass: every candidate step size rolled out as one
(B·A)-row batch and the best kept per scenario.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.autograd.forward_ad as fwAD

from pointfoot_tpu_torch.mpc import riccati
from pointfoot_tpu_torch.ops import linalg as linalg_ops


@dataclass(frozen=True)
class ILQRConfig:
    horizon: int = 50
    iterations: int = 10
    reg_init: float = 1e-6
    reg_min: float = 1e-8
    reg_max: float = 1e8
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
    # O(log T)-depth associative-scan backward pass (mpc/riccati.py)
    parallel_backward: bool = False


class ILQRSolution(NamedTuple):
    xs: torch.Tensor  # (B, T+1, n) optimal state trajectories
    us: torch.Tensor  # (B, T, m) optimal controls
    cost: torch.Tensor  # (B,) final total cost
    gains_K: torch.Tensor  # (B, T, m, n) feedback gains of the last pass
    improved: torch.Tensor  # (B,) bool: the last iteration found better


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


def _T(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


def _rollout(dyn, x0: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """(B, T+1, n) states from x0 (B, n) under controls us (B, T, m)."""
    xs = [x0]
    for t in range(us.shape[1]):
        xs.append(dyn(xs[-1], us[:, t]))
    return torch.stack(xs, dim=1)


def _total_cost(cost_fn, xs: torch.Tensor, us: torch.Tensor,
                T: int) -> torch.Tensor:
    """Sum of the T stage costs and the terminal cost, over the last two
    dims of xs (..., T+1, n) and us (..., T, m)."""
    us_pad = torch.cat([us, torch.zeros_like(us[..., :1, :])], dim=-2)
    ts = torch.arange(T + 1, device=xs.device)
    return torch.sum(cost_fn(xs, us_pad, ts), dim=-1)


def dynamics_jacobian(dyn, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """d dyn / d (x, u) at rows x (R, n), u (R, m): (R, n, n+m), by one
    call of `dyn` under forward-mode AD on (n+m)·R rows."""
    R, n = x.shape
    N = n + u.shape[-1]
    z = torch.cat([x, u], dim=-1)
    primal = z[None].expand(N, R, N).reshape(N * R, N)
    tangent = torch.eye(N, dtype=z.dtype, device=z.device)[:, None, :].expand(
        N, R, N).reshape(N * R, N)
    with fwAD.dual_level():
        dual = fwAD.make_dual(primal, tangent)
        out = dyn(dual[:, :n], dual[:, n:])
        jt = fwAD.unpack_dual(out).tangent
    if jt is None:  # the output does not depend on (x, u)
        jt = torch.zeros_like(out)
    return jt.reshape(N, R, n).permute(1, 2, 0)


def cost_derivatives(cost_fn, z: torch.Tensor, t: torch.Tensor, n: int):
    """Gradient (B, R, N) and Hessian (B, R, N, N) of every row's cost
    `cost_fn(z[..., :n], z[..., n:], t)` at rows z (B, R, N)."""
    N = z.shape[-1]

    def total(zz):
        return torch.sum(cost_fn(zz[..., :n], zz[..., n:], t))

    grad = torch.func.grad(total)
    g = grad(z)
    basis = torch.eye(N, dtype=z.dtype, device=z.device)
    cols = torch.func.vmap(
        lambda v: torch.func.jvp(grad, (z,), (v.expand(z.shape),))[1])(basis)
    return g, cols.permute(1, 2, 3, 0)


def _linearize(dyn, cost_fn, xs: torch.Tensor, us: torch.Tensor, T: int):
    """Derivatives along the trajectories: fx (B, T, n, n), fu (B, T, n, m),
    cx (B, T, n), cu (B, T, m), cxx (B, T, n, n), cuu (B, T, m, m),
    cux (B, T, m, n) and the terminal expansion cxT (B, n), cxxT (B, n, n).
    """
    B, _, n = xs.shape
    m = us.shape[-1]
    fz = dynamics_jacobian(dyn, xs[:, :-1].reshape(B * T, n),
                           us.reshape(B * T, m)).reshape(B, T, n, n + m)
    fx, fu = fz[..., :n], fz[..., n:]

    # the stage rows and the terminal row (u = 0, t = T) in one pass
    us_pad = torch.cat([us, torch.zeros_like(us[:, :1])], dim=1)
    zs = torch.cat([xs, us_pad], dim=-1)
    gz, Hz = cost_derivatives(cost_fn, zs,
                              torch.arange(T + 1, device=xs.device), n)
    cx, cu = gz[:, :T, :n], gz[:, :T, n:]
    cxx = Hz[:, :T, :n, :n]
    cuu = Hz[:, :T, n:, n:]
    cux = Hz[:, :T, n:, :n]
    return fx, fu, cx, cu, cxx, cuu, cux, gz[:, T, :n], Hz[:, T, :n, :n]


def backward_pass(fx, fu, cx, cu, cxx, cuu, cux, cxT, cxxT, reg):
    """Time-reversed Riccati loop -> gains Ks (B, T, m, n), ks (B, T, m) and
    the expected improvement dV (B, 2).  `reg` is a float or (B,)."""
    T = fx.shape[1]
    m = fu.shape[-1]
    eye = torch.eye(m, dtype=fx.dtype, device=fx.device)
    reg_I = torch.as_tensor(reg, dtype=fx.dtype,
                            device=fx.device).reshape(-1, 1, 1) * eye
    Vx, Vxx = cxT, cxxT
    Ks, ks, dVs = [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        fx_t, fu_t = fx[:, t], fu[:, t]
        fxT, fuT = _T(fx_t), _T(fu_t)
        Qx = cx[:, t] + _mv(fxT, Vx)
        Qu = cu[:, t] + _mv(fuT, Vx)
        Qxx = cxx[:, t] + fxT @ Vxx @ fx_t
        Quu = cuu[:, t] + fuT @ Vxx @ fu_t
        Qux = cux[:, t] + fuT @ Vxx @ fx_t
        Quu_reg = Quu + reg_I
        k = -linalg_ops.chol_solve(Quu_reg, Qu)
        K = -linalg_ops.chol_solve_matrix(Quu_reg, Qux)
        KT = _T(K)
        Vx = Qx + _mv(KT @ Quu, k) + _mv(KT, Qu) + _mv(_T(Qux), k)
        Vxx = Qxx + KT @ Quu @ K + KT @ Qux + _T(Qux) @ K
        Vxx = 0.5 * (Vxx + _T(Vxx))
        dVs[t] = torch.stack([torch.sum(k * Qu, dim=-1),
                              0.5 * torch.sum(k * _mv(Quu, k), dim=-1)],
                             dim=-1)
        Ks[t], ks[t] = K, k
    return (torch.stack(Ks, dim=1), torch.stack(ks, dim=1),
            torch.sum(torch.stack(dVs), dim=0))


def _parallel_backward(fx, fu, cx, cu, cxx, cuu, cux, cxT, cxxT, reg):
    """riccati.parallel_backward_pass (time leading) on (B, T, ...)
    derivatives, returning backward_pass's layout."""
    def tf(a):
        return a.transpose(0, 1)

    reg = torch.as_tensor(reg, dtype=fx.dtype,
                          device=fx.device).reshape(-1, 1, 1)
    Ks, ks, dV = riccati.parallel_backward_pass(
        tf(fx), tf(fu), tf(cx), tf(cu), tf(cxx), tf(cuu), tf(cux), cxT,
        cxxT, reg)
    return tf(Ks), tf(ks), dV.transpose(0, 1)


def _forward_pass(dyn, cost_fn, xs, us, Ks, ks, alphas, T):
    """Parallel line search: every scenario rolled out at every step size
    as one (B·A)-row batch, scenario-major; the cheapest kept per scenario.
    Returns (xs (B, T+1, n), us (B, T, m), cost (B,))."""
    B, _, n = xs.shape
    A = len(alphas)
    al = torch.tensor(alphas, dtype=xs.dtype,
                      device=xs.device).repeat(B)[:, None]

    def rep(a):
        return a.repeat_interleave(A, dim=0)

    xs_r, us_r, Ks_r, ks_r = rep(xs), rep(us), rep(Ks), rep(ks)
    x = xs_r[:, 0]
    x_list, u_list = [x], []
    for t in range(T):
        u = us_r[:, t] + al * ks_r[:, t] + _mv(Ks_r[:, t], x - xs_r[:, t])
        x = dyn(x, u)
        x_list.append(x)
        u_list.append(u)
    xs_all = torch.stack(x_list, dim=1).reshape((B, A) + xs.shape[1:])
    us_all = torch.stack(u_list, dim=1).reshape((B, A) + us.shape[1:])
    costs = _total_cost(cost_fn, xs_all, us_all, T)  # (B, A)
    best = torch.argmin(costs, dim=1)
    idx = torch.arange(B, device=xs.device)
    return xs_all[idx, best], us_all[idx, best], costs[idx, best]


def ilqr_solve(dyn: Callable, cost_fn: Callable, x0: torch.Tensor,
               us_init: torch.Tensor, cfg: ILQRConfig,
               lin_dyn: Optional[Callable] = None) -> ILQRSolution:
    """Solve B trajectory-optimization problems, x0 (B, n) and us_init
    (B, T, m).

    `dyn` runs the rollouts and the line search; `lin_dyn` (default `dyn`)
    is what is differentiated, so it must carry forward-mode tangents:
    MPCController passes the plain physics step, whose tangents the kernel
    routes of `dyn` would refuse.
    """
    T = cfg.horizon
    lin_dyn = dyn if lin_dyn is None else lin_dyn
    xs = _rollout(dyn, x0, us_init)
    cost = _total_cost(cost_fn, xs, us_init, T)
    us = us_init
    reg = torch.full_like(cost, cfg.reg_init)
    improved = torch.zeros_like(cost, dtype=torch.bool)
    Ks = None
    for _ in range(cfg.iterations):
        derivs = _linearize(lin_dyn, cost_fn, xs, us, T)
        if cfg.parallel_backward:
            Ks, ks, _ = _parallel_backward(*derivs, reg)
        else:
            Ks, ks, _ = backward_pass(*derivs, reg)
        xs_new, us_new, cost_new = _forward_pass(
            dyn, cost_fn, xs, us, Ks, ks, cfg.alphas, T)
        improved = cost_new < cost - 1e-9
        # LM-style regularization schedule
        reg = torch.where(improved,
                          torch.clamp_min(reg * 0.5, cfg.reg_min),
                          torch.clamp_max(reg * 10.0, cfg.reg_max))
        xs = torch.where(improved[:, None, None], xs_new, xs)
        us = torch.where(improved[:, None, None], us_new, us)
        cost = torch.where(improved, cost_new, cost)
    return ILQRSolution(xs=xs, us=us, cost=cost, gains_K=Ks,
                        improved=improved)
