"""Horizon-parallel LQR/Riccati by an associative scan
(pointfoot_tpu/mpc/riccati.py).

The associative form of the LQR backward pass (Särkkä & García-Fernández,
"Temporal Parallelization of Dynamic Programming and Linear Quadratic
Control"): each time step is summarized by an element e = (A, b, C, eta, J)
and adjacent elements combine associatively, so the backward pass runs in
O(log T) dependent steps.  For the affine step x' = F x + c + L u with
control cost 0.5 u'U u and stage state cost 0.5 x'X x (terminal 0.5 x'XT x)

    A = F,  b = c,  C = L U^-1 L',  eta = 0,  J = X

plus a terminal pure-cost element (A = 0, J = XT).  Combination (i earlier):

    Mij  = (I + C_i J_j)^-1
    A_ij = A_j Mij A_i
    b_ij = A_j Mij (b_i + C_i eta_j) + b_j
    C_ij = A_j Mij C_i A_j' + C_j
    Nij  = (I + J_j C_i)^-1
    eta_ij = A_i' Nij (eta_j - J_j b_i) + eta_i
    J_ij   = A_i' Nij J_j A_i + J_i

The value function at t is V_t(x) = 0.5 x'J x - eta'x after combining the
suffix elements t..T.

Time is dim 0 of every sequence; batch dimensions may stand between it and
the matrix dimensions ((T, ..., n, n), (T, ..., n)), which is how mpc/srb.py
solves all scenarios at once.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from pointfoot_tpu_torch.ops import linalg as linalg_ops


class LQRElement(NamedTuple):
    A: torch.Tensor  # (..., n, n)
    b: torch.Tensor  # (..., n)
    C: torch.Tensor  # (..., n, n)
    eta: torch.Tensor  # (..., n)
    J: torch.Tensor  # (..., n, n)


def _T(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (A @ v[..., None])[..., 0]


def _eye_like(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor]
                     ) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of `elems` (a tuple of tensors) along dim 0 with the
    associative `fn(earlier, later)`, in O(log T) applications of `fn`: pairs
    combine, the half-length sequence is scanned, and the even positions are
    filled in from it."""
    elems = tuple(elems)
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:n - 1:2] for e in elems),
                 tuple(e[1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    out = []
    for first, ev, od in zip(elems, even, odd):
        ev = torch.cat([first[:1], ev])
        res = first.new_empty((n,) + first.shape[1:])
        res[0::2] = ev
        res[1::2] = od
        out.append(res)
    return tuple(out)


def _combine(elem_i: LQRElement, elem_j: LQRElement) -> LQRElement:
    """Associative combination; elem_i earlier in time than elem_j."""
    Ai, bi, Ci, etai, Ji = elem_i
    Aj, bj, Cj, etaj, Jj = elem_j
    I = _eye_like(Ai)
    AjT = _T(Aj)
    AiT = _T(Ai)
    M = torch.linalg.solve(I + Ci @ Jj, I)
    N = torch.linalg.solve(I + Jj @ Ci, I)
    A = Aj @ M @ Ai
    b = _mv(Aj @ M, bi + _mv(Ci, etaj)) + bj
    C = Aj @ M @ Ci @ AjT + Cj
    eta = _mv(AiT @ N, etaj - _mv(Jj, bi)) + etai
    J = AiT @ N @ Jj @ Ai + Ji
    return LQRElement(A, b, C, eta, J)


def make_elements(F, c, L, X, U, XT) -> LQRElement:
    """Stack per-step elements (T+1 including the terminal cost element)."""
    Uinv = torch.linalg.solve(U, _eye_like(U))
    C = L @ Uinv @ _T(L)
    zero_n = torch.zeros_like(F[:1])
    zero_v = torch.zeros_like(c[:1])
    return LQRElement(
        A=torch.cat([F, zero_n]),
        b=torch.cat([c, zero_v]),
        C=torch.cat([C, zero_n]),
        eta=torch.cat([torch.zeros_like(c), zero_v]),
        J=torch.cat([X, XT[None]]),
    )


def parallel_lqr_value(elements: LQRElement
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P_t, p_t) for all t by the O(log T)-depth associative scan.

    V_t(x) = 0.5 x'P_t x - p_t'x + const.
    """
    rev = tuple(torch.flip(a, dims=(0,)) for a in elements)
    # reversed order: a prefix of the reversed sequence is a suffix of the
    # original; the combine must see (earlier, later) = (element closer to
    # t, closer to T), and with reversed inputs the accumulated prefix is
    # the LATER part.
    scanned = LQRElement(*associative_scan(
        lambda a, b: tuple(_combine(LQRElement(*b), LQRElement(*a))), rev))
    P = torch.flip(scanned.J, dims=(0,))
    p = torch.flip(scanned.eta, dims=(0,))
    return P, p


def sequential_lqr_value(F, c, L, X, U, XT):
    """Reference sequential Riccati for the same problem (tests and short
    horizons).  Same value convention as parallel_lqr_value."""
    T = F.shape[0]
    P = XT
    p = torch.zeros_like(c[0])
    Ps, ps = [None] * T, [None] * T
    for t in reversed(range(T)):
        F_t, c_t, L_t, X_t, U_t = F[t], c[t], L[t], X[t], U[t]
        LtP = _T(L_t) @ P
        G = U_t + LtP @ L_t
        H = LtP @ F_t
        K = linalg_ops.chol_solve_matrix(G, H)
        FKL = F_t - L_t @ K
        P_new = X_t + _T(F_t) @ P @ FKL
        P_new = 0.5 * (P_new + _T(P_new))
        p = _mv(_T(FKL), p - _mv(P, c_t))
        P = P_new
        Ps[t], ps[t] = P, p
    Ps = torch.stack(Ps + [XT])
    ps = torch.stack(ps + [torch.zeros_like(c[0])])
    return Ps, ps


def lqr_gains_from_value(F, c, L, U, P_next, p_next):
    """Feedback gains from next-step value: u* = -K x - d."""
    LT = _T(L)
    G = U + LT @ P_next @ L
    H = LT @ P_next @ F
    K = linalg_ops.chol_solve_matrix(G, H)
    d = linalg_ops.chol_solve(G, _mv(LT, _mv(P_next, c) - p_next))
    return K, d


# --------------------------------------------------------------------------
# Full LQT form (Särkkä & García-Fernández): cross term u'Mx and linear
# costs q'x, r'u — everything an iLQR backward pass produces.  Reduced to
# the canonical element by completion of squares so the SAME associative
# combine runs in O(log T) depth.  Value convention here: V_t(x) =
# 0.5 x'P_t x + p_t'x + const.
# --------------------------------------------------------------------------


def make_elements_lqt(F, c, L, X, q, U, r, M, XT, qT) -> LQRElement:
    """Elements for stage cost 0.5x'Xx + q'x + 0.5u'Uu + r'u + u'Mx.

    Completion of squares u = ũ − U⁻¹(Mx + r) folds the cross/linear
    control terms into effective dynamics and state cost:

        F̃ = F − LU⁻¹M,  c̃ = c − LU⁻¹r,  X̃ = X − M'U⁻¹M,  q̃ = q − M'U⁻¹r

    then the canonical element applies with eta = −q̃ (the module's value
    convention is V = 0.5x'Jx − eta'x).  Terminal: J = XT, eta = −qT.
    """
    Uinv = torch.linalg.solve(U, _eye_like(U))
    LT = _T(L)
    MT = _T(M)
    LUi = L @ Uinv
    F_eff = F - LUi @ M
    c_eff = c - _mv(LUi, r)
    X_eff = X - MT @ Uinv @ M
    q_eff = q - _mv(MT @ Uinv, r)
    C = LUi @ LT
    zero_n = torch.zeros_like(F[:1])
    return LQRElement(
        A=torch.cat([F_eff, zero_n]),
        b=torch.cat([c_eff, torch.zeros_like(c[:1])]),
        C=torch.cat([C, zero_n]),
        eta=torch.cat([-q_eff, -qT[None]]),
        J=torch.cat([X_eff, XT[None]]),
    )


def parallel_lqt_value(F, c, L, X, q, U, r, M, XT, qT):
    """(P_t, p_t) for all t, O(log T) depth; V_t = 0.5x'P_t x + p_t'x."""
    P, eta = parallel_lqr_value(make_elements_lqt(F, c, L, X, q, U, r, M,
                                                  XT, qT))
    return P, -eta


def sequential_lqt_value(F, c, L, X, q, U, r, M, XT, qT):
    """Reference sequential recursion for the full LQT (same convention)."""
    T = F.shape[0]
    P, p = XT, qT
    Ps, ps = [None] * T, [None] * T
    for t in reversed(range(T)):
        F_t, c_t, L_t, M_t = F[t], c[t], L[t], M[t]
        LT = _T(L_t)
        G = U[t] + LT @ P @ L_t
        Pc_p = _mv(P, c_t) + p
        K = linalg_ops.chol_solve_matrix(G, LT @ P @ F_t + M_t)
        d = linalg_ops.chol_solve(G, _mv(LT, Pc_p) + r[t])
        P_new = X[t] + _T(F_t) @ P @ F_t - _T(K) @ G @ K
        P_new = 0.5 * (P_new + _T(P_new))
        p = q[t] + _mv(_T(F_t), Pc_p) - _mv(_T(K), _mv(G, d))
        P = P_new
        Ps[t], ps[t] = P, p
    return torch.stack(Ps + [XT]), torch.stack(ps + [qT])


def lqt_gains_from_value(F, c, L, U, r, M, P_next, p_next):
    """u* = −Kx − d from the next-step LQT value (broadcasts over time)."""
    LT = _T(L)
    G = U + LT @ P_next @ L
    K = linalg_ops.chol_solve_matrix(G, LT @ P_next @ F + M)
    d = linalg_ops.chol_solve(G, _mv(LT, _mv(P_next, c) + p_next) + r)
    return K, d


def parallel_backward_pass(fx, fu, cx, cu, cxx, cuu, cux, cxT, cxxT, reg):
    """An iLQR backward pass with O(log T) depth.

    Maps the iLQR derivative tensors onto the LQT problem in DEVIATION
    form (δx' = fx δx + fu δu, no affine drift) and reads the gains
    (K_t, k_t) off the suffix value functions.  Returns (Ks, ks, dV) as a
    sequential backward pass does.

    CAVEAT (regularization semantics): the regularizer is folded into the
    WHOLE value recursion (cuu + reg·I everywhere), whereas a sequential
    pass regularizes only the gain solve and propagates the value with the
    unregularized Quu.  The two are identical as reg -> 0 and differ by
    O(reg) per step at large reg: use the parallel pass with small or fixed
    regularization, not inside aggressive reg-escalation schedules.
    """
    m = fu.shape[-1]
    cuu_reg = cuu + reg * torch.eye(m, dtype=cuu.dtype, device=cuu.device)
    c_zero = torch.zeros_like(cx)
    Ps, ps = parallel_lqt_value(
        fx, c_zero, fu, cxx, cx, cuu_reg, cu, cux, cxxT, cxT)
    Ks, ks = lqt_gains_from_value(
        fx, c_zero, fu, cuu_reg, cu, cux, Ps[1:], ps[1:])
    # expected-improvement terms (same bookkeeping as the sequential pass):
    # Qu_t = cu + fu'p_{t+1};  Quu_t = cuu + fu'P_{t+1}fu (unregularized)
    fuT = _T(fu)
    Qu = cu + _mv(fuT, ps[1:])
    Quu = cuu + fuT @ Ps[1:] @ fu
    # iLQR convention: k = -d (u = u_prev + k), so dV1 = k·Qu = -d·Qu
    dV = torch.stack([
        -torch.einsum("t...m,t...m->...", ks, Qu),
        0.5 * torch.einsum("t...m,t...mk,t...k->...", ks, Quu, ks),
    ])
    return -Ks, -ks, dV
