"""Fused SRB-LQR solve (pointfoot_tpu/ops/pallas/riccati.py).

The SRB-MPC tick (mpc/srb.py) solves, per scenario, a time-invariant LQR
over n = 12 states and m = 3·nf foot forces: a backward Riccati sweep with
an m×m Cholesky and 13 solves per step, then the forward force rollout.
csrc/riccati.cu does the whole solve in one kernel launch: a group of 16
lanes per scenario, eight scenarios a block, the working set of each in a
slab of shared memory.  The batch is the minor axis: every matrix is staged
(rows, B), F as (n·n, B) with F[i, j] in row i·n + j and L as (n·m, B) with
L[i, a] in row i·m + a, so the eight scenarios of a block are 32 contiguous
bytes of every row.

`srb_lqr_lanes` is the kernel's wrapper: the kernel for CUDA tensors, the
plain version (`srb_lqr_lanes_plain`) for CPU tensors.  It counts its
launches in the counter `kernel.srb_lqr` of utils/profiling.py; `srb_lqr`
stages (B, ...) problems and launches through it.  The kernel has no
backward pass: the wrapper raises for CUDA inputs that require grad while
grad mode is on.  `smem_plan` sizes a block's shared memory and decides
where the gains K_t, d_t of the backward sweep live: in the slabs when the
block then fits in an SM's shared memory, else in a global work space.
"""

from __future__ import annotations

import torch

from pointfoot_tpu_torch.ops import linalg
from pointfoot_tpu_torch.ops.cuda import build
from pointfoot_tpu_torch.ops.cuda._grad import refuse_grad
from pointfoot_tpu_torch.utils import profiling

N_STATE = 12
# input sizes the kernel is instantiated for: PointFoot and Cassie (two
# feet), the quadrupeds (four)
SIZES = (6, 12)
# the kernel's launch shape and shared-memory slab (csrc/riccati.cu, Slab)
SCENARIOS_PER_BLOCK = 8
MAX_BLOCK_SMEM = 232448  # bytes a block may use on an H100 (227 KB)
_ARGS = ("F_t", "c_t", "L_t", "Xd_t", "Ud_t", "XTd_t", "x0_t", "fff_t")


def _sum(terms) -> torch.Tensor:
    """Left-to-right sum, as the kernel accumulates."""
    it = iter(terms)
    s = next(it)
    for v in it:
        s = s + v
    return s


def srb_lqr_lanes_plain(F_t, c_t, L_t, Xd_t, Ud_t, XTd_t, x0_t, fff_t,
                        horizon: int) -> torch.Tensor:
    """Planned forces (T, m, B) from the staged problem, on any device: the
    kernel's arithmetic step by step, each sum in the kernel's order, as
    elementwise operations over the batch."""
    n, B = c_t.shape
    m = Ud_t.shape[0]
    T = horizon
    F = F_t.reshape(n, n, B)
    L = L_t.reshape(n, m, B)
    diag_n = torch.arange(n, device=c_t.device)
    diag_m = torch.arange(m, device=c_t.device)
    P = F.new_zeros(n, n, B)
    P[diag_n, diag_n] = XTd_t
    p = torch.zeros_like(c_t)
    Ks, ds = [None] * T, [None] * T
    for t in reversed(range(T)):
        # LP[a, j] = sum_k L[k, a] P[k, j]
        LP = _sum(L[k][:, None] * P[k][None, :] for k in range(n))
        # G = diag(Ud) + LP L;  H = LP F
        G = _sum(LP[:, j][:, None] * L[j][None, :] for j in range(n))
        G[diag_m, diag_m] = Ud_t + G[diag_m, diag_m]
        H = _sum(LP[:, k][:, None] * F[k][None, :] for k in range(n))
        Pc = _sum(P[:, k] * c_t[k] for k in range(n))
        w = Pc - p
        rhs_d = _sum(L[j] * w[j] for j in range(n))
        Lc = linalg._factor(G.permute(2, 0, 1))
        # K's 12 columns and d side by side: rows (n + 1, B) of the
        # right-hand side
        X = torch.stack(linalg.solve_factored(
            Lc, list(torch.cat([H, rhs_d[:, None]], dim=1))))
        K, d = X[:, :n], X[:, n]
        Ks[t], ds[t] = K, d
        FKL = F - _sum(L[:, a][:, None] * K[a][None, :] for a in range(m))
        pm = p - Pc
        p = _sum(FKL[k] * pm[k] for k in range(n))
        FtP = _sum(F[l][:, None] * P[l][None, :] for l in range(n))
        P = _sum(FtP[:, k][:, None] * FKL[k][None, :] for k in range(n))
        P[diag_n, diag_n] = Xd_t + P[diag_n, diag_n]
    # forward rollout: x' = F x + c + L du, du = -K x - d
    x = x0_t
    out = []
    for t in range(T):
        du = -ds[t]
        for j in range(n):
            du = du - Ks[t][:, j] * x[j]
        out.append(fff_t + du)
        acc = c_t
        for j in range(n):
            acc = acc + F[:, j] * x[j]
        for a in range(m):
            acc = acc + L[:, a] * du[a]
        x = acc
    return torch.stack(out)


def gain_rows(m: int) -> int:
    """Floats of one step's gains in the kernel's layout: K's m rows padded
    to 13, then d."""
    return (N_STATE + 1) * m + m


def slab_floats(m: int, horizon: int, gains_in_shared: bool) -> int:
    """Floats between two scenarios' slabs in shared memory: F, L, c, Xd,
    Ud, P and the two m-row matrices padded to 13 columns, F'P, three
    vectors of 12 and, if asked, the gains of every step; rounded up to 16
    mod 32 so that the two groups of a warp fall on different banks."""
    n, pad = N_STATE, N_STATE + 1
    fixed = n * n + n * m + 2 * n + m + n * pad + 2 * m * pad + n * n + 3 * n
    floats = fixed + (horizon * gain_rows(m) if gains_in_shared else 0)
    return (floats + 15) // 32 * 32 + 16


def smem_plan(m: int, horizon: int):
    """(bytes of dynamic shared memory a block needs, gains in shared
    memory?) for input size m and that horizon.  The gains stay in shared
    memory whenever the block then fits; raises for sizes the kernel does
    not take."""
    if m not in SIZES:
        raise ValueError(f"srb_lqr_lanes: no kernel for m = {m} "
                         f"(built for m in {SIZES})")
    if horizon < 1:
        raise ValueError(f"srb_lqr_lanes: horizon {horizon} < 1")
    for shared in (True, False):
        nbytes = 4 * SCENARIOS_PER_BLOCK * slab_floats(m, horizon, shared)
        if nbytes <= MAX_BLOCK_SMEM:
            return nbytes, shared
    raise ValueError(f"srb_lqr_lanes: a block of m = {m} needs {nbytes} B of "
                     f"shared memory, the card gives {MAX_BLOCK_SMEM}")


def srb_lqr_lanes(F_t, c_t, L_t, Xd_t, Ud_t, XTd_t, x0_t, fff_t,
                  horizon: int) -> torch.Tensor:
    """Batch-minor entry: F_t (n·n, B), c_t (n, B), L_t (n·m, B), Xd_t,
    XTd_t, x0_t (n, B), Ud_t, fff_t (m, B) -> forces (horizon, m, B)."""
    args = (F_t, c_t, L_t, Xd_t, Ud_t, XTd_t, x0_t, fff_t)
    n, B = c_t.shape
    m = Ud_t.shape[0]
    T = int(horizon)
    want = (n * n, n, n * m, n, m, n, n, m)
    for name, t, rows in zip(_ARGS, args, want):
        if t.shape != (rows, B):
            raise ValueError(f"srb_lqr_lanes: {name} is {tuple(t.shape)}, "
                             f"expected ({rows}, {B})")
    dev = c_t.device
    if any(t.device != dev for t in args):
        raise ValueError("srb_lqr_lanes: inputs lie on different devices")
    if dev.type == "cpu":
        return srb_lqr_lanes_plain(*args, T)
    if dev.type != "cuda":
        raise ValueError(f"srb_lqr_lanes: unsupported device {dev}")
    if n != N_STATE or m not in SIZES:
        raise ValueError(f"srb_lqr_lanes: no kernel for n = {n}, m = {m} "
                         f"(built for n = {N_STATE}, m in {SIZES})")
    nbytes, gains_in_shared = smem_plan(m, T)
    for name, t in zip(_ARGS, args):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"srb_lqr_lanes: {name} must be contiguous "
                             f"float32, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ', strided'}")
    refuse_grad("srb_lqr_kernel", "srb_lqr_lanes_plain", *args)
    lib = build.load_riccati()
    if lib.lib.pf_srb_lqr_smem_bytes(m, T, int(gains_in_shared)) != nbytes:
        raise RuntimeError("srb_lqr_kernel's shared-memory layout does not "
                           "match smem_plan")
    # K_t and d_t of the backward sweep, read back by the forward rollout:
    # a work space for whole blocks when they do not fit in shared memory
    gains = None
    if not gains_in_shared:
        padded = -(-B // SCENARIOS_PER_BLOCK) * SCENARIOS_PER_BLOCK
        gains = torch.empty((padded, T, gain_rows(m)), dtype=torch.float32,
                            device=dev)
    out = torch.empty((T, m, B), dtype=torch.float32, device=dev)
    err = lib.lib.pf_srb_lqr(*(t.data_ptr() for t in args),
                             None if gains is None else gains.data_ptr(),
                             out.data_ptr(), m, T, B,
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"srb_lqr_kernel: CUDA launch failed with error {err}")
    profiling.count("kernel.srb_lqr")
    return out


def stage(F, c, L, Xd, Ud, XTd, x0, f_ff):
    """The (B, ...) problem as the eight (rows, B) tensors of
    `srb_lqr_lanes`, the input cost floored at 1e-8."""
    B = c.shape[0]

    def rows(a):
        return a.reshape(B, -1).t().contiguous()

    return (rows(F), rows(c), rows(L), rows(Xd),
            rows(torch.clamp_min(Ud, 1e-8)), rows(XTd), rows(x0), rows(f_ff))


def srb_lqr(F, c, L, Xd, Ud, XTd, x0, f_ff, horizon: int) -> torch.Tensor:
    """Batched SRB-LQR solve: planned forces (B, T, m).

    F (B, n, n); c (B, n); L (B, n, m); Xd/XTd (B, n) diagonal costs;
    Ud (B, m); x0 (B, n); f_ff (B, m) feedforward added to every step.
    """
    out = srb_lqr_lanes(*stage(F, c, L, Xd, Ud, XTd, x0, f_ff), horizon)
    return out.permute(2, 0, 1)
