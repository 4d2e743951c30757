"""The CUDA kernels of the port against their plain PyTorch versions.

Needs an NVIDIA GPU with nvcc; skips without one.  On the card (which has no
JAX, so the repo's conftest files are bypassed):

    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from pointfoot_tpu_torch.ops.cuda import substep as sp
from pointfoot_tpu_torch.physics.assets import get_model

from _torch_parity import srb_lqr_problem

pytestmark = pytest.mark.cuda

# not a multiple of the 128-thread block: the last block has idle threads
B = 1000


@pytest.fixture(scope="module")
def rows():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mc = sp.model_consts(get_model("pointfoot"))
    rng = np.random.default_rng(1)

    def r(n, s, o=0.0):
        return o + s * rng.standard_normal((n, B))

    q = r(4, 0.1)
    q[3] += 1.0
    q /= np.linalg.norm(q, axis=0)
    state = np.concatenate([r(2, 0.5), 0.42 + 0.25 * rng.random((1, B)), q,
                            r(3, 0.5), r(3, 0.8), r(6, 0.4), r(6, 1.5),
                            r(6, 1.5)])
    ctrl = np.concatenate([
        r(6, 0.5), np.full((6, B), 40.0), np.full((6, B), 1.5),
        0.2 + 1.2 * rng.random((9, B)), 0.1 * rng.random((6, B)),
        r(1, 0.5), r(3, 0.03), np.full((1, B), 1.2e4),
        np.full((1, B), 1.2e3), r(3, 20.0)])
    n = r(3, 0.15)
    n[2] = 1.0
    n /= np.linalg.norm(n, axis=0)
    surf = np.concatenate([r(9, 0.03), np.tile(n, (9, 1))])
    dev = torch.device("cuda")
    return mc, tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                     for a in (state, ctrl, surf))


@pytest.mark.parametrize("control_type", ["P", "V", "T"])
@pytest.mark.parametrize("surface", [True, False])
@pytest.mark.parametrize("push", [True, False])
def test_rollout_step_kernel_matches_plain(rows, control_type, surface,
                                           push):
    mc, (state, ctrl, surf) = rows
    args = (mc, state, ctrl, surf if surface else None, push,
            (0.1, 0.0, -0.1, 0.0, 0.2, 0.0), 0.5, control_type, 0.005, 9.81)
    before = sp.rollout_step.launches
    ks, ke = sp.rollout_step(*args)
    assert sp.rollout_step.launches == before + 1
    ps, pe = sp.rollout_step_plain(*args)
    torch.cuda.synchronize()
    nj, nc = mc.nj, mc.nc
    torch.testing.assert_close(ks, ps, atol=2e-3, rtol=0)
    torch.testing.assert_close(ke[:nj], pe[:nj], atol=5e-3, rtol=0)
    torch.testing.assert_close(ke[nj:nj + 3 * nc], pe[nj:nj + 3 * nc],
                               atol=0.05, rtol=1e-3)
    torch.testing.assert_close(ke[nj + 3 * nc:], pe[nj + 3 * nc:],
                               atol=5e-5, rtol=0)


def test_fk_kernel_matches_plain(rows):
    mc, (state, _, _) = rows
    before = sp.fk_rows.launches
    got = sp.fk_rows(mc, state)
    assert sp.fk_rows.launches == before + 1
    torch.testing.assert_close(got, sp.fk_rows_plain(mc, state), atol=2e-5,
                               rtol=0)


def test_wrapper_rejects_bad_rows(rows):
    mc, (state, ctrl, surf) = rows
    with pytest.raises(ValueError, match="contiguous"):
        sp.fk_rows(mc, state.t().contiguous().t())
    with pytest.raises(ValueError, match="ctrl_rows"):
        sp.rollout_step(mc, state, ctrl[:-1], surf, True, (0.0,) * 6, 0.5,
                        "P", 0.005, 9.81)


# ---------------------------------------- kernels of dynamics.step_batched

@pytest.fixture(scope="module", params=["pointfoot", "anymal_c"])
def substep_rows(request):
    """Substep input and surface rows of B envs for one robot."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mc = sp.model_consts(get_model(request.param))
    nj, nc = mc.nj, mc.nc
    rng = np.random.default_rng(2)

    def r(n, s, o=0.0):
        return o + s * rng.standard_normal((n, B))

    q = r(4, 0.1)
    q[3] += 1.0
    q /= np.linalg.norm(q, axis=0)
    rows = np.concatenate([
        r(2, 0.5), 0.42 + 0.25 * rng.random((1, B)), q, r(3, 0.5),
        r(3, 0.8), r(nj, 0.4), r(nj, 1.5), r(nj, 10.0), r(3, 20.0),
        0.2 + 1.2 * rng.random((nc, B)), 0.1 * rng.random((nj, B)),
        r(1, 0.5), r(3, 0.03), np.full((1, B), 1.2e4),
        np.full((1, B), 1.2e3)])
    n = r(3, 0.15)
    n[2] = 1.0
    n /= np.linalg.norm(n, axis=0)
    surf = np.concatenate([r(nc, 0.03), np.tile(n, (nc, 1))])
    dev = torch.device("cuda")
    return mc, tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                     for a in (rows, surf))


@pytest.mark.parametrize("surface", [True, False])
def test_substep_kernel_matches_plain(substep_rows, surface):
    """Tolerances of tests/test_pallas_substep.py:50-60 (kernel vs
    reference)."""
    mc, (rows, surf) = substep_rows
    s = surf if surface else None
    before = sp.step_rows.launches
    got = sp.step_rows(mc, rows, s, 0.005, 9.81)
    assert sp.step_rows.launches == before + 1
    want = sp.step_rows_plain(mc, rows, s, 0.005, 9.81)
    torch.cuda.synchronize()
    nj = mc.nj
    o_qpos, o_qvel, o_force = 13, 13 + nj, 13 + 2 * nj
    torch.testing.assert_close(got[:7], want[:7], atol=2e-5, rtol=0)
    torch.testing.assert_close(got[7:13], want[7:13], atol=3e-4, rtol=3e-4)
    torch.testing.assert_close(got[o_qpos:o_qvel], want[o_qpos:o_qvel],
                               atol=2e-5, rtol=0)
    torch.testing.assert_close(got[o_qvel:o_force], want[o_qvel:o_force],
                               atol=1e-3, rtol=3e-4)
    torch.testing.assert_close(got[o_force:], want[o_force:], atol=0.1,
                               rtol=1e-3)


def test_fk_xy_kernel_matches_plain(substep_rows):
    mc, (rows, _) = substep_rows
    fk_in = torch.cat([rows[:7], rows[13:13 + mc.nj]]).contiguous()
    before = sp.fk_xy_rows.launches
    got = sp.fk_xy_rows(mc, fk_in)
    assert sp.fk_xy_rows.launches == before + 1
    torch.testing.assert_close(got, sp.fk_xy_rows_plain(mc, fk_in),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("n", [12, 18])
def test_cholesky_kernel_matches_plain(n):
    """Tolerance of tests/test_pallas.py:24; B = 1000 leaves the last block
    with idle threads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pointfoot_tpu_torch.ops.cuda import cholesky

    rng = np.random.default_rng(n)
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    b = rng.normal(size=(B, n)).astype(np.float32)
    dev = torch.device("cuda")
    A_t = torch.tensor(A.reshape(B, n * n).T.copy(), device=dev)
    b_t = torch.tensor(b.T.copy(), device=dev)
    before = cholesky.chol_solve_lanes.launches
    x_t = cholesky.chol_solve_lanes(A_t, b_t)
    assert cholesky.chol_solve_lanes.launches == before + 1
    want = cholesky.chol_solve_lanes_plain(A_t, b_t)
    torch.cuda.synchronize()
    torch.testing.assert_close(x_t, want, atol=3e-3, rtol=3e-3)
    x = torch.linalg.solve(torch.tensor(A, dtype=torch.float64),
                           torch.tensor(b, dtype=torch.float64))
    torch.testing.assert_close(x_t.t().cpu().double(), x, atol=3e-3,
                               rtol=3e-3)
    with pytest.raises(ValueError, match="no kernel for n = 7"):
        cholesky.chol_solve_lanes(A_t[:49].contiguous(), b_t[:7].contiguous())


# ------------------------------------------------- the SRB-LQR kernel

@pytest.mark.parametrize("num", [B, 4096])
@pytest.mark.parametrize("m", [6, 12])
def test_srb_lqr_kernel_matches_plain(m, num):
    """Tolerance of tests/test_pallas.py:77-78; 1000 scenarios leave the
    last block with idle threads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pointfoot_tpu_torch.ops.cuda import riccati

    T = 12
    dev = torch.device("cuda")
    prob = [torch.tensor(a, device=dev) for a in srb_lqr_problem(num, m, m)]
    staged = riccati.stage(*prob)
    before = riccati.srb_lqr_lanes.launches
    got = riccati.srb_lqr_lanes(*staged, T)
    assert riccati.srb_lqr_lanes.launches == before + 1
    want = riccati.srb_lqr_lanes_plain(*staged, T)
    torch.cuda.synchronize()
    assert got.shape == (T, m, num)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    # and through the (B, ...) entry, against the CPU's plain version
    out = riccati.srb_lqr(*prob, horizon=T)
    assert out.shape == (num, T, m)
    cpu = riccati.srb_lqr(*(a.cpu() for a in prob), horizon=T)
    torch.testing.assert_close(out.cpu(), cpu, atol=2e-3, rtol=2e-3)


def test_srb_lqr_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pointfoot_tpu_torch.ops.cuda import riccati

    dev = torch.device("cuda")
    prob = [torch.tensor(a, device=dev) for a in srb_lqr_problem(64, 9, 0)]
    with pytest.raises(ValueError, match="no kernel for n = 12, m = 9"):
        riccati.srb_lqr(*prob, horizon=4)
    staged = list(riccati.stage(
        *(torch.tensor(a, device=dev) for a in srb_lqr_problem(64, 6, 0))))
    with pytest.raises(ValueError, match="contiguous"):
        riccati.srb_lqr_lanes(staged[0].t().contiguous().t(), *staged[1:], 4)
    with pytest.raises(ValueError, match="different devices"):
        riccati.srb_lqr_lanes(staged[0].cpu(), *staged[1:], 4)
