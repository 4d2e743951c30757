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
from pointfoot_tpu_torch.utils import profiling

from _torch_parity import srb_lqr_problem

pytestmark = pytest.mark.cuda

# 1000 envs or scenarios fill their blocks (8 items each); the ragged sizes
# leave the last block with idle groups: one item, and a prime above 4096
B = 1000
RAGGED = (1, 4099)
# every baked model: each builds its own kernels from its model header
ROBOTS = ("pointfoot", "anymal_c", "anymal_b", "a1", "cassie")


def _columns(t, num):
    """The first `num` columns of (rows, B) tensor t, starting over beyond
    B."""
    reps = -(-num // t.shape[1])
    return torch.cat([t] * reps, dim=1)[:, :num].contiguous()


def _default_qpos(nj: int):
    return tuple((0.1, 0.0, -0.1, 0.0, 0.2, 0.0)[i % 6] for i in range(nj))


def _assert_rollout_close(mc, ks, ke, ps, pe):
    """Within the JAX tests' tolerances, and bit for bit: the kernel does
    its plain version's float32 operations in the same order."""
    nj, nc = mc.nj, mc.nc
    torch.testing.assert_close(ks, ps, atol=2e-3, rtol=0)
    torch.testing.assert_close(ke[:nj], pe[:nj], atol=5e-3, rtol=0)
    torch.testing.assert_close(ke[nj:nj + 3 * nc], pe[nj:nj + 3 * nc],
                               atol=0.05, rtol=1e-3)
    torch.testing.assert_close(ke[nj + 3 * nc:], pe[nj + 3 * nc:],
                               atol=5e-5, rtol=0)
    assert torch.equal(ks, ps) and torch.equal(ke, pe)


@pytest.fixture(scope="module", params=ROBOTS)
def rows(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mc = sp.model_consts(get_model(request.param))
    nj, nc = mc.nj, mc.nc
    rng = np.random.default_rng(1)

    def r(n, s, o=0.0):
        return o + s * rng.standard_normal((n, B))

    q = r(4, 0.1)
    q[3] += 1.0
    q /= np.linalg.norm(q, axis=0)
    state = np.concatenate([r(2, 0.5), 0.42 + 0.25 * rng.random((1, B)), q,
                            r(3, 0.5), r(3, 0.8), r(nj, 0.4), r(nj, 1.5),
                            r(nj, 1.5)])
    ctrl = np.concatenate([
        r(nj, 0.5), np.full((nj, B), 40.0), np.full((nj, B), 1.5),
        0.2 + 1.2 * rng.random((nc, B)), 0.1 * rng.random((nj, B)),
        r(1, 0.5), r(3, 0.03), np.full((1, B), 1.2e4),
        np.full((1, B), 1.2e3), r(3, 20.0)])
    n = r(3, 0.15)
    n[2] = 1.0
    n /= np.linalg.norm(n, axis=0)
    surf = np.concatenate([r(nc, 0.03), np.tile(n, (nc, 1))])
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
            _default_qpos(mc.nj), 0.5, control_type, 0.005, 9.81)
    before = profiling.counter("kernel.rollout_substep")
    ks, ke = sp.rollout_step(*args)
    assert profiling.counter("kernel.rollout_substep") == before + 1
    ps, pe = sp.rollout_step_plain(*args)
    torch.cuda.synchronize()
    _assert_rollout_close(mc, ks, ke, ps, pe)


@pytest.mark.parametrize("num", RAGGED)
def test_rollout_step_kernel_matches_plain_on_ragged_batches(rows, num):
    mc, parts = rows
    state, ctrl, surf = (_columns(t, num) for t in parts)
    args = (mc, state, ctrl, surf, True, _default_qpos(mc.nj), 0.5, "P",
            0.005, 9.81)
    ks, ke = sp.rollout_step(*args)
    again = sp.rollout_step(*args)
    ps, pe = sp.rollout_step_plain(*args)
    torch.cuda.synchronize()
    assert ks.shape == ps.shape and ke.shape == pe.shape
    assert torch.equal(ks, again[0]) and torch.equal(ke, again[1])
    _assert_rollout_close(mc, ks, ke, ps, pe)


@pytest.fixture(scope="module", params=ROBOTS)
def fk_state(request):
    """Rollout state rows of B envs of one robot: random poses, bases far
    from the origin as well as near it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mc = sp.model_consts(get_model(request.param))
    nj = mc.nj
    rng = np.random.default_rng(3)

    def r(n, s, o=0.0):
        return o + s * rng.standard_normal((n, B))

    q = r(4, 0.3)
    q[3] += 1.0
    q /= np.linalg.norm(q, axis=0)
    state = np.concatenate([r(2, 30.0), 0.5 + r(1, 0.1), q, r(6, 0.8),
                            r(nj, 0.6), r(2 * nj, 1.5)])
    return mc, torch.tensor(state, dtype=torch.float32, device="cuda")


@pytest.mark.parametrize("num", [B, *RAGGED])
def test_fk_kernel_matches_plain(fk_state, num):
    """Bit-identical to the plain version (the same operations in the same
    order, -fmad=false), and across two launches; 1 and 4099 envs leave the
    last block with idle groups."""
    mc, state = fk_state
    state = _columns(state, num)
    before = profiling.counter("kernel.fk_from_state")
    got = sp.fk_rows(mc, state)
    assert profiling.counter("kernel.fk_from_state") == before + 1
    again = sp.fk_rows(mc, state)
    want = sp.fk_rows_plain(mc, state)
    torch.cuda.synchronize()
    assert got.shape == (3 * mc.nc, num)
    assert torch.equal(got, want) and torch.equal(got, again)


def test_wrapper_rejects_bad_rows(rows):
    mc, (state, ctrl, surf) = rows
    with pytest.raises(ValueError, match="contiguous"):
        sp.fk_rows(mc, state.t().contiguous().t())
    with pytest.raises(ValueError, match="ctrl_rows"):
        sp.rollout_step(mc, state, ctrl[:-1], surf, True, (0.0,) * 6, 0.5,
                        "P", 0.005, 9.81)


# ---------------------------------------- kernels of dynamics.step_batched

@pytest.fixture(scope="module", params=ROBOTS)
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


def _assert_substep_close(mc, got, want):
    """Within the tolerances of tests/test_pallas_substep.py:50-60 (kernel
    vs reference), and bit for bit."""
    o_qvel, o_force = 13 + mc.nj, 13 + 2 * mc.nj
    torch.testing.assert_close(got[:7], want[:7], atol=2e-5, rtol=0)
    torch.testing.assert_close(got[7:13], want[7:13], atol=3e-4, rtol=3e-4)
    torch.testing.assert_close(got[13:o_qvel], want[13:o_qvel], atol=2e-5,
                               rtol=0)
    torch.testing.assert_close(got[o_qvel:o_force], want[o_qvel:o_force],
                               atol=1e-3, rtol=3e-4)
    torch.testing.assert_close(got[o_force:], want[o_force:], atol=0.1,
                               rtol=1e-3)
    assert torch.equal(got, want)


@pytest.mark.parametrize("surface", [True, False])
def test_substep_kernel_matches_plain(substep_rows, surface):
    mc, (rows, surf) = substep_rows
    s = surf if surface else None
    before = profiling.counter("kernel.substep")
    got = sp.step_rows(mc, rows, s, 0.005, 9.81)
    assert profiling.counter("kernel.substep") == before + 1
    want = sp.step_rows_plain(mc, rows, s, 0.005, 9.81)
    torch.cuda.synchronize()
    _assert_substep_close(mc, got, want)


@pytest.mark.parametrize("num", RAGGED)
def test_substep_kernel_matches_plain_on_ragged_batches(substep_rows, num):
    mc, parts = substep_rows
    rows, surf = (_columns(t, num) for t in parts)
    got = sp.step_rows(mc, rows, surf, 0.005, 9.81)
    again = sp.step_rows(mc, rows, surf, 0.005, 9.81)
    want = sp.step_rows_plain(mc, rows, surf, 0.005, 9.81)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, again)
    _assert_substep_close(mc, got, want)


def test_substep_kernels_fit_an_sm(substep_rows):
    """The block's slabs fit in shared memory, and an SM holds a warp of
    each kernel (the two sphere FK kernels' too)."""
    from pointfoot_tpu_torch.ops.cuda import build

    lib = build.load(substep_rows[0])
    assert 0 < lib.lib.pf_substep_smem_bytes() <= 232448
    assert lib.lib.pf_substep_resident_warps(0) >= 1
    assert lib.lib.pf_substep_resident_warps(1) >= 1
    assert lib.lib.pf_fk_xy_resident_warps() >= 1
    assert lib.lib.pf_fk_xyz_resident_warps() >= 1


@pytest.mark.parametrize("num", [B, *RAGGED])
def test_fk_xy_kernel_matches_plain(substep_rows, num):
    """Bit-identical to the plain version, as the xyz kernel that shares
    its walk; 1 and 4099 envs leave the last block with idle groups, and
    two launches agree bit for bit."""
    mc, (rows, _) = substep_rows
    fk_in = _columns(torch.cat([rows[:7], rows[13:13 + mc.nj]]), num)
    before = profiling.counter("kernel.fk_contact_xy")
    got = sp.fk_xy_rows(mc, fk_in)
    assert profiling.counter("kernel.fk_contact_xy") == before + 1
    again = sp.fk_xy_rows(mc, fk_in)
    want = sp.fk_xy_rows_plain(mc, fk_in)
    torch.cuda.synchronize()
    assert got.shape == (2 * mc.nc, num) and torch.equal(got, again)
    assert torch.equal(got, want)


@pytest.mark.parametrize("num", [1, B, 2048, 4099])
@pytest.mark.parametrize("n", [12, 18])
def test_cholesky_kernel_matches_plain(n, num):
    """Bit-identical to the plain version (same operations in the same
    order) and across two launches; within the tolerance of
    tests/test_pallas.py:24 of a float64 solve.  1, 1000 and 4099 systems
    leave the last block with idle groups."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pointfoot_tpu_torch.ops.cuda import build, cholesky

    rng = np.random.default_rng(n + num)
    A = rng.normal(size=(num, n, n)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    b = rng.normal(size=(num, n)).astype(np.float32)
    dev = torch.device("cuda")
    A_t = torch.tensor(A.reshape(num, n * n).T.copy(), device=dev)
    b_t = torch.tensor(b.T.copy(), device=dev)
    before = profiling.counter("kernel.chol_solve")
    x_t = cholesky.chol_solve_lanes(A_t, b_t)
    assert profiling.counter("kernel.chol_solve") == before + 1
    again = cholesky.chol_solve_lanes(A_t, b_t)
    want = cholesky.chol_solve_lanes_plain(A_t, b_t)
    torch.cuda.synchronize()
    assert x_t.shape == (n, num)
    assert torch.equal(x_t, want) and torch.equal(x_t, again)
    x = torch.linalg.solve(torch.tensor(A, dtype=torch.float64),
                           torch.tensor(b, dtype=torch.float64))
    torch.testing.assert_close(x_t.t().cpu().double(), x, atol=3e-3,
                               rtol=3e-3)
    lib = build.load_cholesky().lib
    assert lib.pf_chol_lanes(n) in (4, 8, 16)
    assert 0 < lib.pf_chol_smem_bytes(n) <= 48 * 1024
    assert lib.pf_chol_resident_warps(n) >= 4
    with pytest.raises(ValueError, match="no kernel for n = 7"):
        cholesky.chol_solve_lanes(A_t[:49].contiguous(), b_t[:7].contiguous())


# ------------------------------------------------- the SRB-LQR kernel

@pytest.mark.parametrize("num", [B, 4096, *RAGGED])
@pytest.mark.parametrize("m", [6, 12])
def test_srb_lqr_kernel_matches_plain(m, num):
    """Tolerance of tests/test_pallas.py:77-78; 1 and 4099 scenarios leave
    the last block with idle groups."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pointfoot_tpu_torch.ops.cuda import riccati

    T = 12
    dev = torch.device("cuda")
    prob = [torch.tensor(a, device=dev) for a in srb_lqr_problem(num, m, m)]
    staged = riccati.stage(*prob)
    before = profiling.counter("kernel.srb_lqr")
    got = riccati.srb_lqr_lanes(*staged, T)
    assert profiling.counter("kernel.srb_lqr") == before + 1
    want = riccati.srb_lqr_lanes_plain(*staged, T)
    torch.cuda.synchronize()
    assert got.shape == (T, m, num)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    # and through the (B, ...) entry, against the CPU's plain version
    out = riccati.srb_lqr(*prob, horizon=T)
    assert out.shape == (num, T, m)
    cpu = riccati.srb_lqr(*(a.cpu() for a in prob), horizon=T)
    torch.testing.assert_close(out.cpu(), cpu, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("T, shared", [(1, True), (12, True), (96, False)])
@pytest.mark.parametrize("m", [6, 12])
def test_srb_lqr_kernel_in_both_homes_of_the_gains(m, T, shared):
    """The gains stay in shared memory at horizons 1 and 12 and go to the
    global work space at 96; the kernel matches its plain version in both,
    and two launches agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pointfoot_tpu_torch.ops.cuda import build, riccati

    nbytes, in_shared = riccati.smem_plan(m, T)
    assert in_shared == shared
    lib = build.load_riccati().lib
    assert lib.pf_srb_lqr_smem_bytes(m, T, int(shared)) == nbytes
    assert lib.pf_srb_lqr_resident_warps(m, T, int(shared)) >= 4
    dev = torch.device("cuda")
    staged = riccati.stage(*(torch.tensor(a, device=dev)
                             for a in srb_lqr_problem(B + 3, m, m + T)))
    got = riccati.srb_lqr_lanes(*staged, T)
    again = riccati.srb_lqr_lanes(*staged, T)
    want = riccati.srb_lqr_lanes_plain(*staged, T)
    torch.cuda.synchronize()
    assert got.shape == (T, m, B + 3) and torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)


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


# ------------------------------------------- forward-only, as the TPU's

def _grad_cases():
    """(the wrapper's launch counter, a call of it with one input scaled
    by g) for each of the six wrappers, on CUDA inputs of the fixtures'
    kinds."""
    from pointfoot_tpu_torch.ops.cuda import cholesky, riccati

    dev = torch.device("cuda")
    mc = sp.model_consts(get_model("pointfoot"))
    nj, nc = mc.nj, mc.nc
    rng = np.random.default_rng(4)
    num = 64

    def rand(rows):
        return torch.tensor(rng.standard_normal((rows, num)),
                            dtype=torch.float32, device=dev)

    state = rand(sp._rows(sp.state_layout(nj)))
    state[3:7] = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)[:, None]
    ctrl = rand(sp._rows(sp.ctrl_layout(nj, nc)))
    sub_in = torch.cat([state[:13 + 2 * nj],
                        rand(sp._rows(sp.substep_in_layout(nj, nc))
                             - 13 - 2 * nj)])
    fk_in = torch.cat([state[:7], state[13:13 + nj]])
    M = torch.randn(num, 12, 12, device=dev)
    A = M @ M.transpose(1, 2) + 12 * torch.eye(12, device=dev)
    A_t = A.reshape(num, 144).t().contiguous()
    b_t = rand(12)
    staged = riccati.stage(*(torch.tensor(a, device=dev)
                             for a in srb_lqr_problem(num, 6, 0)))
    qdef = (0.0,) * nj
    return {
        "rollout_step": ("kernel.rollout_substep", lambda g: sp.rollout_step(
            mc, state, (ctrl * g).contiguous(), None, True, qdef, 0.5, "P",
            0.005, 9.81)),
        "fk_rows": ("kernel.fk_from_state",
                    lambda g: sp.fk_rows(mc, (state * g).contiguous())),
        "step_rows": ("kernel.substep", lambda g: sp.step_rows(
            mc, (sub_in * g).contiguous(), None, 0.005, 9.81)),
        "fk_xy_rows": ("kernel.fk_contact_xy", lambda g: sp.fk_xy_rows(
            mc, (fk_in * g).contiguous())),
        "chol_solve_lanes": ("kernel.chol_solve",
                             lambda g: cholesky.chol_solve_lanes(
                                 A_t, (b_t * g).contiguous())),
        "srb_lqr_lanes": ("kernel.srb_lqr",
                          lambda g: riccati.srb_lqr_lanes(
                              (staged[0] * g).contiguous(), *staged[1:], 4)),
    }


@pytest.mark.parametrize("name", ["rollout_step", "fk_rows", "step_rows",
                                  "fk_xy_rows", "chol_solve_lanes",
                                  "srb_lqr_lanes"])
def test_wrapper_refuses_grad_and_runs_under_no_grad(name):
    """A CUDA input that requires grad raises (the kernel has no backward
    pass, as its TPU kernel has none) and launches nothing; under no_grad
    the same call launches the kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    launches, call = _grad_cases()[name]
    g = torch.ones(1, device="cuda", requires_grad=True)
    before = profiling.counter(launches)
    with pytest.raises(RuntimeError, match="has no backward pass"):
        call(g)
    assert profiling.counter(launches) == before
    with torch.no_grad():
        out = call(g)
    torch.cuda.synchronize()
    assert profiling.counter(launches) == before + 1
    first = out[0] if isinstance(out, tuple) else out
    assert first.grad_fn is None and not first.requires_grad


@pytest.mark.parametrize("name", ["rollout_step", "fk_rows", "step_rows",
                                  "fk_xy_rows", "chol_solve_lanes",
                                  "srb_lqr_lanes"])
def test_wrapper_refuses_a_forward_tangent(name):
    """A CUDA input carrying a forward-mode tangent raises, under no_grad
    too (the kernel would drop the tangent), and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.autograd.forward_ad as fwAD

    launches, call = _grad_cases()[name]
    before = profiling.counter(launches)
    with fwAD.dual_level(), torch.no_grad():
        g = fwAD.make_dual(torch.ones(1, device="cuda"),
                           torch.ones(1, device="cuda"))
        with pytest.raises(RuntimeError, match="forward-mode tangent"):
            call(g)
    assert profiling.counter(launches) == before


# ------------------------------------------ the gait-MPC and iLQR paths

def test_gait_tick_solves_with_the_srb_lqr_kernel():
    """The PointFoot gait tick's frozen-contact solve on the card is kernel
    6, one launch a tick; its first force equals sequential_srb_lqr's on
    the same problems within rtol/atol 2e-3 (tests/test_pallas.py:77-78)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pointfoot_tpu_torch.mpc import gait, srb
    from pointfoot_tpu_torch.ops.cuda import riccati
    from pointfoot_tpu_torch.physics.model import PhysicsState

    stack = gait.make_controller("pointfoot", device="cuda")
    ctrl = stack.ctrl
    num = 1000
    g = torch.Generator(device="cuda").manual_seed(0)
    phys = PhysicsState.default(ctrl.model, stack.q0, num, "cuda",
                                base_height=stack.z0)
    phys = phys.replace(
        base_lin_vel=0.15 * torch.randn(num, 3, generator=g, device="cuda"),
        base_ang_vel=0.15 * torch.randn(num, 3, generator=g, device="cuda"))
    gs = ctrl.init(num, phys)
    cmd = torch.tensor([0.4, 0.0, 0.0], device="cuda").expand(num, 3)
    prob = ctrl.srb_tick_problem(phys, ctrl.placement(phys, cmd, gs))
    before = profiling.counter("kernel.srb_lqr")
    f0 = ctrl.solve_first_force(prob)
    want = srb.sequential_srb_lqr(*prob, horizon=ctrl.srb.horizon)[0][:, 0]
    torch.cuda.synchronize()
    assert profiling.counter("kernel.srb_lqr") == before + 1
    torch.testing.assert_close(f0, want, rtol=2e-3, atol=2e-3)
    tau, gs = ctrl.control(phys, cmd, gs)
    torch.cuda.synchronize()
    assert profiling.counter("kernel.srb_lqr") == before + 2
    assert bool(torch.isfinite(tau).all())


def test_mpc_dyn_refuses_tangents_and_dyn_plain_carries_them():
    """The planner's rollout dynamics take the kernel routes on the card
    (256 scenarios replicated 30 times: the mega route), which refuse a
    forward-mode tangent; its plain dynamics carry one, so the
    linearization differentiates on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pointfoot_tpu_torch import bench
    from pointfoot_tpu_torch.mpc import ilqr

    ctrl, phys, _, _ = bench.make_mpc_ilqr(256, torch.device("cuda"))
    from pointfoot_tpu_torch.mpc.costs import state_to_vec

    x = state_to_vec(phys)
    u = torch.zeros(256, 6, device="cuda")
    jac = ilqr.dynamics_jacobian(ctrl.dyn_plain, x[:4], u[:4])
    assert jac.shape == (4, 24, 30) and bool(torch.isfinite(jac).all())
    with pytest.raises(RuntimeError, match="forward-mode tangent"):
        ilqr.dynamics_jacobian(ctrl.dyn, x, u)
