"""Riccati solvers of the PyTorch port against the JAX package's, on the CPU:
the fused SRB-LQR solve (ops/cuda/riccati.py, its plain version here) and
mpc/riccati.py function by function.  Inputs are made with numpy from a
seed and handed to both; tolerances are those of the JAX package's own
tests and are stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointfoot_tpu.mpc import riccati as jric
from pointfoot_tpu_torch.mpc import riccati as tric
from pointfoot_tpu_torch.ops.cuda import riccati as rk

from _torch_parity import srb_lqr_problem

# tiny tensors: intra-op threads only add contention between test workers
torch.set_num_threads(1)

T_SRB = 5


def _xla_srb_lqr(F, c, L, Xd, Ud, XTd, x0, f_ff, T):
    """Reference: sequential Riccati + gain rollout, the helper of
    tests/test_pallas.py:27-53."""

    def one(F1, c1, L1, Xd1, Ud1, XTd1, x01, fff1):
        n = F1.shape[0]
        X = jnp.diag(Xd1)
        U = jnp.diag(Ud1)
        Fs = jnp.broadcast_to(F1, (T, n, n))
        cs = jnp.broadcast_to(c1, (T, n))
        Ls = jnp.broadcast_to(L1, (T,) + L1.shape)
        Xs = jnp.broadcast_to(X, (T, n, n))
        Us = jnp.broadcast_to(U, (T,) + U.shape)
        Ps, ps = jric.sequential_lqr_value(Fs, cs, Ls, Xs, Us,
                                           jnp.diag(XTd1))

        def rollout(x, t):
            K, d = jric.lqr_gains_from_value(F1, c1, L1, U, Ps[t + 1],
                                             ps[t + 1])
            du = -K @ x - d
            f = fff1 + du
            return F1 @ x + c1 + L1 @ du, f

        _, fs = jax.lax.scan(rollout, x01, jnp.arange(T))
        return fs

    return jax.vmap(one)(F, c, L, Xd, Ud, XTd, x0, f_ff)


_REFERENCE = jax.jit(_xla_srb_lqr, static_argnums=8)


@pytest.fixture(scope="module", params=[6, 12])
def srb(request):
    m = request.param
    prob = srb_lqr_problem(8, m)
    ref = np.asarray(_REFERENCE(*map(jnp.asarray, prob), T_SRB))
    return m, prob, ref


@pytest.mark.parametrize("B", [8, 5])
def test_srb_lqr_matches_jax_sequential(srb, B):
    """rtol = atol = 2e-3 (tests/test_pallas.py:77-78); B = 5 is a batch
    that fills no block."""
    m, prob, ref = srb
    got = rk.srb_lqr(*(torch.from_numpy(a[:B]) for a in prob),
                     horizon=T_SRB)
    assert got.shape == (B, T_SRB, m)
    np.testing.assert_allclose(got.numpy(), ref[:B], rtol=2e-3, atol=2e-3)


def test_srb_lqr_lanes_is_plain_on_cpu(srb):
    m, prob, _ = srb
    staged = rk.stage(*(torch.from_numpy(a) for a in prob))
    assert [tuple(t.shape) for t in staged] == [
        (144, 8), (12, 8), (12 * m, 8), (12, 8), (m, 8), (12, 8), (12, 8),
        (m, 8)]
    before = rk.srb_lqr_lanes.launches
    got = rk.srb_lqr_lanes(*staged, T_SRB)
    want = rk.srb_lqr_lanes_plain(*staged, T_SRB)
    assert rk.srb_lqr_lanes.launches == before  # no kernel on the CPU
    assert torch.equal(got, want)
    assert got.shape == (T_SRB, m, 8)


def test_stage_floors_the_input_cost():
    prob = [torch.from_numpy(a) for a in srb_lqr_problem(4, 6)]
    prob[4] = torch.zeros_like(prob[4])
    assert float(rk.stage(*prob)[4].min()) == pytest.approx(1e-8)
    assert bool(torch.isfinite(rk.srb_lqr(*prob, horizon=3)).all())


def test_srb_lqr_lanes_rejects_mismatched_rows(srb):
    _, prob, _ = srb
    staged = list(rk.stage(*(torch.from_numpy(a) for a in prob)))
    staged[2] = staged[2][:-1]
    with pytest.raises(ValueError, match="L_t"):
        rk.srb_lqr_lanes(*staged, T_SRB)


@pytest.mark.slow
def test_srb_lqr_matches_pallas_interpret():
    """The port's solve against the TPU kernel in interpret mode."""
    from pointfoot_tpu.ops.pallas.riccati import pallas_srb_lqr

    prob = srb_lqr_problem(8, 6)
    want = np.asarray(pallas_srb_lqr(*map(jnp.asarray, prob),
                                     horizon=T_SRB, interpret=True))
    got = rk.srb_lqr(*map(torch.from_numpy, prob), horizon=T_SRB)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


# ----------------------------------------------------------- mpc/riccati.py

def _t(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


@pytest.fixture(scope="module")
def lqr():
    """Inputs of tests/test_mpc.py:13-22."""
    rng = np.random.default_rng(0)
    T, n, m = 17, 4, 2
    F = 0.9 * np.stack([np.eye(n) + 0.05 * rng.normal(size=(n, n))
                        for _ in range(T)])
    c = 0.01 * rng.normal(size=(T, n))
    L = 0.1 * rng.normal(size=(T, n, m))
    X = np.broadcast_to(np.eye(n) * 0.5, (T, n, n))
    U = np.broadcast_to(np.eye(m) * 0.2, (T, m, m))
    XT = np.eye(n) * 2.0
    return F, c, L, X, U, XT


def test_sequential_lqr_value_matches_jax(lqr):
    Ps, ps = tric.sequential_lqr_value(*_t(*lqr))
    Pj, pj = jric.sequential_lqr_value(*_j(*lqr))
    assert Ps.shape == (18, 4, 4) and ps.shape == (18, 4)
    np.testing.assert_allclose(Ps.numpy(), np.asarray(Pj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ps.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-5)


def test_parallel_lqr_value_matches_jax(lqr):
    """The scan against JAX's, and against the sequential recursion at the
    tolerances of tests/test_mpc.py:27-30."""
    el = tric.make_elements(*_t(*lqr))
    ej = jric.make_elements(*_j(*lqr))
    for name, a, b in zip(tric.LQRElement._fields, el, ej):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    Pp, pp = tric.parallel_lqr_value(el)
    Pj, pj = jric.parallel_lqr_value(ej)
    np.testing.assert_allclose(Pp.numpy(), np.asarray(Pj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), rtol=1e-4,
                               atol=1e-4)
    Ps, ps = tric.sequential_lqr_value(*_t(*lqr))
    np.testing.assert_allclose(Pp.numpy(), Ps.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(pp.numpy(), ps.numpy(), rtol=1e-3, atol=2e-3)


def test_lqr_gains_from_value_matches_jax(lqr):
    F, c, L, X, U, XT = lqr
    Pj, pj = jric.sequential_lqr_value(*_j(*lqr))
    Pn, pn = np.asarray(Pj)[1:], np.asarray(pj)[1:]
    K, d = tric.lqr_gains_from_value(*_t(F, c, L, U, Pn, pn))
    Kj, dj = jric.lqr_gains_from_value(*_j(F, c, L, U, Pn, pn))
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-6)


def test_sequential_lqr_value_takes_a_batch(lqr):
    """Batch dimensions between time and the matrices, as mpc/srb.py calls
    it: each scenario equals its own unbatched solve."""
    F, c, L, X, U, XT = _t(*lqr)
    scale = (1.0, 0.5, 2.0)

    def shared(a):
        return a[:, None].expand((a.shape[0], 3) + a.shape[1:])

    Ps, ps = tric.sequential_lqr_value(
        shared(F), torch.stack([c * s for s in scale], dim=1), shared(L),
        torch.stack([X * s for s in scale], dim=1), shared(U),
        torch.stack([XT * s for s in scale]))
    assert Ps.shape == (18, 3, 4, 4) and ps.shape == (18, 3, 4)
    for b in range(3):
        P1, p1 = tric.sequential_lqr_value(F, c * scale[b], L,
                                           X * scale[b], U, XT * scale[b])
        torch.testing.assert_close(Ps[:, b], P1, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(ps[:, b], p1, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def lqt():
    """Inputs of tests/test_mpc.py:183-194."""
    rng = np.random.default_rng(0)
    T, n, m = 6, 3, 2
    F = rng.normal(size=(T, n, n)) * 0.4 + np.eye(n)
    c = rng.normal(size=(T, n)) * 0.1
    L = rng.normal(size=(T, n, m))
    X = np.stack([np.eye(n) * (1 + i * 0.1) for i in range(T)])
    q = rng.normal(size=(T, n)) * 0.3
    U = np.stack([np.eye(m) * 2.0] * T)
    r = rng.normal(size=(T, m)) * 0.3
    M = rng.normal(size=(T, m, n)) * 0.2
    XT = np.eye(n) * 3.0
    qT = rng.normal(size=n) * 0.3
    return F, c, L, X, q, U, r, M, XT, qT


@pytest.mark.parametrize("fn", ["sequential_lqt_value", "parallel_lqt_value"])
def test_lqt_value_matches_jax(lqt, fn):
    """Each LQT recursion against its JAX function (1e-4, the tolerance of
    tests/test_mpc.py:198-201 between the two)."""
    P, p = getattr(tric, fn)(*_t(*lqt))
    Pj, pj = getattr(jric, fn)(*_j(*lqt))
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-4,
                               atol=1e-4)


def test_lqt_parallel_matches_sequential_and_gains(lqt):
    Ps, ps = tric.sequential_lqt_value(*_t(*lqt))
    Pp, pp = tric.parallel_lqt_value(*_t(*lqt))
    np.testing.assert_allclose(Pp.numpy(), Ps.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pp.numpy(), ps.numpy(), rtol=1e-4, atol=1e-4)
    F, c, L, X, q, U, r, M, XT, qT = lqt
    args = (F[0], c[0], L[0], U[0], r[0], M[0], Ps[1].numpy(),
            ps[1].numpy())
    K, d = tric.lqt_gains_from_value(*_t(*args))
    Kj, dj = jric.lqt_gains_from_value(*_j(*args))
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-4,
                               atol=1e-5)


def test_parallel_backward_pass_matches_jax():
    """The linearization of tests/test_mpc.py:240-256 through the port's
    parallel_backward_pass and the JAX package's (rtol 1e-3, the tolerance
    of tests/test_mpc.py:261-266)."""
    from pointfoot_tpu.mpc import ilqr

    T, m = 12, 1
    dt = 0.05

    def dyn(x, u):
        th, om = x[0], x[1]
        return jnp.asarray([th + dt * om, om + dt * (jnp.sin(th) + u[0])])

    def cost_fn(x, u, t):
        return 0.5 * (x @ x) + 0.05 * (u @ u) + 0.01 * x[0] * u[0]

    x0 = jnp.asarray([2.5, 0.0])
    us = 0.1 * jnp.ones((T, m))
    xs = ilqr._rollout(dyn, x0, us)
    lin = ilqr._linearize(dyn, cost_fn, xs, us, T)
    reg = 1e-7
    want = jric.parallel_backward_pass(*lin, reg)
    got = tric.parallel_backward_pass(*_t(*lin), reg)
    for name, g, w, atol in zip(("Ks", "ks", "dV"), got, want,
                                (1e-4, 1e-4, 1e-5)):
        assert tuple(g.shape) == np.asarray(w).shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 13])
def test_associative_scan_is_an_inclusive_scan(n):
    """Against a running sum and a running matrix product (which does not
    commute), for even and odd lengths."""
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.normal(size=(n, 3)))
    M = torch.from_numpy(np.eye(2) + 0.3 * rng.normal(size=(n, 2, 2)))
    got_a, got_M = tric.associative_scan(
        lambda x, y: (x[0] + y[0], y[1] @ x[1]), (a, M))
    torch.testing.assert_close(got_a, torch.cumsum(a, 0))
    want, acc = [], torch.eye(2, dtype=M.dtype)
    for i in range(n):
        acc = M[i] @ acc
        want.append(acc)
    torch.testing.assert_close(got_M, torch.stack(want))
