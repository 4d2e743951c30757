"""The full-model iLQR of the PyTorch port (mpc/costs.py, mpc/ilqr.py,
mpc/controller.py) against the JAX package's, on the CPU.

Inputs are made with numpy from seeds and go through both packages.  The
pointfoot dynamics are differentiated at moving states off the identity,
where JAX's Jacobian is finite: at rest and at an exactly upright moving
state JAX's is NaN (`test_reference_jacobian_nan_at_rest_and_upright`),
the port's is finite.  JAX's `MPCController.plan` is not jitted (its CPU
compile alone outlasts a test file); one pointfoot plan is held to a JAX
reference assembled from JAX's jitted `_rollout`, `_linearize`,
`backward_pass` and `_forward_pass`, with the same control flow.
Tolerances are stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointfoot_tpu.mpc import costs as jcosts
from pointfoot_tpu.mpc import ilqr as jilqr
from pointfoot_tpu.mpc import riccati as jriccati
from pointfoot_tpu.mpc.controller import MPCController as JMPC
from pointfoot_tpu.physics.assets import get_model as jget_model
from pointfoot_tpu.physics.model import PhysicsParams as JParams
from pointfoot_tpu.physics.model import PhysicsState as JState
from pointfoot_tpu_torch.mpc import costs, ilqr
from pointfoot_tpu_torch.mpc.controller import MPCController, MPCState
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
from pointfoot_tpu_torch.terrain import analytic
from pointfoot_tpu_torch.utils import convert


# tiny tensors: intra-op threads only add contention between test workers
torch.set_num_threads(1)

NJ, NX = 6, 24
QDEF = np.zeros(NJ, np.float32)
T = 3  # the pointfoot horizon of these tests
B = 2  # pointfoot scenarios
JFLAT = lambda x, y: jnp.zeros_like(jnp.asarray(x, jnp.float32))  # noqa: E731

# float32 cost terms of up to ~1e3 summed over a few rows
COST_RTOL = 1e-5
# Jacobian entries, each block held to a share of its largest |entry|: the
# port differentiates in forward mode, JAX in reverse, through ~3k float32
# operations of the contact step (measured: 5e-5 of the largest entry)
JAC_TOL = 1e-3


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _chart_rows(rng, num, rot=0.05, vel=0.3, height=0.62):
    """`num` chart rows [pos, rotvec, qpos, lin, ang, qvel] near standing,
    off the identity and moving."""
    x = np.zeros((num, NX), np.float32)
    x[:, 0:2] = 0.05 * rng.standard_normal((num, 2))
    x[:, 2] = height + 0.01 * rng.standard_normal(num)
    x[:, 3:6] = rot * rng.standard_normal((num, 3))
    x[:, 6:12] = 0.1 * rng.standard_normal((num, NJ))
    x[:, 12:15] = vel * rng.standard_normal((num, 3))
    x[:, 15:18] = vel * rng.standard_normal((num, 3))
    x[:, 18:24] = 3 * vel * rng.standard_normal((num, NJ))
    return x


# ------------------------------------------------------------ the chart

def test_state_chart_matches_jax():
    rng = np.random.default_rng(0)
    jm = jget_model("pointfoot")
    n = 5
    q = np.array([0.0, 0.0, 0.0, 1.0]) + 0.2 * rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    state = dict(
        base_pos=f32(rng.standard_normal((n, 3))), base_quat=f32(q),
        base_lin_vel=f32(rng.standard_normal((n, 3))),
        base_ang_vel=f32(rng.standard_normal((n, 3))),
        qpos=f32(rng.standard_normal((n, NJ))),
        qvel=f32(rng.standard_normal((n, NJ))),
        contact_force=np.zeros((n, 9, 3), np.float32))
    js = JState(**{k: jnp.asarray(v) for k, v in state.items()})
    want = np.asarray(jax.vmap(jcosts.state_to_vec)(js))
    got = costs.state_to_vec(convert.physics_state_from_numpy(state))
    # rotvec from atan2 and a norm: a few float32 ulps
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    template = PhysicsState.default(get_model("pointfoot"), QDEF, 1, "cpu")
    back = costs.vec_to_state(got, template, NJ)
    jt = JState.default(jm, QDEF)
    jback = jax.vmap(lambda x: jcosts.vec_to_state(x, jt, NJ))(
        jnp.asarray(want))
    for f in ("base_pos", "base_quat", "qpos", "base_lin_vel",
              "base_ang_vel", "qvel", "contact_force"):
        np.testing.assert_allclose(getattr(back, f).numpy(),
                                   np.asarray(getattr(jback, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    # the round trip recovers the quaternion (up to its sign)
    np.testing.assert_allclose(back.base_quat.numpy(),
                               q * np.sign(q[:, 3:]), atol=1e-6)


# ---------------------------------------------------- the stage cost

@pytest.fixture(scope="module")
def cost_rig():
    """Perturbed rows with commands, terminal and stage times, and JAX's
    cost, gradient and Hessian of each row (one jit)."""
    rng = np.random.default_rng(1)
    n = 6
    x = _chart_rows(rng, n)
    u = (10.0 * rng.standard_normal((n, NJ))).astype(np.float32)
    cmd = (0.5 * rng.standard_normal((n, 3))).astype(np.float32)
    t = np.array([0, 1, 2, T, 1, T], np.int32)
    jm = jget_model("pointfoot")
    w = jcosts.CostWeights(base_height=50.0)

    def one(z, tt, c):
        fn = jcosts.pointfoot_stage_cost(jm, w, QDEF, c, T)
        f = lambda zz: fn(zz[:NX], zz[NX:], tt)  # noqa: E731
        return f(z), jax.grad(f)(z), jax.hessian(f)(z)

    z = np.concatenate([x, u], axis=-1)
    c, g, H = jax.jit(jax.vmap(one))(jnp.asarray(z), jnp.asarray(t),
                                     jnp.asarray(cmd))
    return dict(x=x, u=u, cmd=cmd, t=t, z=z, w=w, c=np.asarray(c),
                g=np.asarray(g), H=np.asarray(H))


def _port_cost(rig, command):
    w = costs.CostWeights(**vars(rig["w"]))
    return costs.pointfoot_stage_cost(get_model("pointfoot"), w, QDEF,
                                      command, T)


def test_cost_weights_defaults_match_jax():
    assert vars(costs.CostWeights()) == vars(jcosts.CostWeights())


def test_stage_cost_rows_match_jax(cost_rig):
    """One row at a time (command (3,)) and all rows at once (command
    (n, 3) lined up with the rows)."""
    r = cost_rig
    for i in range(len(r["t"])):
        fn = _port_cost(r, _t(r["cmd"][i]))
        got = fn(_t(r["x"][i]), _t(r["u"][i]), torch.tensor(r["t"][i]))
        np.testing.assert_allclose(float(got), r["c"][i], rtol=COST_RTOL)
    fn = _port_cost(r, _t(r["cmd"]))
    got = fn(_t(r["x"]), _t(r["u"]), torch.from_numpy(r["t"]))
    np.testing.assert_allclose(got.numpy(), r["c"], rtol=COST_RTOL)


def test_stage_cost_derivatives_match_jax(cost_rig):
    """`torch.func` of one row, and ilqr.cost_derivatives over a batch of
    rows (the gradient of the sum, the Hessian by forward-over-reverse),
    against jax.grad / jax.hessian; each held to 1e-4 of its largest entry
    (float32 derivatives of terms of up to ~1e3)."""
    r = cost_rig
    n = len(r["t"])
    g_tol = 1e-4 * np.abs(r["g"]).max()
    H_tol = 1e-4 * np.abs(r["H"]).max()
    for i in (0, 3):
        fn = _port_cost(r, _t(r["cmd"][i]))
        t = torch.tensor(r["t"][i])

        def f(z):
            return fn(z[:NX], z[NX:], t)

        z = _t(r["z"][i])
        np.testing.assert_allclose(torch.func.grad(f)(z).numpy(), r["g"][i],
                                   rtol=0, atol=g_tol)
        np.testing.assert_allclose(torch.func.hessian(f)(z).numpy(),
                                   r["H"][i], rtol=0, atol=H_tol)
    # the batched form: rows (n, 1, N) of n scenarios, one time each
    fn = _port_cost(r, _t(r["cmd"]))
    g, H = ilqr.cost_derivatives(fn, _t(r["z"])[:, None],
                                 torch.from_numpy(r["t"])[:, None], NX)
    assert g.shape == (n, 1, NX + NJ) and H.shape == (n, 1, NX + NJ, NX + NJ)
    np.testing.assert_allclose(g[:, 0].numpy(), r["g"], rtol=0, atol=g_tol)
    np.testing.assert_allclose(H[:, 0].numpy(), r["H"], rtol=0, atol=H_tol)


# ------------------------------------------- the pointfoot linearization

def _controllers(cfg_kw, weights_kw=None, substeps=1):
    jm = jget_model("pointfoot")
    jw = jcosts.CostWeights(**(weights_kw or {}))
    jcfg = jilqr.ILQRConfig(**cfg_kw)
    jctrl = JMPC(jm, JParams.nominal(jm), JFLAT, QDEF, weights=jw, cfg=jcfg,
                 dt=0.02, substeps=substeps)
    m = get_model("pointfoot")
    tctrl = MPCController(m, PhysicsParams.nominal(m, 1, "cpu"),
                          analytic.FLAT, QDEF,
                          weights=costs.CostWeights(**vars(jw)),
                          cfg=ilqr.ILQRConfig(**cfg_kw), dt=0.02,
                          substeps=substeps)
    return jctrl, tctrl


@pytest.fixture(scope="module")
def plan_rig():
    """The pointfoot controllers (horizon 3) and JAX's jitted parts: the
    rollout, the linearization, the backward pass and the line search,
    each vmapped over the scenarios as JAX's plan vmaps ilqr_solve."""
    cfg_kw = dict(horizon=T, iterations=2, reg_init=1.0)
    jctrl, tctrl = _controllers(cfg_kw)
    jm = jctrl.model
    w = jctrl.weights

    def cost_of(cmd):
        return jcosts.pointfoot_stage_cost(jm, w, jctrl.default_qpos, cmd, T)

    alphas = jnp.asarray(jctrl.cfg.alphas)
    parts = dict(
        rollout=jax.jit(jax.vmap(lambda x0, us, cmd: (
            lambda xs: (xs, jilqr._total_cost(cost_of(cmd), xs, us, T)))(
                jilqr._rollout(jctrl.dyn, x0, us)))),
        linearize=jax.jit(jax.vmap(lambda xs, us, cmd: jilqr._linearize(
            jctrl.dyn, cost_of(cmd), xs, us, T))),
        backward=jax.jit(jax.vmap(jilqr.backward_pass)),
        parallel=jax.jit(jax.vmap(jriccati.parallel_backward_pass)),
        forward=jax.jit(jax.vmap(lambda xs, us, Ks, ks, cmd:
                                 jilqr._forward_pass(
                                     jctrl.dyn, cost_of(cmd), xs, us, Ks,
                                     ks, alphas, T))),
    )
    return dict(jctrl=jctrl, tctrl=tctrl, parts=parts)


def _jac_close(got, want, what):
    for name, g, w in zip(("fx", "fu"), got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all(), f"{what} {name}: JAX not finite"
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=JAC_TOL * scale,
                                   err_msg=f"{what} {name}")


def test_linearize_matches_jax(plan_rig):
    """The pointfoot dyn's Jacobian (forward mode over replicated rows) and
    the cost expansion along B x T moving states off the identity, against
    JAX's `_linearize` (jax.jacobian, jax.grad, jax.hessian)."""
    rng = np.random.default_rng(2)
    xs = _chart_rows(rng, B * (T + 1)).reshape(B, T + 1, NX)
    us = (8.0 * rng.standard_normal((B, T, NJ))).astype(np.float32)
    cmd = (0.3 * rng.standard_normal((B, 3))).astype(np.float32)
    want = plan_rig["parts"]["linearize"](jnp.asarray(xs), jnp.asarray(us),
                                          jnp.asarray(cmd))
    tctrl = plan_rig["tctrl"]
    got = ilqr._linearize(tctrl.dyn_plain, tctrl.cost_fn(_t(cmd)), _t(xs),
                          _t(us), T)
    _jac_close(got[:2], want[:2], "moving, off the identity")
    names = ("cx", "cu", "cxx", "cuu", "cux", "cxT", "cxxT")
    for name, g, w in zip(names, got[2:], want[2:]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1.0),
                                   err_msg=name)


def _rest_rows(moving: bool, off: float):
    """B x (T+1) standing chart rows at the identity (`off` = 0) or just
    off it, at rest or moving."""
    x = np.zeros((B, T + 1, NX), np.float32)
    x[..., 2] = 0.62
    x[..., 3] = off
    if moving:
        rng = np.random.default_rng(3)
        x[..., 12:] = 0.2 * rng.standard_normal((B, T + 1, 12))
    else:
        x[..., 12:] = off * 0.1  # slip well inside the 1 mm/s friction floor
    return x


@pytest.mark.parametrize("moving", [False, True],
                         ids=["at_rest", "upright_moving"])
def test_reference_jacobian_nan_at_rest_and_upright(plan_rig, moving):
    """JAX's Jacobian is NaN at an exactly upright state: in every state
    column at rest (the derivative of |v_t| at zero slip,
    physics/contact.py:146), in the rotation columns 3-5 when moving
    (quat.from_rotvec / to_rotvec at the identity).  The port's is finite
    there and equals JAX's just off the identity (rotvec 1e-3) within
    JAC_TOL x 30 of each block's largest entry (the states differ by 1e-3
    rad, and at rest by 1e-4 m/s)."""
    us = np.zeros((B, T, NJ), np.float32)
    cmd = np.zeros((B, 3), np.float32)
    lin = plan_rig["parts"]["linearize"]
    tctrl = plan_rig["tctrl"]
    x_id = _rest_rows(moving, 0.0)
    j_id = lin(jnp.asarray(x_id), jnp.asarray(us), jnp.asarray(cmd))
    fx = np.asarray(j_id[0])
    cols = slice(0, NX) if not moving else slice(3, 6)
    assert np.isnan(fx[..., cols]).all()
    if moving:
        others = np.r_[0:3, 6:NX]
        assert np.isfinite(fx[..., others]).all()
    got = ilqr._linearize(tctrl.dyn_plain, tctrl.cost_fn(_t(cmd)), _t(x_id),
                          _t(us), T)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    x_off = _rest_rows(moving, 1e-3)
    j_off = lin(jnp.asarray(x_off), jnp.asarray(us), jnp.asarray(cmd))
    for name, g, w in zip(("fx", "fu"), got[:2], j_off[:2]):
        w = np.asarray(w)
        assert np.isfinite(w).all(), name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=30 * JAC_TOL * np.abs(w).max(),
                                   err_msg=name)


def test_contact_slip_norm_has_a_finite_tangent_at_zero():
    """The counterpart of physics/contact.py:146 in the port: the norm of a
    zero slip velocity carries a finite forward-mode tangent."""
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        v = fwAD.make_dual(torch.zeros(4, 3), torch.ones(4, 3))
        t = fwAD.unpack_dual(torch.linalg.vector_norm(v, dim=-1)).tangent
    assert bool(torch.isfinite(t).all())


# --------------------------------------- the backward pass and the plan

def _lq_data(rng, batch, T_, n, m):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    fx = np.eye(n, dtype=np.float32) + 0.1 * f(batch, T_, n, n)
    fu = 0.3 * f(batch, T_, n, m)
    cx, cu = f(batch, T_, n), f(batch, T_, m)
    a = f(batch, T_, n, n)
    cxx = (a @ a.transpose(0, 1, 3, 2) / n + np.eye(n)).astype(np.float32)
    b = f(batch, T_, m, m)
    cuu = (b @ b.transpose(0, 1, 3, 2) / m + np.eye(m)).astype(np.float32)
    cux = 0.1 * f(batch, T_, m, n)
    a = f(batch, n, n)
    cxxT = (a @ a.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)
    return fx, fu, cx, cu, cxx, cuu, cux, f(batch, n), cxxT


@pytest.mark.parametrize("reg", [1e-6, 1.0])
def test_backward_pass_matches_jax(reg):
    """Random LQ data of 4 scenarios, horizon 7, n 5, m 3: gains and the
    expected improvement to 1e-4 of each tensor's largest entry."""
    data = _lq_data(np.random.default_rng(4), 4, 7, 5, 3)
    want = jax.jit(jax.vmap(jilqr.backward_pass, in_axes=(0,) * 9 + (None,)))(
        *map(jnp.asarray, data), reg)
    got = ilqr.backward_pass(*map(_t, data), reg)
    for name, g, w in zip(("Ks", "ks", "dV"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def _jax_plan(rig, x0, us0, cmd, parallel: bool):
    """JAX's ilqr_solve, vmapped over scenarios, from its jitted parts with
    ilqr_solve's own control flow (pointfoot_tpu/mpc/ilqr.py:162-195)."""
    p = rig["parts"]
    cfg = rig["jctrl"].cfg
    xs, cost = p["rollout"](x0, us0, cmd)
    us = us0
    reg = jnp.full((x0.shape[0],), cfg.reg_init, jnp.float32)
    improved = None
    for _ in range(cfg.iterations):
        lin = p["linearize"](xs, us, cmd)
        Ks, ks, _ = (p["parallel"] if parallel else p["backward"])(*lin, reg)
        (xs_new, us_new), cost_new = p["forward"](xs, us, Ks, ks, cmd)
        improved = cost_new < cost - 1e-9
        reg = jnp.where(improved, jnp.maximum(reg * 0.5, cfg.reg_min),
                        jnp.minimum(reg * 10.0, cfg.reg_max))
        xs = jnp.where(improved[:, None, None], xs_new, xs)
        us = jnp.where(improved[:, None, None], us_new, us)
        cost = jnp.where(improved, cost_new, cost)
    return xs, us, cost, improved


@pytest.mark.parametrize("parallel", [False, True],
                         ids=["sequential", "parallel"])
def test_mpc_plan_matches_jax(plan_rig, parallel):
    """One MPCController.plan of 2 moving scenarios off the identity,
    horizon 3, with the sequential and the associative-scan backward pass:
    the torque, the shifted warm start and the cost against JAX's parts;
    the improved flags exactly.  Contact makes a solve sensitive to
    roundoff, so torques are held to 1e-3 of the largest control (N·m) and
    costs to rtol 1e-4."""
    rng = np.random.default_rng(5)
    phys_np = dict(
        base_pos=np.array([[0.0, 0.0, 0.63], [0.05, -0.02, 0.61]],
                          np.float32),
        base_quat=np.array([[0.02, -0.01, 0.03, 1.0],
                            [-0.03, 0.02, 0.01, 1.0]], np.float32),
        base_lin_vel=(0.3 * rng.standard_normal((B, 3))).astype(np.float32),
        base_ang_vel=(0.3 * rng.standard_normal((B, 3))).astype(np.float32),
        qpos=(0.1 * rng.standard_normal((B, NJ))).astype(np.float32),
        qvel=(0.5 * rng.standard_normal((B, NJ))).astype(np.float32),
        contact_force=np.zeros((B, 9, 3), np.float32))
    phys_np["base_quat"] /= np.linalg.norm(phys_np["base_quat"], axis=-1,
                                           keepdims=True)
    us0 = (2.0 * rng.standard_normal((B, T, NJ))).astype(np.float32)
    cmd = np.array([[0.3, 0.0, 0.1], [0.0, 0.1, -0.2]], np.float32)
    js = JState(**{k: jnp.asarray(v) for k, v in phys_np.items()})
    x0 = jax.vmap(jcosts.state_to_vec)(js)
    xs_w, us_w, cost_w, imp_w = _jax_plan(plan_rig, x0, jnp.asarray(us0),
                                          jnp.asarray(cmd), parallel)

    ctrl = plan_rig["tctrl"]
    ctrl = MPCController(ctrl.model, ctrl.params, ctrl.height_fn, QDEF,
                         weights=ctrl.weights,
                         cfg=ilqr.ILQRConfig(
                             **{**vars(ctrl.cfg),
                                "parallel_backward": parallel}),
                         dt=ctrl.dt, substeps=ctrl.substeps)
    phys = convert.physics_state_from_numpy(phys_np)
    ms = convert.mpc_state_from_numpy(
        dict(us_warm=us0, last_cost=np.full(B, np.inf, np.float32)))
    sol = ctrl.solve(phys, _t(cmd), ms.us_warm)
    assert sol.improved.tolist() == np.asarray(imp_w).tolist(), (
        f"improved: port {sol.improved.tolist()}, JAX {np.asarray(imp_w)}")
    torque, ms_new, cost = ctrl.plan(phys, _t(cmd), ms)
    us_w = np.asarray(us_w)
    tol = 1e-3 * np.abs(us_w).max()
    np.testing.assert_allclose(torque.numpy(), us_w[:, 0], rtol=0, atol=tol)
    shifted = np.concatenate([us_w[:, 1:], us_w[:, -1:]], axis=1)
    np.testing.assert_allclose(ms_new.us_warm.numpy(), shifted, rtol=0,
                               atol=tol)
    np.testing.assert_allclose(cost.numpy(), np.asarray(cost_w), rtol=1e-4)
    np.testing.assert_allclose(ms_new.last_cost.numpy(), cost.numpy())
    np.testing.assert_allclose(sol.xs.numpy(), np.asarray(xs_w), rtol=0,
                               atol=1e-3 * np.abs(np.asarray(xs_w)).max())


def test_mpc_init_and_chunks():
    """init's warm start and costs; a plan in chunks of 1 equals the plan
    of the whole batch."""
    m = get_model("pointfoot")
    ctrl = MPCController(m, PhysicsParams.nominal(m, 1, "cpu"),
                         analytic.FLAT, QDEF,
                         cfg=ilqr.ILQRConfig(horizon=2, iterations=1))
    ms = ctrl.init(3)
    assert isinstance(ms, MPCState)
    assert ms.us_warm.shape == (3, 2, NJ) and not ms.us_warm.any()
    assert torch.isinf(ms.last_cost).all()
    phys = PhysicsState.default(m, QDEF, 3, "cpu", base_height=0.62)
    phys = phys.replace(base_lin_vel=torch.tensor([[0.1, 0.0, 0.0],
                                                   [0.0, 0.2, 0.0],
                                                   [0.0, 0.0, -0.1]]))
    cmd = torch.zeros(3, 3)
    whole = ctrl.plan(phys, cmd, ms)
    ctrl.chunk = 1
    parts = ctrl.plan(phys, cmd, ms)
    np.testing.assert_allclose(parts[0].numpy(), whole[0].numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(parts[2].numpy(), whole[2].numpy(),
                               rtol=1e-5)


# ------------------------------------- iLQR on analytic systems, both sides

def _di(lib):
    """tests/test_mpc.py:33-55: a double integrator, LQR-exact."""
    dt, horizon = 0.1, 30
    if lib is jnp:
        def dyn(x, u):
            return jnp.asarray([x[0] + dt * x[1], x[1] + dt * u[0]])
    else:
        def dyn(x, u):
            return torch.stack([x[:, 0] + dt * x[:, 1],
                                x[:, 1] + dt * u[:, 0]], dim=-1)

    def cost(x, u, t):
        state = 1.0 * x[..., 0] ** 2 + 0.1 * x[..., 1] ** 2
        return lib.where(t >= horizon, 50.0 * state,
                         state + 0.01 * lib.sum(u ** 2, -1))

    return dyn, cost, dict(horizon=horizon, iterations=8), [[2.0, 0.0]]


def _pendulum(lib):
    """tests/test_mpc.py:58-85: an inverted-pendulum swing-up."""
    dt, horizon = 0.05, 40
    if lib is jnp:
        def dyn(x, u):
            wdot = 9.81 * jnp.sin(x[0]) + u[0]
            return jnp.asarray([x[0] + dt * (x[1] + dt * wdot),
                                x[1] + dt * wdot])
    else:
        def dyn(x, u):
            wdot = 9.81 * torch.sin(x[:, 0]) + u[:, 0]
            return torch.stack([x[:, 0] + dt * (x[:, 1] + dt * wdot),
                                x[:, 1] + dt * wdot], dim=-1)

    def cost(x, u, t):
        state = (lib.cos(x[..., 0]) - 1.0) ** 2 * 10 + 0.1 * x[..., 1] ** 2
        return lib.where(t >= horizon, 10.0 * state,
                         state + 0.001 * lib.sum(u ** 2, -1))

    return (dyn, cost, dict(horizon=horizon, iterations=15, reg_init=1.0),
            [[np.pi - 0.3, 0.0]])


def _batched(lib):
    """tests/test_mpc.py:88-107: 16 double integrators at once."""
    dyn, _, _, _ = _di(lib)
    horizon = 20

    def cost(x, u, t):
        return lib.where(t >= horizon, 10.0 * x[..., 0] ** 2,
                         x[..., 0] ** 2 + 0.01 * lib.sum(u ** 2, -1))

    x0 = [[float(i) / 4 - 2, 0.0] for i in range(16)]
    return dyn, cost, dict(horizon=horizon, iterations=5), x0


def _swing(lib):
    """tests/test_mpc.py:269-294: a pendulum swing-up for the
    associative-scan backward pass against the sequential one."""
    dt = 0.05
    if lib is jnp:
        def dyn(x, u):
            return jnp.asarray([x[0] + dt * x[1],
                                x[1] + dt * (jnp.sin(x[0]) + u[0])])
    else:
        def dyn(x, u):
            return torch.stack([x[:, 0] + dt * x[:, 1],
                                x[:, 1] + dt * (torch.sin(x[:, 0])
                                                + u[:, 0])], dim=-1)

    def cost(x, u, t):
        return 0.5 * lib.sum(x * x, -1) + 0.05 * lib.sum(u * u, -1)

    return dyn, cost, dict(horizon=30, iterations=12), [[2.0, 0.0]]


CASES = {"double_integrator": (_di, False), "pendulum": (_pendulum, False),
         "batched16": (_batched, False), "swing_sequential": (_swing, False),
         "swing_parallel": (_swing, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_ilqr_analytic_cases_match_jax(case):
    """The iLQR cases of tests/test_mpc.py re-run on the port, with their
    own bounds, and held to JAX's ilqr_solve: cost rtol 1e-4, xs and us to
    1e-3 of their largest entry (float32 over 8-15 iterations)."""
    make, parallel = CASES[case]
    jdyn, jcost, cfg_kw, x0 = make(jnp)
    tdyn, tcost, _, _ = make(torch)
    cfg_kw = dict(cfg_kw, parallel_backward=parallel)
    H = cfg_kw["horizon"]
    x0 = np.asarray(x0, np.float32)
    us0 = np.zeros((len(x0), H, 1), np.float32)
    jcfg = jilqr.ILQRConfig(**cfg_kw)
    want = jax.jit(jax.vmap(lambda x, u: jilqr.ilqr_solve(
        jdyn, jcost, x, u, jcfg)))(jnp.asarray(x0), jnp.asarray(us0))
    got = ilqr.ilqr_solve(tdyn, tcost, _t(x0), _t(us0),
                          ilqr.ILQRConfig(**cfg_kw))
    assert got.xs.shape == (len(x0), H + 1, 2)
    assert got.gains_K.shape == (len(x0), H, 1, 2)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=1e-4)
    for name in ("xs", "us"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(),
                                   err_msg=name)
    assert got.improved.tolist() == np.asarray(want.improved).tolist()

    # the JAX tests' own bounds, on the port
    cost = got.cost.numpy()
    if case == "double_integrator":
        assert cost[0] < 27.0
        assert abs(float(got.xs[0, -1, 0])) < 0.05
    elif case == "pendulum":
        init = ilqr._total_cost(tcost, ilqr._rollout(tdyn, _t(x0), _t(us0)),
                                _t(us0), H)
        assert cost[0] < 0.5 * float(init[0])
    elif case == "batched16":
        assert np.all(np.abs(got.xs[:, -1, 0].numpy()) < 0.2)
    elif case == "swing_parallel":
        cost0 = float(tcost(_t(x0).expand(H, 2), _t(us0[0]), 0).sum())
        assert cost[0] < 0.85 * cost0
        seq = ilqr.ilqr_solve(tdyn, tcost, _t(x0), _t(us0),
                              ilqr.ILQRConfig(**dict(cfg_kw,
                                                     parallel_backward=False)))
        np.testing.assert_allclose(cost, seq.cost.numpy(), rtol=1e-3)


def test_parallel_backward_pass_matches_sequential():
    """tests/test_mpc.py:237-266 on the port: the associative-scan backward
    pass equals the sequential one on a pendulum linearization at reg 1e-7,
    with the JAX test's tolerances; and both equal JAX's."""
    dt = 0.05

    def dyn(x, u):
        return torch.stack([x[:, 0] + dt * x[:, 1],
                            x[:, 1] + dt * (torch.sin(x[:, 0]) + u[:, 0])],
                           dim=-1)

    def cost(x, u, t):
        return (0.5 * torch.sum(x * x, -1) + 0.05 * torch.sum(u * u, -1)
                + 0.01 * x[..., 0] * u[..., 0])

    T_ = 12
    x0 = torch.tensor([[2.5, 0.0]])
    us = 0.1 * torch.ones(1, T_, 1)
    xs = ilqr._rollout(dyn, x0, us)
    lin = ilqr._linearize(dyn, cost, xs, us, T_)
    seq = ilqr.backward_pass(*lin, 1e-7)
    par = ilqr._parallel_backward(*lin, 1e-7)
    for name, s, p, atol in zip(("Ks", "ks", "dV"), seq, par,
                                (1e-4, 1e-4, 1e-5)):
        np.testing.assert_allclose(p.numpy(), s.numpy(), rtol=1e-3,
                                   atol=atol, err_msg=name)

    def jdyn(x, u):
        return jnp.asarray([x[0] + dt * x[1], x[1] + dt * (jnp.sin(x[0])
                                                           + u[0])])

    def jcost(x, u, t):
        return 0.5 * (x @ x) + 0.05 * (u @ u) + 0.01 * x[0] * u[0]

    @jax.jit
    def ref(x0, us):
        xs = jilqr._rollout(jdyn, x0, us)
        return jilqr.backward_pass(
            *jilqr._linearize(jdyn, jcost, xs, us, T_), 1e-7)

    want = ref(jnp.asarray(x0[0].numpy()), jnp.asarray(us[0].numpy()))
    for name, s, w in zip(("Ks", "ks", "dV"), seq, want):
        w = np.asarray(w)
        np.testing.assert_allclose(s[0].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_params_broadcast_expands_one_row_and_refuses_other_sizes():
    """A planner's one-row parameters expand to its rows without a copy, a
    set of that many rows passes unchanged, and a set of any other size
    raises where it is broadcast instead of reaching the physics step."""
    m = get_model("pointfoot")
    one = PhysicsParams.nominal(m, 1, "cpu")
    wide = one.broadcast(5)
    assert wide.kp.shape[0] == 5 and wide.kp.stride(0) == 0
    assert torch.equal(wide.kp[3], one.kp[0])
    five = PhysicsParams.nominal(m, 5, "cpu")
    assert torch.equal(five.broadcast(5).added_mass, five.added_mass)
    with pytest.raises(RuntimeError):
        PhysicsParams.nominal(m, 3, "cpu").broadcast(5)
