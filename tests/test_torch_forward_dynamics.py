"""The port's explicit dynamics (physics/dynamics.forward_dynamics,
physics/contact.contact_forces) against the JAX package, and the physics
recipes of tests/test_dynamics.py and tests/test_physics_invariants.py run
on the port with the same bands.

Parity: the rig of tests/_torch_parity.physics_rig (16 envs, random poses,
velocities, torques and pushes), PointFoot as made (3 envs in contact) and
A1 lowered by 0.3 m (11 in contact), on flat ground.  Contact forces are
held at tests/test_torch_dynamics.py's tolerance for M and C, atol 1e-4
with rtol 1e-5.  u̇ is the solve of M (condition numbers up to ~8e3 on the
rig) against forces of up to ~1e4: the solve spreads the roundoff of the
largest entries over all of them, so its rtol 1e-5 is taken of each env's
largest |u̇| (as tests/test_torch_ppo.py scales its gradient atol by the
tensor's largest entry).

The recipes step one env each; recipes that share a model, a time step
and ground run side by side as envs of one batch (envs do not interact),
from the JAX recipes' own initial states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import export_fields, physics_rig
from pointfoot_tpu.physics import contact as jcontact
from pointfoot_tpu.physics import dynamics as jdyn
from pointfoot_tpu_torch.physics import contact, dynamics
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
from pointfoot_tpu_torch.utils import convert

DT = 0.005
A1_QDEF = np.asarray([-0.1, 0.8, -1.5, 0.1, 0.8, -1.5,
                      -0.1, 1.0, -1.5, 0.1, 1.0, -1.5], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def FLAT(x, y):
    return torch.zeros_like(x)


def NO_GROUND(x, y):
    return torch.full_like(x, -1e3)


def _jflat(x, y):
    return jnp.zeros_like(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------- parity with JAX

@pytest.fixture(scope="module", params=[("pointfoot", 0.0), ("a1", -0.3)],
                ids=["pointfoot", "a1"])
def rig(request):
    name, dz = request.param
    r = physics_rig(name, 16)
    js = r["js"].replace(base_pos=r["js"].base_pos.at[:, 2].add(dz))
    return dict(r, js=js,
                ts=convert.physics_state_from_numpy(export_fields(js)))


def test_forward_dynamics_matches_jax(rig):
    """With the base push and a base torque."""
    jm = rig["jm"]
    torque = np.random.default_rng(5).standard_normal(
        rig["ext"].shape).astype(np.float32)
    ju, jf = jax.jit(jax.vmap(lambda p, s, t, f, n: jdyn.forward_dynamics(
        jm, p, s, t, _jflat, f, n)))(rig["jp"], rig["js"],
                                     jnp.asarray(rig["tau"]),
                                     jnp.asarray(rig["ext"]),
                                     jnp.asarray(torque))
    tu, tf = dynamics.forward_dynamics(
        rig["tm"], rig["tp"], rig["ts"], torch.from_numpy(rig["tau"]), FLAT,
        torch.from_numpy(rig["ext"]), torch.from_numpy(torque))
    ju, jf = np.asarray(ju), np.asarray(jf)
    active = np.abs(jf).sum(-1) > 0
    assert active.any(axis=1).sum() >= 3 and not active.any(axis=1).all()
    np.testing.assert_allclose(tf.numpy(), jf, atol=1e-4, rtol=1e-5)
    scale = np.abs(ju).max(axis=1, keepdims=True)
    assert (np.abs(tu.numpy() - ju) <= 1e-4 + 1e-5 * scale).all(), \
        np.abs(tu.numpy() - ju).max()


def test_contact_forces_match_jax(rig):
    """contact_forces / resolve_forces / _project_cone: the forces and
    their generalized force, on a slope so the normals tilt."""
    jm, tm = rig["jm"], rig["tm"]

    def jslope(x, y):
        return 0.1 * x - 0.05 * y

    def jterms(p, s):
        kin = jdyn.forward_kinematics(jm, s, p)
        S = jdyn.motion_subspaces(jm, kin, s.base_pos)
        V = jdyn.body_spatial_velocities(jm, s, S)
        return jcontact.contact_forces(jm, p, kin, V, S, s.base_pos, jslope)

    jf, jtau = jax.jit(jax.vmap(jterms))(rig["jp"], rig["js"])
    ts = rig["ts"]
    kin = dynamics.forward_kinematics(tm, ts, rig["tp"])
    S = dynamics.motion_subspaces(tm, kin, ts.base_pos)
    V = dynamics.body_spatial_velocities(tm, ts, S)
    tf, ttau = contact.contact_forces(tm, rig["tp"], kin, V, S, ts.base_pos,
                                      lambda x, y: 0.1 * x - 0.05 * y)
    assert np.abs(np.asarray(jf)).max() > 10.0
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(ttau.numpy(), np.asarray(jtau), atol=1e-4,
                               rtol=1e-5)


def test_project_cone():
    f = torch.tensor([[1.0, 2.0, -3.0], [1.0, 2.0, 3.0], [1.0, 2.0, 3.0]])
    n = torch.tensor([[0.0, 0.0, 1.0]]).expand(3, 3)
    active = torch.tensor([True, True, False])
    got = contact._project_cone(f, n, active)
    want = jax.vmap(jcontact._project_cone)(jnp.asarray(f.numpy()),
                                            jnp.asarray(n.numpy()),
                                            jnp.asarray(active.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [[1.0, 2.0, 0.0],
                                                [1.0, 2.0, 3.0],
                                                [0.0, 0.0, 0.0]])


# ----------------------------------------------------------- the recipes

def _params(model, batch, **kw):
    return PhysicsParams.nominal(model, batch, "cpu", **kw)


def _state(model, qpos, batch, base_height):
    return PhysicsState.default(model, qpos, batch, "cpu",
                                base_height=base_height)


def _cat(states):
    return PhysicsState(**{f.name: torch.cat([getattr(s, f.name)
                                              for s in states])
                           for f in dataclasses.fields(PhysicsState)})


def _pd(model, p, qdef, kp=40.0, kd=1.5):
    """tests/test_physics_invariants.py's clipped PD law."""
    lim = model.effort_limit
    return torch.clamp(kp * (qdef - p.qpos) - kd * p.qvel, -lim, lim)


def _flight_state(model, seed, base_height=3.0):
    """tests/test_physics_invariants.py::_flight_state, drawn by JAX."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    s = _state(model, np.zeros(model.nj), 1, base_height)
    draw = lambda k, n, lo, hi: torch.from_numpy(np.array(  # noqa: E731
        jax.random.uniform(k, (n,), minval=lo, maxval=hi)))[None]
    return s.replace(base_lin_vel=draw(k1, 3, -0.5, 0.5),
                     base_ang_vel=draw(k2, 3, -1.0, 1.0),
                     qvel=draw(k3, model.nj, -2.0, 2.0))


def _com_and_L(model, params, state):
    """World CoM, CoM velocity and angular momentum about the CoM."""
    kin = dynamics.forward_kinematics(model, state, params)
    S = dynamics.motion_subspaces(model, kin, state.base_pos)
    V = dynamics.body_spatial_velocities(model, state, S)
    w = V[..., :3]
    v_com_b = V[..., 3:] + torch.linalg.cross(
        w, kin.com_w - state.base_pos[:, None], dim=-1)
    m = model.mass[None, :, None]
    M = model.mass.sum()
    com = (m * kin.com_w).sum(1) / M
    v_com = (m * v_com_b).sum(1) / M
    r = kin.com_w - com[:, None]
    L = (torch.einsum("bnij,bnj->bni", kin.inertia_w, w)
         + m * torch.linalg.cross(r, v_com_b, dim=-1)).sum(1)
    return com, v_com, L


def _rollout(model, params, state, steps, tau_fn, dt=DT, height_fn=FLAT,
             ext_fn=None, record=None):
    """`steps` of dynamics.step; `tau_fn(state, t)` and `ext_fn(t)` give
    the torques and base force of step t, `record(state, t)` what to keep
    after it."""
    out = []
    with torch.no_grad():
        for t in range(steps):
            state = dynamics.step(model, params, state, tau_fn(state, t),
                                  height_fn, dt,
                                  None if ext_fn is None else ext_fn(t))
            if record is not None:
                out.append(record(state, t))
    return state, out


def _weight(model):
    return float(model.mass.sum()) * 9.81


# tests/test_dynamics.py --------------------------------------------------

def test_free_fall_acceleration():
    pf = get_model("pointfoot")
    params = _params(pf, 1)
    state = _state(pf, np.zeros(6), 1, 0.8)
    udot, _ = dynamics.forward_dynamics(pf, params, state, torch.zeros(1, 6),
                                        NO_GROUND)
    kin = dynamics.forward_kinematics(pf, state, params)
    S = dynamics.motion_subspaces(pf, kin, state.base_pos)
    M = dynamics.mass_matrix(pf, params, kin, S, state.base_pos)
    hdot = (M @ udot[..., None])[0, :, 0]
    np.testing.assert_allclose(float(hdot[5]), -9.81 * float(pf.mass.sum()),
                               rtol=1e-4)
    np.testing.assert_allclose(hdot[3:5].numpy(), 0.0, atol=1e-3)


def test_mass_matrix_matches_rnea():
    """CRBA columns equal RNEA with unit accelerations (v = 0, g = 0); M is
    symmetric positive definite."""
    pf = get_model("pointfoot")
    params = _params(pf, 1)
    rng = np.random.default_rng(0)
    q = rng.normal(size=4)
    state = _state(pf, rng.uniform(-0.5, 0.5, 6), 1, 0.8).replace(
        base_quat=torch.tensor(q / np.linalg.norm(q), dtype=torch.float32)[
            None])
    kin = dynamics.forward_kinematics(pf, state, params)
    S = dynamics.motion_subspaces(pf, kin, state.base_pos)
    V = dynamics.body_spatial_velocities(pf, state, S)
    M = dynamics.mass_matrix(pf, params, kin, S, state.base_pos)[0].numpy()
    nv = pf.nv
    cols = [dynamics.inverse_dynamics(pf, params, kin, S, state.qvel, V * 0.0,
                                      state.base_pos,
                                      torch.eye(nv)[j][None],
                                      gravity=0.0)[0].numpy()
            for j in range(nv)]
    np.testing.assert_allclose(M, np.stack(cols, axis=1), atol=1e-4)
    np.testing.assert_allclose(M, M.T, atol=1e-4)
    assert np.all(np.linalg.eigvalsh(M) > 0)


def _total_energy(model, params, state):
    kin = dynamics.forward_kinematics(model, state, params)
    S = dynamics.motion_subspaces(model, kin, state.base_pos)
    M = dynamics.mass_matrix(model, params, kin, S, state.base_pos)[0]
    u = torch.cat([state.base_ang_vel, state.base_lin_vel, state.qvel],
                  dim=-1)[0]
    pe = (model.mass * 9.81 * kin.com_w[0, :, 2]).sum()
    return float(0.5 * u @ M @ u + pe)


def test_energy_conservation_passive():
    """Passive swing in vacuum: energy drifts < 1% over 0.5 s at 1 ms."""
    pf = get_model("pointfoot")
    params = _params(pf, 1)
    model = dataclasses.replace(pf, joint_damping=torch.zeros(6),
                                joint_friction=torch.zeros(6))
    state = _state(model, [0.3, 0.5, -0.4, -0.3, -0.5, 0.4], 1, 0.8).replace(
        base_ang_vel=torch.tensor([[0.4, -0.2, 0.3]]))
    e0 = _total_energy(model, params, state)
    state, _ = _rollout(model, params, state, 500,
                        lambda s, t: torch.zeros(1, 6), dt=1e-3,
                        height_fn=NO_GROUND)
    e1 = _total_energy(model, params, state)
    assert abs(e1 - e0) / abs(e0) < 0.01, (e0, e1)


def test_friction_cone_and_zero_friction_slide():
    """Sliding at 1 m/s with mu 0.7: each touching sphere's tangential
    force opposes the slide at mu f_n; with mu 0 there is none."""
    pf = get_model("pointfoot")
    state = _state(pf, np.zeros(6), 1, 0.56).replace(
        base_lin_vel=torch.tensor([[1.0, 0.0, 0.0]]))
    for mu in (0.7, 0.0):
        p = _params(pf, 1)
        p = dataclasses.replace(p, friction=torch.full_like(p.friction, mu))
        kin = dynamics.forward_kinematics(pf, state, p)
        S = dynamics.motion_subspaces(pf, kin, state.base_pos)
        V = dynamics.body_spatial_velocities(pf, state, S)
        forces, _ = contact.contact_forces(pf, p, kin, V, S, state.base_pos,
                                           FLAT)
        forces = forces[0].numpy()
        touching = forces[:, 2] > 1.0
        assert touching.any()
        if mu == 0.0:
            np.testing.assert_allclose(forces[:, :2], 0.0, atol=1e-5)
            continue
        for f in forces[touching]:
            assert f[0] < 0
            np.testing.assert_allclose(abs(f[0]), mu * f[2], rtol=1e-3)


# PointFoot, nominal model, flat ground: the drop of tests/test_dynamics.py
# and four recipes of tests/test_physics_invariants.py side by side
PF_DROP, PF_DEPEN, PF_DEEP, PF_FLIGHT = range(4)
PF_STEPS = {PF_DROP: 1500, PF_DEPEN: 600, PF_DEEP: 10, PF_FLIGHT: 40}


@pytest.fixture(scope="module")
def pointfoot_runs():
    pf = get_model("pointfoot")
    params = _params(pf, 4)
    zeros = np.zeros(6)
    deep = _state(pf, zeros, 1, -1.5).replace(
        base_lin_vel=torch.tensor([[0.0, 0.0, -20.0]]))
    state = _cat([_state(pf, zeros, 1, 0.7), _state(pf, zeros, 1, -1.5),
                  deep, _flight_state(pf, 0)])
    # the drop's PD law is unclipped, the flight's clipped, the rest zero
    drop = torch.tensor([1.0, 0.0, 0.0, 0.0])[:, None]
    flight = torch.tensor([0.0, 0.0, 0.0, 1.0])[:, None]

    def tau(s, t):
        return (drop * (40.0 * (0.0 - s.qpos) - 1.5 * s.qvel)
                + flight * _pd(pf, s, torch.zeros(6)))

    def record(s, t):
        rec = dict(pos=s.base_pos.clone(), vel=s.base_lin_vel.clone(),
                   ang=s.base_ang_vel.clone(), cf=s.contact_force.clone())
        if t < PF_STEPS[PF_FLIGHT]:
            rec["v_com"] = _com_and_L(pf, params, s)[1]
        return rec

    _, recs = _rollout(pf, params, state, PF_STEPS[PF_DROP], tau,
                       record=record)
    return pf, params, recs


def test_drop_settles_on_ground(pointfoot_runs):
    pf, params, recs = pointfoot_runs
    last = recs[-1]
    assert float(last["vel"][PF_DROP].norm()) < 0.1
    assert 0.0 < float(last["pos"][PF_DROP, 2]) < 0.8
    fz = float(last["cf"][PF_DROP, :, 2].sum())
    np.testing.assert_allclose(fz, _weight(pf), rtol=0.15)


def test_ballistic_com_parabola(pointfoot_runs):
    """In flight the CoM accelerates at exactly g, PD torques or not."""
    _, _, recs = pointfoot_runs
    v_com = np.stack([r["v_com"][PF_FLIGHT].numpy()
                      for r in recs[:PF_STEPS[PF_FLIGHT]]])
    acc = np.diff(v_com, axis=0) / DT
    np.testing.assert_allclose(acc[:, :2], 0.0, atol=6e-2)
    np.testing.assert_allclose(acc[:, 2], -9.81, atol=8e-2)
    np.testing.assert_allclose(v_com[:, :2] - v_com[0, :2], 0.0, atol=1.5e-2)


def test_deep_penetration_bounded_kick(pointfoot_runs):
    pf, params, recs = pointfoot_runs
    r = recs[PF_STEPS[PF_DEEP] - 1]
    assert bool(torch.isfinite(r["pos"][PF_DEEP]).all())
    assert float(r["vel"][PF_DEEP].abs().max()) <= 50.0 + 1e-3
    assert float(r["ang"][PF_DEEP].abs().max()) <= 64.0 + 1e-3
    fmax = float(params.contact_stiffness[0]) * 0.2
    assert float(r["cf"][PF_DEEP].max()) < 4 * fmax


def test_depenetration_velocity_capped(pointfoot_runs):
    _, _, recs = pointfoot_runs
    n = PF_STEPS[PF_DEPEN]
    zs = np.array([float(r["pos"][PF_DEPEN, 2]) for r in recs[:n]])
    vzs = np.array([float(r["vel"][PF_DEPEN, 2]) for r in recs[:n]])
    assert vzs.max() <= 2.0, f"upward exit velocity {vzs.max():.2f} m/s"
    assert zs.max() <= 0.8, f"apex {zs.max():.2f} m"
    assert zs[-1] > -0.6, f"still buried at z={zs[-1]:.2f}"


# PointFoot without joint damping, in flight: the angular-momentum pair and
# the joint-limit rails of tests/test_physics_invariants.py
FL_ZERO, FL_PD, FL_RAILS = range(3)


@pytest.fixture(scope="module")
def flight_runs():
    pf = get_model("pointfoot")
    model = dataclasses.replace(pf, joint_damping=torch.zeros(6))
    params = _params(model, 3)
    rails = _flight_state(model, 3)
    rails = rails.replace(base_pos=rails.base_pos.clone())
    rails.base_pos[:, 2] = 30.0
    state = _cat([_flight_state(model, 1), _flight_state(model, 2), rails])
    qdef = torch.full((6,), 0.5)
    sel = torch.eye(3)[:, :, None]  # (env, which, 1)

    def tau(s, t):
        bang = (1.0 if (t // 12) % 2 == 0 else -1.0) * model.effort_limit
        per = [torch.zeros_like(s.qpos), _pd(model, s, qdef),
               bang.expand_as(s.qpos)]
        return sum(sel[:, i] * per[i] for i in range(3))

    def record(s, t):
        rec = dict(qvel=s.qvel.clone(), qpos=s.qpos.clone(),
                   w=s.base_ang_vel.clone(), v=s.base_lin_vel.clone())
        if t < 40:
            rec["L"] = _com_and_L(model, params, s)[2]
        return rec

    _, recs = _rollout(model, params, state, 400, tau, record=record)
    return model, recs


@pytest.mark.parametrize("env,bound", [(FL_ZERO, 0.05), (FL_PD, 0.10)],
                         ids=["zero_torque", "internal_torques"])
def test_ballistic_angular_momentum(flight_runs, env, bound):
    """Zero torque: L about the CoM stays within 5%; PD torques flailing
    the legs move it only through integrator error (10%)."""
    _, recs = flight_runs
    L = np.stack([r["L"][env].numpy() for r in recs[:40]])
    floor = 1e-3 if env == FL_ZERO else 1e-2
    scale = max(np.abs(L[0]).max(), floor)
    drift = np.abs(L - L[0]).max() / scale
    assert drift < bound, f"L drifted {drift:.1%}"


def test_railed_joint_limits_contract(flight_runs):
    model, recs = flight_runs
    qvel, qpos, w, v = (np.stack([r[k][FL_RAILS].numpy() for r in recs])
                        for k in ("qvel", "qpos", "w", "v"))
    vl = model.velocity_limit.numpy()
    assert (np.abs(qvel).max(axis=0) > 0.9 * vl).all(), "limits never hit"
    assert (np.abs(qvel) <= vl + 1e-4).all(), "velocity clamp breached"
    assert (qpos <= model.q_upper.numpy() + 0.2 + 1e-4).all()
    assert (qpos >= model.q_lower.numpy() - 0.2 - 1e-4).all()
    assert np.isfinite(qpos).all() and np.isfinite(w).all()
    assert (np.abs(w) <= 64.0 + 1e-3).all()
    assert (np.abs(v) <= 50.0 + 1e-3).all()


# A1 stance rig, flat ground: the quadruped drop of tests/test_dynamics.py
# and the calibrated contact bands of tests/test_physics_invariants.py
A1_BALANCE, A1_IMPACT, A1_DROP, A1_SLIP = range(4)
A1_SETTLE, A1_RAMP = 300, 800


@pytest.fixture(scope="module")
def a1_runs():
    a1 = get_model("a1")
    params = _params(a1, 4)
    mu = float(params.friction[0, 0])
    state = _cat([_state(a1, A1_QDEF, 1, h)
                  for h in (0.30, 0.35, 0.34, 0.30)])
    qdef = torch.from_numpy(A1_QDEF)
    drop = torch.tensor([0.0, 0.0, 1.0, 0.0])[:, None]
    forces = torch.linspace(0.0, 2.0 * mu * _weight(a1), A1_RAMP)

    def tau(s, t):
        # the quadruped drop's PD law is 60 / 2 and unclipped
        return (drop * (60.0 * (qdef - s.qpos) - 2.0 * s.qvel)
                + (1.0 - drop) * _pd(a1, s, qdef))

    def ext(t):
        f = torch.zeros(4, 3)
        if t >= A1_SETTLE:
            f[A1_SLIP, 0] = forces[t - A1_SETTLE]
        return f

    def record(s, t):
        return dict(pos=s.base_pos.clone(), vel=s.base_lin_vel.clone(),
                    quat=s.base_quat.clone(), cf=s.contact_force.clone())

    _, recs = _rollout(a1, params, state, A1_SETTLE + A1_RAMP, tau,
                       ext_fn=ext, record=record)
    return a1, params, mu, forces.numpy(), recs


def test_quadruped_drop_stays_upright(a1_runs):
    a1, _, _, _, recs = a1_runs
    r = recs[599]
    assert float(r["vel"][A1_DROP].norm()) < 0.15
    assert 0.2 < float(r["pos"][A1_DROP, 2]) < 0.45
    assert abs(float(r["quat"][A1_DROP, 3])) > 0.95
    fz = float(r["cf"][A1_DROP, :, 2].sum())
    np.testing.assert_allclose(fz, _weight(a1), rtol=0.15)
    feet = list(a1.collision_indices("foot"))
    assert float(r["cf"][A1_DROP, feet, 2].sum()) > 0.9 * fz


def test_static_force_balance_band(a1_runs):
    a1, params, _, _, recs = a1_runs
    w = _weight(a1)
    feet = list(a1.collision_indices("foot"))
    fz = recs[399]["cf"][A1_BALANCE, feet, 2].numpy()
    assert abs(fz.sum() - w) / w < 0.02, f"sum Fz {fz.sum():.1f} vs W {w:.1f}"
    pen_mm = 1e3 * fz / float(params.contact_stiffness[0])
    assert (pen_mm > 0.3).all() and (pen_mm < 10.0).all(), pen_mm


def test_drop_dead_impact_band(a1_runs):
    _, _, _, _, recs = a1_runs
    z = np.array([float(r["pos"][A1_IMPACT, 2]) for r in recs[:400]])
    rebound = max(0.0, z[120:].max() - z[-1])
    assert rebound / 0.05 < 0.10, f"restitution {rebound / 0.05:.3f}"
    assert np.isfinite(z).all()


def test_stick_slip_breakaway_band(a1_runs):
    a1, _, mu, forces, recs = a1_runs
    w = _weight(a1)
    vx = np.array([float(r["vel"][A1_SLIP, 0]) for r in recs[A1_SETTLE:]])
    slid = np.where(vx > 0.2)[0]
    assert len(slid) > 0, "never broke away below 2 mu W"
    ratio = float(forces[slid[0]]) / (mu * w)
    assert 0.30 < ratio < 0.80, f"breakaway at {ratio:.2f} mu*W"
    i_half = np.argmin(np.abs(forces - 0.5 * mu * w))
    assert vx[i_half] < 0.4, f"creep {vx[i_half]:.3f} m/s at 0.5 mu W"
