"""SRB-MPC of the PyTorch port (mpc/srb.py) against the JAX package's, on
the CPU, for PointFoot (two feet, m = 6) and A1 (four feet, m = 12).

The state is that of tests/test_srb_pallas.py:25-37 at B = 3 (default pose
at the height target, a lateral base velocity, 30 N on every foot), with a
seeded perturbation of velocities and commands, and for A1 of the pose too,
so the scenarios differ; scenario 1 has one foot unloaded (A1 only) and
scenario 2 has every foot unloaded, which the contact gate turns back into
full stance.  PointFoot keeps the pose: two point feet leave the static
feedforward's 6x6 system singular but for its regulariser, and away from
the symmetric pose its solution is roundoff noise of about 1 N in both
packages (`test_static_ff_off_nominal_pointfoot`).  One JAX `jit` per robot computes every
reference.  Tolerances are stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointfoot_tpu.mpc import srb as jsrb
from pointfoot_tpu.physics import dynamics as jdyn
from pointfoot_tpu.physics.assets import get_model as jget_model
from pointfoot_tpu.physics.model import PhysicsParams as JParams
from pointfoot_tpu.physics.model import PhysicsState as JState
from pointfoot_tpu_torch.mpc import srb
from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
from pointfoot_tpu_torch.utils import convert

from _torch_parity import export_fields

# tiny tensors: intra-op threads only add contention between test workers
torch.set_num_threads(1)

B, T = 3, 5
A1_QDEF = np.asarray([-0.1, 0.8, -1.5, 0.1, 0.8, -1.5,
                      -0.1, 1.0, -1.5, 0.1, 1.0, -1.5], np.float32)
ROBOTS = {
    "pointfoot": dict(qdef=np.zeros(6, np.float32), height=0.62),
    "a1": dict(qdef=A1_QDEF, height=0.28),
}


def _cfg_kwargs(robot):
    return dict(height_target=ROBOTS[robot]["height"], horizon=T)


def _state(robot):
    """The perturbed B-scenario state, commands, a contact schedule and
    foot forces, as numpy arrays."""
    rng = np.random.default_rng(7)
    jm = jget_model(robot)
    nj, nc = jm.nj, len(jm.collision_body)
    feet = jm.collision_indices("foot")
    nf = len(feet)
    # PointFoot keeps the pose of the state it starts from: see FF_ATOL
    pose = 0.0 if robot == "pointfoot" else 1.0
    q = np.array([0.0, 0.0, 0.0, 1.0]) \
        + pose * 0.03 * rng.standard_normal((B, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    force = np.zeros((B, nc, 3), np.float32)
    force[:, list(feet), 2] = 30.0
    if robot == "a1":
        force[1, feet[0], 2] = 0.0
    force[2] = 0.0
    lin = 0.05 * rng.standard_normal((B, 3))
    lin[:, 1] += 0.2
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    state = dict(
        base_pos=f32(np.c_[pose * 0.3 * rng.standard_normal((B, 2)),
                           ROBOTS[robot]["height"]
                           + pose * 0.01 * rng.standard_normal(B)]),
        base_quat=f32(q),
        base_lin_vel=f32(lin),
        base_ang_vel=f32(0.1 * rng.standard_normal((B, 3))),
        qpos=f32(ROBOTS[robot]["qdef"]
                 + pose * 0.05 * rng.standard_normal((B, nj))),
        qvel=f32(0.2 * rng.standard_normal((B, nj))),
        contact_force=force)
    cmd = f32(0.3 * rng.standard_normal((B, 3)))
    seq = f32(rng.random((B, T, nf)) > 0.3)
    seq[:, :, 0] = 1.0  # never an empty stance set
    forces = f32(np.tile([3.0, -2.0, 40.0], (B, nf, 1))
                 + rng.standard_normal((B, nf, 3)))
    return state, cmd, seq, forces, feet


@pytest.fixture(scope="module", params=sorted(ROBOTS))
def rig(request):
    return _make_rig(request.param)


def _make_rig(robot):
    state, cmd, seq, forces, feet = _state(robot)
    jm = jget_model(robot)
    jp = JParams.nominal(jm)
    qdef = ROBOTS[robot]["qdef"]
    jcfg = jsrb.SRBConfig(**_cfg_kwargs(robot))
    jctrl = jsrb.SRBController(jm, jp, feet, qdef, jcfg)

    def one(p, c, cs, f):
        kin = jdyn.forward_kinematics(jm, p, jp)
        fp = jnp.stack([kin.body_pos[jm.collision_body[i]]
                        + kin.body_rot[jm.collision_body[i]]
                        @ jm.collision_offset[i] for i in feet])
        ct = (p.contact_force[jnp.asarray(feet), 2] > 1.0).astype(jnp.float32)
        ct = jnp.where(jnp.sum(ct) > 0, ct, jnp.ones_like(ct))
        com = jnp.sum(jm.mass[:, None] * kin.com_w, axis=0) / jnp.sum(jm.mass)
        mass = jnp.sum(jm.mass) + jp.added_mass
        return dict(
            fp=fp, ct=ct,
            prob=jsrb.srb_problem(jm, p, jp, fp, ct, c, jcfg),
            prob_h=jsrb.srb_problem(jm, p, jp, fp, ct, c, jcfg,
                                    height_ref=0.05 + jcfg.height_target),
            sched=jsrb.srb_problem_sched(jm, p, jp, fp, cs, c, jcfg),
            ff=jsrb._static_ff(fp - com, ct, mass),
            tau=jsrb.forces_to_torques(jm, p, jp, feet, f, ct,
                                       jnp.asarray(qdef), jcfg))

    @jax.jit
    def run(p, c, cs, f):
        out = jax.vmap(one)(p, c, cs, f)
        tick_tau, tick_plan = jctrl.plan_tick(p, c)
        return out, tick_tau, tick_plan.forces, tick_plan.xs

    js = JState(**{k: jnp.asarray(v) for k, v in state.items()})
    out, tick_tau, tick_forces, tick_xs = run(
        js, jnp.asarray(cmd), jnp.asarray(seq), jnp.asarray(forces))
    want = jax.tree.map(np.asarray, out)
    want.update(tick_tau=np.asarray(tick_tau),
                tick_forces=np.asarray(tick_forces),
                tick_xs=np.asarray(tick_xs))

    tm = get_model(robot)
    tp = PhysicsParams.nominal(tm, B, "cpu")
    ts = convert.physics_state_from_numpy(state)
    cfg = srb.SRBConfig(**_cfg_kwargs(robot))
    ctrl = srb.SRBController(tm, tp, feet, qdef, cfg)
    t = torch.from_numpy
    kin, fp, ct = ctrl.feet_and_contact(ts)
    return dict(robot=robot, want=want, tm=tm, tp=tp, ts=ts, cfg=cfg,
                ctrl=ctrl, cmd=t(cmd), seq=t(seq), forces=t(forces),
                feet=feet, kin=kin, fp=fp, ct=ct, state=state, js=js, jp=jp,
                jm=jm)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol,
                               err_msg=what)


# The problem's tolerances.  F, Xd, Ud, XTd are exact; L and x0 are a few
# float32 operations from the state (1e-5).  f_ff solves the 6x6 system
# A A' + 1e-6 I: full rank for A1's four feet (forces of ~70 N agree to
# 5.7e-5 N); singular but for the regulariser for two point feet, where
# float32 roundoff in A A' moves the solution (forces of ~90 N agree to
# 2e-3 N at this pose).  c_tot = c + L f_ff, ~zero by construction, is held
# to FF_ATOL times |L| (dt/m and dt·I⁻¹·r are below 0.05).
FF_ATOL = {"pointfoot": 5e-3, "a1": 5e-4}
# a schedule step may leave PointFoot one foot or A1 two: the static system
# is then singular but for the regulariser, its solution differs by up to
# 1 N between the packages, and the drift c_seq = c + L f_ff by up to 0.02
SCHED_C_ATOL = 0.03
NAMES = ("F", "c_tot", "L", "Xd", "Ud", "XTd", "x0", "f_ff")


def _problem_tol(robot):
    ff = FF_ATOL[robot]
    return {"F": 0.0, "c_tot": 0.05 * ff, "L": 1e-5, "Xd": 0.0, "Ud": 0.0,
            "XTd": 0.0, "x0": 1e-5, "f_ff": ff}


def test_feet_and_contact_match_jax(rig):
    _close(rig["fp"], rig["want"]["fp"], 0, 1e-6, "foot positions")
    _close(rig["ct"], rig["want"]["ct"], 0, 0, "contact gate")
    assert rig["ct"][2].tolist() == [1.0] * len(rig["feet"])


@pytest.mark.parametrize("height_ref", [None, "float", "tensor"])
def test_srb_problem_matches_jax(rig, height_ref):
    """All eight outputs, with and without a base-height reference."""
    key = "prob" if height_ref is None else "prob_h"
    h = rig["cfg"].height_target + 0.05
    arg = {None: None, "float": h, "tensor": torch.full((B,), h)}[height_ref]
    got = srb.srb_problem(rig["tm"], rig["ts"], rig["tp"], rig["fp"],
                          rig["ct"], rig["cmd"], rig["cfg"], height_ref=arg)
    tol = _problem_tol(rig["robot"])
    assert len(got) == 8
    for name, g, w in zip(NAMES, got, rig["want"][key]):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, 1e-5, tol[name], name)


def test_srb_problem_sched_matches_jax(rig):
    got = srb.srb_problem_sched(rig["tm"], rig["ts"], rig["tp"], rig["fp"],
                                rig["seq"], rig["cmd"], rig["cfg"])
    tol = _problem_tol(rig["robot"])
    tol.update(c_tot=SCHED_C_ATOL, f_ff=SCHED_C_ATOL / 0.02)
    for name, g, w in zip(NAMES, got, rig["want"]["sched"]):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, 1e-5, tol[name], name)


def test_static_ff_matches_jax(rig):
    com = (rig["tm"].mass[:, None] * rig["kin"].com_w).sum(1) \
        / rig["tm"].mass.sum()
    mass = rig["tm"].mass.sum() + rig["tp"].added_mass
    got = srb._static_ff(rig["fp"] - com[:, None], rig["ct"], mass)
    _close(got, rig["want"]["ff"], 1e-5, FF_ATOL[rig["robot"]], "f_ff")
    # the feedforward carries the weight whatever the roundoff
    fz = got.reshape(B, -1, 3)[..., 2].sum(-1)
    np.testing.assert_allclose(fz.numpy(), 9.81 * mass.numpy(), rtol=1e-3)


def test_static_ff_off_nominal_pointfoot():
    """Two point feet away from the symmetric pose: the moment about the
    line through the feet cannot be balanced, (A A' + 1e-6 I)⁻¹ b is ~1e6
    along that direction, and A' times it is float32 roundoff of ~1 N in
    every force component (the values are multiples of 1/16 N), in the JAX
    package as in the port.  The packages agree to 2 N, and the vertical
    forces carry the weight in both."""
    rng = np.random.default_rng(11)
    n = 16
    rel = np.tile([[0.05, 0.1, -0.6], [0.05, -0.1, -0.6]], (n, 1, 1)) \
        + 0.03 * rng.standard_normal((n, 2, 3))
    rel = rel.astype(np.float32)
    mass = np.full(n, 18.0, np.float32)
    ct = np.ones((n, 2), np.float32)
    want = np.asarray(jax.jit(jax.vmap(jsrb._static_ff))(
        jnp.asarray(rel), jnp.asarray(ct), jnp.asarray(mass)))
    got = srb._static_ff(torch.from_numpy(rel), torch.from_numpy(ct),
                         torch.from_numpy(mass)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0)
    for f in (got, want):
        np.testing.assert_allclose(f[:, 2::3].sum(-1), 9.81 * mass,
                                   rtol=1e-2)


# tolerances of tests/test_srb_pallas.py:41-45 (kernel tick vs XLA tick)
TAU_TOL = dict(rtol=2e-3, atol=2e-2)
FORCE_TOL = dict(rtol=2e-3, atol=5e-2)


def test_srb_plan_matches_jax(rig):
    plan = srb.srb_plan(rig["tm"], rig["ts"], rig["tp"], rig["fp"],
                        rig["ct"], rig["cmd"], rig["cfg"])
    assert plan.forces.shape == (B, T, len(rig["feet"]), 3)
    assert plan.xs.shape == (B, T + 1, 12)
    _close(plan.forces, rig["want"]["tick_forces"], what="forces",
           **FORCE_TOL)
    _close(plan.xs, rig["want"]["tick_xs"], 2e-3, 2e-3, "xs")


def test_forces_to_torques_matches_jax(rig):
    """Given forces: a few float32 operations per joint, atol 1e-4 N·m."""
    got = srb.forces_to_torques(
        rig["tm"], rig["ts"], rig["tp"], rig["feet"], rig["forces"],
        rig["ct"], rig["ctrl"].default_qpos, rig["cfg"])
    _close(got, rig["want"]["tau"], 1e-5, 1e-4, "tau")


def test_plan_tick_matches_jax(rig):
    tau, plan = rig["ctrl"].plan_tick(rig["ts"], rig["cmd"])
    _close(tau, rig["want"]["tick_tau"], what="tau", **TAU_TOL)
    _close(plan.forces, rig["want"]["tick_forces"], what="forces",
           **FORCE_TOL)
    _close(plan.xs, rig["want"]["tick_xs"], 2e-3, 2e-3, "xs")


def test_plan_tick_cuda_matches_jax_plan_tick(rig):
    """The kernel tick (its plain version here, on CPU tensors) against the
    JAX package's sequential-solver tick."""
    tau, fs = rig["ctrl"].plan_tick_cuda(rig["ts"], rig["cmd"])
    assert fs.shape == (B, T, len(rig["feet"]), 3)
    _close(tau, rig["want"]["tick_tau"], what="tau", **TAU_TOL)
    _close(fs[:, 0], rig["want"]["tick_forces"][:, 0], what="forces",
           **FORCE_TOL)


def test_control_is_plan_then_leg_torques(rig):
    tau, plans = rig["ctrl"].control(rig["ts"], rig["fp"], rig["ct"],
                                     rig["cmd"])
    _close(tau, rig["want"]["tick_tau"], what="tau", **TAU_TOL)
    _close(plans.forces, rig["want"]["tick_forces"], what="forces",
           **FORCE_TOL)


def test_problem_arrays_cross_as_numpy(rig):
    """A JAX state, params and srb_problem pass to the port as numpy
    arrays, and the port's kernel-tick solver plans from them what JAX's
    sequential solver plans."""
    from pointfoot_tpu_torch.ops.cuda import riccati as rk

    ts = convert.physics_state_from_numpy(export_fields(rig["js"]))
    for name in ("base_pos", "qpos", "contact_force"):
        assert torch.equal(getattr(ts, name), getattr(rig["ts"], name))
    tp = convert.physics_params_from_numpy(
        export_fields(JParams.nominal(rig["jm"], batch=(B,))))
    assert torch.equal(tp.kp, rig["tp"].kp)
    assert torch.equal(tp.joint_friction, rig["tp"].joint_friction)
    prob = convert.srb_problem_from_numpy(rig["want"]["prob"])
    assert [tuple(a.shape) for a in prob] == [
        a.shape for a in rig["want"]["prob"]]
    fs = rk.srb_lqr(*prob, horizon=T)
    fs = srb._project_cone(fs.reshape(B, T, -1, 3), rig["cfg"])
    _close(fs, rig["want"]["tick_forces"], what="forces", **FORCE_TOL)


# ------------------------------------------------- the port's own behaviour

def _flat(x, y):
    return torch.zeros_like(x)


_flat.is_flat = True


def test_plan_supports_weight():
    """Standing plan: stance forces sum to ~weight in z
    (tests/test_srb.py:32-42)."""
    model = get_model("pointfoot")
    params = PhysicsParams.nominal(model, 1, "cpu")
    phys = PhysicsState.default(model, np.zeros(6), 1, "cpu",
                                base_height=0.62)
    feet = model.collision_indices("foot")
    kin = dynamics.forward_kinematics(model, phys, params)
    fp = srb._sphere_positions(model, kin, feet)
    plan = srb.srb_plan(model, phys, params, fp, torch.ones(1, 2),
                        torch.zeros(1, 3), srb.SRBConfig())
    fz = float(plan.forces[0, 0, :, 2].sum())
    weight = 9.81 * float(model.mass.sum())
    np.testing.assert_allclose(fz, weight, rtol=0.15)


@pytest.mark.parametrize("tick", ["plan", "plan_tick_cuda"])
def test_srb_controller_stabilizes_quadruped(tick):
    """Closed loop (tests/test_srb.py:45-92): SRB-MPC holds an A1 upright
    under a lateral velocity perturbation for 1 s, with the two-rate loop
    of `plan` + `leg_torques`, and with the kernel tick's plain version."""
    model = get_model("a1")
    Bc = 2
    params = PhysicsParams.nominal(model, Bc, "cpu")
    feet = model.collision_indices("foot")
    cfg = srb.SRBConfig(height_target=0.28, w_vel=1.0, w_height=10.0,
                        w_orient=5.0, w_omega=0.5, w_force_normal=1e-3,
                        w_force_tangent=2e-2, kp_swing=20.0, kd_swing=0.5)
    ctrl = srb.SRBController(model, params, feet, A1_QDEF, cfg)
    phys = PhysicsState.default(model, A1_QDEF, Bc, "cpu", base_height=0.29)
    lin = phys.base_lin_vel.clone()
    lin[:, 1] = 0.3
    phys = phys.replace(base_lin_vel=lin)
    command = torch.zeros(Bc, 3)
    zs = []
    for _ in range(50):
        if tick == "plan":
            _, fp, contact = ctrl.feet_and_contact(phys)
            f0 = ctrl.plan(phys, fp, contact, command).forces[:, 0]
        else:
            _, fs = ctrl.plan_tick_cuda(phys, command)
            f0 = fs[:, 0]
            contact = ctrl.feet_and_contact(phys)[2]
        for _ in range(4):
            # 200 Hz leg loop: remap the held plan force each substep
            tau = ctrl.leg_torques(phys, f0, contact)
            phys = dynamics.step(model, params, phys, tau, _flat, 0.005)
        zs.append(phys.base_pos[:, 2].clone())
    zs = torch.stack(zs).numpy()
    assert zs.min() > 0.2, zs.min()
    assert abs(float(phys.base_quat[0, 3])) > 0.99
    assert float(torch.linalg.vector_norm(phys.base_lin_vel[0])) < 0.2
