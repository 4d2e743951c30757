"""The gait-MPC stepping stack of the PyTorch port (mpc/gait.py) and the
analytic terrains (terrain/analytic.py) against the JAX package's, on the
CPU.

Closed loops are chaotic (a falling biped amplifies ulps), so parity is per
tick from the same inputs: JAX's controller drives a short loop (its
torques stepped by the port's plain `dynamics.step`, itself held to JAX's
in test_torch_dynamics.py), and at every tick the JAX state and JAX
GaitState go through both controllers.  The discrete decisions (stance,
loaded, the SRB contact gate) are compared exactly and the continuous
state to 1e-5.  The planned stance forces of a biped are ill-conditioned:
its static feedforward solves a 6x6 system that two point feet leave
singular but for a 1e-6 regulariser (test_torch_srb.py,
`test_static_ff_off_nominal_pointfoot`), so float32 roundoff moves the
forces by up to several N in either package.  Forces and torques are held
to FORCE_SPREAD x the port's own change under two one-ulp nudges of the
joint angles at the same tick, plus a floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointfoot_tpu.mpc import gait as jgait
from pointfoot_tpu.physics import contact as jcontact
from pointfoot_tpu.physics.model import PhysicsState as JState
from pointfoot_tpu.terrain import analytic as janalytic
from pointfoot_tpu_torch.mpc import gait
from pointfoot_tpu_torch.mpc.srb import SRBConfig
from pointfoot_tpu_torch.physics import contact, dynamics
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
from pointfoot_tpu_torch.terrain import analytic
from pointfoot_tpu_torch.utils import convert

from _torch_parity import export_fields

# tiny tensors: intra-op threads only add contention between test workers
torch.set_num_threads(1)

SPECS = ["flat", "slope:0.15", "wave:0.04", "bumps:0.05", "step:0.05",
         "step:-0.05", "", "wave"]
STATE_ATOL = 1e-5  # gait-state fields, targets and x0 (observed <= 4e-7)
FORCE_SPREAD = 4.0
FORCE_FLOOR = 0.5  # N
TAU_FLOOR = 0.1  # N·m


# --------------------------------------------------------- the terrains

@pytest.mark.parametrize("spec", SPECS)
def test_make_terrain_matches_jax(spec):
    """Heights to 1e-6 m and the finite-difference surface
    (contact.query_surface) to 1e-4 at seeded points, float64 inputs
    included (both cast to float32)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 3.0, (7, 5))
    y = rng.uniform(-2.0, 2.0, (7, 5))
    jf, tf = janalytic.make_terrain(spec), analytic.make_terrain(spec)
    want = np.asarray(jf(x, y))
    got = tf(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    xf, yf = x.astype(np.float32), y.astype(np.float32)
    jh, jn = jcontact.query_surface(jf, jnp.asarray(xf), jnp.asarray(yf))
    th, tn = contact.query_surface(tf, torch.from_numpy(xf),
                                   torch.from_numpy(yf))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-4)


def test_terrain_specs_and_adapter():
    assert analytic.make_terrain("flat") is analytic.FLAT
    assert analytic.make_terrain("") is analytic.FLAT
    assert not hasattr(analytic.FLAT, "is_flat")
    with pytest.raises(ValueError, match="unknown terrain spec"):
        analytic.make_terrain("cliff:1")
    with pytest.raises(ValueError):
        janalytic.make_terrain("cliff:1")
    f = analytic.make_terrain("wave:0.04")
    assert analytic.AnalyticTerrain(f).height_at is f
    # every field is 0 at the origin
    for spec in SPECS:
        assert float(analytic.make_terrain(spec)(0.0, 0.0)) == 0.0


# -------------------------------------------------- make_controller

ROBOTS = ["pointfoot", "a1", "anymal_c", "anymal_b", "cassie"]


@pytest.mark.parametrize("robot", ROBOTS)
@pytest.mark.parametrize("which", ["trot", "walk"])
def test_make_controller_matches_jax(robot, which):
    """Every GaitConfig and SRBConfig field, q0, z0, ctrl_dt, substeps,
    feet, offsets, the hip joints and the neutral stance offsets (1e-6 m)
    equal JAX's; the bipeds refuse the walk."""
    if which == "walk" and robot in ("pointfoot", "cassie"):
        with pytest.raises(ValueError, match="needs a quadruped"):
            gait.make_controller(robot, gait="walk", device="cpu")
        return
    js = jgait.make_controller(robot, gait=which)
    ts = gait.make_controller(robot, gait=which, device="cpu")
    assert vars(ts.ctrl.gait) == vars(js.ctrl.gait)
    assert vars(ts.ctrl.srb) == vars(js.ctrl.srb)
    np.testing.assert_array_equal(ts.q0.numpy(), np.asarray(js.q0))
    assert (ts.z0, ts.ctrl_dt, ts.substeps) == (js.z0, js.ctrl_dt,
                                                js.substeps)
    assert ts.ctrl.dt == js.ctrl.dt
    assert ts.ctrl.feet_idx == js.ctrl.feet_idx
    assert ts.ctrl._hip_joint == js.ctrl._hip_joint
    np.testing.assert_array_equal(ts.ctrl.offsets.numpy(),
                                  np.asarray(js.ctrl.offsets))
    np.testing.assert_allclose(ts.ctrl._neutral_off.numpy(),
                               np.asarray(js.ctrl._neutral_off), atol=1e-6)
    assert ts.ctrl.height_fn is None


def test_make_controller_errors_and_overrides():
    """The ValueErrors of tests/test_gait.py:594-597 and the others of
    make_controller; overrides merge over the tuned defaults."""
    for robot, g in (("pointfoot", "walk"), ("a1", "bound"),
                     ("a1", "pace"), ("cassie", "walk")):
        with pytest.raises(ValueError):
            gait.make_controller(robot, gait=g, device="cpu")
        with pytest.raises(ValueError):
            jgait.make_controller(robot, gait=g)
    # an unknown robot has no baked model, in both packages
    with pytest.raises(FileNotFoundError):
        gait.make_controller("hexapod", device="cpu")
    with pytest.raises(FileNotFoundError):
        jgait.make_controller("hexapod")
    ts = gait.make_controller("a1", gait_overrides={"period": 0.3},
                              srb_overrides={"f_max": 150.0}, device="cpu")
    assert ts.ctrl.gait.period == 0.3 and ts.ctrl.srb.f_max == 150.0
    assert ts.ctrl.gait.anchor == "hip"


def test_make_controller_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gait.make_controller("pointfoot")


def test_heading_command_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((9, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    vxy = rng.standard_normal((9, 2)).astype(np.float32)
    heading = rng.uniform(-4.0, 4.0, 9).astype(np.float32)
    for gain, wz_max in ((0.5, 1.0), (2.0, 0.3)):
        want = jgait.heading_command(jnp.asarray(q), jnp.asarray(vxy),
                                     jnp.asarray(heading), gain, wz_max)
        got = gait.heading_command(torch.from_numpy(q),
                                   torch.from_numpy(vxy),
                                   torch.from_numpy(heading), gain, wz_max)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ------------------------------------ the fast cases of tests/test_gait.py

def test_gait_clock_alternates():
    """tests/test_gait.py:19-33 on the port's clock."""
    g = gait.GaitConfig(period=0.4, duty=0.55)
    offsets = torch.tensor([0.0, 0.5])
    both_stance = single = 0
    for k in range(40):
        st = gait._leg_phase(torch.tensor(k / 40.0), offsets) < g.duty
        if bool(st[0]) and bool(st[1]):
            both_stance += 1
        elif bool(st[0]) != bool(st[1]):
            single += 1
    assert both_stance > 0
    assert single > both_stance
    assert vars(gait.GaitConfig()) == vars(jgait.GaitConfig())


def _pointfoot(height_fn=None, srb_cfg=None):
    model = get_model("pointfoot")
    kw = {} if srb_cfg is None else dict(srb_cfg=srb_cfg)
    return gait.SteppingController(
        model, PhysicsParams.nominal(model, 1, "cpu"),
        model.collision_indices("foot"), np.zeros(6), height_fn=height_fn,
        **kw)


def test_stepping_controller_runs_and_schedules():
    """tests/test_gait.py:36-60 on the port."""
    ctrl = _pointfoot(srb_cfg=SRBConfig(height_target=0.6))
    B = 2
    phys = PhysicsState.default(ctrl.model, np.zeros(6), B, "cpu",
                                base_height=0.62)
    g = ctrl.init(B, phys)
    cmd = torch.zeros(B, 3)
    phases = []
    for _ in range(12):
        tau, g = ctrl.control(phys, cmd, g)
        phases.append(float(g.phase[0]))
        assert bool(torch.isfinite(tau).all())
        assert float(tau.abs().max()) <= float(ctrl.model.effort_limit.max())
    np.testing.assert_allclose(np.diff(phases), 0.02 / ctrl.gait.period,
                               atol=1e-5)
    assert bool(torch.isfinite(g.target_pos).all())
    assert float(g.target_pos[..., :2].abs().max()) < 1.0


def test_step_targets_avoid_terrain_edges():
    """tests/test_gait.py:63-93 on the port: no target inside the band
    around the 5 cm ledge lip at x = 1, and the target z rides the
    terrain under the (shifted) target xy."""
    ctrl = _pointfoot(height_fn=analytic.make_terrain("step:0.05"))
    B = 1
    phys = PhysicsState.default(ctrl.model, np.zeros(6), B, "cpu",
                                base_height=0.62)
    phys = phys.replace(base_pos=torch.tensor([[0.97, 0.0, 0.62]]),
                        base_lin_vel=torch.tensor([[0.4, 0.0, 0.0]]))
    g = ctrl.init(B, phys)
    cmd = torch.tensor([[0.4, 0.0, 0.0]])
    for _ in range(30):
        tau, g = ctrl.control(phys, cmd, g)
        tx = g.target_pos[0, :, 0].numpy()
        assert not np.any((tx > 1.0 - 0.055) & (tx < 1.0 + 0.055)), tx
        tz = g.target_pos[0, :, 2].numpy()
        for x, z in zip(tx, tz):
            assert abs(z - (0.05 if x > 1.0 else 0.0)) < 0.03, (x, z)


# --------------------------------------------- per-tick parity of control

# robot, terrain spec, ticks, command, base x offsets of the 4 scenarios
CASES = {
    "pointfoot_flat": ("pointfoot", "", 25, (0.4, 0.0, 0.2),
                       (0.0, 0.3, 0.6, 0.9)),
    "pointfoot_ledge": ("pointfoot", "step:0.05", 25, (0.4, 0.0, 0.0),
                        (0.55, 0.65, 0.75, 0.85)),
    # 200 Hz: the first liftoffs come after ~40 ticks
    "a1": ("a1", "", 45, (0.4, 0.0, 0.2), (0.0, 0.1, 0.2, 0.3)),
    "cassie": ("cassie", "", 50, (0.6, 0.0, 0.2), (0.0, 0.1, 0.2, 0.3)),
}
B = 4


def _nudged(phys: PhysicsState, seed: int) -> PhysicsState:
    g = torch.Generator().manual_seed(seed)
    return phys.replace(qpos=phys.qpos * (
        1 + 1.2e-7 * torch.randn(phys.qpos.shape, generator=g)))


@pytest.mark.parametrize("case", list(CASES))
def test_control_matches_jax_per_tick(case):
    """Torques, every GaitState field and the debug dict of
    SteppingController.control against JAX's at every tick of a short loop
    from perturbed starts: pointfoot on flat ground (50 Hz, 4 substeps),
    pointfoot on a 5 cm ledge (edge shift, path-max clearance, terrain
    height reference), A1 (hip anchor, horizon contact schedule) and
    Cassie (six joints a leg, posture spring without a ramp)."""
    robot, spec, ticks, command, x0 = CASES[case]
    jh = janalytic.make_terrain(spec) if spec else None
    th = analytic.make_terrain(spec) if spec else None
    js = jgait.make_controller(robot, height_fn=jh)
    ts = gait.make_controller(robot, height_fn=th, device="cpu")
    rng = np.random.default_rng(7)
    phys = JState.default(js.ctrl.model, js.q0, batch=(B,),
                          base_height=js.z0)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    phys = phys.replace(
        base_pos=phys.base_pos.at[:, 0].add(f32(x0)),
        base_lin_vel=f32(0.15 * rng.standard_normal((B, 3))),
        base_ang_vel=f32(0.15 * rng.standard_normal((B, 3))))
    jg = js.ctrl.init(B, phys)
    tg = ts.ctrl.init(B, convert.physics_state_from_numpy(
        export_fields(phys)))
    for f in jg._fields:
        np.testing.assert_allclose(getattr(tg, f).numpy(),
                                   np.asarray(getattr(jg, f)), atol=1e-6,
                                   err_msg=f"init {f}")
    cmd = jnp.broadcast_to(jnp.asarray(command, jnp.float32), (B, 3))
    tcmd = torch.from_numpy(np.array(cmd))
    control = jax.jit(lambda p, c, g: js.ctrl.control(p, c, g, debug=True))
    model = ts.ctrl.model
    params = PhysicsParams.nominal(model, B, "cpu")
    hfn = th or analytic.FLAT
    dt = ts.ctrl_dt / ts.substeps
    for tick in range(ticks):
        tau, jg_new, dbg = control(phys, cmd, jg)
        tp = convert.physics_state_from_numpy(export_fields(phys))
        tgs = convert.gait_state_from_numpy(jg._asdict())
        ttau, tg_new, tdbg = ts.ctrl.control(tp, tcmd, tgs, debug=True)
        where = f"{case} tick {tick}"
        for f in jg_new._fields:
            np.testing.assert_allclose(
                getattr(tg_new, f).numpy(), np.asarray(getattr(jg_new, f)),
                rtol=0, atol=STATE_ATOL, err_msg=f"{where}: {f}")
        for k in ("stance", "loaded", "ct"):
            assert np.array_equal(tdbg[k].numpy(), np.asarray(dbg[k])), (
                f"{where}: {k} port {tdbg[k].numpy()} JAX "
                f"{np.asarray(dbg[k])}")
        for k in ("target", "x0"):
            np.testing.assert_allclose(tdbg[k].numpy(), np.asarray(dbg[k]),
                                       rtol=0, atol=STATE_ATOL,
                                       err_msg=f"{where}: {k}")
        # the port's own spread under one-ulp nudges of the joint angles
        f_spread = torch.zeros(())
        t_spread = torch.zeros(())
        for seed in (1, 2):
            ntau, _, nd = ts.ctrl.control(_nudged(tp, seed), tcmd, tgs,
                                          debug=True)
            f_spread = torch.maximum(f_spread,
                                     (nd["f0"] - tdbg["f0"]).abs().max())
            t_spread = torch.maximum(t_spread, (ntau - ttau).abs().max())
        f_err = float((tdbg["f0"] - torch.from_numpy(
            np.array(dbg["f0"]))).abs().max())
        t_err = float((ttau - torch.from_numpy(np.array(tau))).abs().max())
        f_tol = FORCE_FLOOR + FORCE_SPREAD * float(f_spread)
        t_tol = TAU_FLOOR + FORCE_SPREAD * float(t_spread)
        assert f_err <= f_tol, (f"{where}: forces differ by {f_err} N, "
                                f"tolerance {f_tol} (spread {f_spread})")
        assert t_err <= t_tol, (f"{where}: torques differ by {t_err} N·m, "
                                f"tolerance {t_tol} (spread {t_spread})")
        # advance the JAX loop: its torques, the port's plain physics
        for _ in range(ts.substeps):
            tp = dynamics.step(model, params, tp, torch.from_numpy(
                np.array(tau)), hfn, dt)
        phys = JState(**{k: jnp.asarray(v.numpy())
                         for k, v in vars(tp).items()})
        jg = jg_new
    assert bool(torch.isfinite(tp.base_pos).all())
