"""The port's batched dynamics (physics/dynamics.py, ops/spatial.py,
ops/linalg.py) vs the JAX package, on the CPU.

The rig of tests/test_pallas_substep.py:22-47, made with numpy from a seed:
16 envs of PointFoot and of ANYmal C with random poses and velocities,
bases from 15 cm below to 1 m above nominal height, random torques and a
base push.  The JAX side vmaps its single-env functions; the port takes the
batch as its leading axis.  Tolerances: those of
tests/test_pallas_substep.py:50-60 for a step; 1e-5 for kinematics, the
spatial and linear-algebra ops; 1e-4 absolute with 1e-5 relative for the
entries of the mass matrix, bias forces and velocity system, which reach
O(100).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import physics_rig
from pointfoot_tpu.ops import linalg as jlinalg
from pointfoot_tpu.ops import spatial as jspatial
from pointfoot_tpu.physics import dynamics as jdyn
from pointfoot_tpu_torch.ops import linalg, spatial
from pointfoot_tpu_torch.physics import dynamics

B = 16
DT = 0.005
SLOPE = (0.12, -0.08)


@pytest.fixture(scope="module", params=["pointfoot", "anymal_c"])
def rig(request):
    return physics_rig(request.param, B)


def _height_fns(kind):
    if kind == "flat":
        return (lambda x, y: jnp.zeros_like(jnp.asarray(x, jnp.float32)),
                lambda x, y: torch.zeros_like(x))
    gx, gy = SLOPE
    return (lambda x, y: gx * x + gy * y, lambda x, y: gx * x + gy * y)


def _kin(r):
    jkin = jax.vmap(lambda s, p: jdyn.forward_kinematics(r["jm"], s, p))(
        r["js"], r["jp"])
    tkin = dynamics.forward_kinematics(r["tm"], r["ts"], r["tp"])
    return jkin, tkin


def test_forward_kinematics(rig):
    jkin, tkin = _kin(rig)
    for f in jkin._fields:
        np.testing.assert_allclose(getattr(tkin, f).numpy(),
                                   np.asarray(getattr(jkin, f)), atol=1e-5,
                                   rtol=1e-5, err_msg=f)


def _terms(r):
    """(S, body velocities, origin) on both sides."""
    jkin, tkin = _kin(r)
    jm, tm = r["jm"], r["tm"]
    jS = jax.vmap(lambda k, o: jdyn.motion_subspaces(jm, k, o))(
        jkin, r["js"].base_pos)
    jV = jax.vmap(lambda s, S: jdyn.body_spatial_velocities(jm, s, S))(
        r["js"], jS)
    tS = dynamics.motion_subspaces(tm, tkin, r["ts"].base_pos)
    tV = dynamics.body_spatial_velocities(tm, r["ts"], tS)
    return (jkin, jS, jV), (tkin, tS, tV)


def test_mass_matrix_and_bias_forces(rig):
    (jkin, jS, jV), (tkin, tS, tV) = _terms(rig)
    np.testing.assert_allclose(tS.numpy(), jS, atol=1e-5)
    np.testing.assert_allclose(tV.numpy(), jV, atol=1e-5, rtol=1e-5)
    jm, tm, js, jp = rig["jm"], rig["tm"], rig["js"], rig["jp"]
    jM = jax.vmap(lambda p, k, S, o: jdyn.mass_matrix(jm, p, k, S, o))(
        jp, jkin, jS, js.base_pos)
    tM = dynamics.mass_matrix(tm, rig["tp"], tkin, tS, rig["ts"].base_pos)
    np.testing.assert_allclose(tM.numpy(), jM, atol=1e-5, rtol=1e-5)
    jC = jax.vmap(lambda p, k, S, q, V, o: jdyn.bias_forces(
        jm, p, k, S, q, V, o))(jp, jkin, jS, js.qvel, jV, js.base_pos)
    tC = dynamics.bias_forces(tm, rig["tp"], tkin, tS, rig["ts"].qvel, tV,
                              rig["ts"].base_pos)
    np.testing.assert_allclose(tC.numpy(), jC, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("terrain", ["flat", "slope"])
def test_assemble_velocity_solve(rig, terrain):
    jhf, thf = _height_fns(terrain)
    jm = rig["jm"]
    jA, jrhs, jterms = jax.vmap(
        lambda p, s, t, f: jdyn.assemble_velocity_solve(
            jm, p, s, t, jhf, DT, f))(rig["jp"], rig["js"],
                                      jnp.asarray(rig["tau"]),
                                      jnp.asarray(rig["ext"]))
    tA, trhs, tterms = dynamics.assemble_velocity_solve(
        rig["tm"], rig["tp"], rig["ts"], torch.from_numpy(rig["tau"]), thf,
        DT, torch.from_numpy(rig["ext"]))
    assert np.asarray(jterms.active).any(), "the rig should be in contact"
    np.testing.assert_array_equal(tterms.active.numpy(), jterms.active)
    np.testing.assert_allclose(tA.numpy(), jA, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(trhs.numpy(), jrhs, atol=1e-4, rtol=1e-5)
    for f in ("jac", "f_spring", "damp", "normal"):
        np.testing.assert_allclose(getattr(tterms, f).numpy(),
                                   np.asarray(getattr(jterms, f)),
                                   atol=1e-4, rtol=1e-5, err_msg=f)


def _assert_step_close(got, ref):
    """tests/test_pallas_substep.py:50-60."""
    np.testing.assert_allclose(got.base_lin_vel.numpy(), ref.base_lin_vel,
                               atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(got.base_ang_vel.numpy(), ref.base_ang_vel,
                               atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(got.qvel.numpy(), ref.qvel, atol=1e-3,
                               rtol=3e-4)
    np.testing.assert_allclose(got.base_pos.numpy(), ref.base_pos, atol=2e-5)
    np.testing.assert_allclose(got.base_quat.numpy(), ref.base_quat,
                               atol=2e-5)
    np.testing.assert_allclose(got.qpos.numpy(), ref.qpos, atol=2e-5)
    np.testing.assert_allclose(got.contact_force.numpy(), ref.contact_force,
                               atol=0.1, rtol=1e-3)


@pytest.mark.parametrize("terrain", ["flat", "slope"])
def test_step_batched_plain(rig, terrain):
    jhf, thf = _height_fns(terrain)
    ref = jdyn.step_batched(rig["jm"], rig["jp"], rig["js"],
                            jnp.asarray(rig["tau"]), jhf, DT,
                            external_force=jnp.asarray(rig["ext"]))
    got = dynamics.step_batched(rig["tm"], rig["tp"], rig["ts"],
                                torch.from_numpy(rig["tau"]), thf, DT,
                                external_force=torch.from_numpy(rig["ext"]))
    assert np.abs(np.asarray(ref.contact_force)).max() > 10.0
    _assert_step_close(got, ref)


# ------------------------------------------------------------ small ops

def _vecs(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", ["skew", "motion_cross", "force_cross",
                                  "spatial_inertia", "revolute_subspace",
                                  "point_velocity", "force_at_point",
                                  "rotate_inertia"])
def test_spatial_ops(name):
    rng = np.random.default_rng(7)
    args = {
        "skew": (_vecs(rng, 5, 3),),
        "motion_cross": (_vecs(rng, 5, 6), _vecs(rng, 5, 6)),
        "force_cross": (_vecs(rng, 5, 6), _vecs(rng, 5, 6)),
        "spatial_inertia": (np.abs(_vecs(rng, 5)) + 0.5, _vecs(rng, 5, 3),
                            _vecs(rng, 5, 3, 3)),
        "revolute_subspace": (_vecs(rng, 5, 3), _vecs(rng, 5, 3)),
        "point_velocity": (_vecs(rng, 5, 6), _vecs(rng, 5, 3)),
        "force_at_point": (_vecs(rng, 5, 3), _vecs(rng, 5, 3),
                           _vecs(rng, 5, 3)),
        "rotate_inertia": (_vecs(rng, 5, 3, 3), _vecs(rng, 5, 3, 3)),
    }[name]
    want = getattr(jspatial, name)(*map(jnp.asarray, args))
    got = getattr(spatial, name)(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("n", [6, 12, 18])
def test_chol_solve_and_factor(n):
    rng = np.random.default_rng(n)
    A = _vecs(rng, 9, n, n)
    A = A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    b = _vecs(rng, 9, n)
    np.testing.assert_allclose(
        linalg.chol_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy(),
        jlinalg.chol_solve(jnp.asarray(A), jnp.asarray(b)), atol=1e-5)
    np.testing.assert_allclose(
        linalg.cholesky_unrolled(torch.from_numpy(A)).numpy(),
        jlinalg.cholesky_unrolled(jnp.asarray(A)), atol=1e-5)
    Bm = _vecs(rng, 9, n, 3)
    np.testing.assert_allclose(
        linalg.chol_solve_matrix(torch.from_numpy(A),
                                 torch.from_numpy(Bm)).numpy(),
        jlinalg.chol_solve_matrix(jnp.asarray(A), jnp.asarray(Bm)),
        atol=1e-5)


def test_inv3():
    rng = np.random.default_rng(11)
    A = _vecs(rng, 20, 3, 3) + 3.0 * np.eye(3, dtype=np.float32)
    A[0] = 0.0  # singular: the eps guard
    np.testing.assert_allclose(linalg.inv3(torch.from_numpy(A)).numpy(),
                               jlinalg.inv3(jnp.asarray(A)), atol=1e-5,
                               rtol=1e-6)
