"""The port's fused rollout (plain path, CPU) vs the JAX env's physics.

`pointfoot_tpu_torch.ops.cuda.substep.rollout_substeps` on CPU tensors runs
the plain version of the CUDA kernels; it is held to the JAX env's
`_physics_rollout` on rough procedural terrain, with a push on substep 0,
at the tolerances of tests/test_pallas_substep.py:141-151.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import B, export_fields, jax_rough_env, torch_rough_env
from pointfoot_tpu.physics import dynamics
from pointfoot_tpu_torch.ops.cuda import substep as sp
from pointfoot_tpu_torch.utils import convert


@pytest.fixture(scope="module")
def rig():
    """A contact-rich state: bases lowered onto the terrain under them,
    random joint and base velocities, a push queued."""
    jenv = jax_rough_env()
    js = jenv.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    p = js.physics
    xy = np.asarray(p.base_pos[:, :2])
    ground = np.asarray(jenv.terrain.height_at(jnp.asarray(xy[:, 0]),
                                               jnp.asarray(xy[:, 1])))
    z = ground + rng.uniform(0.54, 0.62, B)
    phys = p.replace(
        base_pos=jnp.asarray(np.c_[xy, z], jnp.float32),
        base_lin_vel=jnp.asarray(0.3 * rng.standard_normal((B, 3)),
                                 jnp.float32),
        base_ang_vel=jnp.asarray(0.5 * rng.standard_normal((B, 3)),
                                 jnp.float32),
        qpos=jnp.asarray(0.2 * rng.standard_normal((B, 6)), jnp.float32),
        qvel=jnp.asarray(rng.standard_normal((B, 6)), jnp.float32))
    js = js.replace(
        physics=phys,
        push_force=jnp.asarray(5.0 * rng.standard_normal((B, 3)),
                               jnp.float32),
        last_qvel=jnp.asarray(rng.standard_normal((B, 6)), jnp.float32))
    actions = (0.3 * rng.standard_normal((B, 6))).astype(np.float32)
    ref = jenv._physics_rollout(js, jnp.asarray(actions))
    return jenv, js, actions, ref


def _torch_rollout(tenv, js, actions):
    ts = convert.env_state_from_numpy(export_fields(js))
    c = tenv.cfg.control
    return sp.rollout_substeps(
        tenv.model, ts.params, ts.physics, torch.from_numpy(actions),
        ts.last_qvel, ts.push_force, tenv.height_fn, tenv.cfg.sim.dt,
        c.decimation, tenv.default_qpos_values, c.action_scale,
        c.control_type, gravity=tenv.cfg.sim.gravity)


def test_rollout_substeps_matches_jax_physics_rollout(rig):
    jenv, js, actions, (phys_ref, tau_ref, _, _) = rig
    tenv = torch_rough_env()
    phys, tau, sphere = _torch_rollout(tenv, js, actions)
    cf_ref = np.asarray(phys_ref.contact_force)
    assert np.abs(cf_ref).max() > 10.0, "the state should be in contact"
    np.testing.assert_allclose(phys.qvel.numpy(), phys_ref.qvel, atol=2e-3)
    np.testing.assert_allclose(phys.base_lin_vel.numpy(),
                               phys_ref.base_lin_vel, atol=5e-4)
    np.testing.assert_allclose(phys.base_pos.numpy(), phys_ref.base_pos,
                               atol=5e-5)
    np.testing.assert_allclose(phys.contact_force.numpy(), cf_ref,
                               atol=0.05, rtol=1e-3)
    np.testing.assert_allclose(tau.numpy(), tau_ref, atol=5e-3)
    feet = jenv._foot_positions(phys_ref, js.params)
    np.testing.assert_allclose(sphere.numpy()[:, list(jenv.feet_idx)],
                               feet, atol=5e-5)


def test_fk_from_state_matches_jax_forward_kinematics(rig):
    jenv, js, _, _ = rig
    m = jenv.model
    kin = jax.vmap(lambda s, p: dynamics.forward_kinematics(m, s, p))(
        js.physics, js.params)
    want = np.stack([
        np.asarray(kin.body_pos[:, b] + jnp.einsum(
            "bij,j->bi", kin.body_rot[:, b], m.collision_offset[c]))
        for c, b in enumerate(m.collision_body)], axis=1)
    tenv = torch_rough_env()
    phys = convert.physics_state_from_numpy(export_fields(js.physics))
    got = sp.fk_from_state(tenv.model, phys)
    assert got.shape == (B, len(m.collision_body), 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_flat_rollout_matches_level_surface():
    """The flat path (no surface rows) equals a level surface at z=0."""
    tenv = torch_rough_env()
    ts = tenv.init_state(3)
    actions = torch.zeros(B, 6)

    def level(x, y):
        return torch.zeros_like(x)

    level.surface_fn = lambda x, y: (
        torch.zeros_like(x), torch.tensor([0.0, 0.0, 1.0]).expand(
            x.shape + (3,)))
    flat = lambda x, y: torch.zeros_like(x)  # noqa: E731
    flat.is_flat = True
    xy = ts.physics.base_pos * torch.tensor([1.0, 1.0, 0.0])
    phys = dataclasses.replace(
        ts.physics, base_pos=xy + torch.tensor([0.0, 0.0, 0.57]))
    c = tenv.cfg.control
    outs = [sp.rollout_substeps(
        tenv.model, ts.params, phys, actions, ts.last_qvel, ts.push_force,
        hf, tenv.cfg.sim.dt, c.decimation, tenv.default_qpos_values,
        c.action_scale, c.control_type) for hf in (flat, level)]
    (pf, tf, sf), (pl, tl, sl) = outs
    assert pl.contact_force.abs().max() > 10.0
    np.testing.assert_allclose(pf.qvel.numpy(), pl.qvel.numpy(), atol=1e-5)
    np.testing.assert_allclose(pf.contact_force.numpy(),
                               pl.contact_force.numpy(), atol=1e-3)
    np.testing.assert_allclose(tf.numpy(), tl.numpy(), atol=1e-5)
    np.testing.assert_allclose(sf.numpy(), sl.numpy(), atol=1e-6)


def test_wrappers_refuse_other_devices():
    """A wrapper runs the plain version only for CPU tensors."""
    mc = sp.model_consts(torch_rough_env().model)
    rows = torch.zeros(31, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sp.fk_rows(mc, rows)
    with pytest.raises(ValueError, match="unsupported device"):
        sp.rollout_step(mc, rows, torch.zeros(42, 4, device="meta"), None,
                        True, (0.0,) * 6, 0.5, "P", 0.005, 9.81)
