"""Shared helpers for the parity tests of the PyTorch port (test_torch_*.py).

Data crosses between the two packages as numpy arrays.  JAX random streams
cannot be reproduced in torch, so a parity test starts both sides from one
JAX-made state.
"""

import dataclasses

import numpy as np

B = 8
# Procedural terrain, as the flagship trained, without observation noise, so
# a stretch of steps without resets is deterministic on both sides.  The 8
# envs sit on terrain-type columns 0-7 (slopes, rough slopes, stairs), where
# these proportions give the same heights as the flagship's
# (0.1, 0.1, 0.35, 0.25, 0.2); they drop the discrete-obstacle family,
# whose trace costs the JAX side ~80 s of CPU compile per jitted function.
# test_torch_terrain.py holds every family, obstacles included.
ROUGH_PATCH = dict(
    terrain=dict(procedural=True, terrain_proportions=(0.1, 0.1, 0.35, 0.45)),
    noise=dict(add_noise=False))


def export_fields(obj) -> dict:
    """A flax struct as {field: np.ndarray}, nested structs as dicts."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = (export_fields(v) if dataclasses.is_dataclass(v)
                       else np.asarray(v))
    return out


def jax_rough_env(num_envs: int = B):
    from pointfoot_tpu.utils.registry import task_registry

    return task_registry.make_env("pointfoot_rough", num_envs=num_envs,
                                  cfg_patch=ROUGH_PATCH)


def torch_rough_env(num_envs: int = B):
    from pointfoot_tpu_torch.utils.registry import make_env

    return make_env("pointfoot_rough", num_envs=num_envs, device="cpu",
                    cfg_patch=ROUGH_PATCH)


def physics_rig(name: str, batch: int) -> dict:
    """The rig of tests/test_pallas_substep.py:22-47 made with numpy from a
    seed: `batch` envs of robot `name` with random poses and velocities,
    bases from 15 cm below to 1 m above nominal height, random torques
    (`tau`) and a base push (`ext`); the JAX model, state and params (`jm`,
    `js`, `jp`) and the port's (`tm`, `ts`, `tp`)."""
    import jax.numpy as jnp

    from pointfoot_tpu.physics.assets import get_model as jget_model
    from pointfoot_tpu.physics.model import PhysicsParams as JParams
    from pointfoot_tpu.physics.model import PhysicsState as JState
    from pointfoot_tpu_torch.physics.assets import get_model
    from pointfoot_tpu_torch.utils import convert

    B = batch
    rng = np.random.default_rng(3)
    jm = jget_model(name)
    nj, nc = jm.nj, len(jm.collision_body)
    q = np.array([0.0, 0.0, 0.0, 1.0]) + 0.1 * rng.standard_normal((B, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    state = dict(
        base_pos=f32(np.c_[np.zeros((B, 2)),
                           0.5 + rng.uniform(-0.15, 1.0, B)]),
        base_quat=f32(q),
        base_lin_vel=f32(0.5 * rng.standard_normal((B, 3))),
        base_ang_vel=f32(0.8 * rng.standard_normal((B, 3))),
        qpos=f32(0.4 * rng.standard_normal((B, nj))),
        qvel=f32(1.5 * rng.standard_normal((B, nj))),
        contact_force=np.zeros((B, nc, 3), np.float32))
    jp = JParams.nominal(jm, batch=(B,)).replace(
        friction=jnp.asarray(f32(rng.uniform(0.3, 1.2, (B, nc)))),
        added_mass=jnp.asarray(f32(rng.uniform(-0.5, 2.0, B))),
        com_offset=jnp.asarray(f32(0.02 * rng.standard_normal((B, 3)))))
    tau = f32(10.0 * rng.standard_normal((B, nj)))
    ext = f32(20.0 * rng.standard_normal((B, 3)))
    js = JState(**{k: jnp.asarray(v) for k, v in state.items()})
    return dict(
        jm=jm, js=js, jp=jp, tau=tau, ext=ext,
        tm=get_model(name), ts=convert.physics_state_from_numpy(state),
        tp=convert.physics_params_from_numpy(export_fields(jp)))


def srb_lqr_problem(num: int, m: int, seed: int = 0):
    """The random dense SRB-LQR problem of tests/test_pallas.py:60-72 at
    `num` scenarios and `m` inputs, as numpy arrays (F, c, L, Xd, Ud, XTd,
    x0, f_ff): F is perturbed everywhere, so no sparsity can be assumed."""
    rng = np.random.default_rng(seed)
    n = 12
    F = np.tile(np.eye(n, dtype=np.float32), (num, 1, 1))
    F[:, 0:3, 6:9] += 0.02 * np.eye(3)
    F[:, 3:6, 9:12] += 0.02 * np.eye(3)
    F += 0.01 * rng.normal(size=(num, n, n)).astype(np.float32)
    c = 0.05 * rng.normal(size=(num, n)).astype(np.float32)
    L = 0.1 * rng.normal(size=(num, n, m)).astype(np.float32)
    Xd = np.abs(rng.normal(size=(num, n))).astype(np.float32) + 0.5
    Ud = np.abs(rng.normal(size=(num, m))).astype(np.float32) * 0.01 + 0.005
    XTd = 2.0 * Xd
    x0 = rng.normal(size=(num, n)).astype(np.float32)
    f_ff = rng.normal(size=(num, m)).astype(np.float32)
    return F, c, L, Xd, Ud, XTd, x0, f_ff
