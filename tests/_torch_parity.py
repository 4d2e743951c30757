"""Shared helpers for the parity tests of the PyTorch port (test_torch_*.py).

Data crosses between the two packages as numpy arrays.  JAX random streams
cannot be reproduced in torch, so a parity test starts both sides from one
JAX-made state.
"""

import dataclasses

import numpy as np
import torch

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


# ------------------------------------------------- PPO update, both sides

# |g| / max |g| of its tensor below which a gradient entry may be roundoff
# noise around zero
GRAD_FLOOR = 1e-4


def jax_minibatches(jppo, ts, roll, last_value, perms, carry0=None):
    """The JAX package's `PPO.update` unrolled minibatch by minibatch, with
    its own `_loss` and `_sgd_step` and the given per-epoch permutations:
    the metrics and the gradients (as the port's state dicts) of every
    minibatch, and the final TrainState.  With `carry0`, `RecurrentPPO.update`
    the same way: minibatches of envs, its `_loss_seq` from their carries."""
    import jax
    import jax.numpy as jnp

    from pointfoot_tpu.rl import ppo as jppo_mod
    from pointfoot_tpu_torch.utils import convert

    cfg = jppo.cfg
    adv, ret = jppo_mod.compute_gae(roll.reward, roll.done, roll.time_out,
                                    roll.value, last_value, cfg.gamma,
                                    cfg.lam)
    if carry0 is None:
        n = adv.size
        flat = jax.tree.map(lambda x: x.reshape((n,) + x.shape[2:]), roll)
        adv, ret = adv.reshape(-1), ret.reshape(-1)

        def loss_grad(params, idx):
            mb = jax.tree.map(lambda x: x[idx], flat)
            return jax.value_and_grad(jppo._loss, has_aux=True)(
                params, mb, adv[idx], ret[idx])
    else:
        n = adv.shape[1]

        def loss_grad(params, idx):
            mb = jax.tree.map(lambda x: x[:, idx], roll)
            c0 = jax.tree.map(lambda c: c[idx], carry0)
            return jax.value_and_grad(jppo._loss_seq, has_aux=True)(
                params, c0, mb, adv[:, idx], ret[:, idx])

    @jax.jit
    def step(ts, idx):
        (_, m), g = loss_grad(ts.params, idx)
        m = dict(m, lr_intra=ts.learning_rate)
        return jppo._sgd_step(ts, g, m), m, g

    mb_size = n // cfg.num_mini_batches
    metrics, grads = [], []
    for perm in perms:
        for i in range(cfg.num_mini_batches):
            ts, m, g = step(ts, jnp.asarray(perm[i * mb_size:
                                                 (i + 1) * mb_size]))
            metrics.append(jax.tree.map(np.asarray, m))
            grads.append(convert.actor_critic_state_dict(
                jax.tree.map(np.asarray, g)))
    return metrics, grads, ts


def adam_bound(grads, metrics, name: str) -> np.ndarray:
    """Per entry of parameter `name`, how far the two packages' values may
    lie apart after an update: 1e-6 where every step's gradient stayed
    clear of zero (|g| > GRAD_FLOOR of its tensor's largest), else
    2 * (sum of the rates used) + 1e-6, since Adam's step is about
    lr * sign(g) and the sign of roundoff noise is arbitrary."""
    g = np.stack([gr[name].numpy() for gr in grads])
    scale = np.abs(g).reshape(len(g), -1).max(axis=1)
    clear = (np.abs(g) > GRAD_FLOOR * scale.reshape(
        (-1,) + (1,) * (g.ndim - 1))).all(axis=0)
    lr_sum = float(sum(m["lr_intra"] for m in metrics))
    return np.where(clear, 1e-6, 2.0 * lr_sum + 1e-6)


def procedural_points(spec, envs: int, points: int, seed: int = 0):
    """(x, y) query points, (envs, points) float32 on the CPU, for a
    ProcSpec: uniform over the grid, its border and 1 m beyond, then rows
    on the clip edges (the last cell row and column, the grid's origin),
    and NaN and infinite coordinates."""
    g = np.random.default_rng(seed)
    R, C = spec.shape
    hs, b = spec.hscale, spec.border * spec.hscale
    x = g.uniform(-b - 1.0, R * hs - b + 1.0, (envs, points))
    y = g.uniform(-b - 1.0, C * hs - b + 1.0, (envs, points))
    x[0] = (R - 2) * hs - b  # the clip edges, exactly and just beyond
    y[1] = (C - 2) * hs - b
    x[2] = np.nextafter(np.float32((R - 2) * hs - b), np.float32(np.inf))
    x[3], y[3] = -b, -b
    x[4, ::3] = np.nan
    y[4, 1::3] = np.nan
    x[5, ::2] = np.inf
    y[5, 1::2] = -np.inf
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(y.astype(np.float32)))


def assert_bits_equal(got, want) -> None:
    """The same float32 bits wherever `want` is a number, NaN where it is
    NaN."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))
