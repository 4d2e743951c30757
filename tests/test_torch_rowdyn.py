"""Torch-row physics (pointfoot_tpu_torch.physics.rowdyn) vs the JAX rowdyn.

Both fold the same model constants; the rows are (B,) arrays made with
numpy from a seed.  Tolerances are those of tests/test_rowdyn.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointfoot_tpu.physics import rowdyn as jr
from pointfoot_tpu.physics.assets import get_model as jax_model
from pointfoot_tpu_torch.physics import rowdyn as tr
from pointfoot_tpu_torch.physics.assets import get_model as torch_model

DT = 0.005
B = 16
# (key, atol) with rtol 2e-4, as tests/test_rowdyn.py
TOLS = [("base_lin_vel", 2e-4), ("base_ang_vel", 2e-4), ("qvel", 5e-4),
        ("base_pos", 1e-5), ("base_quat", 1e-5), ("qpos", 1e-5),
        ("contact_force", 0.05)]


@pytest.fixture(scope="module")
def consts():
    return jr.ModelConsts(jax_model("pointfoot")), \
        tr.ModelConsts(torch_model("pointfoot"))


def test_model_consts_match(consts):
    jmc, tmc = consts
    for k, v in vars(jmc).items():
        assert getattr(tmc, k) == v, k


def _state(seed, z):
    rng = np.random.default_rng(seed)

    def rows(n, scale, off=0.0):
        return [(off + scale * rng.standard_normal(B)).astype(np.float32)
                for _ in range(n)]

    q = rng.standard_normal((4, B)) * 0.1
    q[3] += 1.0
    q = (q / np.linalg.norm(q, axis=0)).astype(np.float32)
    return {
        "base_pos": rows(2, 0.3) + [np.full(B, z, np.float32)],
        "base_quat": list(q),
        "base_lin_vel": rows(3, 0.5), "base_ang_vel": rows(3, 0.8),
        "qpos": rows(6, 0.4), "qvel": rows(6, 1.5), "last_qvel": rows(6, 1.5),
        "tau": rows(6, 10.0), "ext_force": rows(3, 20.0),
        "actions": rows(6, 0.5), "kp": rows(6, 0.0, 40.0),
        "kd": rows(6, 0.0, 1.5),
        "friction": [rng.uniform(0.3, 1.2, B).astype(np.float32)
                     for _ in range(9)],
        "joint_friction": [rng.uniform(0.0, 0.3, B).astype(np.float32)
                           for _ in range(6)],
        "added_mass": rng.uniform(-0.5, 2.0, B).astype(np.float32),
        "com_offset": rows(3, 0.03),
        "k_contact": np.full(B, 1.2e4, np.float32),
        "d_contact": np.full(B, 1.2e3, np.float32),
    }


def _surface(seed):
    rng = np.random.default_rng(seed + 100)
    n = np.array([0.15, -0.1, 1.0])
    n /= np.linalg.norm(n)
    return [(rng.uniform(-0.05, 0.05, B).astype(np.float32),
             [np.full(B, v, np.float32) for v in n]) for _ in range(9)]


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, fn) for v in tree]
    return fn(tree)


def _np(rows):
    """Nested row lists (constants broadcast) -> flat (n, B) array."""
    flat = []

    def walk(x):
        if isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        else:
            flat.append(np.broadcast_to(np.asarray(x, np.float32), (B,)))

    walk(rows)
    return np.stack(flat)


@pytest.mark.parametrize("surface", [False, True])
@pytest.mark.parametrize("z", [0.55, 0.35, 2.0])  # grounded / deep / flight
def test_substep_rows_match_jax(consts, z, surface):
    jmc, tmc = consts
    st = _state(int(z * 100), z)
    surf = _surface(int(z * 100)) if surface else None
    want = jr.substep_rows(jmc, _to(st, jnp.asarray), DT, 9.81,
                           None if surf is None else _to(surf, jnp.asarray))
    got = tr.substep_rows(tmc, _to(st, torch.from_numpy), DT, 9.81,
                          None if surf is None
                          else _to(surf, torch.from_numpy))
    for key, atol in TOLS:
        g = _np(_to(got[key], lambda t: t.numpy()
                    if isinstance(t, torch.Tensor) else t))
        np.testing.assert_allclose(g, _np(want[key]), atol=atol, rtol=2e-4,
                                   err_msg=f"{key} z={z} surface={surface}")


def test_fk_contact_pos_matches_jax(consts):
    jmc, tmc = consts
    st = _state(7, 0.5)
    want = jr.fk_contact_pos(jmc, _to(st, jnp.asarray))
    got = tr.fk_contact_pos(tmc, _to(st, torch.from_numpy))
    np.testing.assert_allclose(
        _np(_to(got, lambda t: t.numpy())), _np(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("control_type", ["P", "V", "T"])
def test_pd_torque_rows_match_jax(consts, control_type):
    jmc, tmc = consts
    st = _state(9, 0.5)
    dq = (0.1, -0.2, 0.3, 0.0, 0.2, -0.1)
    want = jr.pd_torque_rows(jmc, _to(st, jnp.asarray), dq, 0.5,
                             control_type, DT)
    got = tr.pd_torque_rows(tmc, _to(st, torch.from_numpy), dq, 0.5,
                            control_type, DT)
    np.testing.assert_allclose(_np(_to(got, lambda t: t.numpy())),
                               _np(want), atol=1e-5, rtol=1e-6)
