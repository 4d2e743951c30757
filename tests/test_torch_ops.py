"""Quaternion ops of the PyTorch port vs the JAX package's ops/quat.py
(atol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointfoot_tpu.ops import quat as jq
from pointfoot_tpu_torch.ops import quat as tq

ATOL = 1e-6


def _inputs(seed=0, n=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    a = (rng.standard_normal(n) * 6.0).astype(np.float32)
    b = (rng.standard_normal(n) * 6.0).astype(np.float32)
    return q, v, a, b


CASES = {
    "normalize": lambda m, q, v, a, b: m.normalize(q * 3.0),
    "rotate": lambda m, q, v, a, b: m.rotate(q, v),
    "rotate_inverse": lambda m, q, v, a, b: m.rotate_inverse(q, v),
    "yaw": lambda m, q, v, a, b: m.yaw(q),
    "yaw_quat": lambda m, q, v, a, b: m.yaw_quat(q),
    "apply_yaw": lambda m, q, v, a, b: m.apply_yaw(q, v),
    "wrap_to_pi": lambda m, q, v, a, b: m.wrap_to_pi(a),
    "heading_wz": lambda m, q, v, a, b: m.heading_wz(a, b),
    "mul": lambda m, q, v, a, b: m.mul(q, 0.5 * q + 0.1),
    "to_matrix": lambda m, q, v, a, b: m.to_matrix(q),
    "integrate": lambda m, q, v, a, b: m.integrate(q, 3.0 * v, 0.005),
    "conjugate": lambda m, q, v, a, b: m.conjugate(q),
    "from_axis_angle": lambda m, q, v, a, b: m.from_axis_angle(
        v / _norm(m, v), a),
    "from_euler_zyx": lambda m, q, v, a, b: m.from_euler_zyx(
        a, 0.2 * b, v[..., 0]),
    # the last rows are exactly zero: the Taylor branch at a zero angle
    "from_rotvec": lambda m, q, v, a, b: m.from_rotvec(v * _taper(m, v)),
    # 3 q is not normalized; the last rows are the identity and its negative
    "to_rotvec": lambda m, q, v, a, b: m.to_rotvec(_with_identity(m, 3 * q)),
}


def _norm(m, v):
    return (v * v).sum(-1)[..., None] ** 0.5


def _taper(m, v):
    """1 on most rows, 0 on the last four."""
    n = v.shape[0]
    w = np.ones((n, 1), np.float32)
    w[-4:] = 0.0
    return jnp.asarray(w) if m is jq else torch.from_numpy(w)


def _with_identity(m, q):
    e = np.zeros((q.shape[0], 4), np.float32)
    e[-2:] = [[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, -1.0]]
    mask = np.zeros((q.shape[0], 1), np.float32)
    mask[-2:] = 1.0
    if m is jq:
        return q * (1.0 - jnp.asarray(mask)) + jnp.asarray(e)
    return q * (1.0 - torch.from_numpy(mask)) + torch.from_numpy(e)


@pytest.mark.parametrize("name", sorted(CASES))
def test_quat_matches_jax(name):
    q, v, a, b = _inputs()
    fn = CASES[name]
    want = np.asarray(fn(jq, *(jnp.asarray(x) for x in (q, v, a, b))))
    got = fn(tq, *(torch.from_numpy(x.copy()) for x in (q, v, a, b)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_rotvec_round_trip():
    """to_rotvec inverts from_rotvec for angles below pi (atol 1e-6)."""
    _, v, _, _ = _inputs(3)
    rv = torch.from_numpy(0.5 * v)
    np.testing.assert_allclose(tq.to_rotvec(tq.from_rotvec(rv)).numpy(),
                               rv.numpy(), atol=ATOL, rtol=0)


def test_apply_yaw_broadcasts_over_scan_points():
    """The env's height-scan form: (B, 1, 4) quats on (1, P, 3) points."""
    q, v, _, _ = _inputs(1, 8)
    pts = np.random.default_rng(2).standard_normal((1, 121, 3)).astype(
        np.float32)
    want = np.asarray(jq.apply_yaw(jnp.asarray(q)[:, None],
                                   jnp.asarray(pts)))
    got = tq.apply_yaw(torch.from_numpy(q)[:, None], torch.from_numpy(pts))
    assert got.shape == (8, 121, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
