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
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_quat_matches_jax(name):
    q, v, a, b = _inputs()
    fn = CASES[name]
    want = np.asarray(fn(jq, *(jnp.asarray(x) for x in (q, v, a, b))))
    got = fn(tq, *(torch.from_numpy(x.copy()) for x in (q, v, a, b)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


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
