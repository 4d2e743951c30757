"""The port's actuator network (physics/actuator.py) vs the JAX package:
the same baked ANYdrive weights, and the LSTM over 20 ticks with the carry
threaded through.  The carry (|h|, |c| of order 1) and the network's
output before denormalization hold atol 1e-5; the torque is that output
times out_scale = 20 N·m, so it holds atol 1e-5 · 20.  (The two matmul
orders leave the carry 3e-7 apart, and a torque near zero is the difference
of terms of order 1 N·m, 20 times the carry's roundoff.)"""

import jax.numpy as jnp
import numpy as np
import torch

from pointfoot_tpu.physics import actuator as jact
from pointfoot_tpu_torch.physics import actuator


def test_loader_reads_the_same_weights():
    jw = jact.load_anydrive_weights()
    tw = actuator.load_anydrive_weights()
    for name in jw._fields:
        j, t = getattr(jw, name), getattr(tw, name)
        if isinstance(j, tuple):
            assert len(j) == len(t) == actuator.LAYERS
            for jl, tl in zip(j, t):
                np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_torque_and_carry_over_20_ticks():
    rng = np.random.default_rng(0)
    B, nj, ticks = 6, 12, 20
    jw = jact.load_anydrive_weights()
    tw = actuator.load_anydrive_weights()
    jc = jact.init_carry((B, nj))
    tc = actuator.init_carry((B, nj))
    assert tuple(tc.shape) == tuple(jc.shape) == (B, nj, 2, 2, 8)
    for _ in range(ticks):
        pos_err = (0.3 * rng.standard_normal((B, nj))).astype(np.float32)
        vel = (2.0 * rng.standard_normal((B, nj))).astype(np.float32)
        jt, jc = jact.actuator_net_torque(jw, jc, jnp.asarray(pos_err),
                                          jnp.asarray(vel))
        tt, tc = actuator.actuator_net_torque(tw, tc,
                                              torch.from_numpy(pos_err),
                                              torch.from_numpy(vel))
        np.testing.assert_allclose(tt.numpy(), jt,
                                   atol=1e-5 * float(tw.out_scale))
        np.testing.assert_allclose(tc.numpy(), jc, atol=1e-5)
    assert np.abs(np.asarray(jt)).max() > 1.0, "torques should be nontrivial"
