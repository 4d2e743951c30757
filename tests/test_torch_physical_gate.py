"""Where the physical gate of chip_smoke.py comes from.

The JAX package on the CPU runs anymal_c_rough as chip_smoke.py's gate
does (level 0 of procedural terrain without the discrete-obstacle family,
zero actions, no pushes, 2 s), at 8 envs.  Its mean base height above the
terrain under the base at 2 s, and its share of terminated envs, must lie
inside chip_smoke.py's bands, which the port's 4096-env run on the card is
held to.
"""

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke
from pointfoot_tpu.utils.registry import task_registry

ENVS = 8


def test_jax_reference_lies_inside_the_gate():
    env = task_registry.make_env("anymal_c_rough", num_envs=ENVS,
                                 cfg_patch=chip_smoke.GATE_PATCH)
    state = env.init_state(jax.random.PRNGKey(0))
    assert (np.asarray(state.terrain_level) == 0).all()
    step = jax.jit(env.step)
    zeros = jnp.zeros((ENVS, env.num_actions))
    terminated = np.zeros(ENVS, bool)
    for _ in range(chip_smoke.GATE_STEPS):
        state, out = step(state, zeros)
        terminated |= np.asarray(out.extras["terminate"])
    p = np.asarray(state.physics.base_pos)
    h = p[:, 2] - np.asarray(env.terrain.height_at(jnp.asarray(p[:, 0]),
                                                   jnp.asarray(p[:, 1])))
    lo, hi = chip_smoke.GATE_MEAN_HEIGHT
    # the recorded reference (chip_smoke.py's comment): 0.351 m, none
    # terminated; the band keeps 0.05 m either side of it
    np.testing.assert_allclose(h.mean(), 0.351, atol=5e-3)
    assert lo + 0.05 <= h.mean() <= hi - 0.05
    assert terminated.mean() <= chip_smoke.GATE_MAX_TERMINATED
