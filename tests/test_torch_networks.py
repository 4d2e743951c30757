"""ActorCritic of the PyTorch port vs the flax ActorCritic, through
pointfoot_tpu_torch.utils.convert, and the committed flagship actor npz vs
its Orbax checkpoint."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointfoot_tpu.rl.networks import ActorCritic as FlaxActorCritic
from pointfoot_tpu_torch.rl.networks import ActorCritic
from pointfoot_tpu_torch.utils import convert, policy_eval

REPO = os.path.join(os.path.dirname(__file__), "..")
FLAGSHIP = os.path.join(REPO, "logs/pointfoot_rough/tpu_r4_storm/model_234000")


@pytest.mark.parametrize("hidden", [(512, 256, 128), (128, 64, 32)])
def test_actor_critic_matches_flax(hidden):
    net = FlaxActorCritic(num_actions=6, actor_hidden=hidden,
                          critic_hidden=hidden)
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((32, 27)).astype(np.float32)
    priv = rng.standard_normal((32, 148)).astype(np.float32)
    params = net.init(jax.random.PRNGKey(1), jnp.asarray(obs),
                      jnp.asarray(priv))
    # non-zero biases and log_std, so their mapping is exercised too
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 if path[-1].key in ("bias", "log_std") else x,
        params)
    mean, std, value = net.apply(params, jnp.asarray(obs), jnp.asarray(priv))

    tnet = ActorCritic(27, 148, 6, hidden, hidden)
    tnet.load_state_dict(convert.actor_critic_state_dict(
        jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        t_mean, t_std, t_value = tnet(torch.from_numpy(obs),
                                      torch.from_numpy(priv))
        d_mean, d_std = tnet.distribution(torch.from_numpy(obs))
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(mean), atol=1e-5)
    np.testing.assert_allclose(t_std.numpy(), np.asarray(std), atol=1e-5)
    np.testing.assert_allclose(t_value.numpy(), np.asarray(value), atol=1e-5)
    np.testing.assert_allclose(d_mean.numpy(), np.asarray(mean), atol=1e-5)
    assert d_std.shape == d_mean.shape


def test_flagship_npz_equals_checkpoint():
    """The committed actor npz is the Orbax checkpoint's actor, exactly."""
    import orbax.checkpoint as ocp

    raw = ocp.PyTreeCheckpointer().restore(os.path.abspath(FLAGSHIP))
    params = raw["train_state"]["params"]
    want = convert.actor_critic_state_dict(params)
    with np.load(policy_eval.FLAGSHIP_ACTOR) as f:
        got = convert.actor_critic_state_dict({k: f[k] for k in f.files})
    assert sorted(got) == sorted(k for k in want
                                 if not k.startswith("critic."))
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
