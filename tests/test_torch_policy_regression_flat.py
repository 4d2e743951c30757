"""Policy-in-the-loop regression gate under the port's env, plane terrain:
rows 3 and 5 of tests/test_policy_regression.py (model_55000 and
model_82000 of pointfoot_flat), with their bands.

Each actor walks 8 envs for 6 s on plane terrain (level None) at the row's
commands, through pointfoot_tpu_torch's env and utils/policy_eval.py on
the CPU: falls at most the row's maximum and a mean forward velocity of at
least its minimum.  As in the JAX test, no config patch: the reward and
command knobs model_82000 trained under change neither observations nor
physics.  The actors are the committed `_weights/*.npz`, each held to its
Orbax checkpoint.
"""

import os

import numpy as np
import pytest
import torch

from pointfoot_tpu_torch.utils import convert, policy_eval

REPO = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(REPO, "pointfoot_tpu_torch", "_weights")

# (checkpoint, committed actor, [(level, vx, max_falls, min_mean_vx)]):
# tests/test_policy_regression.py:52-54, 66-74
ROWS = [
    ("logs/pointfoot_flat/tpu_r4_ft/model_55000",
     "pointfoot_flat_model_55000_actor.npz", [(None, 0.5, 4, 0.35)]),
    ("logs/pointfoot_flat/tpu_r5_os/model_82000",
     "pointfoot_flat_model_82000_actor.npz",
     [(None, 0.25, 4, 0.12), (None, 0.5, 4, 0.30)]),
]
CASES = [(ckpt, npz, cfg) for ckpt, npz, cfgs in ROWS for cfg in cfgs]


@pytest.fixture(scope="module")
def eval_env():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # 8 envs: one thread is faster
    yield policy_eval.make_eval_env("pointfoot_flat", 8, device="cpu")
    torch.set_num_threads(n)


@pytest.mark.parametrize(
    "ckpt,npz,config", CASES,
    ids=[f"{c.split('/')[-1]}-vx{cfg[1]}" for c, _, cfg in CASES])
def test_committed_flat_policy_still_walks(eval_env, ckpt, npz, config):
    level, vx, max_falls, min_vx = config
    assert eval_env.is_plane
    policy = policy_eval.inference_policy(policy_eval.load_actor(
        eval_env, "pointfoot_flat", os.path.join(WEIGHTS, npz)))
    rec = policy_eval.eval_config(eval_env, policy, level, vx, secs=6.0)
    assert rec["falls"] <= max_falls, rec
    assert rec["mean_vx"] >= min_vx, rec


@pytest.mark.parametrize("ckpt,npz", [r[:2] for r in ROWS],
                         ids=[r[0].split("/")[-1] for r in ROWS])
def test_flat_actor_npz_equals_checkpoint(ckpt, npz):
    """Each committed actor is its Orbax checkpoint's actor, exactly."""
    import orbax.checkpoint as ocp

    raw = ocp.PyTreeCheckpointer().restore(
        os.path.abspath(os.path.join(REPO, ckpt)))
    want = convert.actor_critic_state_dict(raw["train_state"]["params"])
    with np.load(os.path.join(WEIGHTS, npz)) as f:
        got = convert.actor_critic_state_dict({k: f[k] for k in f.files})
    assert sorted(got) == sorted(k for k in want
                                 if not k.startswith("critic."))
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)


def test_flat_default_actor_is_model_82000():
    assert policy_eval.DEFAULT_ACTORS["pointfoot_flat"] == os.path.join(
        policy_eval.WEIGHTS, "pointfoot_flat_model_82000_actor.npz")
