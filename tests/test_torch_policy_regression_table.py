"""Policy-in-the-loop regression gate under the port's env, table terrain:
row 1 of tests/test_policy_regression.py (model_100000 of pointfoot_rough,
trained on the table), with its band.

The actor walks 8 envs for 6 s at terrain level 0 of pointfoot_rough's
registered config (table terrain), standing and at a command of 0.4 m/s,
through pointfoot_tpu_torch's env and utils/policy_eval.py on the CPU:
falls <= 8, and at 0.4 m/s a mean forward velocity >= 0.20 m/s.  The actor
is the committed `_weights/*.npz`, held to its Orbax checkpoint.
"""

import os

import numpy as np
import pytest
import torch

from pointfoot_tpu_torch.utils import convert, policy_eval

REPO = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(REPO, "pointfoot_tpu_torch", "_weights")
CKPT = "logs/pointfoot_rough/tpu_r3_run1/model_100000"
NPZ = "pointfoot_rough_model_100000_actor.npz"
# tests/test_policy_regression.py:41-42
CONFIGS = [(0, 0.0, 8, None), (0, 0.4, 8, 0.20)]


@pytest.fixture(scope="module")
def eval_env():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # 8 envs: one thread is faster
    yield policy_eval.make_eval_env("pointfoot_rough", 8, device="cpu")
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", CONFIGS,
                         ids=[f"model_100000-vx{c[1]}" for c in CONFIGS])
def test_committed_table_policy_still_walks(eval_env, config):
    level, vx, max_falls, min_vx = config
    assert not eval_env.cfg.terrain.procedural and not eval_env.is_plane
    policy = policy_eval.inference_policy(policy_eval.load_actor(
        eval_env, "pointfoot_rough", os.path.join(WEIGHTS, NPZ)))
    rec = policy_eval.eval_config(eval_env, policy, level, vx, secs=6.0)
    assert rec["falls"] <= max_falls, rec
    if min_vx is not None:
        assert rec["mean_vx"] >= min_vx, rec


def test_table_actor_npz_equals_checkpoint():
    """The committed actor is its Orbax checkpoint's actor, exactly."""
    import orbax.checkpoint as ocp

    raw = ocp.PyTreeCheckpointer().restore(
        os.path.abspath(os.path.join(REPO, CKPT)))
    want = convert.actor_critic_state_dict(raw["train_state"]["params"])
    with np.load(os.path.join(WEIGHTS, NPZ)) as f:
        got = convert.actor_critic_state_dict({k: f[k] for k in f.files})
    assert sorted(got) == sorted(k for k in want
                                 if not k.startswith("critic."))
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
