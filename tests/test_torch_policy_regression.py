"""Policy-in-the-loop regression gate under the port's env: rows 2 and 4 of
tests/test_policy_regression.py (model_150000 and model_234000, the
flagship, both trained on procedural terrain), with their bands.

Each actor walks 8 envs for 6 s at terrain level 0, standing (command 0)
and at a command of 0.4 m/s, through pointfoot_tpu_torch's env and
utils/policy_eval.py on the CPU: falls <= 8, and at 0.4 m/s a mean forward
velocity of at least the row's minimum.  The actors are the committed
`_weights/*.npz`, each held to its Orbax checkpoint.  Rows 1, 3 and 5 need
table and plane terrain, not ported yet.
"""

import os

import numpy as np
import pytest
import torch

from pointfoot_tpu_torch.utils import convert, policy_eval

REPO = os.path.join(os.path.dirname(__file__), "..")
WEIGHTS = os.path.join(REPO, "pointfoot_tpu_torch", "_weights")

# (checkpoint, committed actor, [(level, vx, max_falls, min_mean_vx)]):
# tests/test_policy_regression.py:43-45, 56-58
ROWS = [
    ("logs/pointfoot_rough/tpu_r4_run1/model_150000",
     "pointfoot_rough_model_150000_actor.npz",
     [(0, 0.0, 8, None), (0, 0.4, 8, 0.25)]),
    ("logs/pointfoot_rough/tpu_r4_storm/model_234000",
     "pointfoot_rough_model_234000_actor.npz",
     [(0, 0.0, 8, None), (0, 0.4, 8, 0.15)]),
]
CASES = [(ckpt, npz, cfg) for ckpt, npz, cfgs in ROWS for cfg in cfgs]


@pytest.fixture(scope="module")
def eval_env():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # 8 envs: one thread is faster
    yield policy_eval.make_eval_env("pointfoot_rough", 8,
                                    policy_eval.FLAGSHIP_PATCH, device="cpu")
    torch.set_num_threads(n)


@pytest.mark.parametrize(
    "ckpt,npz,config", CASES,
    ids=[f"{c.split('/')[-1]}-vx{cfg[1]}" for c, _, cfg in CASES])
def test_committed_policy_still_walks(eval_env, ckpt, npz, config):
    level, vx, max_falls, min_vx = config
    policy = policy_eval.inference_policy(policy_eval.load_actor(
        eval_env, "pointfoot_rough", os.path.join(WEIGHTS, npz)))
    rec = policy_eval.eval_config(eval_env, policy, level, vx, secs=6.0)
    assert rec["falls"] <= max_falls, rec
    if min_vx is not None:
        assert rec["mean_vx"] >= min_vx, rec


@pytest.mark.parametrize("ckpt,npz", [r[:2] for r in ROWS],
                         ids=[r[0].split("/")[-1] for r in ROWS])
def test_actor_npz_equals_checkpoint(ckpt, npz):
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
