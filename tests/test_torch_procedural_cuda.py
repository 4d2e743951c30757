"""The procedural terrain's table route against its closed form on the
card, bit for bit: the flagship's queries at 4096 envs, and a training
rollout.

Needs a CUDA device; skips without one.  On the card (which has no JAX, so
the repo's conftest files are bypassed):

    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_procedural_cuda.py
"""

import pytest
import torch

from pointfoot_tpu_torch.terrain.procedural import ProceduralTerrain
from pointfoot_tpu_torch.utils.policy_eval import FLAGSHIP_PATCH
from pointfoot_tpu_torch.utils.registry import make_alg_runner, make_env

from _torch_parity import assert_bits_equal, procedural_points

pytestmark = pytest.mark.cuda

NUM_ENVS = 4096
SEED = 2026


def closed_form(terrain: ProceduralTerrain) -> ProceduralTerrain:
    """The same terrain on the same device, answering from the closed
    form."""
    return ProceduralTerrain(terrain.spec, terrain.env_origins,
                             terrain.terrain_length, table=False)


def flagship_env(num_envs: int, device):
    return make_env("pointfoot_rough", num_envs=num_envs, device=device,
                    cfg_patch=FLAGSHIP_PATCH)


def rollout_storage(env, seed: int) -> dict:
    """One rollout of the registered runner from `seed` (random episode
    steps, as `learn` starts), its storage copied."""
    runner = make_alg_runner(env, "pointfoot_rough")
    es = runner.init(seed, random_episode_step=True)
    es, out = env.step(es, torch.zeros(env.num_envs, env.num_actions,
                                       device=env.device))
    _, _, _, st, _ = runner.rollout(es, out.obs, out.privileged_obs)
    return {k: v.clone() for k, v in st._asdict().items()}


@pytest.fixture(scope="module")
def env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return flagship_env(NUM_ENVS, "cuda")


# the height scan's 121 points and the 9 contact spheres an env
@pytest.mark.parametrize("points", [121, 9])
@pytest.mark.parametrize("query", ["height_at", "height_scan_at",
                                   "surface_at"])
def test_table_route_is_the_closed_form_on_the_card(env, query, points):
    table = env.terrain
    assert table.table is not None  # materialized on the card
    x, y = (t.to(env.device) for t in procedural_points(
        table.spec, NUM_ENVS, points, seed=points))
    got = getattr(table, query)(x, y)
    want = getattr(closed_form(table), query)(x, y)
    if query == "surface_at":
        assert_bits_equal(got[0], want[0])
        assert_bits_equal(got[1], want[1])
    else:
        assert_bits_equal(got, want)


def test_rollout_is_the_same_on_both_routes(env):
    """24 steps of the flagship's training rollout from one seed: the same
    storage, bit for bit, from the table as from the closed form."""
    table = env.terrain
    try:
        want = rollout_storage(env, SEED)
        env.terrain = closed_form(table)
        env.height_fn = env._height_fn()
        got = rollout_storage(env, SEED)
    finally:
        env.terrain = table
        env.height_fn = env._height_fn()
    assert want["obs"].shape[0] == 24
    for k in want:
        if k == "done":
            assert torch.equal(got[k], want[k])
        else:
            assert_bits_equal(got[k], want[k])
