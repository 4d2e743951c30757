"""The env's phase ablation (LeggedEnv._ablate) and `bench --mode
env_phases` on the CPU: an empty switch leaves the step as it was, an
ablated phase yields zeros of its shape without running its function."""

import json

import pytest
import torch

from pointfoot_tpu_torch import bench
from pointfoot_tpu_torch.utils.registry import make_env

B = 8
STEPS = 3
PHASE_FNS = {"heights": "_measured_heights", "commands": "_update_commands",
             "reward": "_compute_reward", "reset": "_reset_envs",
             "obs": "_compute_observations"}


@pytest.fixture(autouse=True)
def private_bench_lock(tmp_path, monkeypatch):
    monkeypatch.setenv("POINTFOOT_BENCH_LOCK", str(tmp_path / "bench_lock"))


def _env(task="pointfoot_rough", push_every_step=False):
    env = make_env(task, num_envs=B, device="cpu")
    if push_every_step:
        env.push_interval = 1
    return env


def _actions(env, t):
    g = torch.Generator().manual_seed(100 + t)
    return torch.randn(B, env.num_actions, generator=g)


def _roll(env, steps=STEPS, state=None):
    state = env.init_state(0) if state is None else state
    outs = []
    for t in range(steps):
        state, out = env.step(state, _actions(env, t))
        outs.append(out)
    return state, outs


def _spy(env, monkeypatch, calls):
    for phase, fn_name in PHASE_FNS.items():
        fn = getattr(env, fn_name)

        def spy(*a, _fn=fn, _phase=phase, **k):
            calls.append(_phase)
            return _fn(*a, **k)

        monkeypatch.setattr(env, fn_name, spy)


def _fields(state):
    return {k: v for k, v in vars(state).items()
            if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("task", ["pointfoot_rough", "anymal_c_flat"])
def test_empty_ablate_steps_every_phase_bit_for_bit(task, monkeypatch):
    """The default switch is empty; with it every phase runs once a step
    in the step's order, and a second env with the switch assigned empty
    gives the same bits over steps with pushes and resets."""
    env = _env(task, push_every_step=True)
    assert env._ablate == frozenset()
    calls = []
    state0 = env.init_state(0)  # the initial state runs phases of its own
    _spy(env, monkeypatch, calls)
    state, outs = _roll(env, state=state0)
    assert calls == ["heights", "commands", "reward", "reset", "obs"] * STEPS
    assert bool(torch.any(state.push_force != 0)) or task != "pointfoot_rough"
    other = _env(task, push_every_step=True)
    other._ablate = frozenset()
    state2, outs2 = _roll(other)
    for k, v in _fields(state).items():
        assert torch.equal(v, getattr(state2, k)), k
    for a, b in zip(outs, outs2):
        assert torch.equal(a.obs, b.obs) and torch.equal(a.reward, b.reward)


@pytest.mark.parametrize("phase", sorted(PHASE_FNS))
def test_ablated_phase_is_zeros_and_never_runs(phase, monkeypatch):
    env = _env()
    env._ablate = frozenset({phase})
    fn_name = PHASE_FNS[phase]

    def refuse(*a, **k):
        raise AssertionError(f"{fn_name} ran with '{phase}' ablated")

    seen = {}
    state0 = env.init_state(0)
    if phase == "heights":
        # the observations receive the ablated scan
        obs_fn = env._compute_observations

        def capture(state, heights):
            seen.setdefault("heights", []).append(heights)
            return obs_fn(state, heights)

        monkeypatch.setattr(env, "_compute_observations", capture)
    monkeypatch.setattr(env, fn_name, refuse)
    state, outs = _roll(env, state=state0)
    if phase == "heights":
        assert len(seen["heights"]) == STEPS
        for h in seen["heights"]:
            assert h.shape == (B, env.num_height_points)
            assert not bool(h.any())
    elif phase == "reward":
        for out in outs:
            assert out.reward.shape == (B,) and not bool(out.reward.any())
        assert state.episode_sums.shape == (B, len(env.reward_names))
        assert not bool(state.episode_sums.any())
    elif phase == "obs":
        for out in outs:
            assert out.obs.shape == (B, env.num_obs)
            assert out.privileged_obs.shape == (B, env.num_privileged_obs)
            assert not bool(out.obs.any() or out.privileged_obs.any())
    elif phase == "commands":
        assert torch.equal(state.commands, state0.commands)
    elif phase == "reset":
        # nothing resets: the episode counter only grows
        assert bool((state.episode_step
                     == state0.episode_step + STEPS).all())


def test_ablated_push_queues_no_force():
    env = _env(push_every_step=True)
    state, _ = _roll(env, 1)
    assert bool(state.push_force.any())
    env._ablate = frozenset({"push"})
    state, _ = _roll(env)
    assert not bool(state.push_force.any())


def test_bench_env_phases_record(capsys):
    rec = bench.main(["--mode", "env_phases", "--device", "cpu",
                      "--num_envs", "2", "--iters", "1", "--steps", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    variants = {"full", "physics_only", "no_reward", "no_obs_heights",
                "no_reset", "no_cmd_push"}
    assert rec["metric"] == "env_phase_profile"
    assert set(rec["phases"]) == variants
    assert set(rec["phase_gain_us_per_step"]) == variants - {"full"}
    assert all(v > 0 for v in rec["phases"].values())
    assert rec["value"] == rec["phases"]["full"]
    for name, sps in rec["phases"].items():
        if name != "full":
            assert rec["phase_gain_us_per_step"][name] == pytest.approx(
                2 * (1 / rec["value"] - 1 / sps) * 1e6, abs=0.1)
    # the full step's spans: the physics' and each phase's own ms a step
    assert set(rec["phase_ms_per_step"]) == {"physics", *bench.PHASES}
    assert all(v >= 0 for v in rec["phase_ms_per_step"].values())
    assert rec["phase_ms_per_step"]["physics"] > 0
    cond = rec["conditions"]
    assert cond["terrain"] == "procedural" and cond["card"] == "cpu"
    assert cond["trainer"] == "no_trainer"
    assert cond["ablated"]["physics_only"] == list(bench.PHASES)
    assert rec["num_envs"] == 2
