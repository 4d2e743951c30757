"""`LeggedEnv.step`'s graph route (envs/step_graph.py): on one card the
step's eager body is captured as a CUDA graph and replayed; the CPU, a
rank of a shard mesh and an input that requires grad take the eager body.

On the CPU: the route choice; the key a capture is filed under; the route's
bookkeeping, with the graph stood in for by an eager call (a capture a
layout, a replay a step, the eager numbers, a new capture when `_ablate`
changes); the counters and the logged row of an iteration on the CPU; that
the eager body makes no tensor from host data and reads no number back to
the host on any physics route, either of which a capture refuses; and the
phases' reading of a row whose steps ran in no phase span.

On the card (marker `cuda`; skips without one): 64 steps of
`pointfoot_rough` at 4096 envs on procedural and on table terrain (the
fused rollout, kernels 1-2) and of `anymal_c_rough` at 4096 envs (the scan
path with the actuator network, `step_batched`'s mega route, kernels 3-4),
graphed and eager from one seed, bit for bit, with resets, command
resamples and pushes (the push interval shortened here only); the
generator's state after both; the layouts of what the step writes; the
captures and replays across `runner.init`, the zero-action step and three
`train_iteration`s; extras that stay as they were after the next step; and
a new capture when `_ablate` changes.  The card has no JAX, so the repo's
conftest files are bypassed:

    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_env_graph.py
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import pointfoot_tpu_torch.physics.dynamics as dynamics
from pointfoot_tpu_torch.device import const
from pointfoot_tpu_torch.envs import step_graph
from pointfoot_tpu_torch.envs.legged_env import (STEP_PHASES, EnvState,
                                                 StepOutput,
                                                 phase_ms_per_step)
from pointfoot_tpu_torch.parallel.mesh import Mesh
from pointfoot_tpu_torch.rl.runner import row_scalars
from pointfoot_tpu_torch.utils import profiling
from pointfoot_tpu_torch.utils.registry import (get_cfgs, make_alg_runner,
                                                make_env)

COUNTERS = ("env.graph_capture", "env.graph_replay")
B = 4  # envs a CPU case
T = 3  # steps an iteration of the tiny runner


def _counts(before: dict) -> dict:
    return {k: profiling.counter(k) - before.get(k, 0) for k in COUNTERS}


def _tiny_runner(env):
    tc = get_cfgs("pointfoot_rough")[1]
    tc = dataclasses.replace(
        tc, runner=dataclasses.replace(tc.runner, num_steps_per_env=T),
        policy=dataclasses.replace(tc.policy, actor_hidden_dims=(16,),
                                   critic_hidden_dims=(16,)))
    return make_alg_runner(env, "pointfoot_rough", train_cfg=tc)


def _same_bits(a, b) -> bool:
    """The same values bit for bit (NaN's bits included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _assert_same(got, want):
    tg, tw = step_graph.leaves(got), step_graph.leaves(want)
    assert len(tg) == len(tw)
    for x, y in zip(tg, tw):
        assert _same_bits(x, y)


class _EagerGraph:
    """`StepGraph`'s interface, run eagerly: the graph route's bookkeeping
    on the CPU."""

    def __init__(self, body, args, generator):
        self.body, self.args = body, args

    def __call__(self, tensors):
        return self.body(*step_graph.rebuild(self.args, iter(tensors)))


# --------------------------------------------------------------- on the CPU

def test_route_takes_the_card_alone():
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    x = [torch.zeros(3), torch.zeros((), dtype=torch.int64)]
    assert step_graph.graph_route(card, None, x)
    assert not step_graph.graph_route(cpu, None, x)
    # a rank's reset all-reduces inside the step
    for mesh in (Mesh(rank=0, world_size=1, device=card),
                 Mesh(rank=1, world_size=4, device=card)):
        assert not step_graph.graph_route(card, mesh, x)
    # sys-ID differentiates through the eager body
    assert not step_graph.graph_route(
        card, None, x + [torch.zeros(2, requires_grad=True)])


def test_cpu_steps_take_the_eager_body():
    """An iteration on the CPU captures nothing: the counters stay absent
    from its row, and `learn`'s scalars log them at 0."""
    env = make_env("pointfoot_rough", num_envs=B, device="cpu")
    runner = _tiny_runner(env)
    es = runner.init(0)
    before = profiling.counters()
    es, out = env.step(es, torch.zeros(B, env.num_actions))
    with profiling.recording():
        runner.train_iteration(es, out.obs, out.privileged_obs)
    row = profiling.last_row()
    assert row["spans"]["env.step"]["count"] == T
    assert not set(COUNTERS) & set(row["counters"])
    assert _counts(before) == dict.fromkeys(COUNTERS, 0)
    assert env._graphs == {}
    scalars = row_scalars(row)
    assert scalars["env_graph_capture"] == scalars["env_graph_replay"] == 0
    assert {f"env_{p}_ms" for p in STEP_PHASES} <= set(scalars)


def test_a_grad_input_steps_the_eager_body():
    env = make_env("pointfoot_flat", num_envs=B, device="cpu")
    es = env.init_state(0)
    a = torch.zeros(B, env.num_actions, requires_grad=True)
    es, out = env.step(es, a)
    assert out.obs.requires_grad and env._graphs == {}


def test_phases_read_nothing_where_no_phase_ran_in_a_span():
    """A row whose steps a graph replayed holds `env.step` and no phase
    span: no phase reads 0 ms, and `learn` logs none."""
    replayed = {"spans": {"env.step": {"count": 24, "total_s": 0.05,
                                       "self_s": 0.05}},
                "counters": {"env.graph_replay": 24}}
    assert phase_ms_per_step(replayed) == {}
    scalars = row_scalars(replayed)
    assert not [k for k in scalars if k.startswith("env_") and
                k.endswith("_ms")]
    assert scalars["env_graph_replay"] == 24
    assert "terrain_ms_per_step" not in scalars
    eager = {"spans": {"env.step": {"count": 2, "total_s": 0.01,
                                    "self_s": 0.002},
                       "env.reward": {"count": 2, "total_s": 0.004,
                                      "self_s": 0.004}},
             "counters": {}}
    got = phase_ms_per_step(eager)
    assert set(got) == set(STEP_PHASES)
    assert got["reward"] == pytest.approx(2.0) and got["obs"] == 0.0
    assert phase_ms_per_step({"spans": {}, "counters": {}}) == {}


def test_leaves_rebuild_a_step_in_order():
    env = make_env("anymal_c_rough", num_envs=B, device="cpu")
    es = env.init_state(0)
    es2, out = env.step(es, torch.zeros(B, env.num_actions))
    tree = (es2, out)
    flat = step_graph.leaves(tree)
    n_state = len(step_graph.leaves(es2))
    assert n_state == sum(
        len(dataclasses.fields(v)) if dataclasses.is_dataclass(v) else 1
        for v in (getattr(es2, f.name) for f in dataclasses.fields(es2)))
    assert flat[0] is es2.physics.base_pos
    back = step_graph.rebuild(tree, iter(flat))
    assert isinstance(back[0], EnvState) and isinstance(back[1], StepOutput)
    assert all(x is y for x, y in zip(step_graph.leaves(back), flat))
    assert back[1].extras.keys() == out.extras.keys()
    assert (back[1].privileged_obs is None) == (out.privileged_obs is None)


def test_graph_key_follows_layout_ablation_terrain_route_and_tf32(
        monkeypatch):
    env = make_env("pointfoot_rough", num_envs=B, device="cpu")
    es = env.init_state(0)
    a = torch.zeros(B, env.num_actions)
    key = step_graph.graph_key(env, step_graph.leaves((es, a)))
    # other values, the same layout: the same graph serves
    assert step_graph.graph_key(
        env, step_graph.leaves((es, a + 1.0))) == key
    # another layout of one input: the reductions may sum in another order
    strided = a.t().contiguous().t()
    assert step_graph.graph_key(
        env, step_graph.leaves((es, strided))) != key
    assert step_graph.graph_key(
        env, step_graph.leaves((es, a[:2]))) != key
    env._ablate = frozenset({"reward"})
    assert step_graph.graph_key(env, step_graph.leaves((es, a))) != key
    env._ablate = frozenset()
    height_fn = env.height_fn
    env.height_fn = env._height_fn()
    assert step_graph.graph_key(env, step_graph.leaves((es, a))) != key
    env.height_fn = height_fn
    monkeypatch.setattr(dynamics, "MEGA_MIN_BATCH", 1)
    assert step_graph.graph_key(env, step_graph.leaves((es, a))) != key
    monkeypatch.undo()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not tf32
        assert step_graph.graph_key(env, step_graph.leaves((es, a))) != key
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert step_graph.graph_key(env, step_graph.leaves((es, a))) == key


def test_graph_route_bookkeeping(monkeypatch):
    """The graph route with the graph run eagerly, through a training
    run's start: a capture for each input layout (the state `init_state`
    makes, then the state `step` makes), a replay for every step, the
    numbers of the eager body; setting `_ablate` captures anew."""
    def run(graphed: bool):
        monkeypatch.setattr(dynamics, "MEGA_MIN_BATCH", 1)  # fused rollout
        if graphed:
            monkeypatch.setattr(step_graph, "graph_route",
                                lambda device, mesh, tensors: True)
            monkeypatch.setattr(step_graph, "StepGraph", _EagerGraph)
        env = make_env("pointfoot_rough", num_envs=B, device="cpu")
        runner = _tiny_runner(env)
        before = profiling.counters()
        es = runner.init(5, random_episode_step=True)
        es, out = env.step(es, torch.zeros(B, env.num_actions))
        obs, priv, got = out.obs, out.privileged_obs, [out]
        for _ in range(2):
            es, obs, priv, m = runner.train_iteration(es, obs, priv)
            got.append((es, obs, priv, m))
        counts = _counts(before)
        monkeypatch.undo()
        return env, got, counts, es

    _, want, eager_counts, _ = run(False)
    env, got, counts, es = run(True)
    assert eager_counts == dict.fromkeys(COUNTERS, 0)
    assert counts == {"env.graph_capture": 2,
                      "env.graph_replay": 1 + 2 * T}
    assert len(env._graphs) == 2
    _assert_same(got, want)
    monkeypatch.setattr(dynamics, "MEGA_MIN_BATCH", 1)
    monkeypatch.setattr(step_graph, "graph_route",
                        lambda device, mesh, tensors: True)
    monkeypatch.setattr(step_graph, "StepGraph", _EagerGraph)
    before = profiling.counters()
    a = torch.zeros(B, env.num_actions)
    env.step(es, a)
    env._ablate = frozenset({"push"})
    env.step(es, a)
    env.step(es, a)
    assert _counts(before) == {"env.graph_capture": 1,
                               "env.graph_replay": 3}
    assert len(env._graphs) == 3


class _HostData(TorchDispatchMode):
    """Records the aten operations that make a tensor from host data or
    read a number back to the host."""

    HOST = {"lift_fresh", "_local_scalar_dense", "nonzero", "is_nonzero",
            "masked_select", "unique"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.HOST:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


# the physics routes of the card, on the CPU: the fused rollout (the
# PointFoot cells), the scan path's mega route (ANYmal), the scan path's
# plain route (small batches)
@pytest.mark.parametrize("task,terrain,mega", [
    ("pointfoot_rough", "procedural", 1),
    ("pointfoot_rough", "table", 1),
    ("anymal_c_rough", "table", 1),
    ("pointfoot_rough", "table", 10 ** 9),
    ("pointfoot_flat", "plane", 1),
], ids=["fused_procedural", "fused_table", "mega_actuator", "plain",
        "fused_plane"])
def test_eager_body_is_capturable(monkeypatch, task, terrain, mega):
    """A CUDA graph cannot capture a copy from the host nor a read back to
    it: the eager body (the card's table of the procedural terrain
    included) makes neither."""
    monkeypatch.setattr(dynamics, "MEGA_MIN_BATCH", mega)
    patch = {"terrain": {"procedural": True}} if terrain == "procedural" \
        else None
    env = make_env(task, num_envs=B, device="cpu", cfg_patch=patch)
    if terrain == "procedural":
        from pointfoot_tpu_torch.terrain.procedural import _table
        t = env.terrain
        t.table = _table(t.spec, t.env_origins, t.terrain_length)
    es = env.init_state(0, random_episode_step=True)
    gen = torch.Generator().manual_seed(0)
    es, _ = env.step(es, torch.zeros(B, env.num_actions))
    with _HostData() as mode:
        for _ in range(3):
            es, _ = env.step(es, torch.randn(B, env.num_actions,
                                             generator=gen))
    assert mode.seen == []


def test_const_is_shared_and_never_an_inference_tensor():
    like = torch.zeros(2, dtype=torch.float64)
    with torch.inference_mode():
        c = const((1.0, 2.0), like)
    assert not c.is_inference()
    assert c.dtype == torch.float64 and c.tolist() == [1.0, 2.0]
    assert const((1.0, 2.0), like) is c
    assert const((1.0, 2.0), like.float()) is not c


# -------------------------------------------------------------- on the card

NUM_ENVS = 4096
STEPS = 64
SEED = 2424
PUSH_S = 0.3  # a push every 15 steps here (7 and 15 s in the tasks)

CASES = {
    "pointfoot_procedural": ("pointfoot_rough", {"procedural": True}),
    "pointfoot_table": ("pointfoot_rough", {}),
    "anymal_c": ("anymal_c_rough", {}),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_env(case: str, device):
    task, terrain = CASES[case]
    patch = {"domain_rand": {"push_interval_s": PUSH_S}}
    if terrain:
        patch["terrain"] = terrain
    return make_env(task, num_envs=NUM_ENVS, device=device, cfg_patch=patch)


def _trajectory(env, actions):
    """The steps from `SEED` (random episode steps): each step's (state,
    output), the generator's state after, the counters' deltas."""
    before = profiling.counters()
    es = env.init_state(SEED, random_episode_step=True)
    steps = []
    for a in actions:
        es, out = env.step(es, a)
        steps.append((es, out))
    torch.cuda.synchronize()
    return steps, env.generator.get_state(), _counts(before)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_steps_are_eager_bit_for_bit(card, monkeypatch, case):
    env = _card_env(case, card)
    gen = torch.Generator(device=card).manual_seed(7)
    actions = [torch.randn(NUM_ENVS, env.num_actions, generator=gen,
                           device=card) for _ in range(STEPS)]
    graphed, g_rng, g_counts = _trajectory(env, actions)
    assert g_counts == {"env.graph_capture": 2,
                        "env.graph_replay": STEPS}
    monkeypatch.setattr(step_graph, "graph_route",
                        lambda device, mesh, tensors: False)
    eager, e_rng, e_counts = _trajectory(env, actions)
    assert e_counts == dict.fromkeys(COUNTERS, 0)
    assert torch.equal(g_rng, e_rng)
    for (gs, go), (es, eo) in zip(graphed, eager):
        for x, y in zip(step_graph.leaves((gs, go)),
                        step_graph.leaves((es, eo))):
            assert _same_bits(x, y)
            assert x.stride() == y.stride()
    # the steps held resets, command resamples and pushes
    done = torch.stack([o.done for _, o in eager])
    assert bool(done.any())
    resampled = torch.stack(
        [(s.episode_step % env.resample_interval == 0) & ~o.done
         for s, o in eager])
    assert bool(resampled.any())
    assert STEPS > 2 * env.push_interval
    if env.cfg.obs_style != "legged":
        assert any(bool(s.push_force.abs().sum() > 0) for s, _ in eager)


@pytest.mark.cuda
def test_a_training_run_captures_at_set_up_and_replays_every_step(card):
    """`runner.init`, the zero-action step and three iterations: a capture
    for the state `init_state` makes and one for the state `step` makes,
    both before the first iteration ends; then every step a replay.  The
    extras a step handed out stay as they were after the next step."""
    env = _card_env("pointfoot_table", card)
    runner = make_alg_runner(env, "pointfoot_rough")
    before = profiling.counters()
    es = runner.init(SEED, random_episode_step=True)
    es, out = env.step(es, torch.zeros(NUM_ENVS, env.num_actions,
                                       device=card))
    assert _counts(before) == {"env.graph_capture": 1,
                               "env.graph_replay": 1}
    obs, priv = out.obs, out.privileged_obs
    T = runner.cfg.runner.num_steps_per_env
    with profiling.recording():
        for it in range(3):
            es, obs, priv, _ = runner.train_iteration(es, obs, priv)
            row = profiling.last_row()
            assert row["counters"].get("env.graph_capture", 0) == (
                1 if it == 0 else 0)
            assert row["counters"]["env.graph_replay"] == T
            assert row["spans"]["env.step"]["count"] == T
    assert _counts(before) == {"env.graph_capture": 2,
                               "env.graph_replay": 1 + 3 * T}
    # extras kept from one step are the caller's: the next step leaves them
    es, out = env.step(es, torch.zeros_like(obs[:, :env.num_actions]))
    kept = {k: v.clone() for k, v in out.extras.items()}
    env.step(es, torch.ones_like(obs[:, :env.num_actions]))
    for k, v in out.extras.items():
        assert _same_bits(v, kept[k])


@pytest.mark.cuda
def test_ablation_captures_its_own_graph(card):
    env = _card_env("pointfoot_table", card)
    es = env.init_state(SEED)
    a = torch.zeros(NUM_ENVS, env.num_actions, device=card)
    before = profiling.counters()
    _, full = env.step(es, a)
    env._ablate = frozenset({"reward"})
    _, ablated = env.step(es, a)
    assert _counts(before) == {"env.graph_capture": 2,
                               "env.graph_replay": 2}
    assert bool((ablated.reward == 0).all())
    assert not bool((full.reward == 0).all())
    env._ablate = frozenset()
    _, again = env.step(es, a)
    assert _counts(before) == {"env.graph_capture": 2,
                               "env.graph_replay": 3}
    assert _same_bits(again.reward, full.reward)
