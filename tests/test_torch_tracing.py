"""The port's tracing (utils/profiling.py) on the CPU: spans, rows and
counters; the switch; the profiler's clock; the spans and counters that
the runner, PPO, env, terrain and DP collectives open, counted from the
shapes of a tiny training iteration."""

import time
from dataclasses import replace

import pytest
import torch

from _torch_dp_worker import run_ranks
from pointfoot_tpu_torch import bench
from pointfoot_tpu_torch.envs.legged_env import STEP_PHASES
from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.terrain.procedural import ProceduralTerrain
from pointfoot_tpu_torch.utils import profiling
from pointfoot_tpu_torch.utils.registry import (get_cfgs, make_alg_runner,
                                                make_env)

B, T = 4, 3
CLOCK_NS = 500_000  # a span and its profiler range: within 0.5 ms
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row_records(row):
    return [r for r in profiling.records() if r.iteration == row["iteration"]]


# ------------------------------------------------------------- the registry

def test_spans_nest_and_self_time_leaves_out_the_children():
    @profiling.span("t.decorated")
    def decorated():
        time.sleep(0.001)

    with profiling.recording():
        with profiling.row() as row:
            with profiling.row() as nested:
                assert nested is None  # a row inside a row is a no-op
            with profiling.span("t.outer"):
                time.sleep(0.004)
                with profiling.span("t.inner"):
                    time.sleep(0.003)
                with profiling.span("t.inner"):
                    decorated()
            with profiling.span("t.outer"):
                pass
    assert profiling.last_row() is row
    recs = _row_records(row)
    outer = [r for r in recs if r.name == "t.outer"]
    inner = [r for r in recs if r.name == "t.inner"]
    deco = [r for r in recs if r.name == "t.decorated"]
    assert len(outer) == 2 and len(inner) == 2 and len(deco) == 1
    assert outer[0].parent is None and outer[1].parent is None
    assert all(r.parent == outer[0].id for r in inner)
    assert deco[0].parent == inner[1].id
    for child, parent in ((inner[0], outer[0]), (inner[1], outer[0]),
                          (deco[0], inner[1])):
        assert parent.start_ns <= child.start_ns <= child.end_ns \
            <= parent.end_ns
    assert row["start_ns"] <= outer[0].start_ns
    assert outer[1].end_ns <= row["end_ns"]

    def dur(rs):
        return sum(r.end_ns - r.start_ns for r in rs)

    s = row["spans"]
    assert {k: v["count"] for k, v in s.items()} == {
        "t.outer": 2, "t.inner": 2, "t.decorated": 1}
    assert s["t.outer"]["total_s"] == pytest.approx(dur(outer) * 1e-9)
    assert s["t.outer"]["self_s"] == pytest.approx(
        (dur(outer) - dur(inner)) * 1e-9)
    assert s["t.inner"]["self_s"] == pytest.approx(
        (dur(inner) - dur(deco)) * 1e-9)
    assert s["t.decorated"]["self_s"] == s["t.decorated"]["total_s"]
    for name, rs in (("t.outer", outer), ("t.inner", inner),
                     ("t.decorated", deco)):
        assert s[name]["self_s"] == pytest.approx(
            sum(r.self_ns for r in rs) * 1e-9)
    assert s["t.outer"]["self_s"] >= 0.004
    assert s["t.inner"]["total_s"] >= 0.004


def test_the_switch_off_records_nothing():
    n_rows, n_id = len(profiling.rows()), profiling._REG.next_id
    last = profiling.records()[-1:]
    # one shared no-op a name: nothing is allocated a span
    assert profiling.span("t.off") is profiling.span("t.off")
    with profiling.row() as row:
        with profiling.span("t.off"):
            torch.ones(8).sum()
    assert row is None
    assert len(profiling.rows()) == n_rows
    assert profiling._REG.next_id == n_id
    assert profiling.records()[-1:] == last
    with profiling.recording():  # the control: the same calls record
        with profiling.row() as row:
            with profiling.span("t.off"):
                torch.ones(8).sum()
    assert row["spans"]["t.off"]["count"] == 1
    assert profiling.records()[-1].name == "t.off"


def test_counters_count_with_the_switch_off():
    before = profiling.counter("t.count")
    profiling.count("t.count")
    profiling.count("t.count", 4)
    assert profiling.counter("t.count") == before + 5
    assert profiling.counters()["t.count"] == before + 5
    with profiling.recording(), profiling.row() as row:
        profiling.count("t.count", 2)
    assert row["counters"] == {"t.count": 2}
    assert profiling.counter("t.count") == before + 7


def _clock_gaps(rounds: int = 4):
    """(start, end) gaps in ns between each span's record and its
    record_function event, for spans past the first round."""
    with profiling.recording(), \
            torch.profiler.profile(activities=CPU) as prof:
        for _ in range(rounds):
            with profiling.span("t.clock_outer"):
                torch.ones(256).sum()
                with profiling.span("t.clock_inner"):
                    time.sleep(0.002)
    events = prof.profiler.kineto_results.events()
    gaps = []
    for name in ("t.clock_outer", "t.clock_inner"):
        evs = sorted((e for e in events if e.name() == name),
                     key=lambda e: e.start_ns())
        recs = sorted((r for r in profiling.records() if r.name == name),
                      key=lambda r: r.start_ns)[-rounds:]
        assert len(evs) == len(recs) == rounds
        for e, r in list(zip(evs, recs))[1:]:  # the first round warms up
            gaps.append((e.start_ns() - r.start_ns,
                         e.start_ns() + e.duration_ns() - r.end_ns))
    return gaps


def test_spans_share_the_profilers_clock():
    """Under a CPU profiler session each span opens a record_function
    range of its name, and its record starts and ends within 0.5 ms of
    the range (the profiler's events carry Unix-epoch ns).  A second and
    third try absorb a descheduled process on a loaded host."""
    for _ in range(3):
        gaps = _clock_gaps()
        if all(abs(a) < CLOCK_NS and abs(b) < CLOCK_NS for a, b in gaps):
            return
    pytest.fail(f"span records vs profiler ranges, ns: {gaps}")


def test_no_record_function_opens_without_a_profiler(monkeypatch):
    calls = []
    real = torch.autograd.profiler.record_function

    def spy(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    with profiling.span("t.rf_off"):
        pass
    with profiling.recording():
        with profiling.span("t.rf_recording"):
            pass
    assert calls == []
    with torch.profiler.profile(activities=CPU):
        with profiling.span("t.rf_profiled"):
            pass
    assert "t.rf_profiled" in calls
    assert "t.rf_off" not in calls and "t.rf_recording" not in calls


# -------------------------------------------------- the port's spans

def _step_points(env):
    """A step's terrain points: the physics' surface under every sphere at
    every substep, the height scan, the feet's heights."""
    return (env.cfg.control.decimation * len(env.model.collision_body) * B
            + B * env.num_height_points + B * len(env.feet_idx))


def _tiny_runner(recurrent: bool):
    env = make_env("pointfoot_rough", num_envs=B, device="cpu")
    assert env.cfg.terrain.mesh_type != "plane"  # the table terrain
    assert not env.cfg.terrain.procedural
    tc = get_cfgs("pointfoot_rough")[1]
    runner_f = dict(num_steps_per_env=T)
    policy_f = dict(actor_hidden_dims=(16,), critic_hidden_dims=(16,))
    alg_f = {}
    if recurrent:
        runner_f["policy_class_name"] = "ActorCriticRecurrent"
        policy_f["rnn_hidden_size"] = 8
        alg_f["num_mini_batches"] = 2  # 2 envs a minibatch
    tc = replace(tc, runner=replace(tc.runner, **runner_f),
                 policy=replace(tc.policy, **policy_f),
                 algorithm=replace(tc.algorithm, **alg_f))
    return env, make_alg_runner(env, "pointfoot_rough", train_cfg=tc)


@pytest.mark.parametrize("recurrent", [False, True],
                         ids=["feed_forward", "recurrent"])
def test_train_iteration_closes_one_row_of_every_span(recurrent):
    env, runner = _tiny_runner(recurrent)
    es = runner.init(0)
    per_step = _step_points(env)
    points = profiling.counter("terrain.points")
    es, out = env.step(es, torch.zeros(B, env.num_actions))
    assert profiling.counter("terrain.points") - points == per_step
    n_rows = profiling._REG.next_row
    with profiling.recording():
        if recurrent:
            runner.train_iteration_recurrent(
                es, out.obs, out.privileged_obs,
                runner.network.initialize_carry(B))
        else:
            runner.train_iteration(es, out.obs, out.privileged_obs)
    assert profiling._REG.next_row == n_rows + 1
    row = profiling.last_row()
    alg = runner.cfg.algorithm
    mb = alg.num_learning_epochs * alg.num_mini_batches
    want = {"runner.rollout": 1, "runner.update": 1, "ppo.gae": 1,
            "ppo.minibatch": mb, "host.wait": mb, "env.step": T,
            "terrain.surface": T * env.cfg.control.decimation,
            "terrain.scan": 2 * T}
    want.update({f"env.{p}": T for p in STEP_PHASES})
    assert {k: v["count"] for k, v in row["spans"].items()} == want
    # the spans and the ablation (bench --mode env_phases) name the same
    # phases
    assert {f"env.{p}" for p in bench.PHASES} <= set(row["spans"])
    # no kernel on the CPU, no mesh: terrain points only
    assert row["counters"] == {"terrain.points": T * per_step}
    for s in row["spans"].values():
        assert 0.0 <= s["self_s"] <= s["total_s"]
    recs = _row_records(row)
    assert len(recs) == sum(want.values())
    by_id = {r.id: r for r in recs}
    parents = {}
    for r in recs:
        assert row["start_ns"] <= r.start_ns <= r.end_ns <= row["end_ns"]
        parents.setdefault(r.name, set()).add(
            by_id[r.parent].name if r.parent in by_id else None)
    phase = {f"env.{p}": {"env.step"} for p in STEP_PHASES}
    assert parents == dict(
        phase, **{"runner.rollout": {None}, "runner.update": {None},
                  "ppo.gae": {"runner.update"},
                  "ppo.minibatch": {"runner.update"},
                  "host.wait": {"ppo.minibatch"},
                  "env.step": {"runner.rollout"},
                  "terrain.surface": {"env.physics"},
                  "terrain.scan": {"env.heights", "env.step"}})


@pytest.mark.parametrize("task,route", [
    ("anymal_c_rough", "mega"), ("anymal_c_rough", "plain"),
    ("pointfoot_rough", "fused")])
def test_actuator_and_batched_substep_spans(monkeypatch, task, route):
    """One env step inside `profiling.recording()`.  ANYmal's actuator
    network runs on the scan path: each of its 4 ticks records
    `actuator.torque` and counts envs x 12 joint rows in `actuator.rows`;
    on `step_batched`'s mega-kernel route (through the plain versions of
    kernels 4 and 3, as its benchmark cell takes the kernels) each substep
    records `physics.step_batched` too, around the surface query, and on
    the plain route (below MEGA_MIN_BATCH envs) none does.  PointFoot's
    fused rollout, the route of its cells, records neither and counts no
    actuator row."""
    if route != "plain":
        monkeypatch.setattr(dynamics, "MEGA_MIN_BATCH", 1)
    env = make_env(task, num_envs=B, device="cpu")
    es = env.init_state(0)
    with profiling.recording():
        with profiling.row() as row:
            env.step(es, torch.zeros(B, env.num_actions))
    counts = {k: v["count"] for k, v in row["spans"].items()}
    n_sub = env.cfg.control.decimation
    if task == "pointfoot_rough":
        assert "actuator.torque" not in counts
        assert "physics.step_batched" not in counts
        assert "actuator.rows" not in row["counters"]
        return
    assert counts["actuator.torque"] == n_sub == 4
    assert row["counters"]["actuator.rows"] == n_sub * B * 12
    assert counts.get("physics.step_batched", 0) == (
        n_sub if route == "mega" else 0)
    recs = _row_records(row)
    by_id = {r.id: r for r in recs}
    parent = {r.name: by_id[r.parent].name for r in recs
              if r.name in ("actuator.torque", "physics.step_batched",
                            "terrain.surface")}
    assert parent["actuator.torque"] == "env.physics"
    assert parent["terrain.surface"] == (
        "physics.step_batched" if route == "mega" else "env.physics")


def test_table_backed_procedural_step_counts_table_points():
    """A procedural terrain with the table (as on a CUDA device) records
    one `terrain.materialize` a construction, and every query point of a
    step counts in `terrain.table_points` as in `terrain.points`."""
    terrain = dict(procedural=True, num_rows=2, num_cols=3, border_size=1.0)
    env = make_env("pointfoot_rough", num_envs=B, device="cpu",
                   cfg_patch=dict(terrain=terrain))
    closed = env.terrain
    assert closed.table is None  # the CPU keeps the closed form

    def materialized():
        return sum(r.name == "terrain.materialize"
                   for r in profiling.records())

    n = materialized()
    with profiling.recording():
        ProceduralTerrain(closed.spec, closed.env_origins,
                          closed.terrain_length)
        assert materialized() == n
        for k in (1, 2):
            env.terrain = ProceduralTerrain(
                closed.spec, closed.env_origins, closed.terrain_length,
                table=True)
            assert materialized() == n + k
    env.height_fn = env._height_fn()
    es = env.init_state(0)
    before = profiling.counters()
    env.step(es, torch.zeros(B, env.num_actions))
    after = profiling.counters()
    points, table_points = (
        after.get(k, 0) - before.get(k, 0)
        for k in ("terrain.points", "terrain.table_points"))
    assert points == table_points == _step_points(env)


def test_dp_collectives_are_counted_as_by_hand(tmp_path):
    """Two gloo ranks, one `train_iteration` each inside
    `profiling.recording()`: the row's `dp.collective` spans and
    `dp.bytes` equal a count of the collectives the iteration makes."""
    spec = dict(
        task="pointfoot_flat", num_envs=2 * B,
        patch=dict(noise=dict(add_noise=False),
                   domain_rand=dict(push_robots=False),
                   # the command curriculum sums over the ranks a step
                   commands=dict(curriculum=True)),
        train=dict(runner=dict(num_steps_per_env=T),
                   policy=dict(actor_hidden_dims=(16,),
                               critic_hidden_dims=(16,))))
    for out in run_ranks("traced", {"spec": spec}, str(tmp_path)):
        assert out["curriculum"] and out["steps"] == T
        mb, params, rewards = (out["minibatches"], out["params"],
                               out["rewards"])
        # each step: the curriculum's (episodes done, tracking sum), f32
        env_calls, env_bytes = T, T * 2 * 4
        # each minibatch: the advantages' sum and squared deviations, the
        # four loss metrics, the gradients (f32)
        mb_calls, mb_bytes = 4, 4 + 4 + 4 * 4 + 4 * params
        # after the epochs: mean advantage and return (f32); the
        # iteration's metrics: resets and quarantines (int64), the
        # episode sums (f32 a reward term), three means (f32)
        end_calls, end_bytes = 1 + 3, 2 * 4 + 2 * 8 + 4 * rewards + 3 * 4
        row = out["row"]
        assert row["spans"]["dp.collective"]["count"] == (
            env_calls + mb * mb_calls + end_calls)
        assert row["counters"]["dp.bytes"] == (
            env_bytes + mb * mb_bytes + end_bytes)
