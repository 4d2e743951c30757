"""Data-parallel training of the PyTorch port (rl/runner.py and rl/ppo.py
with a mesh, `train --mesh auto`) against the JAX package's sharded
training iteration (tests/test_sharding.py:114-131) and against the port's
own single-process iteration.

One iteration of pointfoot_flat (observation noise and pushes off, small
networks, 4 steps an iteration), feed-forward at 16 envs and recurrent at
8 (1 env a device of JAX's 8-device CPU mesh, 4 a rank): JAX runs a warm
iteration and then the iteration under test with its state sharded over
the mesh and its train state replicated; the port takes JAX's state after
the warm iteration on two gloo ranks on the CPU (tests/_torch_dp_worker.py),
each with its rows of the env state, observations, carry and JAX's action
noise, and JAX's global permutations, as tests/test_torch_runner.py and
tests/test_torch_recurrent.py do for one process.  No env resets, command
resamples or pushes fall in the window.  Tolerances: the transitions at
atol 2e-3 (tests/test_torch_runner.py), the metrics at rtol 1e-5, the
parameters within `_torch_parity.adam_bound`.  Against the port's single
process the gathered rollout agrees to 1e-6 and the update as against JAX.
After the update the two ranks hold the same bits.

Then `python -m pointfoot_tpu_torch.train --mesh auto` on two ranks: only
rank 0 writes, and its checkpoint holds the global batch.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from flax import serialization

from _torch_dp_worker import run_ranks
from _torch_parity import adam_bound, export_fields, jax_minibatches
from pointfoot_tpu.parallel import mesh as jmesh
from pointfoot_tpu.utils.registry import task_registry
from pointfoot_tpu_torch import train
from pointfoot_tpu_torch.rl.networks import map_carry
from pointfoot_tpu_torch.utils import convert
from pointfoot_tpu_torch.utils.registry import (get_cfgs, make_alg_runner,
                                                make_env)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 4
ATOL = 2e-3  # tests/test_torch_runner.py (transitions, carries)
RTOL = 1e-5  # tests/test_torch_ppo.py (losses, KL, metrics)
SINGLE_ATOL = 1e-6  # the DP rollout against one process's
PATCH = dict(noise=dict(add_noise=False), domain_rand=dict(push_robots=False))
NETS = dict(actor_hidden_dims=(32,), critic_hidden_dims=(32,))
CASES = {
    "feed_forward": (16, dict(runner=dict(num_steps_per_env=T),
                              policy=NETS)),
    "recurrent": (8, dict(runner=dict(
        num_steps_per_env=T, policy_class_name="ActorCriticRecurrent"),
        policy=dict(NETS, rnn_hidden_size=16))),
}
NAMES = ["obs", "priv_obs", "action", "reward", "done", "time_out", "value",
         "log_prob", "mean", "std"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tc, train_patch):
    return replace(tc, **{g: replace(getattr(tc, g), **f)
                          for g, f in train_patch.items()})


def _t_carry(carry):
    return tuple(tuple(torch.from_numpy(np.array(x)) for x in c)
                 for c in carry)


@pytest.fixture(scope="module", params=list(CASES))
def dp(request):
    B, train_patch = CASES[request.param]
    recurrent = request.param == "recurrent"
    jenv = task_registry.make_env("pointfoot_flat", num_envs=B,
                                  cfg_patch=PATCH)
    jtc = _cfg(task_registry.get_cfgs("pointfoot_flat")[1], train_patch)
    jr = task_registry.make_alg_runner(jenv, "pointfoot_flat",
                                       train_cfg=jtc)
    assert jr.recurrent == recurrent

    def iteration(ts, es, obs, priv, carry, key):
        """JAX's train iteration, also returning the rollout, the
        bootstrap value and the carry."""
        k_roll, k_update = jax.random.split(key)
        if recurrent:
            es, obs, priv, carry1, roll, infos = jr.rollout_recurrent(
                ts, es, obs, priv, carry, k_roll)
            _, (_, _, last) = jr.network.apply(ts.params, carry1, obs, priv)
            ts, m = jr.ppo.update(ts, roll, last, k_update, carry0=carry)
        else:
            es, obs, priv, roll, infos = jr.rollout(ts, es, obs, priv,
                                                    k_roll)
            last = jr.network.apply(ts.params, priv,
                                    method=jr.network.value)
            ts, m = jr.ppo.update(ts, roll, last, k_update)
            carry1 = carry
        return jr._finish_iteration(ts, es, obs, priv, roll, infos,
                                    m) + (carry1, roll, last)

    mesh = jmesh.make_mesh(8)

    def place(ts, es, obs, priv, carry):
        """The train state replicated, the rest sharded over the mesh."""
        return (jax.device_put(ts, jmesh.replicated(mesh)),
                *jmesh.shard_batch((es, obs, priv, carry), mesh))

    it = jax.jit(iteration)
    ts, es = jr.init(jax.random.PRNGKey(0))
    ts = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), ts)
    carry = (jax.tree.map(lambda x: jnp.asarray(np.asarray(x)),
                          jr.network.initialize_carry((B,)))
             if recurrent else None)
    ts1, es1, obs1, priv1, _, carry1, _, _ = it(*place(
        ts, es, jnp.zeros((B, jenv.num_obs)),
        jnp.zeros((B, jenv.num_privileged_obs)), carry),
        jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    ts2, es2, _, _, jm, carry2, jroll, jlast = it(
        *place(ts1, es1, obs1, priv1, carry1), key)
    assert jroll.obs.sharding.is_equivalent_to(
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
            None, "dp")), ndim=3)

    k_roll, k_update = jax.random.split(key)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, 6)))
                      for k in jax.random.split(k_roll, T)])
    n = B if recurrent else T * B
    perms = [np.asarray(jax.random.permutation(k, n))
             for k in jax.random.split(k_update, 5)]
    mb, grads, _ = jax_minibatches(jr.ppo, ts1, jroll, jlast, perms,
                                   carry0=carry1 if recurrent else None)

    spec = dict(task="pointfoot_flat", num_envs=B, patch=PATCH,
                train=train_patch)
    tperms = [torch.from_numpy(p.astype(np.int64)) for p in perms]
    inputs = dict(
        spec=spec, ppo=convert.train_state_from_numpy(
            serialization.to_state_dict(jax.device_get(ts1))),
        env_state=convert.env_state_from_numpy(export_fields(es1)),
        obs=torch.from_numpy(np.array(obs1)),
        priv=torch.from_numpy(np.array(priv1)),
        noise=torch.from_numpy(noise), perms=tperms,
        carry=_t_carry(jax.tree.map(np.asarray, carry1))
        if recurrent else None)
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_ranks("iteration", inputs, tmp)

    # the port's single process on the same inputs
    tenv = make_env("pointfoot_flat", num_envs=B, device="cpu",
                    cfg_patch=PATCH)
    tr = make_alg_runner(tenv, "pointfoot_flat",
                         train_cfg=_cfg(get_cfgs("pointfoot_flat")[1],
                                        train_patch))
    tr.ppo.load_state_dict(inputs["ppo"])
    args = (inputs["env_state"], inputs["obs"], inputs["priv"])
    if recurrent:
        tes2, _, _, tcarry2, tm = tr.train_iteration_recurrent(
            *args, map_carry(torch.clone, inputs["carry"]),
            noise=inputs["noise"], perms=tperms)
    else:
        tes2, _, _, tm = tr.train_iteration(*args, noise=inputs["noise"],
                                            perms=tperms)
        tcarry2 = None
    return dict(case=request.param, B=B, jenv=jenv, es1=es1, es2=es2,
                jroll=jroll,
                jm=jm, ts2=ts2, carry2=carry2, mb=mb, grads=grads,
                outs=outs, tr=tr, tes2=tes2, tm=tm, tcarry2=tcarry2)


def test_dp_window_is_deterministic(dp):
    """No done and no command resample in the window (pushes are off)."""
    assert not np.asarray(dp["jroll"].done).any()
    assert not bool(dp["outs"][0]["storage"]["done"].any())
    steps = np.asarray(dp["es1"].episode_step)[None] + np.arange(
        1, T + 1)[:, None]
    assert (steps % dp["jenv"].resample_interval != 0).all()
    assert [o["local_rows"] for o in dp["outs"]] == [dp["B"] // 2] * 2


@pytest.mark.parametrize("name", NAMES)
def test_dp_transitions_match_jax_and_one_process(dp, name):
    got = dp["outs"][0]["storage"][name]
    want = np.asarray(getattr(dp["jroll"], name))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy().astype(np.float64),
                               want.astype(np.float64), atol=ATOL, rtol=0,
                               err_msg=name)
    single = getattr(dp["tr"].storage, name)
    np.testing.assert_allclose(got.numpy().astype(np.float64),
                               single.numpy().astype(np.float64),
                               atol=SINGLE_ATOL, rtol=0, err_msg=name)


def test_dp_state_and_carry_match_jax_and_one_process(dp):
    es = dp["outs"][0]["env_state"]
    for f in ("base_pos", "base_quat", "qpos", "qvel"):
        got = getattr(es.physics, f).numpy()
        np.testing.assert_allclose(got, np.asarray(
            getattr(dp["es2"].physics, f)), atol=ATOL, rtol=0, err_msg=f)
        np.testing.assert_allclose(
            got, getattr(dp["tes2"].physics, f).numpy(), atol=SINGLE_ATOL,
            rtol=0, err_msg=f)
    np.testing.assert_array_equal(es.episode_step.numpy(),
                                  dp["tes2"].episode_step.numpy())
    np.testing.assert_array_equal(es.episode_step.numpy(),
                                  np.asarray(dp["es2"].episode_step))
    if dp["case"] == "recurrent":
        for (gc, gh), (wc, wh), (sc, sh) in zip(
                dp["outs"][0]["carry"], dp["carry2"], dp["tcarry2"]):
            for g, w, s in ((gc, wc, sc), (gh, wh, sh)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=ATOL, rtol=0)
                np.testing.assert_allclose(g.numpy(), s.numpy(),
                                           atol=SINGLE_ATOL, rtol=0)


def test_dp_metrics_match_jax_and_one_process(dp):
    jm, tm = dp["jm"], dp["outs"][0]["metrics"]
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(np.asarray(tm[k], np.float64),
                                   np.asarray(jm[k], np.float64), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        np.testing.assert_allclose(np.asarray(tm[k], np.float64),
                                   np.asarray(dp["tm"][k], np.float64),
                                   rtol=RTOL, atol=SINGLE_ATOL, err_msg=k)
    got = dp["outs"][0]["minibatch"]["lr_intra"].numpy()
    want = np.array([m["lr_intra"] for m in dp["mb"]])
    np.testing.assert_array_equal(np.sign(np.diff(got)),
                                  np.sign(np.diff(want)))
    np.testing.assert_allclose(got, want, rtol=len(got) * 1.2e-7, atol=0)
    np.testing.assert_array_equal(
        got, dp["tr"].ppo.minibatch_metrics["lr_intra"].numpy())


def test_dp_params_match_jax_and_one_process(dp):
    want = convert.actor_critic_state_dict(jax.tree.map(
        np.asarray, dp["ts2"].params))
    state = dp["outs"][0]["ppo"]
    single = dp["tr"].ppo.state_dict()
    assert state["update_count"] == int(dp["ts2"].update_count)
    assert state["update_count"] == single["update_count"]
    for k, got in state["params"].items():
        bound = adam_bound(dp["grads"], dp["mb"], k)
        err = np.abs(got.numpy() - want[k].numpy())
        assert (err <= bound).all(), (k, err.max())
        err = np.abs(got.numpy() - single["params"][k].numpy())
        assert (err <= bound).all(), (k, err.max())


def test_ranks_agree_bit_for_bit_after_the_update(dp):
    a, b = (o["ppo"] for o in dp["outs"])
    assert a["learning_rate"] == b["learning_rate"]
    assert dp["outs"][0]["learning_rate"] == dp["outs"][1]["learning_rate"]
    assert (a["update_count"], a["adam_step"]) == (b["update_count"],
                                                   b["adam_step"])
    for k in a["params"]:
        torch.testing.assert_close(a["params"][k], b["params"][k], rtol=0,
                                   atol=0)
        for m in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(a["adam"][k][m], b["adam"][k][m],
                                       rtol=0, atol=0)
    for k, v in dp["outs"][0]["metrics"].items():
        torch.testing.assert_close(v, dp["outs"][1]["metrics"][k], rtol=0,
                                   atol=0)


# ------------------------------------------------ train --mesh auto, 2 ranks

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_on_two_ranks(tmp_path):
    """tests/test_multihost.py's run on the port: two processes train with
    `--mesh auto`, only rank 0 writes (metrics.jsonl, run_config.jsonl,
    model_2.pt), and its checkpoint holds the global batch and loads in
    one process."""
    port = str(_free_port())
    dirs = [tmp_path / f"rank{r}" for r in range(2)]
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pointfoot_tpu_torch.train",
             "--task", "pointfoot_flat", "--device", "cpu", "--mesh",
             "auto", "--num_envs", "8", "--max_iterations", "2",
             "--log_every", "1", "--log_dir", str(dirs[r]),
             "--train_override", "runner.num_steps_per_env=4",
             "--train_override", "algorithm.num_learning_epochs=2",
             "--train_override", "algorithm.num_mini_batches=2",
             "--train_override", "policy.actor_hidden_dims=(32,)",
             "--train_override", "policy.critic_hidden_dims=(32,)"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    assert "ranks=2" in logs[0] and "steps/s" in logs[0]
    assert "steps/s" not in logs[1]
    lines = [json.loads(s) for s in
             (dirs[0] / "metrics.jsonl").read_text().splitlines()]
    assert [m["it"] for m in lines] == [1, 2]
    assert all(np.isfinite(m["kl"]) and np.isfinite(m["mean_reward"])
               for m in lines)
    cfg = json.loads((dirs[0] / "run_config.jsonl").read_text())
    assert (cfg["num_envs"], cfg["ranks"]) == (8, 2)
    assert (dirs[0] / "model_2.pt").exists()
    assert not dirs[1].exists() or not os.listdir(dirs[1])

    raw = torch.load(dirs[0] / "model_2.pt", weights_only=True)
    assert raw["env_state"]["physics"]["qpos"].shape[0] == 8
    env = make_env("pointfoot_flat", num_envs=8, device="cpu")
    tc = get_cfgs("pointfoot_flat")[1]
    tc = replace(tc, policy=replace(tc.policy, **NETS))
    runner = make_alg_runner(env, "pointfoot_flat", train_cfg=tc)
    es = runner.load(str(dirs[0] / "model_2.pt"), runner.init(1))
    assert runner.current_iteration == 2
    torch.testing.assert_close(es.physics.qpos,
                               raw["env_state"]["physics"]["qpos"], rtol=0,
                               atol=0)


def test_train_cli_refuses_an_indivisible_batch(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit, match="does not divide over 2 ranks"):
        train.main(["--task", "pointfoot_flat", "--device", "cpu",
                    "--mesh", "auto", "--num_envs", "5",
                    "--max_iterations", "1"])
    assert not dist.is_initialized()
