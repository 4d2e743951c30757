"""One rank of a two-process data-parallel run of the PyTorch port, for
tests/test_torch_parallel.py and tests/test_torch_dp_runner.py (not
collected by pytest).

    python tests/_torch_dp_worker.py <job> <rank> <world_size> <dir>

The ranks meet through a file under <dir> on the gloo backend, on the CPU;
<dir>/inputs.pt holds the job's inputs (global batches; each rank takes its
rows), and each rank writes <dir>/out<rank>.pt.  Jobs:

- rollout: an all-reduce of the rank's row of a (2, n) array;
  `shard_batch` and `all_gather_rows` of an env state; `rollout_substeps`
  on the rank's rows of a physics batch; then the mesh attached to envs
  whose shards differ in size (rank 0 builds 8 envs, rank 1 10), which
  must raise;
- iteration: one `train_iteration` (or `train_iteration_recurrent`) of a
  runner on the mesh from a given PPO state, env state, observations,
  carry, action noise and permutations; the rollout and state gathered;
- traced: one `train_iteration` of a fresh runner on the mesh inside
  `profiling.recording()`: its row, and the shapes a hand count of its
  collectives needs.
"""

import os
import subprocess
import sys
import time
from dataclasses import replace

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pointfoot_tpu_torch.envs.legged_env import EnvState  # noqa: E402
from pointfoot_tpu_torch.ops.cuda import substep as sp  # noqa: E402
from pointfoot_tpu_torch.parallel import mesh as pm  # noqa: E402
from pointfoot_tpu_torch.rl.networks import map_carry  # noqa: E402
from pointfoot_tpu_torch.utils import profiling  # noqa: E402
from pointfoot_tpu_torch.utils.registry import (get_cfgs,  # noqa: E402
                                                make_alg_runner, make_env)

TIMEOUT_S = 120.0


def _train_cfg(spec):
    tc = get_cfgs(spec["task"])[1]
    return replace(tc, **{group: replace(getattr(tc, group), **fields)
                          for group, fields in spec["train"].items()})


def rollout(mesh, inp):
    B = inp["num_envs"]
    env = make_env(inp["task"], num_envs=B, device="cpu")
    env.shard_mesh = mesh
    out = {}
    x = pm.shard_batch(inp["psum"], mesh)
    pm.all_reduce_sum_([x], mesh)
    out["psum"] = x[0]
    state = pm.shard_batch(inp["state"], mesh, batch=B,
                           replicate=EnvState.REPLICATED)
    out["local_rows"] = state.physics.base_pos.shape[0]
    out["gathered"] = pm.all_gather_rows(state, mesh,
                                         replicate=EnvState.REPLICATED)
    c = env.cfg.control
    phys, tau, sphere = sp.rollout_substeps(
        env.model, *(pm.shard_batch(inp[k], mesh, batch=B) for k in (
            "params", "phys", "actions", "last_qvel", "push")),
        env.height_fn, env.cfg.sim.dt, c.decimation,
        env.default_qpos_values, c.action_scale, c.control_type,
        gravity=env.cfg.sim.gravity)
    out.update(phys=phys, tau=tau, sphere_pos=sphere)
    # shards of unequal size: 4 rows on rank 0, 5 on rank 1
    uneven = make_env(inp["task"], num_envs=8 if mesh.rank == 0 else 10,
                      device="cpu")
    try:
        uneven.shard_mesh = mesh
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    out["uneven_attached"] = uneven.shard_mesh is not None
    return out


def iteration(mesh, inp):
    spec = inp["spec"]
    env = make_env(spec["task"], num_envs=spec["num_envs"], device="cpu",
                   cfg_patch=spec["patch"])
    runner = make_alg_runner(env, spec["task"], train_cfg=_train_cfg(spec),
                             mesh=mesh)
    runner.ppo.load_state_dict(inp["ppo"])
    es = env.shard_state(inp["env_state"])
    obs, priv = env.shard_rows(inp["obs"]), env.shard_rows(inp["priv"])
    noise = inp["noise"][:, env_rows(env)]
    if runner.recurrent:
        carry = map_carry(env.shard_rows, inp["carry"])
        es, obs, priv, carry, metrics = runner.train_iteration_recurrent(
            es, obs, priv, carry, noise=noise, perms=inp["perms"])
        carry = pm.all_gather_rows(carry, mesh)
    else:
        es, obs, priv, metrics = runner.train_iteration(
            es, obs, priv, noise=noise, perms=inp["perms"])
        carry = None
    storage = pm.all_gather_rows(runner.storage, mesh, dim=1)
    return dict(ppo=runner.ppo.state_dict(), learning_rate=float(
        runner.ppo.learning_rate), metrics=metrics,
        minibatch=runner.ppo.minibatch_metrics,
        storage=storage._asdict(), env_state=env.gather_state(es),
        obs=pm.all_gather_rows(obs, mesh),
        priv=pm.all_gather_rows(priv, mesh), carry=carry,
        local_rows=env.num_envs)


def traced(mesh, inp):
    spec = inp["spec"]
    env = make_env(spec["task"], num_envs=spec["num_envs"], device="cpu",
                   cfg_patch=spec["patch"])
    runner = make_alg_runner(env, spec["task"], train_cfg=_train_cfg(spec),
                             mesh=mesh)
    es = runner.init(0)
    es, out = env.step(es, torch.zeros(env.num_envs, env.num_actions))
    with profiling.recording():
        runner.train_iteration(es, out.obs, out.privileged_obs)
    alg = runner.cfg.algorithm
    return dict(row=profiling.last_row(),
                params=sum(p.numel() for p in runner.network.parameters()),
                rewards=len(env.reward_names),
                steps=runner.cfg.runner.num_steps_per_env,
                minibatches=alg.num_learning_epochs * alg.num_mini_batches,
                curriculum=env.cfg.commands.curriculum)


def env_rows(env):
    return pm.env_sharding(env.shard_mesh, env.global_num_envs)


def run_ranks(job: str, inputs: dict, tmp: str, world: int = 2) -> list:
    """Run `job` on `world` ranks in processes of their own, each with a
    time limit, and return their outputs in rank order."""
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(r), str(world), tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + TIMEOUT_S + 60.0
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def main():
    job, rank, world, tmp = (sys.argv[1], int(sys.argv[2]),
                             int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    pm.init_distributed("gloo", f"file://{os.path.join(tmp, 'rdzv')}",
                        world_size=world, rank=rank, timeout_s=TIMEOUT_S)
    mesh = pm.make_mesh("cpu")
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    if job == "rollout":
        out = rollout(mesh, inp)
    elif job == "iteration":
        out = iteration(mesh, inp)
    elif job == "traced":
        out = traced(mesh, inp)
    else:
        raise SystemExit(f"unknown job {job}")
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    torch.distributed.destroy_process_group()
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
