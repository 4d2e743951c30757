"""On-policy training runner (pointfoot_tpu/rl/runner.py, OnPolicyRunner).

One `train_iteration` collects `num_steps_per_env` transitions of every env
and runs the PPO update; `learn` loops it, logs the JAX package's metrics
(`metrics.jsonl`, and TensorBoard where it can be imported) and saves
checkpoints.  The runner owns the network, the PPO update (rl/ppo.py) and
the generator of the action noise; the env state is passed in and out.

The rollout runs under `torch.no_grad()`: the update recomputes log-probs
and values from the stored observations, so the rollout needs no graph, and
the CUDA kernels of the env step refuse inputs that carry one.  Not
`inference_mode()`: the stored observations go into the update's forward
pass, which cannot save inference tensors for backward.  The rollout fills
storage preallocated as (T, B, ...), reused by the next iteration.

With `runner.policy_class_name` "ActorCriticRecurrent" the runner trains
the LSTM policy with RecurrentPPO: `rollout_recurrent` steps both cells
every env step (the critic's on the privileged observations) and zeroes an
env's carry after a done; `train_iteration_recurrent` takes and returns the
carry and hands the update the carry the window started from, kept in
preallocated storage.  `learn` starts from zero carries; checkpoints hold
no carry, as in JAX.

Checkpoints are torch files, `model_<iteration>.pt`, holding the PPO state
(parameters, Adam moments, learning rate, update count), the iteration and
the env state.

With a data-parallel mesh (parallel/mesh.py; the JAX runner's `mesh`) the
env steps this rank's shard of the global batch, and the runner shards
what JAX shards: the initial state is the global one drawn from the seed,
the action noise is drawn for the global batch and sliced, and the
recurrent carry is the rank's rows.  Parameters and optimizer state are
replicated (the network is broadcast from rank 0 at init) and the PPO
update reduces across ranks (rl/ppo.py).  Metrics are reduced to their
global values on every rank; only rank 0 logs, prints and writes, and
`save` is a collective that gathers the env state so that rank 0 writes
the global batch.

Tracing (utils/profiling.py): the rollout runs in the span
`runner.rollout`, the update in `runner.update`, and each
`train_iteration` / `train_iteration_recurrent` closes one row of its
spans and counters inside `profiling.recording()`, which `learn` turns
on; `learn`'s log lines carry the row (`row_scalars`).

`learn` honours the bench lock of utils/benchlock.py (the JAX runner's
handshake): rank 0 registers as the live trainer, and every rank checks
the lock before the first iteration and at the top of each, pausing while
a bench of either package measures; the paused seconds come off the
steps/s clock.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import os
import time
from typing import Callable, Dict, Optional

import torch

from pointfoot_tpu_torch.envs.config import TrainCfg
from pointfoot_tpu_torch.envs.legged_env import EnvState, phase_ms_per_step
from pointfoot_tpu_torch.parallel.mesh import (Mesh, all_reduce_mean_,
                                               all_reduce_sum_, replicated,
                                               shard_batch)
from pointfoot_tpu_torch.rl.networks import (ActorCritic,
                                             ActorCriticRecurrent,
                                             carry_leaves, gaussian_log_prob,
                                             map_carry,
                                             sample_action)
from pointfoot_tpu_torch.rl.ppo import PPO, RecurrentPPO, Transition
from pointfoot_tpu_torch.utils import benchlock, profiling

INFO_KEYS = ("episode_rew", "num_resets", "terrain_level", "max_command_x",
             "num_nan_quarantined")


class OnPolicyRunner:
    def __init__(self, env, train_cfg: TrainCfg,
                 log_dir: Optional[str] = None, mesh: Optional[Mesh] = None):
        """`mesh`: train data-parallel over its ranks; the env (built
        with the global batch on the mesh's device) steps this rank's
        shard."""
        if mesh is not None:
            dev = torch.device(env.device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            if dev != mesh.device:
                raise ValueError(f"the env runs on {env.device}, the mesh's "
                                 f"rank on {mesh.device}")
            env.shard_mesh = mesh
        self.env = env
        self.cfg = train_cfg
        self.log_dir = log_dir
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0  # logs and writes
        self.device = env.device
        p = train_cfg.policy
        self.recurrent = (train_cfg.runner.policy_class_name
                          == "ActorCriticRecurrent")
        dims = (env.num_obs, env.num_privileged_obs or env.num_obs,
                env.num_actions)
        if self.recurrent:
            self.network = ActorCriticRecurrent(
                *dims, p.rnn_hidden_size, p.actor_hidden_dims,
                p.critic_hidden_dims, p.activation, p.init_noise_std)
            ppo_cls = RecurrentPPO
        else:
            self.network = ActorCritic(
                *dims, p.actor_hidden_dims, p.critic_hidden_dims,
                p.activation, p.init_noise_std)
            ppo_cls = PPO
        self.network.to(self.device)
        self.ppo = ppo_cls(self.network, train_cfg.algorithm, mesh=mesh)
        self.generator = torch.Generator(device=self.device)
        self.current_iteration = 0
        self._writer = None
        self.storage = None
        self.carry0 = None  # the recurrent window's starting carry

    # ---------------------------------------------------------------- setup

    def init(self, seed: int, random_episode_step: bool = False
             ) -> EnvState:
        """Fresh network (drawn on the CPU, the same on every device;
        broadcast from rank 0 with a mesh), Adam state and learning rate;
        seeded generators; a fresh env state (`LeggedEnv.init_state`)."""
        self.network.reset_parameters(torch.Generator().manual_seed(seed))
        replicated(self.network, self.mesh)
        self.ppo.reset()
        self.generator.manual_seed(seed + 1)
        self.ppo.generator.manual_seed(seed + 2)
        return self.env.init_state(seed, random_episode_step)

    # ------------------------------------------------------------ iteration

    def _buffers(self, obs: torch.Tensor, priv_obs) -> Transition:
        T = self.cfg.runner.num_steps_per_env
        B, na = self.env.num_envs, self.env.num_actions
        st = self.storage
        if st is None:
            def z(*shape, dtype=torch.float32):
                return torch.zeros((T, B) + shape, dtype=dtype,
                                   device=self.device)

            obs_buf = z(obs.shape[-1])
            st = Transition(
                obs=obs_buf,
                # a symmetric critic reads the observations themselves
                priv_obs=(obs_buf if priv_obs is None
                          else z(priv_obs.shape[-1])),
                action=z(na), reward=z(), done=z(dtype=torch.bool),
                time_out=z(), value=z(), log_prob=z(), mean=z(na),
                std=z(na))
            self.storage = st
        return st

    @torch.no_grad()
    def rollout(self, env_state: EnvState, obs, priv_obs, noise=None):
        """`num_steps_per_env` policy steps.  `priv_obs` is None for a
        symmetric-critic task, and `obs` stands in for it.  The action noise
        comes from the runner's generator (drawn for the global batch, with
        a mesh, and sliced) unless `noise` (T, B, na; this rank's rows)
        gives it.  Returns (env state, obs, priv_obs, the rollout as a Transition
        of (T, B, ...) storage, the per-step infos)."""
        env_state, obs, priv_obs, _, st, infos = self._rollout(
            env_state, obs, priv_obs, None, noise)
        return env_state, obs, priv_obs, st, infos

    @torch.no_grad()
    def rollout_recurrent(self, env_state: EnvState, obs, priv_obs, carry,
                          noise=None):
        """`rollout` of the recurrent policy from `carry`, which is copied
        into the storage's `carry0`.  Returns (env state, obs, priv_obs, the
        carry after the window, the rollout, the per-step infos)."""
        if self.carry0 is None:
            self.carry0 = map_carry(torch.empty_like, carry)
        for dst, src in zip(carry_leaves(self.carry0), carry_leaves(carry)):
            dst.copy_(src)
        return self._rollout(env_state, obs, priv_obs, carry, noise)

    @profiling.span("runner.rollout")
    def _rollout(self, env_state, obs, priv_obs, carry, noise):
        net = self.network
        env = self.env
        st = self._buffers(obs, priv_obs)
        T = st.obs.shape[0]
        infos = {k: [] for k in INFO_KEYS}
        for t in range(T):
            po = obs if priv_obs is None else priv_obs
            if carry is None:
                mean, std = net.distribution(obs)
                value = net.value(po)
            else:
                carry, (mean, std, value) = net(carry, obs, po)
            eps = None if noise is None else noise[t]
            if eps is None and env.shard_mesh is not None:
                # the global batch's draw, this rank's rows
                eps = env.shard_rows(torch.randn(
                    (env.global_num_envs,) + mean.shape[1:],
                    generator=self.generator, device=mean.device,
                    dtype=mean.dtype))
            action = sample_action(mean, std, self.generator, eps)
            log_prob = gaussian_log_prob(mean, std, action)
            st.obs[t].copy_(obs)
            if priv_obs is not None:
                st.priv_obs[t].copy_(priv_obs)
            env_state, out = self.env.step(env_state, action)
            if carry is not None:
                # an env that just reset starts its episode from zero
                keep = (1.0 - out.done.to(obs.dtype))[:, None]
                carry = map_carry(lambda c: c * keep, carry)
            st.action[t].copy_(action)
            st.reward[t].copy_(out.reward)
            st.done[t].copy_(out.done)
            st.time_out[t].copy_(out.extras["time_outs"])
            st.value[t].copy_(value)
            st.log_prob[t].copy_(log_prob)
            st.mean[t].copy_(mean)
            st.std[t].copy_(std)
            for k in INFO_KEYS:
                infos[k].append(out.extras[k])
            obs = out.obs
            priv_obs = None if priv_obs is None else out.privileged_obs
        return (env_state, obs, priv_obs, carry, st,
                {k: torch.stack(v) for k, v in infos.items()})

    def train_iteration(self, env_state: EnvState, obs, priv_obs,
                        noise=None, perms=None):
        """Rollout, then the PPO update.  `noise` and `perms` (one
        permutation per epoch) replace the runner's and the PPO's draws.
        Returns (env state, obs, priv_obs, metrics).  Inside
        `profiling.recording()` it closes one row of the iteration's spans
        and counters."""
        with profiling.row():
            env_state, obs, priv_obs, rollout, infos = self.rollout(
                env_state, obs, priv_obs, noise)
            metrics = self.update(rollout, obs, priv_obs, perms)
            return self._finish_iteration(env_state, obs, priv_obs, rollout,
                                          infos, metrics)

    @profiling.span("runner.update")
    def update(self, rollout: Transition, obs, priv_obs, perms=None):
        """The PPO update of a rollout that ended at `obs` / `priv_obs`,
        bootstrapped from their value."""
        with torch.no_grad():
            last_value = self.network.value(
                obs if priv_obs is None else priv_obs)
        return self.ppo.update(rollout, last_value, perms)

    def train_iteration_recurrent(self, env_state: EnvState, obs, priv_obs,
                                  carry, noise=None, perms=None):
        """`train_iteration` of the recurrent policy: the carry threads
        through the rollout and on to the next iteration, and the update
        replays each minibatch from the window's starting carry.  Returns
        (env state, obs, priv_obs, carry, metrics)."""
        with profiling.row():
            env_state, obs, priv_obs, carry, rollout, infos = \
                self.rollout_recurrent(env_state, obs, priv_obs, carry, noise)
            metrics = self.update_recurrent(rollout, obs, priv_obs, carry,
                                            perms)
            env_state, obs, priv_obs, metrics = self._finish_iteration(
                env_state, obs, priv_obs, rollout, infos, metrics)
        return env_state, obs, priv_obs, carry, metrics

    @profiling.span("runner.update")
    def update_recurrent(self, rollout: Transition, obs, priv_obs, carry,
                         perms=None):
        """The RecurrentPPO update of the window `rollout_recurrent` last
        collected, replayed from the carry it started from (the storage's
        `carry0`); the window ended at `obs` / `priv_obs` with `carry`, and
        is bootstrapped from one forward on that carry (the advanced copy is
        discarded)."""
        with torch.no_grad():
            _, (_, _, last_value) = self.network(
                carry, obs, obs if priv_obs is None else priv_obs)
        return self.ppo.update(rollout, last_value, perms,
                               carry0=self.carry0)

    def _finish_iteration(self, env_state, obs, priv_obs, rollout, infos,
                          metrics):
        """The iteration's metrics; with a mesh, reduced across ranks to
        those of the global batch (on every rank)."""
        metrics["mean_reward"] = torch.mean(rollout.reward)
        metrics["mean_episode_length"] = torch.mean(
            env_state.episode_step.to(torch.float32))
        metrics["noise_std"] = torch.mean(
            torch.exp(self.network.log_std.detach()))
        # episode decomposition averaged over the steps that had resets
        n_resets = torch.sum(infos["num_resets"])
        ep_sum = torch.sum(
            infos["episode_rew"] * infos["num_resets"][:, None], dim=0)
        metrics["num_nan_quarantined"] = torch.sum(
            infos["num_nan_quarantined"])
        metrics["terrain_level"] = infos["terrain_level"][-1]
        if self.mesh is not None:
            all_reduce_sum_([n_resets, metrics["num_nan_quarantined"]],
                            self.mesh)
            all_reduce_sum_([ep_sum], self.mesh)
            # every rank holds as many envs: the mean of the ranks' means
            all_reduce_mean_([metrics["mean_reward"],
                              metrics["mean_episode_length"],
                              metrics["terrain_level"]], self.mesh)
        metrics["episode_rew"] = ep_sum / torch.clamp_min(n_resets, 1)
        metrics["num_resets"] = n_resets
        metrics["max_command_x"] = infos["max_command_x"][-1]
        return env_state, obs, priv_obs, metrics

    # ---------------------------------------------------------------- learn

    def learn(self, num_iterations: int, seed: Optional[int] = None,
              env_state: Optional[EnvState] = None,
              log_every: int = 10) -> EnvState:
        """The training loop.  Without `env_state` it initialises from
        `seed` (the config's by default), with random episode lengths drawn
        from the env's generator; with one it goes on from the runner's
        current network and optimizer (a resumed run).  Returns the final
        env state.  With a mesh every rank calls it.  The loop runs inside
        `profiling.recording()`, and each logged line carries the spans of
        its iteration's row (`row_scalars`)."""
        env = self.env
        if env_state is None:
            env_state = self.init(self.cfg.seed if seed is None else seed,
                                  random_episode_step=True)
        # initial observations: one zero-action step
        env_state, out0 = env.step(env_state, torch.zeros(
            env.num_envs, env.num_actions, device=self.device))
        obs, priv_obs = out0.obs, out0.privileged_obs
        carry = (self.network.initialize_carry(env.num_envs)
                 if self.recurrent else None)
        steps_per_iter = (self.cfg.runner.num_steps_per_env
                          * env.global_num_envs)
        save_interval = self.cfg.runner.save_interval
        if self.is_main:
            benchlock.trainer_register()
        try:
            benchlock.trainer_heartbeat()
            if self.is_main and self.log_dir:
                # tensorboard's import takes seconds: before the clock
                self._open_writer()
            t_start = time.time()
            drain = None
            with profiling.recording():
                for it in range(num_iterations):
                    t_start += benchlock.trainer_heartbeat(drain=drain)
                    if self.recurrent:
                        env_state, obs, priv_obs, carry, metrics = \
                            self.train_iteration_recurrent(env_state, obs,
                                                           priv_obs, carry)
                    else:
                        env_state, obs, priv_obs, metrics = \
                            self.train_iteration(env_state, obs, priv_obs)
                    if self.device.type == "cuda":
                        # the last metrics are on the card: wait for them
                        # before acking a bench
                        drain = functools.partial(torch.cuda.synchronize,
                                                  self.device)
                    self.current_iteration += 1
                    if self.is_main and (it % log_every == 0
                                         or it == num_iterations - 1):
                        m = {k: v.cpu() for k, v in metrics.items()}
                        elapsed = time.time() - t_start
                        self._log(self.current_iteration, m,
                                  steps_per_iter * (it + 1)
                                  / max(elapsed, 1e-9),
                                  profiling.last_row())
                    if (save_interval > 0 and self.log_dir
                            and self.current_iteration % save_interval == 0):
                        self.save(env_state)
            if self.log_dir:
                self.save(env_state)
        finally:
            if self.is_main:
                benchlock.trainer_unregister()
        return env_state

    # -------------------------------------------------------------- logging

    def _log(self, it: int, m: Dict, steps_per_sec: float,
             row: Optional[dict] = None):
        scalars = {
            "it": it,
            "steps_per_sec": round(float(steps_per_sec), 1),
            "mean_reward": float(m["mean_reward"]),
            "mean_episode_length": float(m["mean_episode_length"]),
            "value_loss": float(m["value_loss"]),
            "surrogate_loss": float(m["surrogate_loss"]),
            "kl": float(m["kl"]),
            "lr": float(m["learning_rate"]),
            "lr_intra": float(m["lr_intra"]),
            "noise_std": float(m["noise_std"]),
            "terrain_level": float(m["terrain_level"]),
            "nan_quarantined": int(m["num_nan_quarantined"]),
        }
        for name, val in zip(self.env.reward_names,
                             m["episode_rew"].tolist()):
            scalars[f"rew_{name}"] = float(val)
        split = ""
        if row is not None:
            scalars.update(row_scalars(row))
            split = (f" | roll {scalars['rollout_s']:.3f} s"
                     f" | upd {scalars['update_s']:.3f} s"
                     f" | wait {scalars['host_wait_s']:.3f} s")
        print(f"it {it:6d} | {scalars['steps_per_sec']:9.0f} steps/s{split} | "
              f"rew {scalars['mean_reward']:8.4f} | "
              f"eplen {scalars['mean_episode_length']:6.1f} | "
              f"kl {scalars['kl']:.4f} | lr {scalars['lr']:.1e}", flush=True)
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            with open(os.path.join(self.log_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(scalars) + "\n")
            self._tb_log(it, scalars)

    def _open_writer(self):
        """The TensorBoard writer, opened once (False without tensorboard,
        which is optional)."""
        if self._writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self._writer = False
            else:
                self._writer = SummaryWriter(self.log_dir)

    def _tb_log(self, it: int, scalars: Dict):
        self._open_writer()
        if self._writer:
            for k, v in scalars.items():
                if k != "it":
                    self._writer.add_scalar(k, v, it)

    # ---------------------------------------------------------- checkpoints

    def save(self, env_state: EnvState) -> str:
        """`<log_dir>/model_<iteration>.pt`: the PPO state, the iteration
        and the env state.  With a mesh a collective: the env state is
        gathered from every rank and rank 0 alone writes the global batch;
        every rank returns the path."""
        env_state = self.env.gather_state(env_state)
        path = os.path.join(self.log_dir,
                            f"model_{self.current_iteration}.pt")
        if self.is_main:
            os.makedirs(self.log_dir, exist_ok=True)
            torch.save({"train_state": self.ppo.state_dict(),
                        "iteration": self.current_iteration,
                        "env_state": _state_to_dict(env_state)}, path)
        return path

    def load(self, path: str, env_state: EnvState) -> EnvState:
        """Restore the PPO state and iteration from `path`.  Returns the
        saved env state where every saved field has the shape of the one in
        `env_state`; otherwise (another env batch, such as evaluating a
        4096-env run with 50 envs) `env_state` itself.  With a mesh a saved
        global batch gives each rank its rows, so a checkpoint loads on any
        number of ranks that divides its batch."""
        raw = torch.load(path, map_location=self.device, weights_only=True)
        self.ppo.load_state_dict(raw["train_state"])
        self.current_iteration = int(raw["iteration"])
        saved = raw["env_state"]
        if self.mesh is not None:
            saved = shard_batch(saved, self.mesh,
                                batch=self.env.global_num_envs,
                                replicate=EnvState.REPLICATED)
        fresh = _state_to_dict(env_state)
        if all(k in fresh and _same_shapes(fresh[k], v)
               for k, v in saved.items()):
            return _state_from_dict(env_state, saved)
        return env_state

    # ------------------------------------------------------------ inference

    def get_inference_policy(self) -> Callable:
        """Deterministic policy obs -> action mean, of the current
        parameters (a copy: later updates do not change it).  For the
        recurrent policy a callable that keeps the LSTM carry itself:
        `reset(batch)` starts it from zero (`reset()` drops it), and a call
        with another batch size than the last resets it."""
        if self.recurrent:
            return _StatefulPolicy(*self.get_inference_policy_recurrent())
        actor = copy.deepcopy(self.network.actor).eval()

        @torch.no_grad()
        def policy(obs):
            return actor(obs)

        return policy

    def get_inference_policy_recurrent(self):
        """(policy, carry0): policy(carry, obs) -> (carry, action mean) of
        a copy of the current parameters, carry0(batch) the zero carry.
        As in JAX the critic cell is fed the observations too (deployment
        has no privileged observations), so the policy exists only where
        the critic reads observations of the actor's width."""
        env = self.env
        if env.num_privileged_obs not in (None, env.num_obs):
            raise ValueError(
                f"the recurrent inference policy feeds the {env.num_obs}-d "
                f"observations to the critic cell as well, as the JAX "
                f"package does, but this task's critic cell reads "
                f"{env.num_privileged_obs}-d privileged observations (the "
                f"JAX package fails here too, with flax's parameter-shape "
                f"error)")
        net = copy.deepcopy(self.network).eval()

        @torch.no_grad()
        def policy(carry, obs):
            carry, (mean, _, _) = net(carry, obs, obs)
            return carry, mean

        return policy, net.initialize_carry


def row_scalars(row: dict) -> Dict[str, float]:
    """What `learn` logs of an iteration's row (utils/profiling.py), by
    the host's clock: `rollout_s`, `update_s` and `host_wait_s` (the
    update's waits for the card); the recurrent update's CUDA graphs
    captured and minibatches replayed, `ppo_graph_capture` and
    `ppo_graph_replay`, and the env step's, `env_graph_capture` and
    `env_graph_replay` (0 off the graph routes); where the env's terrain
    queries ran in their spans, `terrain_ms_per_step` and
    `terrain_ns_per_point`; where its phases did, each phase's self ms a
    step, `env_<phase>_ms` (a CUDA graph's replays run neither, and log
    neither); with DP collectives,
    `collective_s` and `dp_bytes` (this rank's)."""
    spans, counts = row["spans"], row["counters"]

    def total(name):
        return spans[name]["total_s"] if name in spans else 0.0

    out = {"rollout_s": total("runner.rollout"),
           "update_s": total("runner.update"),
           "host_wait_s": total("host.wait"),
           "ppo_graph_capture": counts.get("ppo.graph_capture", 0),
           "ppo_graph_replay": counts.get("ppo.graph_replay", 0),
           "env_graph_capture": counts.get("env.graph_capture", 0),
           "env_graph_replay": counts.get("env.graph_replay", 0)}
    steps = spans.get("env.step", {}).get("count", 0)
    terrain_s = total("terrain.surface") + total("terrain.scan")
    points = counts.get("terrain.points", 0)
    if steps and points and terrain_s:
        out["terrain_ms_per_step"] = terrain_s / steps * 1e3
        out["terrain_ns_per_point"] = terrain_s / points * 1e9
    for phase, ms in phase_ms_per_step(row).items():
        out[f"env_{phase}_ms"] = ms
    if "dp.collective" in spans:
        out["collective_s"] = total("dp.collective")
        out["dp_bytes"] = counts.get("dp.bytes", 0)
    return out


class _StatefulPolicy:
    """obs -> action mean of a recurrent policy that keeps its carry."""

    def __init__(self, step: Callable, carry0: Callable):
        self._step, self._carry0 = step, carry0
        self._carry, self._batch = None, None

    def reset(self, batch: Optional[int] = None) -> None:
        self._batch = batch
        self._carry = None if batch is None else self._carry0(batch)

    def __call__(self, obs: torch.Tensor) -> torch.Tensor:
        b = obs.shape[0] if obs.ndim > 1 else 1
        if self._carry is None or b != self._batch:
            self.reset(b)
        o = obs if obs.ndim > 1 else obs[None]
        self._carry, mean = self._step(self._carry, o)
        return mean if obs.ndim > 1 else mean[0]


def _state_to_dict(state) -> dict:
    return {f.name: (_state_to_dict(getattr(state, f.name))
                     if dataclasses.is_dataclass(getattr(state, f.name))
                     else getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _same_shapes(fresh, saved) -> bool:
    if isinstance(saved, dict):
        return isinstance(fresh, dict) and all(
            k in fresh and _same_shapes(fresh[k], v)
            for k, v in saved.items())
    return isinstance(fresh, torch.Tensor) and fresh.shape == saved.shape


def _state_from_dict(template, saved: dict):
    """`template` with every field that `saved` holds replaced by the saved
    value; fields added since the checkpoint keep the template's."""
    kw = {}
    for name, v in saved.items():
        cur = getattr(template, name)
        kw[name] = (_state_from_dict(cur, v) if isinstance(v, dict)
                    else v.to(cur.device, cur.dtype))
    return dataclasses.replace(template, **kw)
