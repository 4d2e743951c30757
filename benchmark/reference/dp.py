"""Data-parallel PPO training of the plain route, in one process: the port's
training iteration over W ranks (its parallel/mesh.py, and rl/runner.py and
rl/ppo.py with a mesh), followed over W shards of the frozen reference env.

- The initial state is the global batch's, drawn from the seed by one env
  of the whole batch.  Shard r keeps rows [r*b, (r+1)*b) and then draws
  from a generator of its own, seeded with `rank_seed(seed, r)`, as rank r
  does.
- Each step's action noise is drawn for the global batch and sliced.  The
  networks run on each shard's rows apart, as on the ranks.
- The update permutes the samples of the global batch.  Each minibatch's
  loss is split into the shards' shares: sums over a shard's samples over
  the global count.  Plain sums over the shards, in rank order, stand in
  for the port's `all_reduce_sum_`: the advantages' sum and squared
  deviations, the metrics (the KL that sets the learning rate among
  them), and the gradients before they are clipped.
- The command curriculum sums the finished episodes across ranks on an
  episode-length tick.  A step that reaches such a tick raises here, since
  the shards do not exchange inside a step; none falls within the
  recorded iterations.

Everything else, the optimizer step included, is the one-process
reference (runner.py, ppo.py, legged_env.py).  Feed-forward policies only.
Imports nothing of the port.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import List

import numpy as np
import torch

from benchmark.reference.config import LeggedEnvCfg, TrainCfg
from benchmark.reference.legged_env import EnvState, LeggedEnv, StepOutput
from benchmark.reference.networks import (gaussian_entropy,
                                          gaussian_log_prob, sample_action)
from benchmark.reference.ppo import PPO, Transition, compute_gae
from benchmark.reference.runner import Runner

# the fields of the env state that are not per env: every rank holds them
# whole
REPLICATED = ("common_step", "lin_vel_x_range")


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s random stream, derived from (seed, rank)
    as the port's parallel/mesh.py derives it."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def shard_rows(tree, rows: slice, batch: int):
    """`tree` (dataclasses of tensors) with every tensor whose leading size
    is `batch` cut to `rows`; the fields named in REPLICATED whole."""
    if isinstance(tree, torch.Tensor):
        return tree[rows] if tree.dim() > 0 and tree.shape[0] == batch \
            else tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: (getattr(tree, f.name) if f.name in REPLICATED
                     else shard_rows(getattr(tree, f.name), rows, batch))
            for f in dataclasses.fields(tree)})
    return tree


def _sum(values):
    """The sum in rank order."""
    return functools.reduce(torch.add, values)


class ShardedEnv:
    """W shards of the reference env over one global batch, stepped one
    after another.  Observations, actions and rewards are in the global
    layout (the shards' rows in rank order); the env state is the list of
    the shards' states."""

    def __init__(self, cfg: LeggedEnvCfg, device, ranks: int):
        B = cfg.env.num_envs
        if B % ranks:
            raise ValueError(f"a batch of {B} does not divide over {ranks} "
                             f"shards")
        self.whole = LeggedEnv(cfg, device)
        self.shards = []
        for _ in range(ranks):
            env = copy.copy(self.whole)  # the terrain and model shared
            env.num_envs = B // ranks
            env.generator = torch.Generator(device=self.whole.device)
            self.shards.append(env)
        b = B // ranks
        self.rows = [slice(r * b, (r + 1) * b) for r in range(ranks)]
        self.device = self.whole.device
        self.num_envs = B
        self.num_obs = self.whole.num_obs
        self.num_privileged_obs = self.whole.num_privileged_obs
        self.num_actions = self.whole.num_actions
        self.tick = (self.whole.max_episode_length
                     if cfg.commands.curriculum else None)

    def init_state(self, seed: int, random_episode_step: bool = False
                   ) -> List[EnvState]:
        state = self.whole.init_state(seed, random_episode_step)
        for r, env in enumerate(self.shards):
            env.generator.manual_seed(rank_seed(seed, r))
        return [shard_rows(state, rows, self.num_envs) for rows in self.rows]

    def step(self, states: List[EnvState], actions: torch.Tensor):
        if self.tick and int(states[0].common_step + 1) % self.tick == 0:
            raise NotImplementedError(
                "an episode-length tick: the command curriculum sums the "
                "finished episodes across the shards there")
        outs, new = [], []
        for env, st, rows in zip(self.shards, states, self.rows):
            # a fresh copy, as a rank's own tensor: some kernels take
            # another path on a view that starts off alignment
            st, out = env.step(st, actions[rows].clone())
            new.append(st)
            outs.append(out)
        priv = (None if outs[0].privileged_obs is None
                else torch.cat([o.privileged_obs for o in outs]))
        return new, StepOutput(
            obs=torch.cat([o.obs for o in outs]), privileged_obs=priv,
            reward=torch.cat([o.reward for o in outs]),
            done=torch.cat([o.done for o in outs]),
            extras={"time_outs": torch.cat(
                [o.extras["time_outs"] for o in outs])})


class ShardedPPO(PPO):
    """The reference PPO over W shards of the rollout: each minibatch's
    loss is the sum of the shards' shares."""

    def __init__(self, network, cfg, ranks: int):
        super().__init__(network, cfg)
        self.ranks = ranks

    def _share(self, batch: Transition, advantages, returns, mu, sd,
               count: int):
        """A shard's share of the global minibatch loss and of its metrics
        (sums over the shard's samples over the global `count`), with the
        global advantage mean `mu` and standard deviation `sd`."""
        cfg = self.cfg
        mean, std = self.network.distribution(batch.obs)
        value = self.network.value(batch.priv_obs)

        def avg(x):
            return x.sum() / count

        log_prob = gaussian_log_prob(mean, std, batch.action)
        ratio = torch.exp(log_prob - batch.log_prob)
        norm_adv = (advantages - mu) / (sd + 1e-8)
        surr1 = ratio * norm_adv
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param,
                            1.0 + cfg.clip_param) * norm_adv
        surrogate_loss = -avg(torch.minimum(surr1, surr2))
        if cfg.use_clipped_value_loss:
            value_clipped = batch.value + torch.clamp(
                value - batch.value, -cfg.clip_param, cfg.clip_param)
            v_loss = torch.maximum((value - returns) ** 2,
                                   (value_clipped - returns) ** 2)
        else:
            v_loss = (value - returns) ** 2
        value_loss = avg(v_loss)
        entropy = avg(gaussian_entropy(std))
        loss = (surrogate_loss + cfg.value_loss_coef * value_loss
                - cfg.entropy_coef * entropy)
        with torch.no_grad():
            kl_per_sample = torch.sum(
                torch.log(std / batch.std + 1e-5)
                + (batch.std ** 2 + (batch.mean - mean) ** 2)
                / (2.0 * std ** 2)
                - 0.5, dim=-1)
            if cfg.kl_winsor > 0.0:
                kl_per_sample = torch.clamp_max(kl_per_sample, cfg.kl_winsor)
            kl = avg(kl_per_sample)
        metrics = dict(surrogate_loss=surrogate_loss.detach().clone(),
                       value_loss=value_loss.detach().clone(),
                       entropy=entropy.detach().clone(), kl=kl)
        return loss, metrics

    def update(self, rollout: Transition, last_value: torch.Tensor,
               perms=None):
        """GAE on each shard, then epochs x minibatches of SGD over the
        global samples (sample t * B + e of global env e), each minibatch
        taking the samples of each shard's envs."""
        T, B = rollout.reward.shape
        b = B // self.ranks
        shards, advs, rets = [], [], []
        for r in range(self.ranks):
            part = Transition(*(x[:, r * b:(r + 1) * b].clone()
                                for x in rollout))
            adv, ret = compute_gae(part.reward, part.done, part.time_out,
                                   part.value,
                                   last_value[r * b:(r + 1) * b].clone(),
                                   self.cfg.gamma, self.cfg.lam)
            shards.append((Transition(*(x.reshape((T * b,) + x.shape[2:])
                                        for x in part)),
                           adv.reshape(-1), ret.reshape(-1)))
            advs.append(adv)
            rets.append(ret)

        def minibatch(idx):
            count = idx.numel()
            e = idx % B
            parts = []
            for r, (flat, adv, ret) in enumerate(shards):
                own = (e >= r * b) & (e < (r + 1) * b)
                j = (idx // B)[own] * b + e[own] - r * b
                parts.append((Transition(*(x[j] for x in flat)), adv[j],
                              ret[j]))
            mu = _sum([a.sum() for _, a, _ in parts]) / count
            dev2 = _sum([((a - mu) ** 2).sum() for _, a, _ in parts])
            sd = torch.sqrt(dev2 / count)
            grads, metrics = [], []
            for batch, adv, ret in parts:
                self.optimizer.zero_grad(set_to_none=False)
                loss, m = self._share(batch, adv, ret, mu, sd, count)
                loss.backward()
                grads.append([p.grad.clone() for p in self.params])
                metrics.append(m)
            for p, g in zip(self.params, zip(*grads)):
                p.grad.copy_(_sum(g))
            return None, {k: _sum([m[k] for m in metrics])
                          for k in metrics[0]}

        return self._epochs(T * B, perms, minibatch, torch.cat(advs, 1),
                            torch.cat(rets, 1))


class ShardedRunner(Runner):
    """The reference runner over a ShardedEnv: the networks run on each
    shard's rows apart; the action noise is drawn for the global batch."""

    def __init__(self, env: ShardedEnv, train_cfg: TrainCfg):
        if train_cfg.runner.policy_class_name == "ActorCriticRecurrent":
            raise ValueError("the data-parallel reference is feed-forward")
        super().__init__(env, train_cfg)
        self.ppo = ShardedPPO(self.network, train_cfg.algorithm,
                              len(env.shards))

    def _outputs(self, obs, po):
        """(mean, std, value) of the network, each shard's rows apart (a
        fresh copy of them, as the env step hands a rank)."""
        outs = []
        for rows in self.env.rows:
            mean, std = self.network.distribution(obs[rows].clone())
            outs.append((mean, std, self.network.value(po[rows].clone())))
        return outs

    def _rollout(self, env_state, obs, priv_obs, carry, noise):
        env = self.env
        st = self._buffers(obs, priv_obs)
        for t in range(st.obs.shape[0]):
            po = obs if priv_obs is None else priv_obs
            outs = self._outputs(obs, po)
            mean0 = outs[0][0]
            eps = noise[t] if noise is not None else torch.randn(
                (env.num_envs,) + mean0.shape[1:], generator=self.generator,
                device=mean0.device, dtype=mean0.dtype)
            acts, logps = [], []
            for (mean, std, _), rows in zip(outs, env.rows):
                a = sample_action(mean, std, None, eps[rows])
                acts.append(a)
                logps.append(gaussian_log_prob(mean, std, a))
            action = torch.cat(acts)
            st.obs[t].copy_(obs)
            if priv_obs is not None:
                st.priv_obs[t].copy_(priv_obs)
            env_state, out = env.step(env_state, action)
            st.action[t].copy_(action)
            st.reward[t].copy_(out.reward)
            st.done[t].copy_(out.done)
            st.time_out[t].copy_(out.extras["time_outs"])
            st.value[t].copy_(torch.cat([o[2] for o in outs]))
            st.log_prob[t].copy_(torch.cat(logps))
            st.mean[t].copy_(torch.cat([o[0] for o in outs]))
            st.std[t].copy_(torch.cat([o[1] for o in outs]))
            obs = out.obs
            priv_obs = None if priv_obs is None else out.privileged_obs
        return env_state, obs, priv_obs, carry, st, {}

    def update(self, rollout: Transition, obs, priv_obs, perms=None):
        po = obs if priv_obs is None else priv_obs
        with torch.no_grad():
            last_value = torch.cat([self.network.value(po[rows].clone())
                                    for rows in self.env.rows])
        return self.ppo.update(rollout, last_value, perms)
