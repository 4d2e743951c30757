"""One PPO training iteration of the plain route: a frozen copy of the
port's rl/runner.py (`OnPolicyRunner`'s init, rollout, update and their
recurrent forms), one process, without logging, checkpoints or the bench
lock.  The runner owns the network, the PPO update and the generator of
the action noise; the env state is passed in and out."""

from __future__ import annotations

import torch

from benchmark.reference.config import TrainCfg
from benchmark.reference.legged_env import EnvState
from benchmark.reference.networks import (ActorCritic, ActorCriticRecurrent,
                                          carry_leaves, gaussian_log_prob,
                                          map_carry, sample_action)
from benchmark.reference.ppo import PPO, RecurrentPPO, Transition

INFO_KEYS = ("episode_rew", "num_resets", "terrain_level", "max_command_x",
             "num_nan_quarantined")


class Runner:
    def __init__(self, env, train_cfg: TrainCfg):
        self.env = env
        self.cfg = train_cfg
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
        self.ppo = ppo_cls(self.network, train_cfg.algorithm)
        self.generator = torch.Generator(device=self.device)
        self.storage = None
        self.carry0 = None  # the recurrent window's starting carry

    def init(self, seed: int, random_episode_step: bool = False
             ) -> EnvState:
        """Fresh network (drawn on the CPU, the same on every device), Adam
        state and learning rate; seeded generators; a fresh env state."""
        self.network.reset_parameters(torch.Generator().manual_seed(seed))
        self.ppo.reset()
        self.generator.manual_seed(seed + 1)
        self.ppo.generator.manual_seed(seed + 2)
        return self.env.init_state(seed, random_episode_step)

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
        Returns (env state, obs, priv_obs, metrics)."""
        env_state, obs, priv_obs, rollout, infos = self.rollout(
            env_state, obs, priv_obs, noise)
        metrics = self.update(rollout, obs, priv_obs, perms)
        return env_state, obs, priv_obs, metrics

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
        env_state, obs, priv_obs, carry, rollout, infos = \
            self.rollout_recurrent(env_state, obs, priv_obs, carry, noise)
        metrics = self.update_recurrent(rollout, obs, priv_obs, carry, perms)
        return env_state, obs, priv_obs, carry, metrics

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
