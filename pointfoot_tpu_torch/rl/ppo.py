"""PPO with GAE, timeout bootstrapping and the adaptive-KL learning rate
(pointfoot_tpu/rl/ppo.py).

rsl_rl's PPO as the JAX package configures it: the clipped surrogate and
the clipped value loss, an entropy bonus, 5 epochs x 4 minibatches over the
flattened (T*B) rollout, GAE with gamma 0.99 and lambda 0.95, and the
adaptive learning rate that targets a KL of desired_kl (lr / 1.5 above
twice the target, x 1.5 below half of it, within [min_lr, max_lr]).  On a
time-out the reward is raised by gamma * V(s), so truncation is not
treated as death.

One optimizer step, in the JAX package's order (`_sgd_step`): every
non-finite gradient entry is zeroed (an inf would otherwise become NaN in
the clip and live in the Adam moments for good), the gradients are clipped
by optax's `clip_by_global_norm` formula, Adam steps at the learning rate
this minibatch started with, `log_std` is clamped to the noise rails, and
the adaptive rule sets the next minibatch's learning rate.  The learning
rate is kept in float32, as JAX keeps it, so both packages take the same
sequence of rates from the same KLs.  `RecurrentPPO` shares the loss, the
optimizer step and the SGD loop, and cuts its minibatches from the env axis
(BPTT over each env's whole window).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pointfoot_tpu_torch.envs.config import AlgorithmCfg
from pointfoot_tpu_torch.rl.networks import (ActorCritic, gaussian_entropy,
                                             gaussian_log_prob, map_carry)


class Transition(NamedTuple):
    """One rollout step per row, (T, B, ...) for a rollout."""

    obs: torch.Tensor
    priv_obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    time_out: torch.Tensor
    value: torch.Tensor
    log_prob: torch.Tensor
    mean: torch.Tensor
    std: torch.Tensor


def compute_gae(rewards, dones, time_outs, values, last_value, gamma: float,
                lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(advantages, returns) of a (T, B) rollout, rsl_rl's timeout
    bootstrapping included."""
    rewards = rewards + gamma * values * time_outs
    dones = dones.to(rewards.dtype)
    advantages = torch.empty_like(rewards)
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in reversed(range(rewards.shape[0])):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * v_next * nonterminal - values[t]
        adv_next = delta + gamma * lam * nonterminal * adv_next
        advantages[t] = adv_next
        v_next = values[t]
    return advantages, advantages + values


def zero_non_finite_(grads: Sequence[torch.Tensor]) -> None:
    for g in grads:
        g.masked_fill_(~torch.isfinite(g), 0.0)


def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm: g unchanged while the global norm is
    below max_norm, else (g / norm) * max_norm.  Returns the norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class PPO:
    """The PPO update; owns the network's Adam optimizer, the adaptive
    learning rate, the update count and the generator of the minibatch
    permutations."""

    METRICS = ("surrogate_loss", "value_loss", "entropy", "kl", "lr_intra")

    def __init__(self, network: ActorCritic, cfg: AlgorithmCfg):
        self.network = network
        self.cfg = cfg
        self.params = list(network.parameters())
        self.device = self.params[0].device
        self.generator = torch.Generator(device=self.device)
        self.log_std_range = (math.log(cfg.min_noise_std),
                              math.log(cfg.max_noise_std))
        self.reset()
        # per-minibatch metrics of the last update, (epochs * minibatches,)
        self.minibatch_metrics: Dict[str, torch.Tensor] = {}

    def reset(self) -> None:
        """Fresh Adam moments, the initial learning rate, no updates."""
        self.optimizer = torch.optim.Adam(self.params,
                                          lr=self.cfg.learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.learning_rate = np.float32(self.cfg.learning_rate)
        self.update_count = 0

    # ----------------------------------------------------------------- loss

    def _loss_from_outputs(self, mean, std, value, batch: Transition,
                           advantages, returns):
        cfg = self.cfg
        log_prob = gaussian_log_prob(mean, std, batch.action)
        ratio = torch.exp(log_prob - batch.log_prob)

        # jnp.std: ddof 0
        norm_adv = (advantages - advantages.mean()) / (
            advantages.std(correction=0) + 1e-8)
        surr1 = ratio * norm_adv
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param,
                            1.0 + cfg.clip_param) * norm_adv
        surrogate_loss = -torch.mean(torch.minimum(surr1, surr2))

        if cfg.use_clipped_value_loss:
            value_clipped = batch.value + torch.clamp(
                value - batch.value, -cfg.clip_param, cfg.clip_param)
            v_loss = torch.maximum((value - returns) ** 2,
                                   (value_clipped - returns) ** 2)
        else:
            v_loss = (value - returns) ** 2
        value_loss = torch.mean(v_loss)

        entropy = torch.mean(gaussian_entropy(std))
        loss = (surrogate_loss + cfg.value_loss_coef * value_loss
                - cfg.entropy_coef * entropy)

        # KL(old || new) for the adaptive rule (rsl_rl's formula), a metric
        with torch.no_grad():
            kl_per_sample = torch.sum(
                torch.log(std / batch.std + 1e-5)
                + (batch.std ** 2 + (batch.mean - mean) ** 2)
                / (2.0 * std ** 2)
                - 0.5, dim=-1)
            if cfg.kl_winsor > 0.0:
                kl_per_sample = torch.clamp_max(kl_per_sample, cfg.kl_winsor)
            kl = torch.mean(kl_per_sample)
        metrics = dict(surrogate_loss=surrogate_loss.detach(),
                       value_loss=value_loss.detach(),
                       entropy=entropy.detach(), kl=kl)
        return loss, metrics

    def loss_and_grad(self, batch: Transition, advantages, returns):
        """The minibatch loss and its metrics; leaves the gradients in the
        parameters' `.grad`."""
        net = self.network
        self.optimizer.zero_grad(set_to_none=False)
        mean, std = net.distribution(batch.obs)
        value = net.value(batch.priv_obs)
        loss, metrics = self._loss_from_outputs(mean, std, value, batch,
                                                advantages, returns)
        loss.backward()
        return loss.detach(), metrics

    # ----------------------------------------------------------------- step

    def _sgd_step(self, kl: float) -> None:
        cfg = self.cfg
        grads = [p.grad for p in self.params]
        zero_non_finite_(grads)
        clip_by_global_norm_(grads, cfg.max_grad_norm)
        self.optimizer.param_groups[0]["lr"] = float(self.learning_rate)
        self.optimizer.step()
        with torch.no_grad():
            self.network.log_std.clamp_(*self.log_std_range)
        if cfg.schedule == "adaptive":
            f32 = np.float32
            kl, lr = f32(kl), self.learning_rate
            if kl > f32(cfg.desired_kl * 2.0):
                lr = max(lr / f32(1.5), f32(cfg.min_lr))
            elif f32(0.0) < kl < f32(cfg.desired_kl / 2.0):
                lr = min(lr * f32(1.5), f32(cfg.max_lr))
            self.learning_rate = f32(lr)
        self.update_count += 1

    def update(self, rollout: Transition, last_value: torch.Tensor,
               perms: Optional[Sequence[torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
        """GAE, then epochs x minibatches of SGD over the flattened rollout.

        Each epoch's permutation of the T*B samples is drawn from the PPO's
        generator unless `perms` gives one per epoch.  Returns the JAX
        package's metrics: the means over minibatches of the surrogate and
        value losses, the entropy, the KL and the learning rate each
        minibatch used (`lr_intra`), then the final `learning_rate`,
        `mean_advantage` and `mean_return`."""
        T, B = rollout.reward.shape
        advantages, returns = self._gae(rollout, last_value)
        n = T * B
        flat = Transition(*(x.reshape((n,) + x.shape[2:]) for x in rollout))
        adv_flat = advantages.reshape(-1)
        ret_flat = returns.reshape(-1)

        def minibatch(idx):
            return self.loss_and_grad(Transition(*(x[idx] for x in flat)),
                                      adv_flat[idx], ret_flat[idx])

        return self._epochs(n, perms, minibatch, advantages, returns)

    def _gae(self, rollout: Transition, last_value):
        return compute_gae(rollout.reward, rollout.done, rollout.time_out,
                           rollout.value, last_value, self.cfg.gamma,
                           self.cfg.lam)

    def _epochs(self, n: int, perms, minibatch, advantages, returns
                ) -> Dict[str, torch.Tensor]:
        """The SGD loop shared by both PPOs: each epoch permutes the n
        items minibatches are cut from (samples, or envs for the recurrent
        PPO) and `minibatch(idx)` leaves the gradients of one."""
        cfg = self.cfg
        mb_size = n // cfg.num_mini_batches
        history = {k: [] for k in self.METRICS}
        for epoch in range(cfg.num_learning_epochs):
            perm = (perms[epoch].to(self.device) if perms is not None else
                    torch.randperm(n, generator=self.generator,
                                   device=self.device))
            for i in range(cfg.num_mini_batches):
                _, metrics = minibatch(perm[i * mb_size:(i + 1) * mb_size])
                metrics["lr_intra"] = torch.tensor(
                    self.learning_rate, device=self.device)
                self._sgd_step(float(metrics["kl"]))
                for k in self.METRICS:
                    history[k].append(metrics[k])
        self.minibatch_metrics = {k: torch.stack(v)
                                  for k, v in history.items()}
        out = {k: v.mean() for k, v in self.minibatch_metrics.items()}
        out["learning_rate"] = torch.tensor(self.learning_rate,
                                            device=self.device)
        out["mean_advantage"] = advantages.mean()
        out["mean_return"] = returns.mean()
        return out

    # ---------------------------------------------------------------- state

    def state_dict(self) -> dict:
        """Parameters, Adam moments by parameter name (zeros before the
        first step) and step count, learning rate and update count."""
        adam, step = {}, 0
        for name, p in self.network.named_parameters():
            st = self.optimizer.state.get(p, {})
            if st:
                step = int(st["step"])
            adam[name] = {
                "exp_avg": st.get("exp_avg", torch.zeros_like(p)).detach(),
                "exp_avg_sq": st.get("exp_avg_sq",
                                     torch.zeros_like(p)).detach()}
        return {"params": self.network.state_dict(), "adam": adam,
                "adam_step": step,
                "learning_rate": float(self.learning_rate),
                "update_count": int(self.update_count)}

    def load_state_dict(self, state: dict) -> None:
        """Restore what `state_dict` gives (or utils/convert's
        train_state_from_numpy), onto this PPO's device."""
        self.network.load_state_dict(state["params"])
        self.reset()
        step = int(state["adam_step"])
        if step > 0:
            for name, p in self.network.named_parameters():
                m = state["adam"][name]
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(step), dtype=torch.float32),
                    "exp_avg": m["exp_avg"].to(p.device, p.dtype).clone(),
                    "exp_avg_sq": m["exp_avg_sq"].to(p.device,
                                                     p.dtype).clone()}
        self.learning_rate = np.float32(state["learning_rate"])
        self.update_count = int(state["update_count"])


class RecurrentPPO(PPO):
    """PPO for ActorCriticRecurrent (pointfoot_tpu/rl/ppo.py RecurrentPPO).

    Minibatches split the env axis and keep each env's T-step window whole
    in (T, mb) layout.  The loss replays the LSTM over the window from the
    carry the rollout started with, zeroing an env's carry before step t
    where it was done at t - 1, and backpropagates through the whole
    window; the advantages are normalised over the (T, mb) window."""

    def sequence_outputs(self, carry0, batch: Transition):
        """(mean, std, value), each (T, mb, ...), of the network replayed
        over `batch` from `carry0`, an env's carry zeroed before step t
        where it was done at t - 1."""
        done_prev = torch.cat([torch.zeros_like(batch.done[:1]),
                               batch.done[:-1]]).to(batch.obs.dtype)
        return self.network.replay(carry0, batch.obs, batch.priv_obs,
                                   done_prev)

    def loss_and_grad(self, carry0, batch: Transition, advantages, returns):
        """The window loss of a minibatch of envs and its metrics; leaves
        the gradients in the parameters' `.grad`."""
        self.optimizer.zero_grad(set_to_none=False)
        mean, std, value = self.sequence_outputs(carry0, batch)
        loss, metrics = self._loss_from_outputs(mean, std, value, batch,
                                                advantages, returns)
        loss.backward()
        return loss.detach(), metrics

    def update(self, rollout: Transition, last_value: torch.Tensor,
               perms: Optional[Sequence[torch.Tensor]] = None,
               carry0=None) -> Dict[str, torch.Tensor]:
        """GAE, then epochs x env-axis minibatches with BPTT over the
        window, from `carry0`, the carry the rollout started with.  `perms`
        gives one permutation of the B envs per epoch; the metrics are
        PPO.update's."""
        if carry0 is None:
            raise ValueError("RecurrentPPO.update needs the rollout's carry0")
        B = rollout.reward.shape[1]
        advantages, returns = self._gae(rollout, last_value)

        def minibatch(idx):
            return self.loss_and_grad(
                map_carry(lambda c: c[idx], carry0),
                Transition(*(x[:, idx] for x in rollout)),
                advantages[:, idx], returns[:, idx])

        return self._epochs(B, perms, minibatch, advantages, returns)
