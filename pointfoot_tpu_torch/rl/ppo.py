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

With a data-parallel mesh (parallel/mesh.py) each rank holds its envs' part
of the rollout, and the update computes what one process computes on the
global rollout, as the JAX package's update under pjit does: every rank
draws the same permutation of the global samples (or envs) from the
PPO's generator, and a minibatch's loss is the sum over the entries the
rank holds divided by the global minibatch size.  The advantage
normalization, the losses and the KL that drives the adaptive rate are
reduced across ranks, and the gradients are summed across ranks before
they are zeroed where not finite and clipped, so every rank takes the same
step and branch and ends with the same parameters, Adam moments and rate.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pointfoot_tpu_torch.envs.config import AlgorithmCfg
from pointfoot_tpu_torch.parallel.mesh import (Mesh, all_reduce_mean_,
                                               all_reduce_sum_)
from pointfoot_tpu_torch.rl.networks import (ActorCritic, gaussian_entropy,
                                             gaussian_log_prob, map_carry)
from pointfoot_tpu_torch.utils import profiling


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

    def __init__(self, network: ActorCritic, cfg: AlgorithmCfg,
                 mesh: Optional[Mesh] = None):
        self.network = network
        self.cfg = cfg
        self.mesh = mesh  # data parallelism over its ranks when given
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
                           advantages, returns, count: Optional[int] = None):
        """The minibatch loss and its metrics.  With a mesh, `count` is the
        global minibatch's number of entries: the loss is this rank's share
        of the global loss (its gradients sum across ranks to the global
        gradient), the metrics are the global ones."""
        cfg = self.cfg
        mesh = self.mesh
        log_prob = gaussian_log_prob(mean, std, batch.action)
        ratio = torch.exp(log_prob - batch.log_prob)

        # jnp.std: ddof 0
        if mesh is None:
            avg = torch.mean
            norm_adv = (advantages - advantages.mean()) / (
                advantages.std(correction=0) + 1e-8)
        else:
            def avg(x):
                return x.sum() / count

            # two passes over the global minibatch, as jnp.std
            mu = advantages.sum()
            all_reduce_sum_([mu], mesh)
            mu = mu / count
            dev2 = ((advantages - mu) ** 2).sum()
            all_reduce_sum_([dev2], mesh)
            norm_adv = (advantages - mu) / (torch.sqrt(dev2 / count) + 1e-8)
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

        # KL(old || new) for the adaptive rule (rsl_rl's formula), a metric
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
        all_reduce_sum_(list(metrics.values()), mesh)
        return loss, metrics

    def loss_and_grad(self, batch: Transition, advantages, returns,
                      count: Optional[int] = None):
        """The minibatch loss and its metrics; leaves the gradients in the
        parameters' `.grad` (with a mesh, this rank's share: `_sgd_step`
        sums them across ranks).  `count`: the global minibatch size, with
        a mesh."""
        net = self.network
        self.optimizer.zero_grad(set_to_none=False)
        mean, std = net.distribution(batch.obs)
        value = net.value(batch.priv_obs)
        loss, metrics = self._loss_from_outputs(mean, std, value, batch,
                                                advantages, returns, count)
        loss.backward()
        return loss.detach(), metrics

    # ----------------------------------------------------------------- step

    def _sgd_step(self, kl: float) -> None:
        cfg = self.cfg
        grads = [p.grad for p in self.params]
        all_reduce_sum_(grads, self.mesh)
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
        `mean_advantage` and `mean_return`.

        With a mesh the rollout holds this rank's b envs, the permutations
        run over the T * B samples of the global batch (B = b * world
        size; sample t * B + e of global env e), and each minibatch takes
        the samples of this rank's envs."""
        T, b = rollout.reward.shape
        advantages, returns = self._gae(rollout, last_value)
        flat = Transition(*(x.reshape((T * b,) + x.shape[2:])
                            for x in rollout))
        adv_flat = advantages.reshape(-1)
        ret_flat = returns.reshape(-1)
        lo, B = self._rows(b)

        def minibatch(idx):
            count = None
            if self.mesh is not None:
                count = idx.numel()
                e = idx % B
                own = (e >= lo) & (e < lo + b)
                idx = (idx // B)[own] * b + e[own] - lo
            return self.loss_and_grad(Transition(*(x[idx] for x in flat)),
                                      adv_flat[idx], ret_flat[idx], count)

        return self._epochs(T * B, perms, minibatch, advantages, returns)

    def _rows(self, b: int) -> Tuple[int, int]:
        """(the first global env of this rank's b envs, the global env
        count)."""
        if self.mesh is None:
            return 0, b
        return self.mesh.rank * b, self.mesh.world_size * b

    @profiling.span("ppo.gae")
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
                with profiling.span("ppo.minibatch"):
                    _, metrics = minibatch(
                        perm[i * mb_size:(i + 1) * mb_size])
                    metrics["lr_intra"] = torch.tensor(
                        self.learning_rate, device=self.device)
                    # the adaptive rule needs the KL on the host: the
                    # host waits here for the card, once a minibatch
                    with profiling.span("host.wait"):
                        kl = float(metrics["kl"])
                    self._sgd_step(kl)
                    for k in self.METRICS:
                        history[k].append(metrics[k])
        self.minibatch_metrics = {k: torch.stack(v)
                                  for k, v in history.items()}
        out = {k: v.mean() for k, v in self.minibatch_metrics.items()}
        out["learning_rate"] = torch.tensor(self.learning_rate,
                                            device=self.device)
        out["mean_advantage"] = advantages.mean()
        out["mean_return"] = returns.mean()
        # every rank holds as many samples: the mean of the ranks' means
        all_reduce_mean_([out["mean_advantage"], out["mean_return"]],
                         self.mesh)
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

    def loss_and_grad(self, carry0, batch: Transition, advantages, returns,
                      count: Optional[int] = None):
        """The window loss of a minibatch of envs and its metrics; leaves
        the gradients in the parameters' `.grad`.  `count`: the global
        minibatch's T * envs, with a mesh."""
        self.optimizer.zero_grad(set_to_none=False)
        mean, std, value = self.sequence_outputs(carry0, batch)
        loss, metrics = self._loss_from_outputs(mean, std, value, batch,
                                                advantages, returns, count)
        loss.backward()
        return loss.detach(), metrics

    def update(self, rollout: Transition, last_value: torch.Tensor,
               perms: Optional[Sequence[torch.Tensor]] = None,
               carry0=None) -> Dict[str, torch.Tensor]:
        """GAE, then epochs x env-axis minibatches with BPTT over the
        window, from `carry0`, the carry the rollout started with.  `perms`
        gives one permutation of the B envs per epoch; the metrics are
        PPO.update's.  With a mesh the permutations run over the global
        envs, and each minibatch takes the envs this rank holds."""
        if carry0 is None:
            raise ValueError("RecurrentPPO.update needs the rollout's carry0")
        T, b = rollout.reward.shape
        advantages, returns = self._gae(rollout, last_value)
        lo, B = self._rows(b)

        def minibatch(idx):
            count = None
            if self.mesh is not None:
                count = T * idx.numel()
                idx = idx[(idx >= lo) & (idx < lo + b)] - lo
            return self.loss_and_grad(
                map_carry(lambda c: c[idx], carry0),
                Transition(*(x[:, idx] for x in rollout)),
                advantages[:, idx], returns[:, idx], count)

        return self._epochs(B, perms, minibatch, advantages, returns)
