"""WGAN-GP sys-ID (pointfoot_tpu/sysid/wgan.py): one 10-d generator of
(friction^6, mass, com^3) against a Lipschitz critic, Wasserstein loss with
a gradient penalty of weight 10 on interpolates, Adam with betas (0.5, 0.9)
for both.  The penalty differentiates the critic's gradient, a double
backward through its LSTM (models/nets.ScanLSTM, which supports one).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pointfoot_tpu_torch.models.nets import MLPCritic, MLPGenerator
from pointfoot_tpu_torch.sysid.gan import PARAM_RANGE, apply_grads, grads_of
from pointfoot_tpu_torch.sysid.simulate import (chunk_windows,
                                                simulate_trajectory)


def gradient_penalty(critic, real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
    """mean((|d critic / d x| - 1)^2) at x = eps real + (1 - eps) fake,
    per window; eps (len(real), 1, 1) is cut to the shorter batch.  The
    critic treats each window on its own, so the gradient of the summed
    scores is every window's own gradient."""
    n = min(real.shape[0], fake.shape[0])
    inter = eps[:n] * real[:n] + (1 - eps[:n]) * fake[:n]
    if not inter.requires_grad:
        inter.requires_grad_(True)
    grads, = torch.autograd.grad(critic(inter).sum(), inter,
                                 create_graph=True)
    gnorm = torch.sqrt(torch.sum(grads ** 2, dim=(1, 2)) + 1e-12)
    return torch.mean((gnorm - 1.0) ** 2)


class WGANTrainer:
    def __init__(self, env, policy_fn: Callable, sim_length: int = 400,
                 warmup: int = 100, lr: float = 1e-4, gp_lambda: float = 10.0,
                 chunk: int = 400, overlap: int = 100):
        self.env = env
        self.policy_fn = policy_fn
        self.sim_length = sim_length
        self.warmup = warmup
        self.lr = lr
        self.chunk = min(chunk, sim_length)
        self.overlap = min(overlap, self.chunk // 2)
        self.gp_lambda = gp_lambda
        self.gen = MLPGenerator(10, 10, PARAM_RANGE).to(env.device)
        self.critic = MLPCritic(env.num_obs).to(env.device)
        self.init()

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw both nets from `generator` (CPU; default: torch's) and start
        fresh optimizers."""
        g = generator if generator is not None else torch.default_generator
        self.gen.reset_parameters(g)
        self.critic.reset_parameters(g)
        self.opt_gen = torch.optim.Adam(self.gen.parameters(), self.lr,
                                        betas=(0.5, 0.9))
        self.opt_critic = torch.optim.Adam(self.critic.parameters(), self.lr,
                                           betas=(0.5, 0.9))

    def _simulate(self, env_state, params10, cmd) -> torch.Tensor:
        """Windows (N, chunk, num_obs) of a rollout with params10 pinned."""
        fric = params10[:6].expand(self.env.num_envs, self.env.model.nj)
        traj, _ = simulate_trajectory(
            self.env, env_state, self.policy_fn, fric, params10[6],
            params10[7:10], cmd, length=self.sim_length, warmup=self.warmup)
        return chunk_windows(traj.obs, chunk=self.chunk, overlap=self.overlap)

    def _gradient_penalty(self, real: torch.Tensor, fake: torch.Tensor,
                          eps: torch.Tensor) -> torch.Tensor:
        return gradient_penalty(self.critic, real, fake, eps)

    def train_step(self, env_state, real_windows: torch.Tensor, cmd,
                   generator: Optional[torch.Generator] = None,
                   z: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None) -> dict:
        """One update of the generator, then the critic.  `z` (10,) and the
        penalty's `eps` (len(real_windows), 1, 1) default to draws from
        `generator`.  Returns the losses."""
        dev = self.env.device
        if z is None:
            z = torch.randn(10, generator=generator).to(dev)
        if eps is None:
            eps = torch.rand(real_windows.shape[0], 1, 1,
                             generator=generator).to(dev)
        fake = self._simulate(env_state, self.gen(z), cmd)
        g_loss = -torch.mean(self.critic(fake))
        params = list(self.gen.parameters())
        apply_grads(self.opt_gen, params, grads_of(g_loss, params))

        fake = fake.detach()
        w_loss = (torch.mean(self.critic(fake))
                  - torch.mean(self.critic(real_windows)))
        c_loss = w_loss + self.gp_lambda * self._gradient_penalty(
            real_windows, fake, eps)
        params = list(self.critic.parameters())
        apply_grads(self.opt_critic, params, grads_of(c_loss, params))
        return {"gen_loss": g_loss.detach(), "critic_loss": c_loss.detach()}
