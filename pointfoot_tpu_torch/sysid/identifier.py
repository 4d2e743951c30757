"""Supervised LSTM system identifier (pointfoot_tpu/sysid/identifier.py).

Candidate (friction^6, mass, com^3) vectors are drawn uniformly in the
GAN's ranges, one per env, simulated as one batch, and regressed from the
observation windows by an LSTMIdentifier with an MSE; rollouts that fell
are masked out of the loss.  The simulation takes no gradient and runs
under `torch.no_grad()`, so a batch of MEGA_MIN_BATCH (4096) envs or more
takes the fused rollout kernel.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pointfoot_tpu_torch.models.nets import LSTMIdentifier
from pointfoot_tpu_torch.sysid.gan import PARAM_RANGE, apply_grads, grads_of
from pointfoot_tpu_torch.sysid.simulate import simulate_trajectory


class IdentifierTrainer:
    """Trains an LSTMIdentifier on simulated (trajectory -> parameters)
    pairs; the env holds one env per candidate (num_envs = batch)."""

    def __init__(self, env, policy_fn: Callable, window: int = 400,
                 warmup: int = 100, lr: float = 1e-3, hidden: int = 512):
        self.env = env
        self.policy_fn = policy_fn
        self.window = window
        self.warmup = warmup
        self.lr = lr
        self.net = LSTMIdentifier(env.num_obs, hidden, 10).to(env.device)
        self.lo = torch.tensor([r[0] for r in PARAM_RANGE], device=env.device)
        self.hi = torch.tensor([r[1] for r in PARAM_RANGE], device=env.device)
        self.init()

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw the net from `generator` (CPU; default: torch's) and start a
        fresh Adam."""
        self.net.reset_parameters(generator if generator is not None
                                  else torch.default_generator)
        self.opt = torch.optim.Adam(self.net.parameters(), self.lr)

    def sample_params(self, generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """(num_envs, 10) candidates, uniform in the ranges."""
        u = torch.rand(self.env.num_envs, 10, generator=generator)
        return self.lo + u.to(self.lo.device) * (self.hi - self.lo)

    def simulate(self, env_state, cmd, target: torch.Tensor):
        """(windows (B, window, num_obs), valid (B,)) of every env's rollout
        with its own row of `target` pinned, without a gradient."""
        with torch.no_grad():
            traj, _ = simulate_trajectory(
                self.env, env_state, self.policy_fn, target[:, :6],
                target[:, 6], target[:, 7:10], cmd, length=self.window,
                warmup=self.warmup)
        return traj.obs.transpose(0, 1), ~traj.fell

    def train_step(self, env_state, cmd,
                   generator: Optional[torch.Generator] = None,
                   target: Optional[torch.Tensor] = None) -> dict:
        """One Adam step on freshly simulated candidates (`target`, default
        drawn from `generator`).  Returns the masked MSE and the count of
        rollouts that did not fall."""
        if target is None:
            target = self.sample_params(generator)
        windows, valid = self.simulate(env_state, cmd, target)
        per = torch.mean((self.net(windows) - target) ** 2, dim=-1)
        n_valid = torch.clamp_min(valid.sum(), 1)
        loss = torch.sum(torch.where(valid, per, 0.0)) / n_valid
        params = list(self.net.parameters())
        apply_grads(self.opt, params, grads_of(loss, params))
        return {"mse": loss.detach(), "num_valid": valid.sum()}

    def predict(self, windows: torch.Tensor) -> torch.Tensor:
        """Parameters inferred from observation windows (B, T, num_obs)."""
        with torch.no_grad():
            return self.net(windows)
