"""Adversarial sys-ID (pointfoot_tpu/sysid/gan.py): three parameter
generators against a trajectory discriminator, with gradients through the
simulator.

MLP generators propose per-joint friction (6-d, [0, 0.2] each), added base
mass (1-d, [-1, 2]) and CoM offset (3-d, +-(0.03, 0.02, 0.03)); the LSTM
discriminator scores windows of simulated against real 27-d observations
with BCE.  The generator loss backpropagates through `simulate_trajectory`
into the generators (`through_sim_gradients=True`), so the env must take
the plain physics route (fewer than MEGA_MIN_BATCH envs: the GAN simulates
one).  Each generator and the discriminator has its own Adam.  After a
step each parameter's `.grad` holds the gradient of its last update: a
generator's is zero if the simulator's path was cut.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from pointfoot_tpu_torch.models.nets import MLPDiscriminator, MLPGenerator
from pointfoot_tpu_torch.sysid.simulate import (SimTrajectory, chunk_windows,
                                                simulate_trajectory)

FRIC_RANGE = tuple((0.0, 0.2) for _ in range(6))
MASS_RANGE = ((-1.0, 2.0),)
COM_RANGE = ((-0.03, 0.03), (-0.02, 0.02), (-0.03, 0.03))
PARAM_RANGE = FRIC_RANGE + MASS_RANGE + COM_RANGE  # 10-d


def _bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    eps = 1e-7
    pred = torch.clamp(pred, eps, 1 - eps)
    return -torch.mean(target * torch.log(pred)
                       + (1 - target) * torch.log(1 - pred))


def grads_of(loss: torch.Tensor, params: Sequence[torch.Tensor]):
    """d(loss)/d(params), zero for a parameter the loss does not reach (as
    jax.grad gives)."""
    return torch.autograd.grad(loss, list(params), allow_unused=True,
                               materialize_grads=True)


def apply_grads(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor]) -> None:
    """One optimizer step of `params` along `grads`, which stay on each
    parameter's `.grad` until the next step."""
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


class GANTrainer:
    def __init__(self, env, policy_fn: Callable, sim_length: int = 400,
                 warmup: int = 100, lr: float = 1e-3,
                 through_sim_gradients: bool = True,
                 chunk: int = 400, overlap: int = 100):
        self.env = env
        self.policy_fn = policy_fn
        self.sim_length = sim_length
        self.warmup = warmup
        self.lr = lr
        self.chunk = min(chunk, sim_length)
        self.overlap = min(overlap, self.chunk // 2)
        self.through_sim = through_sim_gradients
        dev = env.device
        self.gen_fric = MLPGenerator(6, 6, FRIC_RANGE).to(dev)
        self.gen_mass = MLPGenerator(1, 1, MASS_RANGE).to(dev)
        self.gen_com = MLPGenerator(3, 3, COM_RANGE).to(dev)
        self.disc = MLPDiscriminator(env.num_obs, out_dim=1).to(dev)
        self.init()

    @property
    def generators(self):
        return (self.gen_fric, self.gen_mass, self.gen_com)

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every net from `generator` (CPU; default: torch's) and start
        fresh optimizers."""
        g = generator if generator is not None else torch.default_generator
        for net in self.generators + (self.disc,):
            net.reset_parameters(g)
        self.opt_gen = [torch.optim.Adam(net.parameters(), self.lr)
                        for net in self.generators]
        self.opt_disc = torch.optim.Adam(self.disc.parameters(), self.lr)

    def noise(self, generator: Optional[torch.Generator] = None):
        """Independent standard-normal inputs of the three generators."""
        return tuple(torch.randn(n, generator=generator).to(self.env.device)
                     for n in (6, 1, 3))

    def propose(self, generator: Optional[torch.Generator] = None,
                noise=None):
        """(friction (6,), mass (1,), com (3,)) from fresh noise."""
        z = self.noise(generator) if noise is None else noise
        with torch.no_grad():
            return tuple(g(zi) for g, zi in zip(self.generators, z))

    def _simulate(self, env_state, fric, mass, com, cmd) -> SimTrajectory:
        """The rollout of every env with the proposal pinned."""
        fric_full = fric.expand(self.env.num_envs, self.env.model.nj)
        traj, _ = simulate_trajectory(
            self.env, env_state, self.policy_fn, fric_full, mass[0], com,
            cmd, length=self.sim_length, warmup=self.warmup)
        return traj

    def train_step(self, env_state, real_windows: torch.Tensor, cmd,
                   generator: Optional[torch.Generator] = None,
                   noise=None) -> dict:
        """One adversarial update.  real_windows: (N, chunk, num_obs) real
        windows of this command; `noise` (default: drawn from `generator`)
        is the generators' input.  Returns the losses."""
        z = self.noise(generator) if noise is None else noise
        fric, mass, com = (g(zi) for g, zi in zip(self.generators, z))
        if not self.through_sim:
            fric, mass, com = fric.detach(), mass.detach(), com.detach()
        traj = self._simulate(env_state, fric, mass, com, cmd)
        sim_w = chunk_windows(traj.obs, chunk=self.chunk, overlap=self.overlap)
        score = self.disc(sim_w)
        # the generators want the discriminator to say "real" (1)
        g_loss = _bce(score, torch.ones_like(score))
        # one backward pass through the simulator for all three
        params = [list(g.parameters()) for g in self.generators]
        grads = iter(grads_of(g_loss, sum(params, [])))
        grads = [[next(grads) for _ in p] for p in params]
        for opt, p, g in zip(self.opt_gen, params, grads):
            apply_grads(opt, p, g)

        sim_w = sim_w.detach()
        s_real = self.disc(real_windows)
        s_sim = self.disc(sim_w)
        d_loss = (_bce(s_real, torch.ones_like(s_real))
                  + _bce(s_sim, torch.zeros_like(s_sim)))
        params = list(self.disc.parameters())
        apply_grads(self.opt_disc, params, grads_of(d_loss, params))
        return {"gen_loss": g_loss.detach(), "disc_loss": d_loss.detach()}
