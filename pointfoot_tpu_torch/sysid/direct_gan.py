"""Direct-trajectory GAN (pointfoot_tpu/sysid/direct_gan.py): a generator
maps noise straight to observation windows, with no simulator, and the
LSTM discriminator separates them from real windows; a learned trajectory
prior."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pointfoot_tpu_torch.models.nets import MLPDiscriminator, _Net, leaky
from pointfoot_tpu_torch.sysid.gan import _bce, apply_grads, grads_of


class _SeqGenerator(_Net):
    """Noise (B, z_dim) -> an observation window (B, window, obs_dim)."""

    def __init__(self, z_dim: int, window: int, obs_dim: int = 27,
                 hidden: Sequence[int] = (256, 512, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.window, self.obs_dim = window, obs_dim
        dims = [z_dim] + list(hidden)
        self.hidden = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims, dims[1:]))
        self.out = nn.Linear(dims[-1], window * obs_dim)
        self._init(generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z
        for lin in self.hidden:
            h = leaky(lin(h))
        return self.out(h).reshape(z.shape[0], self.window, self.obs_dim)


class DirectTrajectoryGAN:
    def __init__(self, window: int = 100, obs_dim: int = 27,
                 z_dim: int = 64, lr: float = 1e-3, device="cpu"):
        self.window = window
        self.obs_dim = obs_dim
        self.z_dim = z_dim
        self.lr = lr
        self.device = torch.device(device)
        self.gen = _SeqGenerator(z_dim, window, obs_dim).to(self.device)
        self.disc = MLPDiscriminator(obs_dim, out_dim=1).to(self.device)
        self.init()

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw both nets from `generator` (CPU; default: torch's) and start
        fresh optimizers."""
        g = generator if generator is not None else torch.default_generator
        self.gen.reset_parameters(g)
        self.disc.reset_parameters(g)
        self.opt_gen = torch.optim.Adam(self.gen.parameters(), self.lr)
        self.opt_disc = torch.optim.Adam(self.disc.parameters(), self.lr)

    def sample(self, batch: int = 1,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        z = torch.randn(batch, self.z_dim, generator=generator)
        with torch.no_grad():
            return self.gen(z.to(self.device))

    def train_step(self, real_windows: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   z: Optional[torch.Tensor] = None) -> dict:
        """One update of the generator, then the discriminator; `z`
        (len(real_windows), z_dim) defaults to a draw from `generator`."""
        if z is None:
            z = torch.randn(real_windows.shape[0], self.z_dim,
                            generator=generator).to(self.device)
        fake = self.gen(z)
        score = self.disc(fake)
        g_loss = _bce(score, torch.ones_like(score))
        params = list(self.gen.parameters())
        apply_grads(self.opt_gen, params, grads_of(g_loss, params))

        s_real = self.disc(real_windows)
        s_fake = self.disc(fake.detach())
        d_loss = (_bce(s_real, torch.ones_like(s_real))
                  + _bce(s_fake, torch.zeros_like(s_fake)))
        params = list(self.disc.parameters())
        apply_grads(self.opt_disc, params, grads_of(d_loss, params))
        return {"gen_loss": g_loss.detach(), "disc_loss": d_loss.detach()}
