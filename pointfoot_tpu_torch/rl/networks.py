"""Actor-critic networks and the Gaussian policy's helpers
(pointfoot_tpu/rl/networks.py: ActorCritic, sample_action,
gaussian_log_prob, gaussian_entropy).

Separate actor and critic MLPs, a state-independent learned log-std, and an
asymmetric critic that reads the privileged observations.  Layer names
follow `nn.Sequential` indexing; utils/convert.py maps the flax parameters
onto them.  `reset_parameters` draws them as flax's defaults do (LeCun
normal kernels, zero biases).  The Gaussian helpers keep the JAX formulas
and their order of operations.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

_ACT = {"elu": nn.ELU}  # the rough policies' activation
# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled to unit variance by the truncated normal's standard deviation
_TRUNC_STD = 0.87962566103423978
_LOG_2PI = math.log(2.0 * math.pi)


def mlp(n_in: int, hidden: Sequence[int], n_out: int,
        activation: str = "elu") -> nn.Sequential:
    layers = []
    for h in hidden:
        layers += [nn.Linear(n_in, h), _ACT[activation]()]
        n_in = h
    layers.append(nn.Linear(n_in, n_out))
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    """Gaussian policy and value function with asymmetric observations."""

    def __init__(self, num_obs: int, num_critic_obs: int, num_actions: int,
                 actor_hidden: Sequence[int] = (512, 256, 128),
                 critic_hidden: Sequence[int] = (512, 256, 128),
                 activation: str = "elu", init_noise_std: float = 1.0):
        super().__init__()
        self.actor = mlp(num_obs, actor_hidden, num_actions, activation)
        self.critic = mlp(num_critic_obs, critic_hidden, 1, activation)
        self.init_noise_std = init_noise_std
        self.log_std = nn.Parameter(
            torch.full((num_actions,), math.log(init_noise_std)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every kernel from flax's lecun_normal on the CPU `generator`
        (so a seed gives the same network on every device), zero every
        bias, and set log_std to log(init_noise_std)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                m.weight.copy_(w)
                m.bias.zero_()
        self.log_std.fill_(math.log(self.init_noise_std))

    def forward(self, obs: torch.Tensor, priv_obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(action mean, std, value)."""
        return self.act_mean(obs), torch.exp(self.log_std), \
            self.value(priv_obs)

    def act_mean(self, obs: torch.Tensor) -> torch.Tensor:
        return self.actor(obs)

    def value(self, priv_obs: torch.Tensor) -> torch.Tensor:
        return self.critic(priv_obs).squeeze(-1)

    def distribution(self, obs: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        mean = self.actor(obs)
        return mean, torch.exp(self.log_std).expand_as(mean)


def sample_action(mean: torch.Tensor, std: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean + std * noise, with standard normal `noise` drawn from
    `generator` unless given."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
    return mean + std * noise


def gaussian_log_prob(mean: torch.Tensor, std: torch.Tensor,
                      action: torch.Tensor) -> torch.Tensor:
    var = std ** 2
    return torch.sum(
        -0.5 * ((action - mean) ** 2 / var + torch.log(2 * math.pi * var)),
        dim=-1)


def gaussian_entropy(std: torch.Tensor) -> torch.Tensor:
    return torch.sum(0.5 * (1.0 + _LOG_2PI) + torch.log(std), dim=-1)
