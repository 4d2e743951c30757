"""Actor-critic networks (pointfoot_tpu/rl/networks.py ActorCritic).

Separate actor and critic MLPs, a state-independent learned log-std, and an
asymmetric critic that reads the privileged observations.  Layer names
follow `nn.Sequential` indexing; utils/convert.py maps the flax parameters
onto them.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

_ACT = {"elu": nn.ELU}  # the rough policies' activation


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
        self.log_std = nn.Parameter(
            torch.full((num_actions,), math.log(init_noise_std)))

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
