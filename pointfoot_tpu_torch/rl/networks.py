"""Actor-critic networks and the Gaussian policy's helpers
(pointfoot_tpu/rl/networks.py: ActorCritic, ActorCriticRecurrent,
sample_action, gaussian_log_prob, gaussian_entropy).

Separate actor and critic MLPs, a state-independent learned log-std, and an
asymmetric critic that reads the privileged observations.  Layer names
follow `nn.Sequential` indexing; utils/convert.py maps the flax parameters
onto them.  `reset_parameters` draws them as flax's defaults do (LeCun
normal kernels, zero biases; orthogonal recurrent kernels).  The Gaussian
helpers keep the JAX formulas and their order of operations.

The recurrent variant puts one LSTM cell in front of each MLP head.  The
cell is flax's `OptimizedLSTMCell`, not `nn.LSTMCell`: flax gives the input
kernels no bias and the hidden kernels one, and keeps kernels as (in, out).
`LSTMCell` here keeps flax's layout, the four gate kernels (i, f, g, o) of
each group side by side in one (in, 4H) matrix, so a flax tree converts by
concatenation.
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


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax's lecun_normal into `w`, drawn on the CPU `generator` (so a seed
    gives the same network on every device)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    cpu = torch.empty(w.shape)
    nn.init.trunc_normal_(cpu, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    w.copy_(cpu)


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
        _reset_mlps(self, generator)
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


def _reset_mlps(module: nn.Module, generator: torch.Generator) -> None:
    for m in module.modules():
        if isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, generator)
            m.bias.zero_()


Carry = Tuple[torch.Tensor, torch.Tensor]  # (c, h), each (B, H)


class LSTMCell(nn.Module):
    """flax's OptimizedLSTMCell: gates i, f, g, o =
    act(h @ W_h + b_h + x @ W_i) with sigmoid for i, f, o and tanh for g;
    c' = f c + i g and h' = o tanh(c')."""

    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_i = nn.Parameter(torch.zeros(n_in, 4 * hidden))
        self.weight_h = nn.Parameter(torch.zeros(hidden, 4 * hidden))
        self.bias_h = nn.Parameter(torch.zeros(4 * hidden))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Each gate's input kernel from lecun_normal, its hidden kernel
        orthogonal (flax's defaults), zero biases."""
        H = self.hidden
        for k in range(4):
            _lecun_normal_(self.weight_i[:, k * H:(k + 1) * H],
                           self.weight_i.shape[0], generator)
            q = torch.empty(H, H)
            nn.init.orthogonal_(q, generator=generator)
            self.weight_h[:, k * H:(k + 1) * H] = q
        self.bias_h.zero_()

    def forward(self, carry: Carry, x: torch.Tensor
                ) -> Tuple[Carry, torch.Tensor]:
        c, h = carry
        z = (h @ self.weight_h + self.bias_h) + x @ self.weight_i
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class ActorCriticRecurrent(nn.Module):
    """One LSTM cell on the observations feeding the actor's MLP head, one
    on the privileged observations feeding the critic's.  The carry is
    (actor (c, h), critic (c, h))."""

    def __init__(self, num_obs: int, num_critic_obs: int, num_actions: int,
                 rnn_hidden: int = 256,
                 actor_hidden: Sequence[int] = (256, 128),
                 critic_hidden: Sequence[int] = (256, 128),
                 activation: str = "elu", init_noise_std: float = 1.0):
        super().__init__()
        self.rnn_hidden = rnn_hidden
        self.actor_rnn = LSTMCell(num_obs, rnn_hidden)
        self.critic_rnn = LSTMCell(num_critic_obs, rnn_hidden)
        self.actor_head = mlp(rnn_hidden, actor_hidden, num_actions,
                              activation)
        self.critic_head = mlp(rnn_hidden, critic_hidden, 1, activation)
        self.init_noise_std = init_noise_std
        self.log_std = nn.Parameter(
            torch.full((num_actions,), math.log(init_noise_std)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers, drawn on the CPU `generator`."""
        self.actor_rnn.reset_parameters(generator)
        self.critic_rnn.reset_parameters(generator)
        _reset_mlps(self, generator)
        self.log_std.fill_(math.log(self.init_noise_std))

    def initialize_carry(self, batch: int) -> Tuple[Carry, Carry]:
        z = self.log_std.new_zeros(batch, self.rnn_hidden)
        return (z, z), (z, z)

    def forward(self, carry: Tuple[Carry, Carry], obs: torch.Tensor,
                priv_obs: torch.Tensor):
        """(carry, (action mean, std, value))."""
        a_carry, a_feat = self.actor_rnn(carry[0], obs)
        c_carry, c_feat = self.critic_rnn(carry[1], priv_obs)
        mean = self.actor_head(a_feat)
        value = self.critic_head(c_feat).squeeze(-1)
        std = torch.exp(self.log_std).expand_as(mean)
        return (a_carry, c_carry), (mean, std, value)

    def replay(self, carry: Tuple[Carry, Carry], obs: torch.Tensor,
               priv_obs: torch.Tensor, reset: torch.Tensor):
        """(action mean, std, value), each (T, B, ...), of `forward` stepped
        over a (T, B, ...) window from `carry`, each env's carry zeroed
        before step t where `reset[t]` (B,) is 1.  Only the cells step
        through time; the heads run once over the window's features, with
        half the operations of `forward` step by step."""
        a_carry, c_carry = carry
        a_feats, c_feats = [], []
        for t in range(obs.shape[0]):
            keep = (1.0 - reset[t])[:, None]
            a_carry, h = self.actor_rnn(map_carry(lambda c: c * keep, a_carry),
                                        obs[t])
            a_feats.append(h)
            c_carry, h = self.critic_rnn(
                map_carry(lambda c: c * keep, c_carry), priv_obs[t])
            c_feats.append(h)
        mean = self.actor_head(torch.stack(a_feats))
        value = self.critic_head(torch.stack(c_feats)).squeeze(-1)
        return mean, torch.exp(self.log_std).expand_as(mean), value


def map_carry(fn, carry):
    """`fn` applied to every tensor of a nested tuple carry."""
    if isinstance(carry, torch.Tensor):
        return fn(carry)
    return tuple(map_carry(fn, c) for c in carry)


def carry_leaves(carry) -> list:
    """The tensors of a nested tuple carry, in order."""
    if isinstance(carry, torch.Tensor):
        return [carry]
    return [t for c in carry for t in carry_leaves(c)]


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
