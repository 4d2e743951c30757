"""The sys-ID network zoo (pointfoot_tpu/models/nets.py), as nn.Modules.

* MLPGenerator      - 4 x (Linear 256 + LeakyReLU 0.2), Linear + tanh, then
                      a sigmoid mapped into `output_range`
* MLPDiscriminator  - an LSTM as wide as its input over time, mean over
                      time (or over the batch), 4 x (Linear 128 + LeakyReLU),
                      Linear + sigmoid
* MLPCritic         - the WGAN-GP critic: LSTM and mean over time for a
                      (B, T, D) window, 2 x (Linear + LeakyReLU), Linear
* LSTMIdentifier    - LSTM 512, its last step through 256 -> 128 -> 10
* AttentionModel    - two forward LSTMs, the second on the time-flipped
                      input, additive attention, an MLP head
* TransformerGenerator / TransformerDiscriminator - pre-norm encoder
                      blocks (LayerNorm eps 1e-6, 4-head attention, GELU
                      with the tanh approximation) on a sin/cos position
                      code, read at the last step

Inputs are batch-first.  The LSTMs are rl/networks.LSTMCell, flax's
OptimizedLSTMCell layout, unrolled over time in python: cuDNN's RNN has no
double backward, which the WGAN's gradient penalty takes through the
critic's LSTM, and `nn.LSTM`'s two biases round differently.  Torch needs
each layer's input width at construction, where flax reads it from the
first call, so every net takes `in_dim`.  `reset_parameters(generator)`
draws the parameters as flax's initialisers do (LeCun-normal kernels with
zero biases, orthogonal recurrent kernels, unit LayerNorm scales) from a
CPU `torch.Generator`, so a seed gives the same network on every device;
the constructors draw from the given generator, or torch's default one.
utils/convert.py carries flax parameters over.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from pointfoot_tpu_torch.rl.networks import LSTMCell, _lecun_normal_

Range = Sequence[Tuple[float, float]]


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def _range_map(x: torch.Tensor, output_range: Range) -> torch.Tensor:
    lo = torch.tensor([r[0] for r in output_range], dtype=x.dtype,
                      device=x.device)
    hi = torch.tensor([r[1] for r in output_range], dtype=x.dtype,
                      device=x.device)
    return torch.sigmoid(x) * (hi - lo) + lo


class _Net(nn.Module):
    """flax's initialisers for every Linear, LSTMCell and LayerNorm."""

    def _init(self, generator: Optional[torch.Generator]) -> None:
        self.reset_parameters(generator if generator is not None
                              else torch.default_generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, generator)
                m.bias.zero_()
            elif isinstance(m, LSTMCell):
                m.reset_parameters(generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


class ScanLSTM(nn.Module):
    """A batch-first LSTM unrolled over time: (B, T, D) -> (B, T, H) and
    the last (c, h), from a zero carry."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.cell = LSTMCell(in_dim, hidden)

    def forward(self, x: torch.Tensor):
        B, T = x.shape[:2]
        zeros = x.new_zeros(B, self.cell.hidden)
        carry = (zeros, zeros)
        ys = []
        for t in range(T):
            carry, y = self.cell(carry, x[:, t])
            ys.append(y)
        return torch.stack(ys, dim=1), carry


class MLPGenerator(_Net):
    """Noise (..., in_dim) -> physical parameters inside `output_range`."""

    def __init__(self, in_dim: int, out_dim: int, output_range: Range,
                 hidden: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.output_range = tuple(tuple(r) for r in output_range)
        dims = [in_dim] + [hidden] * 4
        self.hidden = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims, dims[1:]))
        self.out = nn.Linear(hidden, out_dim)
        self._init(generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z
        for lin in self.hidden:
            x = leaky(lin(x))
        return _range_map(torch.tanh(self.out(x)), self.output_range)


class MLPDiscriminator(_Net):
    """Windows (B, T, D) -> a probability per window (B, out_dim); with
    `pool_time=False` the mean runs over the batch of windows instead, as
    the reference did."""

    def __init__(self, in_dim: int, hidden: int = 128, out_dim: int = 27,
                 pool_time: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pool_time = pool_time
        self.lstm = ScanLSTM(in_dim, in_dim)
        dims = [in_dim] + [hidden] * 4
        self.hidden = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims, dims[1:]))
        self.out = nn.Linear(hidden, out_dim)
        self._init(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys, _ = self.lstm(x)
        h = ys.mean(dim=1) if self.pool_time else ys.mean(dim=0)
        for lin in self.hidden:
            h = leaky(lin(h))
        return torch.sigmoid(self.out(h))


class MLPCritic(_Net):
    """The WGAN critic: a window (B, T, D), or features (B, D), -> an
    unbounded score (B, 1)."""

    def __init__(self, in_dim: int, hidden: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lstm = ScanLSTM(in_dim, in_dim)
        self.hidden = nn.ModuleList([nn.Linear(in_dim, hidden),
                                     nn.Linear(hidden, hidden)])
        self.out = nn.Linear(hidden, 1)
        self._init(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            ys, _ = self.lstm(x)
            x = ys.mean(dim=1)
        h = x
        for lin in self.hidden:
            h = leaky(lin(h))
        return self.out(h)


class LSTMIdentifier(_Net):
    """Windows (B, T, D) -> (friction^6, mass, com^3) regressed from the
    LSTM's last step."""

    def __init__(self, in_dim: int, hidden: int = 512, out_dim: int = 10,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lstm = ScanLSTM(in_dim, hidden)
        self.hidden = nn.ModuleList([nn.Linear(hidden, hidden // 2),
                                     nn.Linear(hidden // 2, hidden // 4)])
        self.out = nn.Linear(hidden // 4, out_dim)
        self._init(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys, _ = self.lstm(x)
        h = ys[:, -1]
        for lin in self.hidden:
            h = leaky(lin(h))
        return self.out(h)


class AttentionModel(_Net):
    """Two forward LSTMs (the second reads the time-flipped window, its
    outputs flipped back), additive attention over time, an MLP head."""

    def __init__(self, in_dim: int, hidden: int = 256, out_dim: int = 10,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fwd = ScanLSTM(in_dim, hidden)
        self.bwd = ScanLSTM(in_dim, hidden)
        self.score = nn.Linear(hidden, 1)
        self.attn = nn.Linear(2 * hidden, hidden)
        self.hidden = nn.Linear(2 * hidden, hidden)
        self.out = nn.Linear(hidden, out_dim)
        self._init(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fwd, _ = self.fwd(x)
        bwd, _ = self.bwd(torch.flip(x, dims=(1,)))
        ys = torch.cat([fwd, torch.flip(bwd, dims=(1,))], dim=-1)
        scores = self.score(torch.tanh(self.attn(ys)))  # (B, T, 1)
        ctx = torch.sum(torch.softmax(scores, dim=1) * ys, dim=1)
        return self.out(leaky(self.hidden(ctx)))


class MultiHeadAttention(nn.Module):
    """flax's MultiHeadDotProductAttention as self-attention: query, key
    and value projections to (heads, head_dim), the query scaled by
    1/sqrt(head_dim), softmax over keys, the output projection back."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        d = D // self.heads

        def split(t):
            return t.reshape(B, T, self.heads, d)

        q = split(self.query(x)) / math.sqrt(d)
        k, v = split(self.key(x)), split(self.value(x))
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        y = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(y.reshape(B, T, D))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiHeadAttention(dim, heads)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        y = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(y)


def posenc(T: int, D: int, device=None) -> torch.Tensor:
    """(T, D): sin of every angle, then cos of every angle (concatenated,
    not interleaved), angle pos / 10000^(2i / D)."""
    pos = torch.arange(T, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(D // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2.0 * i / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class TransformerGenerator(_Net):
    """A noise sequence (B, T, in_dim) -> bounded parameters (B, out_dim),
    read at the last step."""

    def __init__(self, in_dim: int, out_dim: int, output_range: Range,
                 dim: int = 64, layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.output_range = tuple(tuple(r) for r in output_range)
        self.embed = nn.Linear(in_dim, dim)
        self.blocks = nn.ModuleList(EncoderBlock(dim) for _ in range(layers))
        self.out = nn.Linear(dim, out_dim)
        self._init(generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.embed(z) + posenc(z.shape[1], self.embed.out_features,
                                   z.device)
        for block in self.blocks:
            x = block(x)
        return _range_map(torch.tanh(self.out(x[:, -1])), self.output_range)


class TransformerDiscriminator(_Net):
    """Windows (B, T, in_dim) -> a probability (B, 1), read at the last
    step."""

    def __init__(self, in_dim: int, dim: int = 64, layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed = nn.Linear(in_dim, dim)
        self.blocks = nn.ModuleList(EncoderBlock(dim) for _ in range(layers))
        self.out = nn.Linear(dim, 1)
        self._init(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.embed(x) + posenc(x.shape[1], self.embed.out_features,
                                   x.device)
        for block in self.blocks:
            h = block(h)
        return torch.sigmoid(self.out(h[:, -1]))
