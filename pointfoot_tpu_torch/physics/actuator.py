"""Actuator network: the ANYdrive v3 LSTM in the loop
(pointfoot_tpu/physics/actuator.py).

A 2-layer LSTM (2 -> 8 -> 8) and a Linear(8 -> 1) map each joint's
(position error, velocity) to a torque; hidden and cell state are kept per
env and joint and zeroed on reset.  The weights are the package's copy of
the baked JSON.  Plain PyTorch: the JAX package has no kernel for it.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

_ASSET = os.path.join(os.path.dirname(__file__), "_assets",
                      "actuator_anydrive_v3_lstm.json")

HIDDEN = 8
LAYERS = 2


class ActuatorWeights(NamedTuple):
    w_ih: Tuple[torch.Tensor, ...]  # per layer (4H, in)
    w_hh: Tuple[torch.Tensor, ...]  # per layer (4H, H)
    b: Tuple[torch.Tensor, ...]  # per layer (4H,) = b_ih + b_hh
    w_out: torch.Tensor  # (1, H)
    b_out: torch.Tensor  # (1,)
    in_scale: torch.Tensor  # (2,) input normalization
    out_scale: torch.Tensor  # () torque denormalization

    def to(self, device) -> "ActuatorWeights":
        def move(v):
            return (tuple(t.to(device) for t in v) if isinstance(v, tuple)
                    else v.to(device))

        return ActuatorWeights(*(move(v) for v in self))


def load_anydrive_weights(device="cpu") -> ActuatorWeights:
    """The baked ANYdrive weights, float32, on `device`."""
    with open(_ASSET) as f:
        w = {k: np.asarray(v, np.float32) for k, v in json.load(f).items()}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    return ActuatorWeights(
        w_ih=tuple(t(w[f"lstm.weight_ih_l{i}"]) for i in range(LAYERS)),
        w_hh=tuple(t(w[f"lstm.weight_hh_l{i}"]) for i in range(LAYERS)),
        b=tuple(t(w[f"lstm.bias_ih_l{i}"] + w[f"lstm.bias_hh_l{i}"])
                for i in range(LAYERS)),
        w_out=t(w["linear.weight"]),
        b_out=t(w["linear.bias"]),
        in_scale=t(w["in_scale"]).reshape(2),
        out_scale=t(w["out_scale"]).reshape(()),
    ).to(device)


def init_carry(batch_shape: Tuple[int, ...], device="cpu") -> torch.Tensor:
    """(..., LAYERS, 2, HIDDEN) zeros: h and c per layer."""
    return torch.zeros(batch_shape + (LAYERS, 2, HIDDEN), device=device)


def _lstm_cell(w_ih, w_hh, b, x, h, c):
    """Torch gate order i, f, g, o."""
    gates = x @ w_ih.T + h @ w_hh.T + b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def actuator_net_torque(weights: ActuatorWeights, carry: torch.Tensor,
                        pos_err: torch.Tensor, vel: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM tick: (pos_err, vel) (..., nj) -> (torque (..., nj), new
    carry (..., nj, LAYERS, 2, HIDDEN))."""
    x = torch.stack([pos_err, vel], dim=-1) * weights.in_scale
    layers = []
    for layer in range(LAYERS):
        h, c = _lstm_cell(weights.w_ih[layer], weights.w_hh[layer],
                          weights.b[layer], x, carry[..., layer, 0, :],
                          carry[..., layer, 1, :])
        layers.append(torch.stack([h, c], dim=-2))
        x = h
    torque = (x @ weights.w_out.T + weights.b_out)[..., 0] * weights.out_scale
    return torque, torch.stack(layers, dim=-3)
