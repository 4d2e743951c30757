"""The ANYdrive v3 actuator network of the plain route: a frozen copy of the
port's physics/actuator.py, with its weights read from
`assets/actuator_anydrive_v3_lstm.json` (the port's
physics/_assets/actuator_anydrive_v3_lstm.json as this benchmark was
written).

A 2-layer LSTM (2 -> 8 -> 8) and a Linear(8 -> 1) map each joint's
(position error, velocity), scaled by `in_scale`, to a torque scaled by
`out_scale`; hidden and cell state are kept per env and joint and zeroed on
reset, as legged_gym's `anymal.py` keeps them for its TorchScript
`anydrive_v3_lstm.pt`.  Gate order i, f, g, o, as torch's LSTM; the two
biases of a layer are summed once, in float32, when the weights load.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

_ASSET = os.path.join(os.path.dirname(__file__), "assets",
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


def load_anydrive_weights(device) -> ActuatorWeights:
    """The baked ANYdrive weights, float32, on `device`."""
    with open(_ASSET) as f:
        w = {k: np.asarray(v, np.float32) for k, v in json.load(f).items()}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    return ActuatorWeights(
        w_ih=tuple(t(w[f"lstm.weight_ih_l{i}"]) for i in range(LAYERS)),
        w_hh=tuple(t(w[f"lstm.weight_hh_l{i}"]) for i in range(LAYERS)),
        b=tuple(t(w[f"lstm.bias_ih_l{i}"] + w[f"lstm.bias_hh_l{i}"])
                for i in range(LAYERS)),
        w_out=t(w["linear.weight"]),
        b_out=t(w["linear.bias"]),
        in_scale=t(w["in_scale"]).reshape(2),
        out_scale=t(w["out_scale"]).reshape(()),
    )


def init_carry(batch_shape: Tuple[int, ...], device) -> torch.Tensor:
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
