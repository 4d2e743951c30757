"""Export the trained actor for the robot (pointfoot_tpu/export/onnx.py).

- `export_policy_as_onnx`: the feed-forward actor as ONNX opset 13 (Gemm and
  activation nodes on the 27-d observations), written by the port's own
  pure-Python writer (export/onnx_writer.py): `torch.onnx` needs the `onnx`
  package, which is not installed.
- `export_policy_torchscript`: the feed-forward actor traced to TorchScript.
- `export_policy_lstm`: the recurrent actor as a stateful TorchScript
  module, `PolicyExporterLSTM`: the actor cell as an `nn.LSTM` whose
  (hidden, cell) state lives in buffers and advances one step a call,
  `reset_memory()` to zero it, and the actor head.
- `load_onnx_policy`: a numpy policy from a `.onnx` file (through the
  reader) or a TorchScript `.pt`.
- `load_policy_as_torch`: an exported TorchScript actor rebuilt as a
  function of tensors, for the sys-ID rollouts (JAX's load_policy_as_jax).

Each exporter takes the port's ActorCritic / ActorCriticRecurrent or its
state dict, on any device: the file does not depend on the device.
"""

from __future__ import annotations

from typing import Callable, List, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.export.onnx_writer import (read_mlp_onnx,
                                                   write_mlp_onnx)

Policy = Union[nn.Module, Mapping[str, torch.Tensor]]
_ACTS = {"elu": nn.ELU, "relu": nn.ReLU, "tanh": nn.Tanh, "selu": nn.SELU}


def _arrays(policy: Policy) -> dict:
    sd = policy.state_dict() if isinstance(policy, nn.Module) else policy
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in sd.items()}


def actor_layers(policy: Policy, head: str = "actor"
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """[(W (in, out), b), ...] of the MLP `head` ("actor", or "actor_head"
    of the recurrent network)."""
    sd = _arrays(policy)
    layers, i = [], 0
    while f"{head}.{i}.weight" in sd:
        layers.append((np.ascontiguousarray(sd[f"{head}.{i}.weight"].T),
                       sd[f"{head}.{i}.bias"]))
        i += 2
    if not layers:
        raise KeyError(f"no layers '{head}.<i>.weight' in the policy")
    return layers


def _torch_mlp(layers, activation: str) -> nn.Sequential:
    mods: list = []
    for i, (w, b) in enumerate(layers):
        lin = nn.Linear(w.shape[0], w.shape[1])
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
            lin.bias.copy_(torch.from_numpy(np.ascontiguousarray(b)))
        mods.append(lin)
        if i < len(layers) - 1:
            mods.append(_ACTS[activation]())
    return nn.Sequential(*mods).eval()


def export_policy_as_onnx(policy: Policy, obs_dim: int, path: str,
                          activation: str = "elu", opset: int = 13) -> str:
    """The feed-forward actor as an ONNX file at `path`."""
    layers = actor_layers(policy)
    if layers[0][0].shape[0] != obs_dim:
        raise ValueError(
            f"actor expects {layers[0][0].shape[0]}-d obs, got {obs_dim}")
    return write_mlp_onnx(layers, path, activation=activation, opset=opset)


def export_policy_torchscript(policy: Policy, obs_dim: int, path: str,
                              activation: str = "elu") -> str:
    """The feed-forward actor traced to TorchScript at `path`."""
    model = _torch_mlp(actor_layers(policy), activation)
    torch.jit.trace(model, torch.zeros(1, obs_dim)).save(path)
    return path


class PolicyExporterLSTM(nn.Module):
    """The recurrent actor for deployment: one step a call on a batch of
    one, the LSTM state kept in buffers."""

    def __init__(self, memory: nn.LSTM, head: nn.Sequential):
        super().__init__()
        self.memory = memory
        self.head = head
        hidden = memory.hidden_size
        self.register_buffer("hidden_state", torch.zeros(1, 1, hidden))
        self.register_buffer("cell_state", torch.zeros(1, 1, hidden))

    def forward(self, x):
        out, (h, c) = self.memory(
            x.unsqueeze(0), (self.hidden_state, self.cell_state))
        self.hidden_state[:] = h
        self.cell_state[:] = c
        return self.head(out.squeeze(0))

    @torch.jit.export
    def reset_memory(self):
        self.hidden_state[:] = 0.0
        self.cell_state[:] = 0.0


def export_policy_lstm(policy: Policy, obs_dim: int, path: str,
                       activation: str = "elu") -> str:
    """The recurrent actor as a scripted `PolicyExporterLSTM` at `path`.
    nn.LSTM orders its gates i, f, g, o as the port's cell does and keeps
    (out, in) weights: the cell's packed kernels go over transposed, its
    hidden bias as `bias_hh` and a zero `bias_ih`."""
    sd = _arrays(policy)
    w_i, w_h = sd["actor_rnn.weight_i"], sd["actor_rnn.weight_h"]
    if w_i.shape[0] != obs_dim:
        raise ValueError(f"actor cell expects {w_i.shape[0]}-d obs, got "
                         f"{obs_dim}")
    lstm = nn.LSTM(obs_dim, w_h.shape[0], num_layers=1)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.from_numpy(np.ascontiguousarray(w_i.T)))
        lstm.weight_hh_l0.copy_(torch.from_numpy(np.ascontiguousarray(w_h.T)))
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.copy_(torch.from_numpy(sd["actor_rnn.bias_h"]))
    head = _torch_mlp(actor_layers(sd, "actor_head"), activation)
    torch.jit.script(PolicyExporterLSTM(lstm, head).eval()).save(path)
    return path


_NP_ACTS = {"elu": lambda x: np.where(x > 0, x, np.expm1(x)),
            "relu": lambda x: np.maximum(x, 0.0),
            "selu": lambda x: 1.0507010 * np.where(
                x > 0, x, 1.6732632 * np.expm1(x)),
            "tanh": np.tanh, "linear": lambda x: x}


def load_onnx_policy(path: str) -> Callable[[np.ndarray], np.ndarray]:
    """A policy obs (numpy) -> actions (numpy): a `.onnx` file decoded by
    the reader into a numpy forward pass, anything else loaded as
    TorchScript."""
    if path.endswith(".onnx"):
        layers, activation, _, _, _ = read_mlp_onnx(path)
        act = _NP_ACTS[activation]

        def policy(obs_np: np.ndarray) -> np.ndarray:
            x = obs_np.astype(np.float32)
            for i, (W, b) in enumerate(layers):
                x = x @ W + b
                if i < len(layers) - 1:
                    x = act(x)
            return x

        return policy
    mod = torch.jit.load(path)

    def policy(obs_np: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return mod(torch.from_numpy(obs_np.astype(np.float32))).numpy()

    return policy


def load_policy_as_torch(path: str, activation: str = "elu", device=None
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """An exported TorchScript actor as a plain function of tensors on
    `device` (default: the GPU, see device.resolve_device), so autograd
    runs through it inside the sys-ID simulation.  The MLP is rebuilt from
    the module's `named_parameters()` ('<i>.weight' / '<i>.bias' in order),
    with `activation` between the layers."""
    dev = resolve_device(device)
    mod = torch.jit.load(path, map_location="cpu")
    layers = []
    for name, p in mod.named_parameters():
        if name.endswith("weight"):
            layers.append([p.detach().to(dev), None])
        else:
            layers[-1][1] = p.detach().to(dev)
    act = {"elu": F.elu, "relu": F.relu, "tanh": torch.tanh}[activation]

    def policy(obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for i, (W, b) in enumerate(layers):
            x = x @ W.T + b
            if i < len(layers) - 1:
                x = act(x)
        return x

    return policy
