"""Work counted from shapes, frozen here so that the program cannot change
what its utilisation is measured against, and the chip's published peaks.

- `network_flops_per_iteration`: the floating-point operations of the
  policy and value networks in one PPO iteration, from the configuration's
  widths: matrix products only (2 per multiply-add), at float32.  The
  rollout runs the actor and the critic forward on every env step, the
  bootstrap one more forward of the critic (of the whole network for the
  recurrent policy) per env; the update runs, per epoch, every sample
  forward and backward.  A backward pass counts the weight gradient of
  every layer and the input gradient of every layer but the first (the
  observations need none).  Physics and terrain are left out.
- `substep_bytes`: the bytes one decimation substep of B envs needs
  (`rollout_substep_kernel`'s work): each input row read once, each output
  row written once, float32.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

# Published peaks of one card (NVIDIA's data sheet, SXM, dense, at its 700 W
# limit), keyed by the exact name torch.cuda.get_device_name gives.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def _mlp(n_in: int, hidden: Sequence[int], n_out: int) -> Tuple[int, int]:
    """(multiply-adds of the layers, of the first layer)."""
    dims = [n_in, *hidden, n_out]
    macs = [a * b for a, b in zip(dims[:-1], dims[1:])]
    return sum(macs), macs[0]


def network_macs(config: dict) -> Dict[str, int]:
    """Multiply-adds of one forward pass of one sample: the actor and the
    critic (cells and heads), and what the backward pass skips (the first
    layers' input gradients)."""
    env, pol = config["env"]["env"], config["train"]["policy"]
    n_obs, n_act = env["num_observations"], env["num_actions"]
    n_priv = env["num_privileged_obs"] or n_obs
    recurrent = (config["train"]["runner"]["policy_class_name"]
                 == "ActorCriticRecurrent")
    if recurrent:
        H = pol["rnn_hidden_size"]
        a_cell, c_cell = 4 * H * (n_obs + H), 4 * H * (n_priv + H)
        a_head, _ = _mlp(H, pol["actor_hidden_dims"], n_act)
        c_head, _ = _mlp(H, pol["critic_hidden_dims"], 1)
        # the cells' input kernels take the observations: no input
        # gradient for them; the hidden kernels' input gradient is needed
        return {"actor": a_cell + a_head, "critic": c_cell + c_head,
                "no_input_grad": 4 * H * (n_obs + n_priv)}
    a, a0 = _mlp(n_obs, pol["actor_hidden_dims"], n_act)
    c, c0 = _mlp(n_priv, pol["critic_hidden_dims"], 1)
    return {"actor": a, "critic": c, "no_input_grad": a0 + c0}


def network_flops_per_iteration(config: dict, envs: int) -> float:
    """Network FLOPs of one iteration of `envs` envs (all ranks)."""
    m = network_macs(config)
    alg = config["train"]["algorithm"]
    T = config["train"]["runner"]["num_steps_per_env"]
    fwd = m["actor"] + m["critic"]
    recurrent = (config["train"]["runner"]["policy_class_name"]
                 == "ActorCriticRecurrent")
    rollout = T * envs * fwd
    bootstrap = envs * (fwd if recurrent else m["critic"])
    backward = 2 * fwd - m["no_input_grad"]
    update = alg["num_learning_epochs"] * T * envs * (fwd + backward)
    return 2.0 * (rollout + bootstrap + update)


def substep_rows(nj: int, nc: int) -> Dict[str, int]:
    """float32 rows of `rollout_substep_kernel` per env: state in and out
    (pose, velocities, joints, the last joint velocities), the control rows
    (actions, gains, frictions, mass, CoM, contact constants, push), the
    surface rows (height and normal under each sphere), and the extra rows
    out (torque, contact forces, sphere positions)."""
    state = 3 + 4 + 3 + 3 + 3 * nj
    ctrl = 3 * nj + nc + nj + 1 + 3 + 1 + 1 + 3
    return {"state_in": state, "ctrl": ctrl, "surface": 4 * nc,
            "state_out": state, "extra": nj + 6 * nc}


def substep_bytes(nj: int, nc: int, envs: int, surface: bool = True
                  ) -> int:
    r = substep_rows(nj, nc)
    rows = sum(r.values()) - (0 if surface else r["surface"])
    return 4 * rows * envs
