"""Export a trained policy for the robot (scripts/export_policy_as_onnx.py
of the JAX package).

    python -m pointfoot_tpu_torch.export_policy --task pointfoot_flat \
        --load_run logs/pointfoot_flat/<run>/model_1500.pt
    python -m pointfoot_tpu_torch.export_policy --task pointfoot_flat \
        --load_run pointfoot_tpu_torch/_weights/pointfoot_flat_model_82000_actor.npz \
        --out /tmp/policy.onnx --device cpu

A feed-forward actor becomes an ONNX file (default `policy.onnx` beside the
checkpoint), a recurrent one (a checkpoint of `runner.policy_class_name`
"ActorCriticRecurrent") the stateful LSTM TorchScript module (default
`policy_lstm.pt`).  `--load_run` takes the port's `model_<it>.pt` or an
actor npz of flax-named arrays (the committed `_weights/*.npz`); without
it, the newest checkpoint of the newest run under logs/<experiment_name>.
The weights load on the GPU unless --device names another; the file
written does not depend on the device.
"""

from __future__ import annotations

import argparse
import os

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.export import onnx
from pointfoot_tpu_torch.utils.helpers import get_load_path
from pointfoot_tpu_torch.utils.policy_eval import load_policy_state
from pointfoot_tpu_torch.utils.registry import get_cfgs


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="pointfoot_flat")
    ap.add_argument("--load_run", default=None,
                    help="model_<it>.pt or actor npz (default: the newest "
                         "checkpoint under logs/<experiment_name>)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    env_cfg, train_cfg = get_cfgs(args.task)
    path = args.load_run or get_load_path(
        os.path.join("logs", train_cfg.runner.experiment_name))
    sd = load_policy_state(path, device)
    obs_dim = env_cfg.env.num_observations
    activation = train_cfg.policy.activation
    if "actor_rnn.weight_i" in sd:
        out = args.out or os.path.join(os.path.dirname(path),
                                       "policy_lstm.pt")
        onnx.export_policy_lstm(sd, obs_dim, out, activation)
    else:
        out = args.out or os.path.join(os.path.dirname(path), "policy.onnx")
        onnx.export_policy_as_onnx(sd, obs_dim, out, activation)
    print(f"exported to {out}")
    return out


if __name__ == "__main__":
    main()
