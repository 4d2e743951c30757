"""Adversarial sys-ID training (scripts/gan.py of the JAX package).

    python -m pointfoot_tpu_torch.gan --real data/rr1.npy \
        --policy logs/pointfoot_flat/tpu_run7/exported/policy.pt [--wgan]
    python -m pointfoot_tpu_torch.gan --real /tmp/rr1.npy --device cpu \
        --epochs 1 --sim_length 24 --min_bucket 10 --log_dir /tmp/gan_run

Loads real-robot observations (npy of dicts, sysid/realdata.py), buckets
them by command, and for every bucket with more than `--min_bucket` rows
runs one adversarial step an epoch on pointfoot_flat at one env: the
generators propose (friction, mass, CoM), the simulator rolls
100 warm-up steps and `--sim_length` more with the exported `--policy` (a
TorchScript actor, through export.onnx.load_policy_as_torch; without one
the actions are zero), and the discriminator (`--wgan`: the WGAN-GP
critic) scores simulated against real windows of the first 3 x
`--sim_length` rows.  One JSON line of losses an update goes to
`<log_dir>/metrics.jsonl`.  Runs on the GPU unless --device names another.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.sysid import (GANTrainer, WGANTrainer,
                                       categorize_data_by_cmd, chunk_windows,
                                       real_to_tensor)
from pointfoot_tpu_torch.utils.registry import make_env


def zero_policy(obs: torch.Tensor) -> torch.Tensor:
    return torch.zeros(obs.shape[:-1] + (6,), device=obs.device)


def load_policy(path, device):
    """`path`'s exported actor as a function of tensors, or zero actions."""
    if path is None:
        return zero_policy
    from pointfoot_tpu_torch.export.onnx import load_policy_as_torch

    return load_policy_as_torch(path, device=device)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--real", required=True, help="npy of dicts with 'obs'")
    p.add_argument("--policy", default=None,
                   help="exported TorchScript actor; default zero actions")
    p.add_argument("--wgan", action="store_true", help="use WGAN-GP")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--sim_length", type=int, default=400)
    p.add_argument("--min_bucket", type=int, default=1100)
    p.add_argument("--log_dir", default="logs/gan_training")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    real = real_to_tensor(args.real)
    buckets = categorize_data_by_cmd(real)
    print(f"{len(buckets)} command buckets; sizes "
          f"{[v.shape[0] for v in buckets.values()]}", flush=True)
    used = {cmd: data for cmd, data in buckets.items()
            if data.shape[0] > args.min_bucket}
    if not used:
        raise SystemExit(f"no command bucket has more than --min_bucket "
                         f"{args.min_bucket} rows")

    env = make_env("pointfoot_flat", num_envs=1, device=dev)
    cls = WGANTrainer if args.wgan else GANTrainer
    trainer = cls(env, load_policy(args.policy, dev),
                  sim_length=args.sim_length)
    gen = torch.Generator().manual_seed(0)
    trainer.init(gen)
    env_state = env.init_state(1)

    os.makedirs(args.log_dir, exist_ok=True)
    metrics_path = os.path.join(args.log_dir, "metrics.jsonl")
    for epoch in range(args.epochs):
        for cmd, data in used.items():
            # a bucket (N, 1, 27) is a (T, B = 1, 27) trajectory
            traj = torch.from_numpy(data[: trainer.sim_length * 3]).to(dev)
            wins = chunk_windows(traj, chunk=trainer.chunk,
                                 overlap=trainer.overlap)
            m = trainer.train_step(env_state, wins,
                                   torch.tensor(cmd, device=dev),
                                   generator=gen)
            line = {k: float(v) for k, v in m.items()}
            line["epoch"] = epoch
            with open(metrics_path, "a") as f:
                f.write(json.dumps(line) + "\n")
        if epoch % 10 == 0:
            print(f"epoch {epoch}: {line}", flush=True)
    print("done;", metrics_path, flush=True)
    return metrics_path


if __name__ == "__main__":
    main()
