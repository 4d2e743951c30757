"""Identifier evaluation (scripts/inference.py of the JAX package).

    python -m pointfoot_tpu_torch.inference \
        --ckpt 'logs/identifier/identifier_*.pt' [--batch 32]
    python -m pointfoot_tpu_torch.inference --ckpt '/tmp/ident/*.pt' \
        --device cpu --batch 2 --window 8

Simulates `--batch` pointfoot_flat envs with parameters drawn uniformly in
their ranges (seed 42, zero actions, command 0.5 m/s), each env with its
own per-joint friction, mass and CoM as the identifier trains, and prints
the parameter-regression MSE of every checkpoint the glob `--ckpt`
matches.  (The JAX script broadcasts the mean friction to one value per
collision sphere, a shape `update_frictions` cannot take.)  Runs on the
GPU unless --device names another.
"""

from __future__ import annotations

import argparse
import glob
import os

import torch

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.gan import zero_policy
from pointfoot_tpu_torch.identifier import CMD
from pointfoot_tpu_torch.sysid import IdentifierTrainer
from pointfoot_tpu_torch.utils.registry import make_env


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", required=True,
                   help="checkpoint file or glob (identifier_*.pt)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--window", type=int, default=400)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    paths = sorted(glob.glob(args.ckpt))
    if not paths:
        raise SystemExit(f"no checkpoint matches {args.ckpt}")

    env = make_env("pointfoot_flat", num_envs=args.batch, device=dev)
    trainer = IdentifierTrainer(env, zero_policy, window=args.window)
    target = trainer.sample_params(torch.Generator().manual_seed(42))
    windows, _ = trainer.simulate(env.init_state(0),
                                  torch.tensor(CMD, device=dev), target)
    out = {}
    for path in paths:
        trainer.net.load_state_dict(torch.load(path, map_location=dev))
        mse = float(torch.mean((trainer.predict(windows) - target) ** 2))
        out[path] = mse
        print(f"{os.path.basename(path)}: mse {mse:.6f}", flush=True)
    return out


if __name__ == "__main__":
    main()
