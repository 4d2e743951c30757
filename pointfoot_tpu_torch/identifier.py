"""Supervised LSTM identifier training (scripts/identifier.py of the JAX
package).

    python -m pointfoot_tpu_torch.identifier [--iters 2000] [--batch 64]
    python -m pointfoot_tpu_torch.identifier --device cpu --iters 2 \
        --batch 2 --window 8 --log_dir /tmp/ident

Each iteration draws `--batch` parameter vectors (per-joint friction,
added mass, CoM offset) uniformly in their ranges, simulates one
pointfoot_flat env for each (100 warm-up steps and `--window` more,
command 0.5 m/s, the exported `--policy` or zero actions) without a
gradient, and
takes one Adam step of the identifier on the windows; rollouts that fell
are masked out of the loss.  At 4096 envs or more the simulation runs
through the fused rollout kernel.  Writes the identifier's state dict as
`<log_dir>/identifier_<it>.pt` every `--save_every` iterations and at the
last.  Runs on the GPU unless --device names another.
"""

from __future__ import annotations

import argparse
import os

import torch

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.gan import load_policy
from pointfoot_tpu_torch.sysid import IdentifierTrainer
from pointfoot_tpu_torch.utils.registry import make_env

CMD = (0.5, 0.0, 0.0)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--window", type=int, default=400)
    p.add_argument("--save_every", type=int, default=100)
    p.add_argument("--log_dir", default="logs/identifier")
    p.add_argument("--policy", default=None,
                   help="exported TorchScript actor; default zero actions")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    env = make_env("pointfoot_flat", num_envs=args.batch, device=dev)
    trainer = IdentifierTrainer(env, load_policy(args.policy, dev),
                                window=args.window)
    gen = torch.Generator().manual_seed(0)
    trainer.init(gen)
    env_state = env.init_state(1)
    cmd = torch.tensor(CMD, device=dev)

    os.makedirs(args.log_dir, exist_ok=True)
    saved = []
    for it in range(args.iters):
        m = trainer.train_step(env_state, cmd, generator=gen)
        if it % 10 == 0:
            print(f"it {it}: mse {float(m['mse']):.5f} valid "
                  f"{int(m['num_valid'])}/{args.batch}", flush=True)
        if it % args.save_every == 0 or it == args.iters - 1:
            path = os.path.join(args.log_dir, f"identifier_{it}.pt")
            torch.save(trainer.net.state_dict(), path)
            saved.append(path)
    print("done", flush=True)
    return saved


if __name__ == "__main__":
    main()
