"""Trajectory-equality and determinism probe (scripts/shape.py of the JAX
package): compares two recorded trajectories (.tlog or .npy) element-wise
and reports where they diverge.

    python -m pointfoot_tpu_torch.shape a.tlog b.tlog [--atol 1e-6]

Prints "EQUAL within atol=... over N steps" or "DIVERGE at step S: max
err ... (dim D)"; host code only.
"""

from __future__ import annotations

import argparse

import numpy as np

from pointfoot_tpu_torch.runtime import read_log


def load(path: str) -> np.ndarray:
    if path.endswith(".tlog"):
        return read_log(path)[0]
    return np.asarray(np.load(path), np.float32)


def main(argv=None) -> str:
    """Prints and returns the verdict line."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--atol", type=float, default=1e-6)
    args = p.parse_args(argv)
    a, b = load(args.a), load(args.b)
    n = min(len(a), len(b))
    if len(a) != len(b):
        print(f"length mismatch: {len(a)} vs {len(b)}; comparing first {n}")
    diff = np.abs(a[:n] - b[:n])
    if diff.max() <= args.atol:
        line = f"EQUAL within atol={args.atol} over {n} steps"
    else:
        first = int(np.argwhere(diff.max(axis=1) > args.atol)[0, 0])
        line = (f"DIVERGE at step {first}: max err {diff.max():.3e} "
                f"(dim {int(diff[first].argmax())})")
    print(line)
    return line


if __name__ == "__main__":
    main()
