"""Sim-vs-real trajectory comparison plots, one subplot an observation
dimension (scripts/comparison.py of the JAX package).

    python -m pointfoot_tpu_torch.comparison --sim sim.tlog --real rr1.npy \
        [--out comparison.png] [--max_steps 1000]

Inputs are .tlog files (runtime/recorder.py), (N, D) .npy arrays or
npy-of-dicts real data (sysid/realdata.py).  Prints the per-dimension and
overall max |sim - real| and the mean error; host code only.
"""

from __future__ import annotations

import argparse

import numpy as np

from pointfoot_tpu_torch.runtime import read_log
from pointfoot_tpu_torch.sysid.realdata import real_to_tensor


def load_traj(path: str) -> np.ndarray:
    """(N, D) float32 trajectory of a .tlog or .npy file."""
    if path.endswith(".tlog"):
        return read_log(path)[0]
    arr = np.load(path, allow_pickle=True)
    if arr.dtype == object:  # npy-of-dicts real data
        return real_to_tensor(path)[:, 0, :]
    return np.asarray(arr, np.float32).reshape(len(arr), -1)


def main(argv=None) -> np.ndarray:
    """Writes the figure and returns the per-dimension max error."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sim", required=True)
    p.add_argument("--real", required=True)
    p.add_argument("--out", default="comparison.png")
    p.add_argument("--max_steps", type=int, default=1000)
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sim = load_traj(args.sim)[: args.max_steps]
    real = load_traj(args.real)[: args.max_steps]
    dims = min(sim.shape[1], real.shape[1])
    rows = int(np.ceil(dims / 4))
    fig, axs = plt.subplots(rows, 4, figsize=(16, 2.2 * rows))
    axs = np.atleast_2d(axs)
    for d in range(dims):
        ax = axs[d // 4, d % 4]
        ax.plot(sim[:, d], label="sim", lw=0.8)
        ax.plot(real[:, d], label="real", lw=0.8, alpha=0.7)
        ax.set_title(f"obs[{d}]", fontsize=8)
        if d == 0:
            ax.legend(fontsize=7)
    for d in range(dims, rows * 4):
        axs[d // 4, d % 4].axis("off")
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    plt.close(fig)
    n = min(len(sim), len(real))
    err = np.abs(sim[:n, :dims] - real[:n, :dims])
    print(f"saved {args.out}; per-dim max err: {err.max(0).round(4).tolist()}")
    print(f"overall max err: {err.max():.4f}  mean err: {err.mean():.4f}")
    return err.max(0)


if __name__ == "__main__":
    main()
