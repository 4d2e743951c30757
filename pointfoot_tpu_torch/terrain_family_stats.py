"""Per-terrain-family curriculum stats from a checkpoint's env state
(scripts/terrain_family_stats.py of the JAX package).

    python -m pointfoot_tpu_torch.terrain_family_stats LOG_DIR/model_N.pt \
        [--task pointfoot_rough]

The terrain_level metric is a global mean over the envs, and one binding
family (stairs_up) can dominate it.  This tool splits it by terrain
family: each family's mean level, its share of envs stuck at level 0, and
the global mean, the numbers the terrain "done" bar is judged by (global
>= 6 and stairs_up >= 5).  It reads `env_state.terrain_level` and
`env_state.terrain_type` of the port's `model_<it>.pt` (rl/runner.py);
the family of a type column follows the registered terrain config of
--task: its proportions, cumulated and scaled to `num_cols` columns with
round(), name the columns smooth_slope, rough_slope, stairs_up,
stairs_down, discrete_obstacles, then stepping_stones, gap and pit.
Prints the JSON (indent 1).  Reads the checkpoint on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pointfoot_tpu_torch.utils.registry import get_cfgs

FAMILIES = ("smooth_slope", "rough_slope", "stairs_up", "stairs_down",
            "discrete_obstacles", "stepping_stones", "gap", "pit")


def family_columns(terrain_cfg) -> list:
    """[(family, first column, one past the last)] of the type columns,
    families without a column left out; the grid's `choice < p[k]`
    buckets over num_cols columns."""
    props = list(terrain_cfg.terrain_proportions)
    cum, acc = [], 0.0
    for p in props:
        acc += p
        cum.append(acc)
    bounds = [int(round(c / max(acc, 1e-9) * terrain_cfg.num_cols))
              for c in cum]
    out, lo = [], 0
    for name, hi in zip(FAMILIES[:len(props)], bounds):
        if hi > lo:
            out.append((name, lo, hi))
        lo = hi
    return out


def family_stats(level: np.ndarray, ttype: np.ndarray, terrain_cfg) -> list:
    """One row a family with envs: its columns, env count, mean level and
    share stuck at level 0 (rounded as the JAX tool rounds)."""
    rows = []
    for name, lo, hi in family_columns(terrain_cfg):
        m = (ttype >= lo) & (ttype < hi)
        if m.sum() == 0:
            continue
        rows.append({
            "family": name, "cols": f"{lo}-{hi - 1}",
            "envs": int(m.sum()),
            "mean_level": round(float(level[m].mean()), 2),
            "stuck_at_0_pct": round(100.0 * float(
                (level[m] == 0).mean()), 1),
        })
    return rows


def main(argv=None) -> dict:
    """Prints the JSON; returns it as a dict."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt")
    ap.add_argument("--task", default="pointfoot_rough")
    args = ap.parse_args(argv)

    raw = torch.load(args.ckpt, map_location="cpu", weights_only=True)
    es = raw["env_state"]
    level = es["terrain_level"].numpy()
    ttype = es["terrain_type"].numpy()
    cfg = get_cfgs(args.task)[0].terrain
    out = {"ckpt": args.ckpt, "iteration": int(raw.get("iteration", -1)),
           "global_mean_level": round(float(level.mean()), 3),
           "families": family_stats(level, ttype, cfg)}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
