"""Regenerate the golden control-sequence anchor, with archival
(scripts/regen_golden.py of the JAX package).

    python -m pointfoot_tpu_torch.regen_golden --reason "why it changed"
    python -m pointfoot_tpu_torch.regen_golden --reason "..." \
        --golden_dir "$(mktemp -d)/golden" --device cpu

Regenerating an anchor in place ratifies whatever physics exists, so
regeneration archives:

1. the current anchor is copied to GOLDEN_DIR/archive/ under a name that
   carries its generation and the git revision it was recorded at;
2. the new anchor holds its provenance (`generation`, `git_rev`, `date`,
   `reason`) beside `obs` and `torques`;
3. GOLDEN_DIR/archive/HISTORY.md gets a row (--reason is required);
4. `replay_archive` replays every archived anchor against the current
   physics and reports its drift, so the record stays runnable.

The anchor is a 1-env pointfoot_flat rollout (noise and domain
randomization off, command pinned at 0.3 m/s) of 50 steps of the fixed
action 0.3 sin(j + 0.1 t), the recipe of tests/test_golden_trajectory.py.
Its random inputs are the JAX package's, whose threefry streams the port
cannot draw: the initial state of PRNGKey(42) and each step's reset draws
(the joint-position scale and the base velocities of an env that falls,
as the JAX step keys them) are committed in
`_weights/pointfoot_flat_golden_recipe.npz` (`utils/recipe.py`), which a
test holds to JAX.
--golden_dir defaults to the repository's tests/golden; the git revision
is the package's own repository's ("unknown" outside a git checkout), so
a golden directory elsewhere records the revision of the code that made it.
Runs on the GPU unless --device names another (1 env: the plain route).
"""

from __future__ import annotations

import argparse
import datetime
import glob
import os
import shutil
import subprocess
from typing import Optional

import numpy as np
import torch

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.envs.config import override
from pointfoot_tpu_torch.envs.legged_env import LeggedEnv
from pointfoot_tpu_torch.utils.policy_eval import WEIGHTS
from pointfoot_tpu_torch.utils.recipe import Replay
from pointfoot_tpu_torch.utils.registry import get_cfgs

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "tests", "golden")
ANCHOR_NAME = "pointfoot_flat_50step.npz"
RECIPE = os.path.join(WEIGHTS, "pointfoot_flat_golden_recipe.npz")
STEPS = 50
COMMAND = (0.3, 0.0, 0.0)
GOLDEN_PATCH = dict(env=dict(num_envs=1), noise=dict(add_noise=False),
                    domain_rand=dict(randomize_friction=False,
                                     push_robots=False,
                                     randomize_base_mass=False,
                                     randomize_base_com=False))


def golden_env(device="cpu") -> LeggedEnv:
    return LeggedEnv(override(get_cfgs("pointfoot_flat")[0],
                              **GOLDEN_PATCH), device=device)


def record_rollout(device="cpu", recipe: str = RECIPE,
                   resets: Optional[list] = None):
    """The anchor's rollout under the port: (obs (STEPS, num_obs),
    torques (STEPS, nj)) as float32 numpy.  `resets`, where given, gets
    one bool a step: whether any env reset in it."""
    env = golden_env(device)
    replay = Replay(env, recipe, resets=resets)
    state = env.update_cmd(replay.initial, COMMAND)
    obs, tau = [], []
    with torch.no_grad():
        for t in range(STEPS):
            a = (0.3 * np.sin(np.arange(env.num_actions) * 1.0
                              + t * 0.1))[None, :]
            state, out = replay.step(state, torch.tensor(
                a, dtype=torch.float32, device=env.device))
            obs.append(out.obs[0].cpu().numpy())
            tau.append(state.torques[0].cpu().numpy())
    return np.stack(obs), np.stack(tau)


def replay_archive(golden_dir: str = GOLDEN_DIR, device="cpu") -> dict:
    """{archived file name: max |torques - current physics' torques|}
    for every anchor under golden_dir/archive (the port's form of
    tests/test_golden_trajectory.py::test_archived_anchors_stay_runnable:
    archives document deliberate changes, so drift is reported, not
    bounded).  Raises when an archive does not load, has another shape,
    or replays to a non-finite drift."""
    anchors = sorted(glob.glob(os.path.join(golden_dir, "archive", "*.npz")))
    if not anchors:
        raise FileNotFoundError(f"no archived anchor under {golden_dir}")
    obs, tau = record_rollout(device)
    drifts = {}
    for path in anchors:
        with np.load(path, allow_pickle=True) as ref:
            if ref["obs"].shape != obs.shape or \
                    ref["torques"].shape != tau.shape:
                raise ValueError(f"{path}: shapes {ref['obs'].shape}, "
                                 f"{ref['torques'].shape} against "
                                 f"{obs.shape}, {tau.shape}")
            drift = float(np.abs(ref["torques"] - tau).max())
        if not np.isfinite(drift):
            raise ValueError(f"{path}: non-finite drift")
        name = os.path.basename(path)
        print(f"{name}: max torque drift vs current physics {drift:.4f} N·m")
        drifts[name] = drift
    return drifts


def git_revision() -> str:
    """The short revision of the package's own repository."""
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"], cwd=PACKAGE_DIR,
            stderr=subprocess.DEVNULL).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def main(argv=None) -> dict:
    """Archives, records and writes the history row; returns
    {"generation", "git_rev", "archived", "anchor"}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reason", required=True,
                    help="what physics behavior changed, and why")
    ap.add_argument("--golden_dir", default=GOLDEN_DIR)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    anchor = os.path.join(args.golden_dir, ANCHOR_NAME)
    archive = os.path.join(args.golden_dir, "archive")
    rev = git_revision()
    today = datetime.date.today().isoformat()

    os.makedirs(archive, exist_ok=True)
    archived = None
    if os.path.exists(anchor):
        with np.load(anchor, allow_pickle=True) as old:
            gen = int(old["generation"]) if "generation" in old else 0
            old_rev = (str(old["git_rev"]) if "git_rev" in old
                       else "pre-archival")
        archived = f"pointfoot_flat_50step_gen{gen:02d}_{old_rev}.npz"
        shutil.copy2(anchor, os.path.join(archive, archived))
        print(f"archived generation {gen} -> archive/{archived}")
    else:
        gen = -1

    obs, tau = record_rollout(dev)
    np.savez(anchor, obs=obs, torques=tau,
             generation=np.int32(gen + 1),
             git_rev=np.str_(rev), date=np.str_(today),
             reason=np.str_(args.reason))
    hist = os.path.join(archive, "HISTORY.md")
    header = not os.path.exists(hist)
    with open(hist, "a") as f:
        if header:
            f.write("# Golden-anchor generation history\n\n"
                    "| gen | date | git rev | reason |\n|---|---|---|---|\n")
        f.write(f"| {gen + 1} | {today} | {rev} | {args.reason} |\n")
    print(f"recorded generation {gen + 1} @ {rev}: {args.reason}")
    return {"generation": gen + 1, "git_rev": rev, "archived": archived,
            "anchor": anchor}


if __name__ == "__main__":
    main()
