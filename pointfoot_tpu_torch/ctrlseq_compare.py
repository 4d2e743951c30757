"""Control-sequence comparison: the gait-MPC against a trained RL policy
(scripts/ctrlseq_compare.py of the JAX package).

    python -m pointfoot_tpu_torch.ctrlseq_compare [--load_run PATH] \
        [--vx 0.4] [--steps 250]
    python -m pointfoot_tpu_torch.ctrlseq_compare --device cpu --steps 60

BASELINE's "ctrl-seq max err" asks how close direct optimization gets to
the learned controller.  The RL policy rolls closed-loop on pointfoot_flat
at 1 env (observation noise and domain randomization off, the command
pinned at --vx after every step); at every state it visits the stepping
controller (mpc/gait.py::SteppingController, nominal physics parameters)
is queried for its torques at the same pre-step state, its gait clock
threaded along.  Agreement is measured on the common output, the joint
torques: the RL torques are the env's PD law, the MPC's the SRB force map
and swing PD.  The first JSON line gives the RMS and largest torque
differences and the RL torques' RMS over the ticks after the first 50 (a
1 s transient); the second the task-level comparison: each controller's
mean base-frame vx over the same ticks in its own closed loop (the MPC
stepping 4 substeps of `dynamics.step` a tick on flat ground).

The two RL loops start from the JAX script's initial states, those of
PRNGKey(0) and PRNGKey(1), and reset with its draws for the default 250
ticks (`utils/recipe.py`; `_weights/pointfoot_flat_ctrlseq_recipe.npz`,
which a test holds to JAX), so that the port's numbers are the JAX
script's up to roundoff: the RL policy's vx depends strongly on where its
loop starts.  --load_run takes an actor npz of flax-named
arrays or the port's `model_<it>.pt`; the default is the actor of
logs/pointfoot_flat/tpu_run7/model_4500, the JAX script's default,
committed as `_weights/pointfoot_flat_tpu_run7_model_4500_actor.npz`.  On
the card every gait tick launches kernel 6 once (frozen contact).  Runs on
the GPU unless --device names another.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.mpc.gait import SteppingController
from pointfoot_tpu_torch.ops import quat as quat_ops
from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
from pointfoot_tpu_torch.terrain.analytic import FLAT
from pointfoot_tpu_torch.utils import policy_eval
from pointfoot_tpu_torch.utils.recipe import Replay
from pointfoot_tpu_torch.utils.registry import make_env

DEFAULT_ACTOR = os.path.join(policy_eval.WEIGHTS,
                             "pointfoot_flat_tpu_run7_model_4500_actor.npz")
# the JAX script's initial states (PRNGKey(0) under key0/, PRNGKey(1) under
# key1/) and each loop's reset draws for 1 + 250 env steps
RECIPE = os.path.join(policy_eval.WEIGHTS,
                      "pointfoot_flat_ctrlseq_recipe.npz")
EVAL_PATCH = dict(noise=dict(add_noise=False),
                  domain_rand=dict(randomize_friction=False,
                                   push_robots=False,
                                   randomize_base_mass=False,
                                   randomize_base_com=False))
SKIP = 50  # ticks of the 1 s transient (command ramp in both controllers)
SUB_DT = 0.005
SUBSTEPS = 4


def torque_errors(tau_mpc: np.ndarray, tau_rl: np.ndarray) -> dict:
    """The first line's reductions over ticks SKIP onward."""
    diff = tau_mpc[SKIP:] - tau_rl[SKIP:]
    rms = float(np.sqrt(np.mean(diff ** 2)))
    scale = float(np.sqrt(np.mean(tau_rl[SKIP:] ** 2)))
    return {"rms_Nm": round(rms, 3),
            "max_Nm": round(float(np.abs(diff).max()), 3),
            "rl_rms_Nm": round(scale, 3),
            "normalized_rms": round(rms / max(scale, 1e-9), 3)}


def tracking(v_mpc: float, v_rl: float, vx: float) -> dict:
    """The second line's numbers."""
    return {"cmd": vx, "mpc_vx": round(v_mpc, 3), "rl_vx": round(v_rl, 3),
            "mpc_err_pct": round(100 * abs(v_mpc - vx) / max(vx, 1e-9), 1),
            "rl_err_pct": round(100 * abs(v_rl - vx) / max(vx, 1e-9), 1)}


def _body_vx(phys: PhysicsState) -> torch.Tensor:
    return quat_ops.rotate_inverse(phys.base_quat[0],
                                   phys.base_lin_vel[0])[0]


def _mean(vxs: list) -> float:
    """The float64 mean of float32 readings, as np.mean of the JAX
    script's python floats."""
    return float(np.mean(torch.stack(vxs).cpu().numpy().astype(np.float64)))


def rl_start(env, key: int):
    """(initial state, step function) of the RL loop that the JAX script
    starts from PRNGKey(key)."""
    replay = Replay(env, RECIPE, prefix=f"key{key}/")
    return replay.initial, replay.step


def main(argv=None) -> dict:
    """Prints the two JSON lines; returns {"ctrlseq": first line,
    "tracking": second line}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--load_run", default=DEFAULT_ACTOR)
    ap.add_argument("--vx", type=float, default=0.4)
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    env = make_env("pointfoot_flat", num_envs=1, device=dev,
                   cfg_patch=EVAL_PATCH)
    policy = policy_eval.inference_policy(
        policy_eval.load_actor(env, "pointfoot_flat", args.load_run))
    model = env.model
    params1 = PhysicsParams.nominal(model, 1, dev)
    mpc = SteppingController(model, params1, model.collision_indices("foot"),
                             np.zeros(model.nj))
    cmd_list = [args.vx, 0.0, 0.0]
    cmd = torch.tensor([cmd_list], device=dev)
    zeros = torch.zeros(1, env.num_actions, device=dev)

    with torch.no_grad():
        state, step = rl_start(env, 0)
        state, out = step(env.update_cmd(state, cmd_list), zeros)
        obs = out.obs
        gait = mpc.init(1, state.physics)
        tau_rl, tau_mpc = [], []
        for _ in range(args.steps):
            a = policy(obs)
            # MPC torque at the SAME pre-step state
            tq_mpc, gait = mpc.control(state.physics, cmd, gait)
            state, out = step(state, a)
            state = env.update_cmd(state, cmd_list)
            obs = out.obs
            tau_rl.append(state.torques[0])
            tau_mpc.append(tq_mpc[0])
        line1 = dict(metric="ctrlseq_torque_err_vs_rl_policy",
                     **torque_errors(torch.stack(tau_mpc).cpu().numpy(),
                                     torch.stack(tau_rl).cpu().numpy()),
                     vx=args.vx, steps=args.steps)
    print(json.dumps(line1))

    # task-level comparison: closed-loop velocity tracking of each
    # controller on the same command (the practically meaningful number:
    # instantaneous torques differ mostly by gait-phase misalignment)
    with torch.no_grad():
        phys = PhysicsState.default(model, np.zeros(model.nj), 1, dev,
                                    base_height=0.62)
        g = mpc.init(1, phys)
        vxs = []
        for t in range(args.steps):
            tq, g = mpc.control(phys, cmd, g)
            for _ in range(SUBSTEPS):
                phys = dynamics.step(model, params1, phys, tq, FLAT, SUB_DT)
            if t >= SKIP:
                vxs.append(_body_vx(phys))
        v_mpc = _mean(vxs)

        st, step = rl_start(env, 1)
        st, o = step(env.update_cmd(st, cmd_list), zeros)
        ob = o.obs
        vxs = []
        for t in range(args.steps):
            st, o = step(st, policy(ob))
            st = env.update_cmd(st, cmd_list)
            ob = o.obs
            if t >= SKIP:
                vxs.append(_body_vx(st.physics))
        v_rl = _mean(vxs)
    line2 = dict(metric="closed_loop_vx_tracking",
                 **tracking(v_mpc, v_rl, args.vx))
    print(json.dumps(line2))
    return {"ctrlseq": line1, "tracking": line2}


if __name__ == "__main__":
    main()
