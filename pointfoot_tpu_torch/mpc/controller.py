"""Receding-horizon MPC controller over the differentiable physics step
(pointfoot_tpu/mpc/controller.py).

Runs iLQR at the reference's 50 Hz control rate with warm-started control
trajectories: each tick shifts the previous solution one step and re-solves
a few iterations, for a batch of scenarios.

Two dynamics, one function: `dyn` steps with `dynamics.step_batched`, so on
the card the rollouts and the line search take its kernel routes (kernel 5
at 128-4095 rows, kernels 4 and 3 from 4096), and `dyn_plain` steps with
the plain `dynamics.step`, which the linearization differentiates in
forward mode (the kernels refuse tangents).  On the CPU both are the same
plain code.  The scenarios are planned in chunks of `chunk`, which bounds
the (n+m)·chunk·T rows of the linearization.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from pointfoot_tpu_torch.mpc.costs import (CostWeights, pointfoot_stage_cost,
                                           state_to_vec, vec_to_state)
from pointfoot_tpu_torch.mpc.ilqr import ILQRConfig, ILQRSolution, ilqr_solve
from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.physics.model import (PhysicsParams, PhysicsState,
                                               RobotModel)

DEFAULT_CHUNK = 1024  # scenarios a solve, as bench.py's BENCH_ILQR_CHUNK


class MPCState(NamedTuple):
    us_warm: torch.Tensor  # (B, T, m) warm-start control trajectory
    last_cost: torch.Tensor  # (B,)


class MPCController:
    """Batched receding-horizon torque controller for a legged robot.

    `params` is one row of physics parameters (`PhysicsParams.nominal(model,
    1, device)`), broadcast to every row the planner steps; the model and
    the default pose move to its device.
    """

    def __init__(self, model: RobotModel, params: PhysicsParams,
                 height_fn: Callable, default_qpos,
                 weights: CostWeights = CostWeights(),
                 cfg: ILQRConfig = ILQRConfig(horizon=25, iterations=3),
                 dt: float = 0.02, substeps: int = 1,
                 chunk: int = DEFAULT_CHUNK):
        device = params.kp.device
        self.model = model.to(device)
        self.params = params
        self.height_fn = height_fn
        self.default_qpos = torch.as_tensor(
            default_qpos, dtype=torch.float32).to(device)
        self.weights = weights
        self.cfg = cfg
        self.dt = dt
        self.substeps = substeps
        self.chunk = chunk
        self.nj = model.nj
        self.nx = 12 + 2 * model.nj
        self._template = PhysicsState.default(self.model, self.default_qpos,
                                              1, device)

    def _step_rows(self, step_fn, x: torch.Tensor, u: torch.Tensor):
        model = self.model
        phys = vec_to_state(x, self._template, self.nj)
        params = self.params.broadcast(x.shape[0])
        u_clip = torch.minimum(torch.maximum(u, -model.effort_limit),
                               model.effort_limit)
        for _ in range(self.substeps):
            phys = step_fn(model, params, phys, u_clip, self.height_fn,
                           self.dt / self.substeps)
        return state_to_vec(phys)

    def dyn(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Chart rows (R, n), torques (R, nj) -> chart rows one control tick
        later, by `dynamics.step_batched` (kernel routes on the card)."""
        return self._step_rows(dynamics.step_batched, x, u)

    def dyn_plain(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """`dyn` by the plain `dynamics.step` on every device: what the
        linearization differentiates."""
        return self._step_rows(dynamics.step, x, u)

    def init(self, batch: int) -> MPCState:
        dev = self.default_qpos.device
        return MPCState(
            us_warm=torch.zeros(batch, self.cfg.horizon, self.nj,
                                device=dev),
            last_cost=torch.full((batch,), float("inf"), device=dev))

    def cost_fn(self, command: torch.Tensor):
        """The stage cost of scenarios with commands (B, 3)."""
        return pointfoot_stage_cost(self.model, self.weights,
                                    self.default_qpos, command,
                                    self.cfg.horizon)

    def solve(self, phys: PhysicsState, command: torch.Tensor,
              us_warm: torch.Tensor) -> ILQRSolution:
        """iLQR of every scenario from its state and warm start, `chunk`
        scenarios a solve."""
        x0 = state_to_vec(phys)
        B = x0.shape[0]
        sols = []
        for s in range(0, B, self.chunk):
            sl = slice(s, min(s + self.chunk, B))
            sols.append(ilqr_solve(self.dyn, self.cost_fn(command[sl]),
                                   x0[sl], us_warm[sl], self.cfg,
                                   lin_dyn=self.dyn_plain))
        return ILQRSolution(*(torch.cat(f) for f in zip(*sols)))

    def plan(self, phys: PhysicsState, command: torch.Tensor,
             mpc_state: MPCState):
        """One 50 Hz control tick for a batch of scenarios.

        phys: (B, ...) state; command: (B, 3).
        Returns (torque (B, nj), new MPCState, cost (B,)).
        """
        sol = self.solve(phys, command, mpc_state.us_warm)
        torque = sol.us[:, 0]
        # shift warm start: drop first, repeat last
        us_shift = torch.cat([sol.us[:, 1:], sol.us[:, -1:]], dim=1)
        return (torque, MPCState(us_warm=us_shift, last_cost=sol.cost),
                sol.cost)
