"""Batched MPC and trajectory optimization (pointfoot_tpu/mpc): the
full-model iLQR over the differentiable physics step, the SRB-MPC tick and
the gait-MPC stepping stack, every function batched over scenarios."""

from pointfoot_tpu_torch.mpc.controller import MPCController
from pointfoot_tpu_torch.mpc.costs import CostWeights, pointfoot_stage_cost
from pointfoot_tpu_torch.mpc.gait import (GaitConfig, SteppingController,
                                          TunedStack, heading_command,
                                          make_controller)
from pointfoot_tpu_torch.mpc.ilqr import ILQRConfig, ilqr_solve

__all__ = ["ILQRConfig", "ilqr_solve", "pointfoot_stage_cost", "CostWeights",
           "MPCController", "GaitConfig", "SteppingController", "TunedStack",
           "heading_command", "make_controller"]
