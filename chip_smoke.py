"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at full width: the policy rollout of
pointfoot_rough (fused rollout kernels) and the actuator-net task
anymal_c_rough (physics/dynamics.step_batched and its kernels), both on
procedural terrain at 4096 envs, the SRB-MPC tick of PointFoot at 4096
scenarios (the fused SRB-LQR kernel), PPO training of pointfoot_rough at
4096 envs (its rollouts through the fused rollout kernels), and the same
env paths on plane terrain (pointfoot_flat, anymal_c_flat, PPO training of
pointfoot_flat) and on table terrain (the registered pointfoot_rough and
anymal_c_rough), the recurrent policy's training and inference, the
gait-MPC and iLQR paths, sys-ID (the identifier at 4096 envs through
the fused rollout kernel, the GANs through the simulator), and
data-parallel training (two ranks sharing the card, each launching the
fused rollout kernels on its shard).

1. device and build: the card's name and power limit; the PointFoot,
   ANYmal, A1, Cholesky and Riccati libraries of pointfoot_tpu_torch/csrc/
   built by parallel nvcc processes (seconds, registers, spills, shared
   memory a block, resident warps an SM);
2. PointFoot kernels against their plain PyTorch versions on a state
   reached after 20 policy steps, with a push queued: the full decimation
   rollout and one rollout substep, each within its stated tolerance and
   bit for bit, also at 1000, 1 and 4099 envs (batches that leave a
   block's groups idle), and two launches bit for bit; the sphere-xyz FK bit for bit against its
   plain version at 4096, 1000, 1 and 4099 envs, on this state, on an
   anymal_c_rough state and on perturbed A1 poses, and two launches bit
   for bit;
3. step_batched's kernels against their plain versions on an anymal_c_rough
   state reached after 20 steps of the bench action signal, with a push
   queued: the mega-kernel route (sphere-xy FK, surface query, substep
   kernel) against the plain path, the substep kernel and the FK-xy
   kernel bit for bit against their twins at 4096, 1000, 1 and 4099
   envs and two launches bit for bit, and the Cholesky kernel bit for bit
   against ops/linalg.chol_solve on the velocity systems of 2048 ANYmal
   (n = 18) and 2048 PointFoot (n = 12) envs, at 1000, 1 and 4099 of them
   as well, and two launches bit for bit;
   for every kernel: per-launch time of the kernel (its launches replayed
   from a CUDA graph, so the device's time; and a loop of wrapper calls,
   which cannot show less than the host's time to enqueue one) and of the
   plain version by CUDA events, and the least time the card could take (bytes over 3.35 TB/s or
   float32 operations over 67 TFLOP/s); the Cholesky kernel also beside
   torch.linalg.cholesky + torch.cholesky_solve;
4. the PointFoot rollout at full width: 100 policy steps with the launch
   counters reset just before and read just after (1x and 4x the step
   count), env-steps/s, a per-layer breakdown and the regression probe
   (level 0, command vx 0.4 m/s, 6 s): falls <= num_envs and mean forward
   velocity >= 0.15 m/s;
5. anymal_c_rough at full width: 100 steps of the bench signal (substep and
   FK-xy kernels 4x the step count each, the other kernels 0), env-steps/s,
   a per-layer breakdown, and the physical gate (level 0, zero actions, no
   pushes, 2 s) inside the band the JAX package gives;
6. anymal_c_rough at 2048 envs, the Cholesky route: 25 steps, Cholesky
   kernel 4x the step count, substep kernel 0, and one substep split into
   its layers (assemble_velocity_solve, staging, the Cholesky kernel,
   finish_step);
7. the SRB-LQR kernel against its plain version at 4096, 1000, 1 and 4099
   scenarios, on the PointFoot tick's own problems (m = 6), A1's (m = 12)
   and random dense problems, horizon 12; at horizon 1 and at a horizon
   whose gains leave shared memory for the global work space; two launches
   bit for bit; its per-launch time, bound, and the time of the sequential
   Riccati solver on the same problems;
8. the SRB-MPC tick at full width through pointfoot_tpu_torch.bench: 4096
   PointFoot scenarios, horizon 12, one SRB-LQR launch per tick and no
   other kernel, solves/s against real time (50 Hz), a per-layer
   breakdown, and the kernel tick against the sequential-solver tick on
   the same states;
9. the closed-loop gate: 4096 A1 scenarios on flat ground, a lateral
   0.3 m/s perturbation, 50 ticks of the kernel tick with 4 substeps of
   leg_torques and dynamics.step_batched each: every base stays above
   0.2 m, upright, and comes to rest;
10. PPO training of pointfoot_rough on procedural terrain at 4096 envs
   through rl/runner.OnPolicyRunner.train_iteration, fresh from seed 0,
   the registry's PPO config (512/256/128, 24 steps an iteration, 5 x 4
   minibatches): two warm iterations, then two timed ones, env-steps/s
   including the update and the seconds of rollout and update of each;
   the launch counters around one iteration (rollout substep kernel 4 x 24,
   sphere-xyz FK 24, the other kernels 0); after every iteration finite
   parameters, Adam moments and metrics, the learning rate in [min_lr,
   max_lr], exp(log_std) within the noise rails and 20 more updates; and
   the card's PPO update held to the CPU's on the first 256 envs of a card
   rollout, from the same parameters, Adam state and permutations: the
   first minibatch's gradients, every minibatch's losses and KL, the
   learning rates, and the final parameters and Adam moments;
11. plane terrain: pointfoot_flat at 4096 envs with model_82000's actor and
   the reward and command knobs it trained under: the fused rollout
   against its plain version with no surface rows, one rollout substep
   without surface rows at 4096, 1000, 1 and 4099 envs and two launches
   bit for bit, and its per-launch time; 200 policy steps with the launch
   counters (rollout substep kernel 4x the step count, sphere-xyz FK 0: no
   surface query), env-steps/s, a per-layer breakdown and the probe of
   policy-regression row 5 (command 0.5 m/s, 6 s: mean forward velocity
   >= 0.30 m/s, falls reported); anymal_c_flat for 20 steps (substep kernel
   4x the step count, FK-xy 0: step_batched's flat branch);
12. table terrain, the registered configs: pointfoot_rough with
   model_100000's actor, the fused rollout and one substep on the table's
   surface rows against their plain versions (4096, 1000, 1, 4099 envs),
   the sphere-xyz FK bit for bit; 100 steps with the launch counters (4 + 1
   a step), env-steps/s, a per-layer breakdown with the table's surface
   query and height scan, and the probe of row 1 (level 0, 0.4 m/s, 6 s:
   mean forward velocity >= 0.20 m/s); anymal_c_rough on the table: the
   mega-kernel route against the plain path on the same surface rows, the
   substep and FK-xy kernels against their twins, 20 steps with the
   counters; then bench.main_env for pointfoot_rough and anymal_c_rough
   (the procedural headline and the table leg, 24-step iterations);
13. PPO training of pointfoot_flat at 4096 envs with its registered PPO
   config (128/64/32) and model_82000's knobs: one warm iteration and two
   timed, 96 rollout-substep launches and no sphere-xyz FK an iteration,
   and the state checks of phase 10;
14. the recurrent policy: PPO training of the registered pointfoot_rough
   (table terrain) at 4096 envs with runner.policy_class_name
   "ActorCriticRecurrent" (LSTM cells of 256, heads 512/256/128,
   RecurrentPPO: 5 epochs x 4 minibatches of 1024 envs, BPTT over the 24
   steps), fresh from seed 0: one warm iteration and two timed,
   `[train-rnn]` env-steps/s including the update with the rollout and
   update seconds, 96 rollout-substep and 24 sphere-xyz FK launches an
   iteration and no other kernel, phase 10's state checks after every
   iteration, and the card's recurrent update of 256 envs held to the
   CPU's from the same parameters, Adam state, starting carry and
   permutations (`[train-rnn-check]`); then one recurrent iteration of
   pointfoot_flat (96 + 0 launches) and 50 steps of the plane env driven
   by its stateful inference policy (4 launches a step, finite actions);
15. the gait-MPC and iLQR paths at 4096 scenarios: `[gait-lqr]` the SRB-LQR
   kernel on the frozen-contact problems of the PointFoot gait's first
   tick (4096, 1000, 1, 4099 scenarios, against sequential_srb_lqr, two
   launches bit for bit); `[gait]` make_controller("pointfoot") walking at
   vx 0.4 from perturbed starts (sigma 0.15 m/s) for 250 ticks of 4 x
   step_batched substeps on analytic.FLAT: kernel 6 once a tick, kernels 4
   and 3 four times, the fall share at most 1/8, the mean vx, scenario-
   ticks/s and a per-layer tick; `[gait-a1]` make_controller("a1") trotting
   for 1000 ticks at 200 Hz (min z > 0.15, tilt < 0.3, mean vx over ticks
   400-1000 > 0.2; kernels 4 and 3 once a tick); kernels 3 and 4 of
   PointFoot and A1 held to their plain versions on each loop's first
   step_batched inputs (full width and 1000, 1, 4099, two launches bit for
   bit); `[ilqr]` bench.main_mpc_ilqr (solves/s; launches derived from the
   row counts: kernel 5 for the 1024-row rollouts, kernels 4 and 3 for the
   6144-row line search) with one chunk split into rollout, linearization
   (and its peak memory), backward and forward pass; `[ilqr-check]` the
   card's solve of 1024 perturbed scenarios at horizon 3 against the CPU's,
   with kernels 3 and 4 held to their plain versions on its first 6144-row
   line-search step; `[ilqr-witness]` the same scenarios at horizon 25
   through the kernel routes against the plain dynamics.step on the card,
   beside the plain route's moves under one-ulp nudges, and how many of
   those scenarios end below their warm start's cost and how many lose
   finite gains in the first iteration; `[mpc-balance]` the iLQR balance
   recipe of tests/test_mpc.py at 64 scenarios;
16. sys-ID on pointfoot_flat with the committed exported actor:
   `[sysid] identifier` one IdentifierTrainer.train_step at the identifier
   CLI's defaults (64 envs, window 400 after a warm-up of 100, LSTM 512;
   the plain route, no launches) and at 4096 envs (kernel 1's route under
   no gradient, 4 launches a step), each with its seconds, simulated
   env-steps/s, num_valid, MSE and peak memory; kernel 1 bit for bit
   against its plain version on the first step of the wide simulation's
   rows (per-env friction, mass and CoM) at 4096, 1000, 1 and 4099 rows;
   `[sysid] gan` and `[sysid] wgan` one step each through the simulator at
   1 env (GAN_SMOKE's length and warm-up), against "real" windows
   simulated at known parameters: seconds, losses and every generator's
   gradient norm finite and nonzero; `[sysid] card vs cpu` the four
   trainers' nets (the GAN's generator and discriminator, the WGAN's
   generator and critic with its gradient penalty, the identifier, the
   direct GAN's pair) forward and backward on the card and on the CPU in
   float32 against the CPU in float64 (the CPU's float32 beyond the
   tolerance only through a LeakyReLU input at its kink);
17. data parallelism (parallel/mesh.py), after the build, so the ranks
   only load the libraries: two ranks on cuda:0 (`chip_smoke.py --dp-rank
   R DIR`, started by the script) on gloo with CUDA tensors, since nccl
   refuses two ranks on one device, each with 4096 envs of the registered
   pointfoot_rough: (a) the union of the ranks' rollout_substeps_sharded
   outputs on the rank's rows of one 8192-env state, bit for bit against
   this process's rollout_substeps of all 8192 rows; (b) kernel 1 on each
   rank's rows bit for bit against its plain version; (c) the launches of
   one DP training iteration on each rank (96 rollout-substep, 24
   sphere-xyz FK, 0 others); (d) the ranks' parameters, Adam moments and
   learning rate bit-identical after it; (e) the DP update against one
   process's update of the gathered rollout from the same parameters,
   Adam state and permutations (phase 10's tolerances; an Adam moment
   beyond them passes while within WITNESS_FACTOR of the update of the
   observations one ulp up); (f) a checkpoint that rank 0 alone writes,
   with the 8192 rows, loaded back by one process; `[dp]` global
   env-steps/s including the update, each rank's rollout and update
   seconds and the gradient all-reduce ms a minibatch.  Then `[dp-nccl]`:
   one rank on nccl, a DP iteration at 4096 envs against the runner
   without a mesh from the same state (rollouts bit for bit, the update
   as in (e)).
18. the last modules: `[env-phases]` bench.main_env_phases at 4096
   procedural envs (one timed 24-step iteration a variant after the warm
   iteration and at most 4 settle ones; reported, not gated: one
   iteration cannot resolve a few ms of a ~180 ms step; each variant's
   launches: kernel 1 four times and
   kernel 2 once a step, no other kernel); `[profile]`
   utils.profiling.trace around 3 procedural env steps, the device's busy
   share of the traced window, its top operations and longest idle gaps
   from the trace's device events (the trace kept gzipped under
   smoke_out/phase18/), and utils.profiling.timed of the step beside
   its CUDA-event time; `[play]` play.run of the flagship (procedural),
   the registered pointfoot_rough (table) and pointfoot_flat (plane) at
   4096 envs with the command pinned at 0.4 m/s: the logger's keys finite,
   command_x 0.4 in every step, print_rewards, the launches, and the
   flagship's --export; `[tlog]` TrajectoryRecorder logs of the
   flagship's observations, env 0 and all 4096 rows for 50 steps, read
   back bit for bit, none dropped, shape EQUAL on a log against itself,
   and a second play from the same seed compared (reported, not gated);
   `[native-policy]` the exported ONNX through runtime.NativePolicy on
   the card's observations against the torch actor on the card, within
   2e-5; `[test-env]` the test_env CLI for all seven tasks at 10 envs, 50
   steps each, one process a task; `[gait-diag]` the gait_diag CLI at 4096
   scenarios, vx 0.4, 25 ticks: kernel 6 once and kernels 3 and 4 four
   times a tick, the falls.
19. the run-diagnostic and validation CLIs, each through its `main` with
   the launch counts zeroed just before and read just after, each kernel
   held first to its plain version on the tool's first inputs:
   `[catapult-hunt]` catapult_hunt at 4096 pointfoot_flat envs (training
   conditions, the committed flat actor) for CATAPULT_STEPS steps, kernel
   1 four times a step; `[ctrlseq]` ctrlseq_compare at CTRLSEQ_STEPS ticks
   (1 env), kernel 6 at 1 scenario once a gait tick (twice 100), its
   numbers held to the JAX script's (CTRLSEQ_JAX);
   `[profile-substep]` profile_substep at 4096 envs, its five rows (the
   procedural env.step through kernels 1-2, step_batched through kernels
   4 and 3, kernel 5 for the solve); `[regen-golden]` regen_golden into a
   temporary copy of tests/golden (its anchor held to the repository's at
   the golden tolerance) and replay_archive there; `[storm-guard]` the
   guard on the committed flagship run's log, which must read calm;
   `[terrain-stats]`
   terrain_family_stats on a checkpoint of the flagship env's state after
   `[rollout]`; `[multihost]` multihost_smoke, two gloo ranks sharing the
   card; `[contact]` contact_calibration's CONTACT_EXPERIMENTS, the feet's
   normal forces within 5% of the weight.

The line before the last holds the kernels' JSON record, the one before it
the card's name and power limit, and the last line is the JSON
{"ok": true, "device": ...}.  Any failed check raises, so the exit code is
not 0 and no result line is printed.  Without CUDA it exits with code 2.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from pointfoot_tpu_torch import (bench, catapult_hunt, contact_calibration,
                                 ctrlseq_compare, gait_diag,
                                 multihost_smoke, play, profile_substep,
                                 regen_golden, shape, storm_guard,
                                 terrain_family_stats)
from pointfoot_tpu_torch.kernel_times import (A1_QDEF, dense_problem,
                                              graph_ms, substep_inputs)
from pointfoot_tpu_torch.kernel_times import events_ms as cuda_ms
from pointfoot_tpu_torch.mpc import costs as mpc_costs
from pointfoot_tpu_torch.mpc import gait as gait_mpc
from pointfoot_tpu_torch.mpc import ilqr, srb
from pointfoot_tpu_torch.mpc.controller import MPCController
from pointfoot_tpu_torch.mpc.gait import SteppingController
from pointfoot_tpu_torch.export.onnx import load_policy_as_torch
from pointfoot_tpu_torch.models.nets import (LSTMIdentifier, MLPCritic,
                                             MLPDiscriminator, MLPGenerator)
from pointfoot_tpu_torch.ops import quat
from pointfoot_tpu_torch.ops.cuda import build
from pointfoot_tpu_torch.ops.cuda import cholesky as ch
from pointfoot_tpu_torch.ops.cuda import riccati as rk
from pointfoot_tpu_torch.ops.cuda import substep as sp
from pointfoot_tpu_torch.parallel import mesh as pm
from pointfoot_tpu_torch.physics import actuator as act
from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.physics.contact import query_surface
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
from pointfoot_tpu_torch.rl.networks import map_carry
from pointfoot_tpu_torch.rl.ppo import PPO, Transition, compute_gae
from pointfoot_tpu_torch.runtime import (NativePolicy, TrajectoryRecorder,
                                         read_log)
from pointfoot_tpu_torch.sysid import (GANTrainer, IdentifierTrainer,
                                       WGANTrainer, chunk_windows,
                                       simulate_trajectory)
from pointfoot_tpu_torch.sysid.direct_gan import DirectTrajectoryGAN
from pointfoot_tpu_torch.sysid.gan import (FRIC_RANGE, PARAM_RANGE, _bce,
                                           grads_of)
from pointfoot_tpu_torch.sysid.wgan import gradient_penalty
from pointfoot_tpu_torch.terrain.analytic import FLAT
from pointfoot_tpu_torch.utils import policy_eval, profiling
from pointfoot_tpu_torch.utils.registry import (TASKS, get_cfgs,
                                                make_alg_runner, make_env)

NUM_ENVS = 4096
CHOL_ENVS = 2048
WARM_STEPS = 20
ROLLOUT_STEPS = 100  # 500 before phase 15, 200 before phase 18
ANYMAL_STEPS = 100  # 200 before phase 15 needed the time
CHOL_STEPS = 25
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
SUBSTEP_SRC = "pointfoot_tpu_torch/csrc/substep.cu"
CHOL_SRC = "pointfoot_tpu_torch/csrc/cholesky.cu"
RICCATI_SRC = "pointfoot_tpu_torch/csrc/riccati.cu"
# tolerances of tests/test_pallas_substep.py:141-151 (rollout vs reference)
ROLLOUT_TOL = {"qvel": 2e-3, "base_lin_vel": 5e-4, "base_pos": 5e-5,
               "tau": 5e-3, "sphere_pos": 5e-5}
FORCE_ATOL, FORCE_RTOL = 0.05, 1e-3
# tolerances of tests/test_pallas_substep.py:50-60 (one substep vs
# step_batched): (atol, rtol) per state field
STEP_TOL = {"base_lin_vel": (3e-4, 3e-4), "base_ang_vel": (3e-4, 3e-4),
            "qvel": (1e-3, 3e-4), "base_pos": (2e-5, 0.0),
            "base_quat": (2e-5, 0.0), "qpos": (2e-5, 0.0),
            "contact_force": (0.1, 1e-3)}
ANYMAL_PATCH = dict(terrain=dict(procedural=True))
# The physical gate: anymal_c_rough on level 0 of procedural terrain
# without the discrete-obstacle family, zero actions, no pushes, 2 s.  The
# JAX package on the CPU gives, at 8 envs (tests/test_torch_physical_gate.py
# recomputes it and holds it inside these bands): a mean base height above
# the terrain under the base of 0.351 m at 2 s (envs 0.278-0.425 m), no
# terminations.
GATE_PATCH = dict(
    terrain=dict(procedural=True, max_init_terrain_level=0,
                 terrain_proportions=(0.1, 0.1, 0.35, 0.45)),
    domain_rand=dict(push_robots=False), noise=dict(add_noise=False))
GATE_STEPS = 100  # 2 s at the 50 Hz policy rate
GATE_MEAN_HEIGHT = (0.25, 0.45)  # m
GATE_MAX_TERMINATED = 0.02  # share of envs
# SRB-MPC: kernel vs plain version, tests/test_pallas.py:77-78; kernel tick
# vs sequential-solver tick, tests/test_srb_pallas.py:41-45
LQR_TOL = 2e-3  # rtol and atol
# batches that leave idle groups in the last block: a round count that is
# no multiple of a block, one item, and a prime above the full width
RAGGED = (1000, 1, 4099)
LQR_LONG_HORIZON = 96  # its gains do not fit in a block's shared memory
TICK_TAU_TOL = (2e-3, 2e-2)  # (rtol, atol), N·m
TICK_FORCE_TOL = (2e-3, 5e-2)  # (rtol, atol), N
MPC_ITERS, MPC_REPS = 20, 3
# the closed-loop recipe of tests/test_srb.py:45-92
SRB_GATE_CFG = dict(height_target=0.28, w_vel=1.0, w_height=10.0,
                    w_orient=5.0, w_omega=0.5, w_force_normal=1e-3,
                    w_force_tangent=2e-2, kp_swing=20.0, kd_swing=0.5)
SRB_GATE_TICKS, SRB_GATE_SUBSTEPS, SRB_GATE_DT = 50, 4, 0.005
TRAIN_WARM, TRAIN_TIMED = 2, 2  # iterations (3 timed before phase 18)
FLAT_TRAIN_WARM, FLAT_TRAIN_TIMED = 1, 2  # pointfoot_flat (phase 13)
RNN_TRAIN_WARM, RNN_TRAIN_TIMED = 1, 2  # recurrent pointfoot_rough (14)
RNN_FLAT_STEPS = 50  # steps of the recurrent flat inference policy
FLAT_STEPS = 200
ANYMAL_FLAT_STEPS = 20
TABLE_STEPS = 100
ANYMAL_TABLE_STEPS = 20
# bench.main_env inside the smoke run: iterations of 24 steps a repetition
BENCH_ITERS, BENCH_REPS = 1, 1  # 2 repetitions before phase 18
MODEL_100000 = (policy_eval.WEIGHTS
                + "/pointfoot_rough_model_100000_actor.npz")
TRAIN_CHECK_ENVS = 256  # envs of a card rollout whose update the CPU redoes
# phase 15: the perturbed-start battery of tests/test_gait.py:246-290 at
# full width, 5 s; the JAX test allows 2 of 32 starts to fall, and the JAX
# package measured 3-4 falls per 64 at vx 0.4 (pointfoot_tpu/mpc/gait.py:
# 120-130), so the gate is twice the JAX bound
GAIT_SEED, GAIT_SIGMA, GAIT_VX = 2, 0.15, 0.4
GAIT_TICKS, GAIT_VX_FROM = 250, 100
GAIT_FALL_Z, GAIT_MAX_FALL_SHARE = 0.40, 1 / 8
# the A1 trot of tests/test_gait.py:395-437: 5 s at 200 Hz
A1_TICKS, A1_VX_FROM = 1000, 400
ILQR_CHUNK, ILQR_ITERS = 1024, 1  # bench --mode mpc_ilqr (2 before 18)
# [ilqr-check]: the card's solve against the CPU's, one chunk of perturbed
# scenarios, so that on the card the rollouts take kernel 5 and the 6144-row
# line search kernels 4 and 3, as in the bench; horizon 3, where a solve is
# well-conditioned.  The check prints how far a one-ulp nudge of the
# velocities moves the CPU's own solve; the tolerances are about ten times
# that: ((rtol, atol) of the controls, N·m), ((rtol, atol) of the costs)
ILQR_CHECK_ENVS, ILQR_CHECK_HORIZON, ILQR_CHECK_SEED = ILQR_CHUNK, 3, 5
ILQR_CHECK_TOL = ((0.0, 0.03), (5e-3, 0.0))
# [ilqr-witness]: the same scenarios at the bench's horizon 25, the card's
# kernel routes against its plain dynamics.step.  A horizon-25 solve from
# such states jumps to another local solution under roundoff (the witness
# prints how many scenarios a one-ulp nudge of the plain route's
# velocities moves), so the gate counts scenarios beyond ILQR_CHECK_TOL:
# the kernel routes may move no more of them, and flip no more improved
# flags, than either nudge of the plain route does.  Then the first
# scenarios at horizon 25, the card against the CPU: every scenario beyond
# the tolerance must be one that a one-ulp nudge of the card moves onto the
# CPU's solution
ILQR_WITNESS_HORIZON, ILQR_WITNESS_NUDGES = 25, (1, 2)
ILQR_WITNESS_CPU_ENVS, ILQR_WITNESS_CPU_NUDGES = 8, (1, 2, 3)
# tests/test_mpc.py:110-175 at 64 scenarios: a gate, sized for time
BALANCE_ENVS, BALANCE_TICKS = 64, 10
# phase 16, sys-ID: the identifier CLI's defaults (batch 64, window 400,
# warm-up 100, hidden 512) and the same step at full width, on kernel 1's
# route; every rollout drives the committed exported flat actor, the
# command 0.5 m/s.  The GAN CLI's defaults are 1 env, 400 + 100 steps and
# windows of 400, a host-bound step of ~4-5 minutes through the simulator
# and back (sysid_gans(policy, *GAN_DEFAULTS), PERF.md section 6), so the
# run steps the GAN and the WGAN at GAN_SMOKE's (length, warm-up), the
# window as long as the rollout.  The "real" windows are simulated at
# REAL_PARAMS (friction^6, mass, com^3)
SYSID_BATCH, SYSID_WINDOW, SYSID_WARMUP, SYSID_HIDDEN = 64, 400, 100, 512
GAN_DEFAULTS, GAN_SMOKE = (400, 100), (25, 12)  # (50, 12) before phase 18
SYSID_SEED, SYSID_CMD = 11, (0.5, 0.0, 0.0)
REAL_PARAMS = (0.02, 0.12, 0.05, 0.18, 0.08, 0.15, 0.8, 0.01, -0.01, 0.015)
FLAT_EXPORTED = "logs/pointfoot_flat/tpu_run7/exported/policy.pt"
# [sysid] card vs cpu: outputs and gradients of the four trainers' nets in
# float32 on the card, and on the CPU, against float64 on the CPU, as a
# share of each tensor's largest entry (float32 roundoff through up to 50
# LSTM steps).  The CPU's float32 may be off by more only where one of the
# net's LeakyReLU inputs lies within roundoff of the kink, so that its sign
# differs from float64's and the slope there (1 or 0.2) with it: on the
# H100's host the WGAN generator's gradients were 8% off through one input
# of 7.3e-8 that float32 rounded to -3.0e-8 (PERF.md section 6)
SYSID_NET_TOL = 1e-4
# phase 17, data parallelism: the registered pointfoot_rough (table
# terrain) at NUM_ENVS envs a rank, DP_RANKS ranks sharing the one card on
# gloo with CUDA tensors (nccl refuses two ranks on one device); the
# sharded rollout is checked on a state DP_STATE_STEPS random-action steps
# in; DP_WARM iterations before the timed one
DP_TASK, DP_RANKS, DP_SEED = "pointfoot_rough", 2, 7
DP_STATE_STEPS, DP_WARM, DP_ALLREDUCE_REPS = 5, 1, 20
DP_TIMEOUT_S = 300.0
# a moment of the DP update may lie this many times as far from one
# process's as that process's own update of observations one ulp away
WITNESS_FACTOR = 4.0
# phase 18, the last modules: bench --mode env_phases cut to one timed
# iteration of its 24 steps and one repetition, the settle loop kept but
# stopped after ENV_PHASES_SETTLE_MAX iterations (the bench's 8 took up to
# 43 s a variant);
# PROFILE_STEPS procedural env steps under utils.profiling.trace; play at
# each task's default width for PLAY_STEPS steps with the command PLAY_CMD
# pinned; TLOG_STEPS steps of the flagship logged; test_env for
# TEST_ENV_EPISODES x the episode length (50 steps); gait_diag for
# GAIT_DIAG_TICKS ticks at vx GAIT_VX; NativePolicy against the torch
# actor at the tolerance of tests/test_runtime.py:81
ENV_PHASES_ITERS, ENV_PHASES_SETTLE_MAX = 1, 4
PROFILE_STEPS, PROFILE_TOP = 3, 5
PLAY_STEPS, PLAY_CMD = 20, (0.4, 0.0, 0.0)
TLOG_STEPS = 50
TEST_ENV_EPISODES = 0.05
TEST_ENV_TIMEOUT_S = 300.0
GAIT_DIAG_TICKS = 25
NATIVE_POLICY_TOL = 2e-5
PHASE18_DIR = os.path.join("smoke_out", "phase18")  # gitignored
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")  # trace categories
# phase 19, the diagnostic CLIs: the catapult hunt's steps (the JAX
# script's default 3000 cut to fit the script's limit); the control-sequence
# comparison's ticks (its default 250 cut for the same reason); the contact
# experiments (the four take ~3,500 eager one-robot substeps); the golden
# anchor's tolerance (tests/test_golden_trajectory.py:49-50)
CATAPULT_STEPS = 1000
CTRLSEQ_STEPS = 100
# the JAX script's lines at CTRLSEQ_STEPS on a CPU, same actor and initial
# states (`JAX_PLATFORMS=cpu python scripts/ctrlseq_compare.py --steps
# 100`), and what the card's may differ by: the MPC's loop from its fixed
# state agrees to the printed digit; the RL loops amplify roundoff from
# tick to tick (tests/test_torch_diagnostics.py holds 60 ticks on the CPU)
CTRLSEQ_JAX = {"mpc_vx": 0.476, "rl_vx": 0.47, "normalized_rms": 2.057}
CTRLSEQ_TOL = {"mpc_vx": 2e-3, "rl_vx": 2e-2, "normalized_rms": 5e-2}
PROFILE_CALLS = 24  # profile_substep: 2 warm + 20 timed + flops + bytes
CONTACT_EXPERIMENTS = "static"
CONTACT_WEIGHT_TOL = 0.05  # share of the weight
GOLDEN_ATOL, GOLDEN_RTOL = 2e-3, 1e-4
STORM_LOG = os.path.join("logs", "pointfoot_rough", "tpu_r4_storm",
                         "metrics.jsonl")
# tests/test_torch_ppo.py: losses, KL and gradients (rtol, and atol scaled
# by the tensor's largest entry for gradients)
PPO_RTOL, PPO_ATOL = 1e-5, 1e-6
# Adam moments after the 20 steps: rtol 1e-4, atol 1e-5 of the tensor's
# largest entry, since each moment is a running mean of 20 gradients whose
# roundoff, each within PPO_RTOL, does not cancel (an H100 against the
# CPU: 3.2e-6 of the largest entry, exp_avg of the actor's first kernel)
ADAM_RTOL, ADAM_ATOL = 1e-4, 1e-5


def log(*args):
    print(*args, flush=True)


# ops that only move or view data; everything else counts one operation per
# output element
_MOVES = {"select", "slice", "view", "_unsafe_view", "reshape", "stack",
          "cat", "unbind", "expand", "clone", "_to_copy", "copy_", "empty",
          "empty_like", "full", "full_like", "zeros_like", "scalar_tensor",
          "lift_fresh", "detach", "alias", "t", "transpose", "permute",
          "unsqueeze", "squeeze", "as_strided", "contiguous"}


class _OpCount(TorchDispatchMode):
    """Counts the elementwise float operations a plain version performs
    (`ops`) and the aten operations it dispatches (`calls`)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _MOVES and \
                isinstance(out, torch.Tensor):
            self.ops += out.numel()
        return out


def count_ops(fn) -> int:
    with _OpCount() as c:
        fn()
    return c.ops


def count_calls(fn) -> int:
    """The aten operations fn dispatches (each ~10 µs of host time when the
    path is eager)."""
    with _OpCount() as c:
        fn()
    return c.calls


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def reset_counts():
    sp.reset_launch_counts()
    ch.chol_solve_lanes.launches = 0
    rk.srb_lqr_lanes.launches = 0


def read_counts() -> dict:
    return {"rollout_substep": sp.rollout_step.launches,
            "fk_from_state": sp.fk_rows.launches,
            "substep": sp.step_rows.launches,
            "fk_contact_xy": sp.fk_xy_rows.launches,
            "chol_solve": ch.chol_solve_lanes.launches,
            "srb_lqr": rk.srb_lqr_lanes.launches}


def expect_counts(got: dict, **want):
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"launch counts {got} != {full}")


def kernel_ms(fn) -> dict:
    """A kernel's time per launch: `ms` with its launches replayed from a
    CUDA graph (the device's time), `wrapper_ms` around a loop of calls of
    its wrapper (at least the host's time to enqueue one)."""
    return dict(wrapper_ms=cuda_ms(fn, 200), ms=graph_ms(fn))


def kernel_record(name, source, replaces, launches, err, ms, wrapper_ms,
                  plain_ms, nbytes, ops, library_ms=None):
    b_ms, b_by = bound(nbytes, ops)
    log(f"[kernels] {name}: {ms:.4f} ms/launch on the device, "
        f"{wrapper_ms:.4f} in a loop of wrapper calls (plain "
        f"{plain_ms:.2f} ms"
        + ("" if library_ms is None else f", library {library_ms:.4f} ms")
        + f"), {nbytes} B, {ops} ops, bound {b_ms:.5f} ms by {b_by}")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def ragged_columns(tensors, num: int):
    """The first `num` columns of (rows, B) tensors; beyond B the columns
    start over, so 4099 of 4096 repeats the first three."""
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        reps = -(-num // t.shape[1])
        out.append(torch.cat([t] * reps, dim=1)[:, :num].contiguous())
    return tuple(out)


def check_same_bits(what: str, fn):
    """Two launches on the same inputs give identical bits."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: two launches differ")
    log(f"[kernels] {what}: two launches give identical bits")


def take_rows(obj, idx):
    """Rows `idx` (an index tensor or a slice) of a PhysicsState or
    PhysicsParams, envs leading."""
    cls = type(obj)
    return cls(**{f: getattr(obj, f)[idx] for f in cls.__dataclass_fields__})


def check_finite(state, obs, num_envs, num_obs, what):
    for name in ("base_pos", "base_quat", "qpos", "qvel"):
        if not bool(torch.isfinite(getattr(state.physics, name)).all()):
            raise AssertionError(f"{what}: non-finite {name}")
    if obs.shape != (num_envs, num_obs) or \
            not bool(torch.isfinite(obs).all()):
        raise AssertionError(f"{what}: observations not finite or misshapen")


# ------------------------------------------------------------ 1. build

def build_kernels(mc_pf, mc_any, mc_a1):
    specs = [build.model_spec(mc_pf), build.model_spec(mc_any),
             build.model_spec(mc_a1), build.CHOLESKY_SPEC,
             build.RICCATI_SPEC]
    t0 = time.perf_counter()
    libs = build.build_all(specs)
    log(f"[build] {len(specs)} libraries in {time.perf_counter() - t0:.2f} "
        f"s wall (parallel nvcc)")
    for what, lib in zip(("PointFoot substep.cu", "ANYmal substep.cu",
                          "A1 substep.cu", "cholesky.cu", "riccati.cu"),
                         libs):
        log(f"[build] {what}: {lib.path}: {lib.build_seconds:.2f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build]   {line.strip()}")
    for what, lib in zip(("PointFoot", "ANYmal", "A1"), libs):
        warps = [lib.lib.pf_substep_resident_warps(k) for k in (0, 1)]
        log(f"[build] {what} substep kernels: "
            f"{lib.lib.pf_substep_smem_bytes()} B of dynamic shared memory a "
            f"block (8 envs, 4 lanes each)")
        log(f"[kernels] {what}: resident warps an SM "
            f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor): "
            f"rollout_substep_kernel {warps[0]}, substep_kernel {warps[1]}")
        if min(warps) < 1:
            raise AssertionError(f"{what}: a substep kernel does not fit an "
                                 f"SM: resident warps {warps}")
    fk_warps = libs[1].lib.pf_fk_xy_resident_warps()
    log(f"[kernels] ANYmal fk_contact_xy_kernel: 32 envs a block, a warp a "
        f"leg, resident warps an SM {fk_warps}")
    if fk_warps < 1:
        raise AssertionError("fk_contact_xy_kernel does not fit an SM")
    for what, lib in zip(("PointFoot", "ANYmal", "A1"), libs):
        warps = lib.lib.pf_fk_xyz_resident_warps()
        log(f"[kernels] {what} fk_from_state_kernel: 32 envs a block, a warp "
            f"a leg, resident warps an SM {warps}")
        if warps < 1:
            raise AssertionError(f"{what} fk_from_state_kernel does not fit "
                                 f"an SM")
    for n in ch.SIZES:
        chol_lib = libs[3].lib
        warps = chol_lib.pf_chol_resident_warps(n)
        log(f"[kernels] chol_solve_kernel<{n}>: {chol_lib.pf_chol_lanes(n)} "
            f"lanes a system, 16 systems a block, "
            f"{chol_lib.pf_chol_smem_bytes(n)} B of dynamic shared memory a "
            f"block, resident warps an SM {warps}")
        if warps < 1:
            raise AssertionError(f"chol_solve_kernel<{n}> does not fit an SM")
    for m in rk.SIZES:
        for horizon in (1, 12, LQR_LONG_HORIZON):
            nbytes, shared = rk.smem_plan(m, horizon)
            warps = libs[4].lib.pf_srb_lqr_resident_warps(m, horizon,
                                                          int(shared))
            log(f"[kernels] srb_lqr_kernel<{m}> horizon {horizon}: {nbytes} "
                f"B of dynamic shared memory a block (8 scenarios, 16 lanes "
                f"each), gains in "
                f"{'shared memory' if shared else 'the global work space'}, "
                f"resident warps an SM {warps}")
            if warps < 1:
                raise AssertionError(f"srb_lqr_kernel<{m}> does not fit an "
                                     f"SM at horizon {horizon}")


# ------------------------------------------ 2. PointFoot kernels vs plain

def check_rollout(got, want):
    """Hold a kernel rollout (phys, tau, sphere_pos) to the plain one:
    within the JAX tests' tolerances, and bit for bit, as the substep
    kernels do the plain version's operations in its order."""
    (gp, gt, gs), (wp, wt, ws) = got, want
    errs = {
        "qvel": max_err(gp.qvel, wp.qvel),
        "base_lin_vel": max_err(gp.base_lin_vel, wp.base_lin_vel),
        "base_pos": max_err(gp.base_pos, wp.base_pos),
        "tau": max_err(gt, wt),
        "sphere_pos": max_err(gs, ws),
    }
    for k, tol in ROLLOUT_TOL.items():
        if not errs[k] <= tol:
            raise AssertionError(f"rollout {k}: max |err| {errs[k]} > {tol}")
    f_err = (gp.contact_force - wp.contact_force).abs()
    f_tol = FORCE_ATOL + FORCE_RTOL * wp.contact_force.abs()
    if not bool((f_err <= f_tol).all()):
        raise AssertionError(
            f"rollout contact force: max |err| {float(f_err.max())} beyond "
            f"atol {FORCE_ATOL} + rtol {FORCE_RTOL}")
    errs["contact_force"] = float(f_err.max())
    for name in ("base_quat", "base_ang_vel", "qpos"):
        errs[name] = max_err(getattr(gp, name), getattr(wp, name))
    for v in errs.values():
        if not np.isfinite(v):
            raise AssertionError(f"non-finite rollout error {errs}")
    if not (all(torch.equal(getattr(gp, f), getattr(wp, f))
                for f in gp.__dataclass_fields__)
            and torch.equal(gt, wt) and torch.equal(gs, ws)):
        raise AssertionError(f"rollout: not bit-identical to the plain "
                             f"version, max |err| {errs}")
    return errs


def check_rollout_step(mc, step_args):
    """Hold one rollout substep to its plain version: (max |err| over all
    rows, over the state rows, over the forces, the kernel's extra rows)."""
    ks, ke = sp.rollout_step(*step_args)
    ps, pe = sp.rollout_step_plain(*step_args)
    torch.cuda.synchronize()
    nj, nc = mc.nj, mc.nc
    state_err = max_err(ks, ps)
    force_err = (ke[nj:nj + 3 * nc] - pe[nj:nj + 3 * nc]).abs()
    if ks.shape != ps.shape or ke.shape != pe.shape or not (
            state_err <= ROLLOUT_TOL["qvel"]
            and bool((force_err <= FORCE_ATOL + FORCE_RTOL
                      * pe[nj:nj + 3 * nc].abs()).all())
            and max_err(ke[:nj], pe[:nj]) <= ROLLOUT_TOL["tau"]
            and max_err(ke[nj + 3 * nc:], pe[nj + 3 * nc:])
            <= ROLLOUT_TOL["sphere_pos"]):
        raise AssertionError(
            f"rollout_step B={ks.shape[1]}: state {state_err}, forces "
            f"{float(force_err.max())}")
    if not (torch.equal(ks, ps) and torch.equal(ke, pe)):
        raise AssertionError(
            f"rollout_step B={ks.shape[1]}: not bit-identical to the plain "
            f"version, state {state_err}, forces {float(force_err.max())}")
    return (max(state_err, max_err(ke, pe)), state_err,
            float(force_err.max()), ke)


def check_fk_rows(mc, state_rows, what) -> float:
    """The sphere-xyz FK kernel does the plain version's operations in its
    order, so the two agree bit for bit: at the full width and the RAGGED
    batches, and two launches.  Returns the max |err| (0)."""
    err = 0.0
    for num in (state_rows.shape[1],) + RAGGED:
        part = ragged_columns((state_rows,), num)[0]
        got = sp.fk_rows(mc, part)
        want = sp.fk_rows_plain(mc, part)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(
                f"fk_rows {what} B={num}: not bit-identical to the plain "
                f"version, max |err| {max_err(got, want)}")
        err = max(err, max_err(got, want))
    check_same_bits(f"fk_from_state {what}",
                    lambda: sp.fk_rows(mc, state_rows))
    log(f"[kernels] fk_from_state {what}: bit-identical to the plain version "
        f"at B = {state_rows.shape[1]}, {', '.join(map(str, RAGGED))}")
    return err


def warm_with_push(env, policy, seed: int):
    """A state WARM_STEPS policy steps in with a push queued, and the
    policy's next actions."""
    state = env.init_state(0)
    obs = torch.zeros(NUM_ENVS, env.num_obs, device=env.device)
    for _ in range(WARM_STEPS):
        state, out = env.step(state, policy(obs))
        obs = out.obs
    g = torch.Generator(device=env.device).manual_seed(seed)
    push = 200.0 * (2.0 * torch.rand(NUM_ENVS, 3, generator=g,
                                     device=env.device) - 1.0)
    return state.replace(push_force=push), policy(obs)


def rollout_args(env, state, actions):
    """The arguments of `rollout_substeps` after its model: the env's
    state, actions, terrain and control."""
    c = env.cfg.control
    return (state.params, state.physics, actions, state.last_qvel,
            state.push_force, env.height_fn, env.cfg.sim.dt, c.decimation,
            env.default_qpos_values, c.action_scale, c.control_type,
            env.cfg.sim.gravity)


def check_env_rollout(env, state, actions, what: str):
    """The fused decimation rollout through the kernels against its plain
    version, on the env's own terrain."""
    roll_args = (env.model,) + rollout_args(env, state, actions)
    got = sp.rollout_substeps(*roll_args)
    want = sp.rollout_substeps_plain(*roll_args)
    torch.cuda.synchronize()
    errs = check_rollout(got, want)
    log(f"[kernels] rollout_substeps kernel vs plain, {what}, max |err|: "
        + json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))
    return errs


def pointfoot_kernels(env, mc, policy):
    state, actions = warm_with_push(env, policy, 5)
    c = env.cfg.control
    check_env_rollout(env, state, actions, "procedural terrain")

    # one substep and the FK, at the main path's shapes
    state_rows = sp.pack_state(state.physics, state.last_qvel)
    ctrl_rows = sp.pack_ctrl(actions, state.params, state.push_force)
    xyz = sp.fk_rows_plain(mc, state_rows)
    surf_rows = sp.surface_rows(env.height_fn, xyz, mc.nc)
    step_args = (mc, state_rows, ctrl_rows, surf_rows, True,
                 env.default_qpos_values, c.action_scale, c.control_type,
                 env.cfg.sim.dt, env.cfg.sim.gravity)
    step_err, state_err, force_err, ke = check_rollout_step(mc, step_args)
    for num in RAGGED:
        part = ragged_columns((state_rows, ctrl_rows, surf_rows), num)
        errs = check_rollout_step(mc, (mc, *part) + step_args[4:])
        log(f"[kernels] rollout_substep B={num}: max |err| {errs[0]:.3g} "
            f"(state rows {errs[1]:.3g}, forces {errs[2]:.3g})")
    check_same_bits("rollout_substep", lambda: sp.rollout_step(*step_args))
    nj, nc = mc.nj, mc.nc
    fk_err = check_fk_rows(mc, state_rows, "PointFoot")
    log(f"[kernels] rollout_substep max |err| {step_err:.3g} (state rows "
        f"{state_err:.3g}, forces {force_err:.3g}); "
        f"fk_from_state max |err| {fk_err:.3g}")

    R_state, R_ctrl = state_rows.shape[0], ctrl_rows.shape[0]
    roll = dict(
        err=step_err, **kernel_ms(lambda: sp.rollout_step(*step_args)),
        plain_ms=cuda_ms(lambda: sp.rollout_step_plain(*step_args), 3,
                         warmup=1),
        nbytes=4 * NUM_ENVS * (R_state + R_ctrl + surf_rows.shape[0]
                               + R_state + ke.shape[0]),
        ops=count_ops(lambda: sp.rollout_step_plain(*step_args)))
    # the FK reads base_pos, base_quat and qpos (7 + nj rows) and writes
    # 3·nc rows
    fk = dict(
        err=fk_err, **kernel_ms(lambda: sp.fk_rows(mc, state_rows)),
        plain_ms=cuda_ms(lambda: sp.fk_rows_plain(mc, state_rows), 5,
                         warmup=1),
        nbytes=4 * NUM_ENVS * (7 + nj + 3 * nc),
        ops=count_ops(lambda: sp.fk_rows_plain(mc, state_rows)))
    return roll, fk, state, xyz


# ------------------------------------ 3. step_batched's kernels vs plain

def bench_signal(env, seed: int = 0):
    """bench.py's deterministic action signal 0.2 sin(phase + 0.1 t)."""
    g = torch.Generator(device=env.device).manual_seed(seed)
    phase = 6.28 * torch.rand(env.num_envs, env.num_actions, generator=g,
                              device=env.device)
    return lambda t: 0.2 * torch.sin(phase + 0.1 * t)


def step_errors(got: PhysicsState, want: PhysicsState):
    """Per field: (max |err|, largest share of the allowed error) and the
    (B,) mask of envs beyond STEP_TOL."""
    out, beyond = {}, None
    for name, (atol, rtol) in STEP_TOL.items():
        g, w = getattr(got, name), getattr(want, name)
        err = (g - w).abs()
        share = (err / (atol + rtol * w.abs())).reshape(g.shape[0], -1)
        out[name] = (float(err.max()), float(share.max()))
        over = (share > 1.0).any(-1)
        beyond = over if beyond is None else beyond | over
    return out, beyond


def sphere_surface(env, phys, params):
    """The surface under each sphere where the plain path queries it: at
    positions from dynamics.forward_kinematics, in world coordinates."""
    m = env.model
    kin = dynamics.forward_kinematics(m, phys, params)
    p = torch.stack([kin.body_pos[:, b] + kin.body_rot[:, b]
                     @ m.collision_offset[c]
                     for c, b in enumerate(m.collision_body)], dim=1)
    return query_surface(env.height_fn, p[..., 0], p[..., 1])


def velocity_system(env, phys, params, tau):
    """(A_t (nv·nv, B), b_t (nv, B)) that assemble_velocity_solve builds."""
    A, rhs, _ = dynamics.assemble_velocity_solve(
        env.model, params, phys, tau, env.height_fn, env.cfg.sim.dt,
        torch.zeros_like(phys.base_pos), None, env.cfg.sim.gravity)
    B, nv = rhs.shape
    return A.reshape(B, nv * nv).t().contiguous(), rhs.t().contiguous()


def check_cholesky(A_t, b_t, what):
    """The kernel does the plain version's operations in its order, so the
    two agree bit for bit."""
    x_k = ch.chol_solve_lanes(A_t, b_t)
    x_p = ch.chol_solve_lanes_plain(A_t, b_t)
    torch.cuda.synchronize()
    err = max_err(x_k, x_p)
    if not torch.equal(x_k, x_p):
        raise AssertionError(f"chol_solve {what}: not bit-identical to the "
                             f"plain version, max |err| {err}")
    log(f"[kernels] chol_solve {what}: bit-identical to the plain version")
    return err


def check_step_rows(mc, in_rows, surf_rows, dt, grav):
    """Hold the substep kernel to its plain twin on the same rows, field by
    field within STEP_TOL and bit for bit: (kernel rows, max |err|, max
    |err| over the state rows)."""
    k_rows = sp.step_rows(mc, in_rows, surf_rows, dt, grav)
    p_rows = sp.step_rows_plain(mc, in_rows, surf_rows, dt, grav)
    torch.cuda.synchronize()
    if k_rows.shape != p_rows.shape or \
            not bool(torch.isfinite(k_rows).all()):
        raise AssertionError(f"substep kernel: shape {tuple(k_rows.shape)} "
                             f"or non-finite rows")
    row = 0
    for name, cnt in sp.substep_out_layout(mc.nj, mc.nc):
        atol, rtol = STEP_TOL[name]
        g, w = k_rows[row:row + cnt], p_rows[row:row + cnt]
        if not bool(((g - w).abs() <= atol + rtol * w.abs()).all()):
            raise AssertionError(
                f"substep kernel vs plain twin B={k_rows.shape[1]}: {name} "
                f"max |err| {max_err(g, w)} beyond atol {atol}, rtol {rtol}")
        row += cnt
    if not torch.equal(k_rows, p_rows):
        raise AssertionError(
            f"substep kernel vs plain twin B={k_rows.shape[1]}: not "
            f"bit-identical, max |err| {max_err(k_rows, p_rows)}")
    n_state = 13 + 2 * mc.nj
    return (k_rows, max_err(k_rows, p_rows),
            max_err(k_rows[:n_state], p_rows[:n_state]))


def check_route(env, phys, params, tau, push, what: str):
    """The mega-kernel route of step_batched against the plain path on the
    same device and state, and the same terrain under each sphere: the
    route's query at the FK-xy kernel's positions.  Returns those positions
    and the surface there."""
    dt, grav = env.cfg.sim.dt, env.cfg.sim.gravity
    got = dynamics.step_batched(env.model, params, phys, tau, env.height_fn,
                                dt, external_force=push, gravity=grav)
    xy = sp.fk_contact_xy(env.model, phys)
    surface = query_surface(env.height_fn, xy[..., 0], xy[..., 1])
    want = dynamics.step(env.model, params, phys, tau, env.height_fn, dt,
                         external_force=push, gravity=grav, surface=surface)
    torch.cuda.synchronize()
    route, beyond = step_errors(got, want)
    log(f"[kernels] step_batched mega-kernel route vs plain path on {what} "
        f"terrain, same surface, max |err| (share of tolerance): "
        + json.dumps({k: f"{e:.3g} ({100 * s:.2g}%)"
                      for k, (e, s) in route.items()}))
    if bool(beyond.any()):
        raise AssertionError(f"step_batched {what}: {int(beyond.sum())} envs "
                             f"beyond the tolerances {STEP_TOL}: {route}")
    # the plain path querying the terrain itself places each sphere in world
    # coordinates, a few ulp (~1e-5 m at 100 m) from the route's base-
    # relative FK: every env that then leaves the tolerance must be one
    # whose terrain under a sphere differs between the two queries
    own = dynamics.step(env.model, params, phys, tau, env.height_fn, dt,
                        external_force=push, gravity=grav)
    h_own, n_own = sphere_surface(env, phys, params)
    d_h = (h_own - surface[0]).abs().amax(-1)
    d_n = (n_own - surface[1]).abs().amax((-1, -2))
    moved = (d_h > 1e-6) | (d_n > 1e-6)
    _, beyond_own = step_errors(got, own)
    if bool((beyond_own & ~moved).any()):
        raise AssertionError(
            f"step_batched vs the plain path's own terrain query ({what}): "
            f"{int((beyond_own & ~moved).sum())} envs beyond the tolerances "
            f"with the same terrain under every sphere")
    log(f"[kernels] step_batched vs the plain path's own terrain query "
        f"({what}): {int(beyond_own.sum())} of {NUM_ENVS} envs beyond the "
        f"tolerances, all with other terrain under a sphere "
        f"({int(moved.sum())} envs see a height or normal >1e-6 apart; "
        f"{int((d_n > 0.1).sum())} a normal flipped at a cell edge)")
    return xy, surface


def anymal_inputs(env, seed: int):
    """A state WARM_STEPS steps of the bench signal in, a push, and the
    actuator network's torque for the next step."""
    signal = bench_signal(env)
    state = env.init_state(0)
    for t in range(WARM_STEPS):
        state, _ = env.step(state, signal(t))
    g = torch.Generator(device=env.device).manual_seed(seed)
    push = 200.0 * (2.0 * torch.rand(NUM_ENVS, 3, generator=g,
                                     device=env.device) - 1.0)
    phys = state.physics
    c = env.cfg.control
    pos_err = signal(WARM_STEPS) * c.action_scale + env.default_qpos \
        - phys.qpos
    tau, _ = act.actuator_net_torque(env.actuator_weights,
                                     state.actuator_carry, pos_err,
                                     phys.qvel)
    tau = torch.clamp(tau, -env.torque_limit, env.torque_limit)
    return state, signal, push, tau


def check_substep_and_fk_xy(mc, phys, params, tau, push, surface, dt, grav,
                            what: str):
    """The substep kernel against its plain twin on the same rows, and the
    FK-xy kernel bit for bit, at the full width and the RAGGED batches and
    two launches; returns the rows and the max |err|s."""
    in_rows = sp.pack_substep_in(phys, params, tau, push)
    surf_rows = sp.pack_surface(surface)
    k_rows, sub_err, sub_state_err = check_step_rows(
        mc, in_rows, surf_rows, dt, grav)
    for num in RAGGED:
        part = ragged_columns((in_rows, surf_rows), num)
        errs = check_step_rows(mc, *part, dt, grav)[1:]
        log(f"[kernels] substep kernel vs plain twin, {what}, B={num}: max "
            f"|err| {errs[0]:.3g} (state rows {errs[1]:.3g})")
    check_same_bits(f"substep {what}",
                    lambda: sp.step_rows(mc, in_rows, surf_rows, dt, grav))
    fk_in = sp.pack_fk_in(phys)
    xy_err = 0.0
    for num in (fk_in.shape[1],) + RAGGED:
        part = ragged_columns((fk_in,), num)[0]
        xy_k = sp.fk_xy_rows(mc, part)
        xy_p = sp.fk_xy_rows_plain(mc, part)
        torch.cuda.synchronize()
        err = max_err(xy_k, xy_p)
        if xy_k.shape != xy_p.shape or not torch.equal(xy_k, xy_p):
            raise AssertionError(f"fk_contact_xy {what} B={num}: not "
                                 f"bit-identical to the plain version, max "
                                 f"|err| {err}")
        log(f"[kernels] fk_contact_xy {what} B={num}: max |err| {err:.3g}")
        xy_err = max(xy_err, err)
    check_same_bits(f"fk_contact_xy {what}",
                    lambda: sp.fk_xy_rows(mc, fk_in))
    log(f"[kernels] substep kernel vs plain twin, {what}, max |err| "
        f"{sub_err:.3g} (state rows {sub_state_err:.3g}); fk_contact_xy max "
        f"|err| {xy_err:.3g}")
    return in_rows, surf_rows, k_rows, fk_in, sub_err, xy_err


def anymal_kernels(env, mc, pf_env, pf_state):
    state, signal, push, tau = anymal_inputs(env, 6)
    phys, params = state.physics, state.params
    dt, grav = env.cfg.sim.dt, env.cfg.sim.gravity

    xy, surface = check_route(env, phys, params, tau, push, "procedural")

    in_rows, surf_rows, k_rows, fk_in, sub_err, xy_err = \
        check_substep_and_fk_xy(mc, phys, params, tau, push, surface, dt,
                                grav, "procedural terrain")
    check_fk_rows(mc, sp.pack_state(phys, phys.qvel), "ANYmal")
    nj, nc = mc.nj, mc.nc

    sub = dict(
        err=sub_err,
        **kernel_ms(lambda: sp.step_rows(mc, in_rows, surf_rows, dt, grav)),
        plain_ms=cuda_ms(lambda: sp.step_rows_plain(
            mc, in_rows, surf_rows, dt, grav), 2, warmup=1),
        nbytes=4 * NUM_ENVS * (in_rows.shape[0] + surf_rows.shape[0]
                               + k_rows.shape[0]),
        ops=count_ops(lambda: sp.step_rows_plain(mc, in_rows, surf_rows, dt,
                                                 grav)))
    fkxy = dict(
        err=xy_err, **kernel_ms(lambda: sp.fk_xy_rows(mc, fk_in)),
        plain_ms=cuda_ms(lambda: sp.fk_xy_rows_plain(mc, fk_in), 5,
                         warmup=1),
        # base_pos x, y, base_quat and qpos in (base_pos z does not move a
        # sphere's xy), 2·nc rows out
        nbytes=4 * NUM_ENVS * (6 + nj + 2 * nc),
        ops=count_ops(lambda: sp.fk_xy_rows_plain(mc, fk_in)))

    # the Cholesky kernel on the velocity systems of 2048 envs of each robot
    n = CHOL_ENVS
    A_t, b_t = velocity_system(env, take_rows(phys, slice(n)),
                               take_rows(params, slice(n)), tau[:n])
    pf_A, pf_b = velocity_system(
        pf_env, take_rows(pf_state.physics, slice(n)),
        take_rows(pf_state.params, slice(n)), pf_state.torques[:n])
    chol_err = 0.0
    for At, bt, what in ((A_t, b_t, "ANYmal n=18"),
                         (pf_A, pf_b, "PointFoot n=12")):
        for num in (n,) + RAGGED:
            chol_err = max(chol_err, check_cholesky(
                *ragged_columns((At, bt), num), f"{what} B={num}"))
        check_same_bits(f"chol_solve {what}",
                        lambda: ch.chol_solve_lanes(At, bt))
    nv = 18
    A = A_t.t().reshape(n, nv, nv).contiguous()
    b = b_t.t().contiguous()

    def library():
        return torch.cholesky_solve(b[..., None], torch.linalg.cholesky(A))

    chol = dict(
        err=chol_err, **kernel_ms(lambda: ch.chol_solve_lanes(A_t, b_t)),
        plain_ms=cuda_ms(lambda: ch.chol_solve_lanes_plain(A_t, b_t), 5,
                         warmup=1),
        nbytes=ch.chol_solve_bytes(nv, n),
        ops=count_ops(lambda: ch.chol_solve_lanes_plain(A_t, b_t)),
        library_ms=cuda_ms(library, 50))
    pf_ms = kernel_ms(lambda: ch.chol_solve_lanes(pf_A, pf_b))
    log(f"[kernels] chol_solve at PointFoot n=12 B={n}: {pf_ms['ms']:.4f} "
        f"ms/launch on the device, {pf_ms['wrapper_ms']:.4f} in a loop of "
        f"wrapper calls")
    layers_in = dict(state=state, signal=signal, xy=xy, tau=tau, push=push)
    return sub, fkxy, chol, layers_in


# ---------------------------------------------- 4. PointFoot at full width

def timed_steps(env, state, act, steps: int, tag: str, label: str):
    """One warm step from `state`, then `steps` timed env steps with the
    launch counts zeroed just before them; logs the rate and checks the
    final state.  `act(t, obs)` gives the actions of step t.  Returns
    (state, out, launches)."""
    obs = torch.zeros(NUM_ENVS, env.num_obs, device=env.device)
    state, out = env.step(state, act(0, obs))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    falls = torch.zeros((), dtype=torch.int64, device=env.device)
    for t in range(1, steps + 1):
        state, out = env.step(state, act(t, out.obs))
        falls += out.extras["terminate"].sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    check_finite(state, out.obs, NUM_ENVS, env.num_obs, label)
    log(f"[{tag}] {label} {steps} steps x {NUM_ENVS} envs in {wall:.2f} s: "
        f"{steps * NUM_ENVS / wall:.0f} env-steps/s, "
        f"{wall / steps * 1e3:.2f} ms/step, terminations {int(falls)}, "
        f"launches {launches}")
    return state, out, launches


def log_layers(label: str, layers: dict):
    log(f"[layers] {label} ms: " + json.dumps(
        {k: round(v, 3) for k, v in layers.items()}))


def pointfoot_rollout(env, mc, policy, xyz):
    c = env.cfg.control
    state, out, launches = timed_steps(
        env, env.init_state(1), lambda t, obs: policy(obs), ROLLOUT_STEPS,
        "rollout", "pointfoot_rough")
    expect_counts(launches, rollout_substep=c.decimation * ROLLOUT_STEPS,
                  fk_from_state=ROLLOUT_STEPS)

    obs = out.obs
    acts = policy(obs)
    layers = {
        "env.step": cuda_ms(lambda: env.step(state, acts), 10),
        "policy": cuda_ms(lambda: policy(obs), 20),
        "physics rollout (kernels + surface queries)": cuda_ms(
            lambda: env._physics_rollout(state, acts), 10),
        "surface query (one substep)": cuda_ms(
            lambda: sp.surface_rows(env.height_fn, xyz, mc.nc), 10),
        "height scan (121 points)": cuda_ms(
            lambda: env._measured_heights(state.physics), 10),
    }
    log_layers("pointfoot_rough", layers)

    probe_env = policy_eval.make_eval_env(
        "pointfoot_rough", NUM_ENVS, policy_eval.FLAGSHIP_PATCH)
    rec = policy_eval.eval_config(probe_env, policy, 0, 0.4, secs=6.0)
    log(f"[probe] {json.dumps(rec)}")
    if not (rec["falls"] <= NUM_ENVS and rec["mean_vx"] >= 0.15):
        raise AssertionError(f"probe outside its band: {rec}")
    return launches, state


# -------------------------------------------- 5. anymal_c_rough, 4096 envs

def anymal_rollout(env, lay):
    c = env.cfg.control
    signal = lay["signal"]
    state, out, launches = timed_steps(
        env, env.init_state(1), lambda t, obs: signal(t), ANYMAL_STEPS,
        "anymal", "anymal_c_rough")
    expect_counts(launches, substep=c.decimation * ANYMAL_STEPS,
                  fk_contact_xy=c.decimation * ANYMAL_STEPS)
    if not bool(torch.isfinite(out.reward).all()):
        raise AssertionError("anymal rollout: non-finite reward")

    # where a step's time goes, by layer (CUDA events, same state)
    phys, params = state.physics, state.params
    a = signal(0)
    pos_err = a * c.action_scale + env.default_qpos - phys.qpos
    xy = lay["xy"]
    layers = {
        "env.step": cuda_ms(lambda: env.step(state, a), 10),
        "actuator net (one substep)": cuda_ms(
            lambda: act.actuator_net_torque(
                env.actuator_weights, state.actuator_carry, pos_err,
                phys.qvel), 20),
        "step_batched (kernels + surface query, one substep)": cuda_ms(
            lambda: dynamics.step_batched(
                env.model, params, phys, lay["tau"], env.height_fn,
                env.cfg.sim.dt, external_force=lay["push"],
                gravity=env.cfg.sim.gravity), 20),
        "surface query (13 spheres)": cuda_ms(
            lambda: query_surface(env.height_fn, xy[..., 0], xy[..., 1]),
            20),
        "height scan (187 points)": cuda_ms(
            lambda: env._measured_heights(phys), 10),
    }
    log_layers("anymal_c_rough", layers)
    return launches


def physical_gate():
    env = make_env("anymal_c_rough", num_envs=NUM_ENVS, cfg_patch=GATE_PATCH)
    state = env.init_state(2)
    zeros = torch.zeros(NUM_ENVS, env.num_actions, device=env.device)
    terminated = torch.zeros(NUM_ENVS, dtype=torch.bool, device=env.device)
    for _ in range(GATE_STEPS):
        state, out = env.step(state, zeros)
        terminated |= out.extras["terminate"]
    p = state.physics.base_pos
    h = p[:, 2] - env.terrain.height_at(p[:, 0], p[:, 1])
    rec = {"mean_height": float(h.mean()), "min_height": float(h.min()),
           "terminated": float(terminated.float().mean()),
           "levels": sorted({int(v) for v in state.terrain_level})}
    log(f"[gate] anymal_c_rough level 0, zero actions, 2 s: "
        f"{json.dumps(rec)}")
    lo, hi = GATE_MEAN_HEIGHT
    if not (lo <= rec["mean_height"] <= hi
            and rec["terminated"] <= GATE_MAX_TERMINATED):
        raise AssertionError(f"physical gate outside its band: {rec}")


# ---------------------------------- 6. the Cholesky route, 2048 envs

def cholesky_route():
    env = make_env("anymal_c_rough", num_envs=CHOL_ENVS,
                   cfg_patch=ANYMAL_PATCH)
    signal = bench_signal(env)
    state = env.init_state(3)
    state, _ = env.step(state, signal(0))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for t in range(1, CHOL_STEPS + 1):
        state, out = env.step(state, signal(t))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    expect_counts(launches,
                  chol_solve=env.cfg.control.decimation * CHOL_STEPS)
    check_finite(state, out.obs, CHOL_ENVS, env.num_obs, "cholesky route")
    log(f"[cholesky-route] anymal_c_rough {CHOL_STEPS} steps x {CHOL_ENVS} "
        f"envs in {wall:.2f} s: {CHOL_STEPS * CHOL_ENVS / wall:.0f} "
        f"env-steps/s, {wall / CHOL_STEPS * 1e3:.2f} ms/step, launches "
        f"{launches}")

    # one substep of step_batched's Cholesky route, by layer (CUDA events,
    # same state)
    phys, params = state.physics, state.params
    c, dt, grav = env.cfg.control, env.cfg.sim.dt, env.cfg.sim.gravity
    a = signal(0)
    pos_err = a * c.action_scale + env.default_qpos - phys.qpos
    tau, _ = act.actuator_net_torque(env.actuator_weights,
                                     state.actuator_carry, pos_err,
                                     phys.qvel)
    tau = torch.clamp(tau, -env.torque_limit, env.torque_limit)
    ext = torch.zeros_like(phys.base_pos)

    def assemble():
        return dynamics.assemble_velocity_solve(
            env.model, params, phys, tau, env.height_fn, dt, ext, None, grav)

    A, rhs, terms = assemble()
    nv = rhs.shape[1]

    def stage():
        return (A.reshape(CHOL_ENVS, nv * nv).t().contiguous(),
                rhs.t().contiguous())

    A_t, b_t = stage()
    u_new = ch.chol_solve_lanes(A_t, b_t).t()
    kernel = kernel_ms(lambda: ch.chol_solve_lanes(A_t, b_t))
    layers = {
        "env.step": cuda_ms(lambda: env.step(state, a), 5),
        "step_batched (one substep)": cuda_ms(
            lambda: dynamics.step_batched(env.model, params, phys, tau,
                                          env.height_fn, dt, gravity=grav),
            10),
        "assemble_velocity_solve": cuda_ms(assemble, 10),
        "staging A, b to (rows, B)": cuda_ms(stage, 20),
        "Cholesky kernel (device)": kernel["ms"],
        "Cholesky kernel (wrapper loop)": kernel["wrapper_ms"],
        "finish_step": cuda_ms(
            lambda: dynamics.finish_step(env.model, phys, u_new, terms, dt),
            10),
    }
    share = layers["Cholesky kernel (device)"] / \
        layers["step_batched (one substep)"]
    log("[layers] anymal_c_rough 2048 envs, Cholesky route ms: " + json.dumps(
        {k: round(v, 4) for k, v in layers.items()})
        + f"; the kernel is {100 * share:.3g}% of a substep")
    return launches


# ------------------------------------------ 7. the SRB-LQR kernel vs plain

def mpc_scenarios(ctrl, num: int, qdef, height: float, seed: int):
    """`num` scenarios at the default pose with a seeded velocity
    perturbation and commands; 30 N on every foot, and on none in every
    fourth scenario, which the contact gate turns back into full stance."""
    dev = ctrl.default_qpos.device
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    phys = PhysicsState.default(ctrl.model, qdef, num, dev,
                                base_height=height)
    force = torch.zeros_like(phys.contact_force)
    force[:, list(ctrl.feet_idx), 2] = 30.0
    force[::4] = 0.0
    lin = 0.1 * randn(num, 3)
    lin[:, 1] += 0.2
    phys = phys.replace(base_lin_vel=lin, base_ang_vel=0.1 * randn(num, 3),
                        qvel=0.2 * randn(num, ctrl.model.nj),
                        contact_force=force)
    return phys, 0.3 * randn(num, 3)


def check_srb_lqr(staged, horizon: int, what: str,
                  sizes=None) -> float:
    """Hold the kernel to its plain version on staged problems, at the full
    batch and at the RAGGED ones (or at `sizes`)."""
    worst = 0.0
    for num in sizes or (staged[1].shape[1],) + RAGGED:
        part = ragged_columns(staged, num)
        got = rk.srb_lqr_lanes(*part, horizon)
        want = rk.srb_lqr_lanes_plain(*part, horizon)
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"srb_lqr {what} B={num}: shape "
                                 f"{tuple(got.shape)} or non-finite forces")
        err = (got - want).abs()
        share = float((err / (LQR_TOL + LQR_TOL * want.abs())).max())
        if not share <= 1.0:
            raise AssertionError(
                f"srb_lqr {what} B={num}: max |err| {float(err.max())} "
                f"beyond rtol/atol {LQR_TOL}")
        log(f"[kernels] srb_lqr {what} horizon {horizon} B={num}: max |err| "
            f"{float(err.max()):.3g} of forces up to "
            f"{float(want.abs().max()):.3g} ({100 * share:.2g}% of the "
            f"tolerance)")
        worst = max(worst, float(err.max()))
    return worst


def riccati_kernels(pf_ctrl, a1_ctrl):
    dev = pf_ctrl.default_qpos.device
    T = pf_ctrl.cfg.horizon
    pf_phys, pf_cmd = mpc_scenarios(pf_ctrl, NUM_ENVS, [0.0] * 6, 0.62, 7)
    pf_prob = pf_ctrl.tick_problem(pf_phys, pf_cmd)[0]
    pf_staged = rk.stage(*pf_prob)
    err = check_srb_lqr(pf_staged, T, "PointFoot tick problems m=6")
    a1_phys, a1_cmd = mpc_scenarios(a1_ctrl, NUM_ENVS, A1_QDEF, 0.28, 8)
    a1_staged = rk.stage(*a1_ctrl.tick_problem(a1_phys, a1_cmd)[0])
    err = max(err, check_srb_lqr(a1_staged, T, "A1 tick problems m=12"))
    for m in rk.SIZES:
        dense = dense_problem(m, NUM_ENVS, 9 + m, dev)
        err = max(err, check_srb_lqr(dense, T, f"random dense m={m}"))
    # both homes of the gains: one step, and a horizon that no longer fits
    # in a block's shared memory
    for staged, what in ((pf_staged, "PointFoot tick problems m=6"),
                         (a1_staged, "A1 tick problems m=12")):
        m = staged[4].shape[0]
        if not rk.smem_plan(m, T)[1] or not rk.smem_plan(m, 1)[1] or \
                rk.smem_plan(m, LQR_LONG_HORIZON)[1]:
            raise AssertionError(
                f"smem_plan: m = {m} should keep the gains in shared memory "
                f"at horizons 1 and {T} and not at {LQR_LONG_HORIZON}")
        for horizon in (1, LQR_LONG_HORIZON):
            err = max(err, check_srb_lqr(staged, horizon, what,
                                         sizes=(RAGGED[0],)))
    check_same_bits("srb_lqr m=6",
                    lambda: rk.srb_lqr_lanes(*pf_staged, T))
    check_same_bits("srb_lqr m=12",
                    lambda: rk.srb_lqr_lanes(*a1_staged, T))
    check_same_bits(
        f"srb_lqr m=6 horizon {LQR_LONG_HORIZON}",
        lambda: rk.srb_lqr_lanes(*pf_staged, LQR_LONG_HORIZON))

    # per launch, at the main path's shapes: the PointFoot problems
    n, m = 12, pf_staged[4].shape[0]
    rec = dict(
        err=err, **kernel_ms(lambda: rk.srb_lqr_lanes(*pf_staged, T)),
        plain_ms=cuda_ms(lambda: rk.srb_lqr_lanes_plain(*pf_staged, T), 3,
                         warmup=1),
        nbytes=4 * NUM_ENVS * (n * n + n * m + 4 * n + 2 * m + T * m),
        ops=count_ops(lambda: rk.srb_lqr_lanes_plain(*pf_staged, T)))
    a1_ms = graph_ms(lambda: rk.srb_lqr_lanes(*a1_staged, T))
    seq_ms = cuda_ms(lambda: srb.sequential_srb_lqr(*pf_prob, horizon=T), 3,
                     warmup=1)
    log(f"[kernels] srb_lqr at A1 m=12 B={NUM_ENVS}: {a1_ms:.4f} ms/launch "
        f"on the device")
    log(f"[kernels] sequential Riccati solver (plan_tick's) on the PointFoot "
        f"problems: {seq_ms:.2f} ms (no single PyTorch call computes the "
        f"solve: library_ms is null)")
    return rec


# ------------------------------------------------ 8. the SRB-MPC tick

def check_close(got, want, rtol, atol, what):
    err = (got - want).abs()
    share = float((err / (atol + rtol * want.abs())).max())
    if not share <= 1.0 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: max |err| {float(err.max())} beyond "
                             f"rtol {rtol} / atol {atol}")
    return float(err.max()), share


def mpc_tick(pf_ctrl, kernel_ms: float):
    torch.cuda.synchronize()
    reset_counts()
    rec = bench.main_mpc(NUM_ENVS, iters=MPC_ITERS, reps=MPC_REPS,
                         solver="kernel")
    launches = read_counts()
    ticks = 1 + MPC_ITERS * MPC_REPS  # the warm-up tick and the timed ones
    expect_counts(launches, srb_lqr=ticks)
    if rec["metric"] != f"srb_mpc_scenario_solves_per_sec@{NUM_ENVS}" or \
            rec["conditions"]["horizon"] != 12 or not rec["value"] > 0:
        raise AssertionError(f"bench record {rec}")
    log(f"[mpc] SRB-MPC tick, PointFoot, {NUM_ENVS} scenarios, horizon "
        f"{rec['conditions']['horizon']}: {rec['value']:.0f} solves/s, "
        f"{NUM_ENVS / rec['value'] * 1e3:.2f} ms/tick, "
        f"{rec['vs_baseline']:.4f} x real time ({NUM_ENVS} x 50 Hz), "
        f"launches {launches}")

    cfg = pf_ctrl.cfg
    phys, cmd = mpc_scenarios(pf_ctrl, NUM_ENVS, [0.0] * 6, 0.62, 17)
    tau_k, fs_k = pf_ctrl.plan_tick_cuda(phys, cmd)
    tau_p, plan = pf_ctrl.plan_tick(phys, cmd)
    torch.cuda.synchronize()
    nf = len(pf_ctrl.feet_idx)
    if tau_k.shape != (NUM_ENVS, pf_ctrl.model.nj) or \
            fs_k.shape != (NUM_ENVS, cfg.horizon, nf, 3):
        raise AssertionError(f"tick shapes {tuple(tau_k.shape)}, "
                             f"{tuple(fs_k.shape)}")
    tau_err, tau_share = check_close(tau_k, tau_p, *TICK_TAU_TOL,
                                     "kernel tick vs plain tick, torques")
    f_err, f_share = check_close(fs_k[:, 0], plan.forces[:, 0],
                                 *TICK_FORCE_TOL,
                                 "kernel tick vs plain tick, first forces")
    log(f"[mpc] kernel tick vs sequential-solver tick on {NUM_ENVS} "
        f"perturbed states: torques max |err| {tau_err:.3g} N·m "
        f"({100 * tau_share:.2g}% of the tolerance), first forces "
        f"{f_err:.3g} N ({100 * f_share:.2g}%)")

    prob, ct, kin = pf_ctrl.tick_problem(phys, cmd)
    raw = rk.srb_lqr(*prob, horizon=cfg.horizon).reshape(
        NUM_ENVS, cfg.horizon, nf, 3)
    layers = {
        "tick (plan_tick_cuda)": cuda_ms(
            lambda: pf_ctrl.plan_tick_cuda(phys, cmd), 10),
        "FK + problem assembly": cuda_ms(
            lambda: pf_ctrl.tick_problem(phys, cmd), 10),
        "staging to (rows, B)": cuda_ms(lambda: rk.stage(*prob), 20),
        "SRB-LQR kernel": kernel_ms,
        "cone projection": cuda_ms(
            lambda: srb._project_cone(raw, cfg), 20),
        "leg_torques": cuda_ms(
            lambda: pf_ctrl.leg_torques(phys, fs_k[:, 0], ct, kin=kin), 10),
        "tick with the sequential solver (plan_tick)": cuda_ms(
            lambda: pf_ctrl.plan_tick(phys, cmd), 3, warmup=1),
    }
    log_layers("SRB-MPC tick", layers)
    return launches


# ------------------------------------------------ 9. the closed-loop gate

def _flat_ground(x, y):
    return torch.zeros_like(x)


_flat_ground.is_flat = True


def srb_gate(a1_model):
    dev = a1_model.mass.device
    params = PhysicsParams.nominal(a1_model, NUM_ENVS, dev)
    ctrl = srb.SRBController(a1_model, params,
                             a1_model.collision_indices("foot"), A1_QDEF,
                             srb.SRBConfig(**SRB_GATE_CFG))
    phys = PhysicsState.default(ctrl.model, A1_QDEF, NUM_ENVS, dev,
                                base_height=0.29)
    lin = torch.zeros_like(phys.base_lin_vel)
    lin[:, 1] = 0.3
    phys = phys.replace(base_lin_vel=lin)
    command = torch.zeros(NUM_ENVS, 3, device=dev)
    min_z = torch.full((NUM_ENVS,), float("inf"), device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(SRB_GATE_TICKS):
        _, fs = ctrl.plan_tick_cuda(phys, command)
        contact = ctrl.feet_and_contact(phys)[2]
        for _ in range(SRB_GATE_SUBSTEPS):
            # 200 Hz leg loop: remap the held plan force each substep
            tau = ctrl.leg_torques(phys, fs[:, 0], contact)
            phys = dynamics.step_batched(ctrl.model, params, phys, tau,
                                         _flat_ground, SRB_GATE_DT)
        min_z = torch.minimum(min_z, phys.base_pos[:, 2])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_counts(read_counts(), srb_lqr=SRB_GATE_TICKS,
                  substep=SRB_GATE_TICKS * SRB_GATE_SUBSTEPS)
    rec = {"min_height": float(min_z.min()),
           "min_abs_quat_w": float(phys.base_quat[:, 3].abs().min()),
           "max_final_speed": float(
               torch.linalg.vector_norm(phys.base_lin_vel, dim=-1).max())}
    log(f"[srb-gate] A1, {NUM_ENVS} scenarios, flat ground, lateral 0.3 m/s, "
        f"{SRB_GATE_TICKS} ticks x {SRB_GATE_SUBSTEPS} substeps in "
        f"{wall:.2f} s: {json.dumps(rec)}")
    if not (rec["min_height"] > 0.2 and rec["min_abs_quat_w"] > 0.99
            and rec["max_final_speed"] < 0.2):
        raise AssertionError(f"SRB closed-loop gate outside its bounds: "
                             f"{rec}")


# ------------------------------------------ 10. PPO training, 4096 envs

def check_train_state(runner, count0: int, metrics: dict, what: str):
    alg = runner.cfg.algorithm
    ppo = runner.ppo
    for name, p in runner.network.named_parameters():
        st = ppo.optimizer.state[p]
        for t, label in ((p, "parameter"), (st["exp_avg"], "exp_avg"),
                         (st["exp_avg_sq"], "exp_avg_sq")):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{what}: non-finite {label} {name}")
    for k, v in metrics.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: non-finite metric {k}: {v}")
    f32 = np.float32
    if not f32(alg.min_lr) <= ppo.learning_rate <= f32(alg.max_lr):
        raise AssertionError(f"{what}: learning rate {ppo.learning_rate} "
                             f"outside [{alg.min_lr}, {alg.max_lr}]")
    # log_std is clamped to float32 logs of the rails: 1e-6 of slack
    std = torch.exp(runner.network.log_std.detach().double())
    if not (bool((std >= alg.min_noise_std * (1 - 1e-6)).all())
            and bool((std <= alg.max_noise_std * (1 + 1e-6)).all())):
        raise AssertionError(f"{what}: noise std {std.tolist()} outside "
                             f"[{alg.min_noise_std}, {alg.max_noise_std}]")
    steps = alg.num_learning_epochs * alg.num_mini_batches
    if ppo.update_count != count0 + steps:
        raise AssertionError(f"{what}: update count {ppo.update_count}, "
                             f"expected {count0 + steps}")


def update_card_vs_cpu(runner, rollout: Transition, last_value, tag: str,
                       carry0=None):
    """The PPO update of the first TRAIN_CHECK_ENVS envs of a card rollout
    on the card and on the CPU, from the runner's parameters and Adam state,
    with the same permutations (of samples; of envs for the recurrent PPO,
    which replays from the window's starting carry `carry0`)."""
    alg = runner.cfg.algorithm
    n = TRAIN_CHECK_ENVS
    sub = Transition(*(x[:, :n].contiguous() for x in rollout))
    last = last_value[:n]
    T = sub.reward.shape[0]
    items = T * n if carry0 is None else n
    g = torch.Generator().manual_seed(5)
    perms = [torch.randperm(items, generator=g)
             for _ in range(alg.num_learning_epochs)]
    mb = items // alg.num_mini_batches
    state = runner.ppo.state_dict()
    out = {}
    for dev in ("cuda", "cpu"):
        net = copy.deepcopy(runner.network).to(dev)
        ppo = type(runner.ppo)(net, alg)
        ppo.load_state_dict(state)
        roll = Transition(*(x.to(dev) for x in sub))
        adv, ret = compute_gae(roll.reward, roll.done, roll.time_out,
                               roll.value, last.to(dev), alg.gamma, alg.lam)
        idx = perms[0][:mb].to(dev)
        extra = {}
        # the CPU side counts the aten operations one minibatch dispatches
        with (_OpCount() if dev == "cpu" else contextlib.nullcontext()) as c:
            if carry0 is None:
                flat = Transition(*(x.reshape((T * n,) + x.shape[2:])
                                    for x in roll))
                ppo.loss_and_grad(Transition(*(x[idx] for x in flat)),
                                  adv.reshape(-1)[idx],
                                  ret.reshape(-1)[idx])
            else:
                c0 = map_carry(lambda c: c[:n].to(dev), carry0)
                extra["carry0"] = c0
                ppo.loss_and_grad(map_carry(lambda c: c[idx], c0),
                                  Transition(*(x[:, idx] for x in roll)),
                                  adv[:, idx], ret[:, idx])
        if dev == "cpu":
            calls = c.calls
        grads = {k: q.grad.detach().cpu().clone()
                 for k, q in net.named_parameters()}
        t0 = time.perf_counter()
        ppo.update(roll, last.to(dev), perms, **extra)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (grads, ppo, time.perf_counter() - t0)
    (g_card, card, s_card), (g_cpu, cpu, s_cpu) = out["cuda"], out["cpu"]
    for k, want in g_cpu.items():
        check_close(g_card[k], want, PPO_RTOL,
                    PPO_ATOL * float(want.abs().max()),
                    f"first minibatch gradient {k}, card vs CPU")
    c = compare_updates(card, cpu, alg, "card vs CPU")
    log(f"[{tag}] {n} envs x {T} steps, update on the card "
        f"{s_card:.3f} s, on the CPU {s_cpu:.3f} s: gradients, losses and "
        f"KL of 20 minibatches within rtol {PPO_RTOL}; learning rates equal "
        f"over {c['upto']} of {c['minibatches']} minibatches; final params "
        f"max abs {c['worst']:.3e} (Adam bound {c['bound']:.3e}), "
        f"{c['loose']} of {c['nparams']} entries beyond 1e-6; Adam moments "
        f"max abs error {c['moment']:.3e} of their tensor's largest entry; "
        f"one minibatch's loss and gradient dispatch {calls} aten "
        f"operations")


def compare_updates(got, want, alg, what: str, witness=None) -> dict:
    """Hold one PPO update (`got`, a PPO after its update) to another from
    the same start (`want`): every minibatch's losses and KL within
    PPO_RTOL, the learning rates equal until a KL lies within that
    tolerance of a threshold of the adaptive rule, the final parameters
    within Adam's bound and the moments within ADAM_RTOL.  With `witness`,
    `want`'s update of observations one ulp away (`one_process_update`),
    a moment tensor beyond ADAM_RTOL passes while it lies no further from
    `want` than WITNESS_FACTOR times the witness does: over tens of
    thousands of samples a minibatch holds some whose probability ratio or
    value lies within roundoff of a clip boundary, and a last-bit change
    of the forward pass (another matrix-product kernel for another shape)
    flips those samples' terms of the gradient in or out.  Returns what it
    found."""
    for k in ("surrogate_loss", "value_loss", "entropy", "kl"):
        check_close(got.minibatch_metrics[k].cpu(),
                    want.minibatch_metrics[k].cpu(), PPO_RTOL, PPO_ATOL,
                    f"minibatch {k}, {what}")
    # the rates are equal while no KL sits within the KL tolerance of a
    # threshold of the adaptive rule; after one, the two may branch apart
    kl = want.minibatch_metrics["kl"].cpu().double()
    dkl = alg.desired_kl
    near = torch.zeros_like(kl, dtype=torch.bool)
    for edge in (2.0 * dkl, dkl / 2.0):
        near |= (kl - edge).abs() <= PPO_RTOL * edge + PPO_ATOL
    upto = (int(near.nonzero()[0]) + 1 if bool(near.any())
            else len(kl))
    lr_got = got.minibatch_metrics["lr_intra"].cpu()
    lr_want = want.minibatch_metrics["lr_intra"].cpu()
    if not torch.equal(lr_got[:upto], lr_want[:upto]):
        raise AssertionError(f"learning rates differ, {what}: "
                             f"{lr_got.tolist()} vs {lr_want.tolist()}")
    # Adam steps roundoff-level gradients by about lr * sign(g): an entry
    # may end up as far apart as both sides' rates add up to, 2 * (sum of
    # the rates) while they agree (tests/test_torch_ppo.py)
    bound = float(lr_got.double().sum() + lr_want.double().sum()) + 1e-6
    worst, loose, moment, spread = 0.0, 0, 0.0, 0.0
    sg, sw = got.state_dict(), want.state_dict()
    sx = None if witness is None else witness.state_dict()
    for k, w_param in sw["params"].items():
        err = (sg["params"][k].cpu() - w_param.cpu()).abs()
        worst = max(worst, float(err.max()))
        loose += int((err > 1e-6).sum())
        if float(err.max()) > bound:
            raise AssertionError(f"final {k}, {what}: {float(err.max())}"
                                 f" > Adam bound {bound}")
        for m in ("exp_avg", "exp_avg_sq"):
            w = sw["adam"][k][m].cpu()
            scale = float(w.abs().max())
            g = sg["adam"][k][m].cpu()
            moment = max(moment, max_err(g, w) / max(scale, 1e-30))
            if sx is not None:
                x = max_err(sx["adam"][k][m].cpu(), w)
                spread = max(spread, x / max(scale, 1e-30))
                if max_err(g, w) <= WITNESS_FACTOR * x:
                    continue
            check_close(g, w, ADAM_RTOL, ADAM_ATOL * scale,
                        f"final {m} {k}, {what}")
    return dict(upto=upto, minibatches=len(kl), worst=worst, bound=bound,
                loose=loose, moment=moment, spread=spread,
                nparams=sum(v.numel() for v in sw["params"].values()))


def one_process_update(net0, state0: dict, alg, roll: Transition, last,
                       perms, nudge: bool = False):
    """One process's PPO update of `roll` from a copy of `net0` and the PPO
    state `state0`; with `nudge`, of the rollout's observations moved one
    ulp up: the roundoff witness of `compare_updates`."""
    ppo = PPO(copy.deepcopy(net0), alg)
    ppo.load_state_dict(state0)
    if nudge:
        up = lambda x: torch.nextafter(  # noqa: E731
            x, torch.full_like(x, float("inf")))
        roll = roll._replace(obs=up(roll.obs), priv_obs=up(roll.priv_obs))
    ppo.update(roll, last, perms)
    return ppo


def train_phase(task: str, patch, warm: int, timed: int, tag: str,
                card_vs_cpu: bool, recurrent: bool = False):
    """PPO training of `task` at full width, fresh from seed 0 with the
    registry's PPO config (phases 10, 13 and 14; `recurrent`: the
    ActorCriticRecurrent policy and RecurrentPPO): `warm` iterations, then
    `timed` ones; the launch counters around the first timed one.  Returns
    the runner, those counts and the state it ended in (env state, obs,
    priv_obs, carry)."""
    env = make_env(task, num_envs=NUM_ENVS, cfg_patch=patch)
    tc = get_cfgs(task)[1]
    if recurrent:
        tc = replace(tc, runner=replace(
            tc.runner, policy_class_name="ActorCriticRecurrent"))
    runner = make_alg_runner(env, task, train_cfg=tc)
    T = runner.cfg.runner.num_steps_per_env
    es = runner.init(0)
    es, out = env.step(es, torch.zeros(NUM_ENVS, env.num_actions,
                                       device=env.device))
    obs, priv = out.obs, out.privileged_obs
    carry = runner.network.initialize_carry(NUM_ENVS) if recurrent else None
    # time the rollout inside the iteration: a synchronising wrapper (the
    # update waits on the rollout at its first KL read anyway)
    marks = []
    name = "rollout_recurrent" if recurrent else "rollout"
    rollout = getattr(runner, name)

    def timed_rollout(*args, **kwargs):
        result = rollout(*args, **kwargs)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return result

    setattr(runner, name, timed_rollout)
    timed_its, launches = [], None
    for i in range(warm + timed):
        count0 = runner.ppo.update_count
        torch.cuda.synchronize()
        if i == warm:
            reset_counts()
        t0 = time.perf_counter()
        if recurrent:
            es, obs, priv, carry, metrics = runner.train_iteration_recurrent(
                es, obs, priv, carry)
        else:
            es, obs, priv, metrics = runner.train_iteration(es, obs, priv)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i == warm:
            launches = read_counts()
            # plane terrain needs no sphere positions for a surface query
            expect_counts(launches,
                          rollout_substep=env.cfg.control.decimation * T,
                          fk_from_state=0 if env.is_plane else T)
        check_train_state(runner, count0, metrics,
                          f"{task} train iteration {i}")
        if i >= warm:
            timed_its.append((t2 - t0, marks[-1] - t0, t2 - marks[-1]))
    setattr(runner, name, rollout)
    steps = T * NUM_ENVS
    total = sum(t[0] for t in timed_its)
    m = {k: round(float(metrics[k]), 6) for k in (
        "kl", "learning_rate", "lr_intra", "noise_std", "value_loss",
        "surrogate_loss", "mean_reward")}
    m["lr"] = m.pop("learning_rate")
    p = tc.policy
    net = ("ActorCriticRecurrent, rnn " + str(p.rnn_hidden_size) + ", heads"
           if recurrent else "ActorCritic")
    log(f"[{tag}] {task} PPO, {net} {'/'.join(map(str, p.actor_hidden_dims))}"
        f", {NUM_ENVS} envs x {T} steps, {timed} iterations after {warm} "
        f"warm in {total:.2f} s: {timed * steps / total:.0f} env-steps/s "
        f"including the update; iteration s "
        f"{[round(t[0], 4) for t in timed_its]}, rollout s "
        f"{[round(t[1], 4) for t in timed_its]}, update s "
        f"{[round(t[2], 4) for t in timed_its]}; launches in one iteration "
        f"{launches}; last iteration {json.dumps(m)}")
    if card_vs_cpu:
        if recurrent:
            es, obs, priv, carry, roll, _ = runner.rollout_recurrent(
                es, obs, priv, carry)
            with torch.no_grad():
                _, (_, _, last_value) = runner.network(carry, obs, priv)
            update_card_vs_cpu(runner, roll, last_value, f"{tag}-check",
                               carry0=runner.carry0)
        else:
            es, obs, priv, roll, _ = runner.rollout(es, obs, priv)
            with torch.no_grad():
                last_value = runner.network.value(priv)
            update_card_vs_cpu(runner, roll, last_value, f"{tag}-check")
    return runner, launches, (es, obs, priv, carry)


def recurrent_phase() -> dict:
    """14. Recurrent PPO training of the registered pointfoot_rough (table
    terrain) at 4096 envs, the card's update held to the CPU's; then one
    recurrent iteration of pointfoot_flat and its stateful inference
    policy driving the plane env.  Returns the launch counts of one
    recurrent pointfoot_rough iteration."""
    _, launches, _ = train_phase(
        "pointfoot_rough", None, RNN_TRAIN_WARM, RNN_TRAIN_TIMED,
        "train-rnn", card_vs_cpu=True, recurrent=True)
    runner, _, (es, _, _, _) = train_phase(
        "pointfoot_flat", policy_eval.FLAT_PATCH, 0, 1, "train-rnn-flat",
        card_vs_cpu=False, recurrent=True)
    env = runner.env
    policy = runner.get_inference_policy()
    actions = []

    def act(t, obs):
        a = policy(obs)
        actions.append(bool(torch.isfinite(a).all()))
        return a

    _, _, policy_launches = timed_steps(
        env, es, act, RNN_FLAT_STEPS, "rnn-flat-policy",
        "pointfoot_flat recurrent inference policy")
    expect_counts(policy_launches,
                  rollout_substep=env.cfg.control.decimation * RNN_FLAT_STEPS)
    if not all(actions):
        raise AssertionError("recurrent inference policy: non-finite actions")
    return launches


# ------------------------------- 11. plane terrain, pointfoot_flat, 4096 envs

def flat_phase(mc):
    """pointfoot_flat with model_82000's actor and config patch: kernel 1
    without surface rows against its plain version, the launch counts of
    the plane path (no sphere-xyz FK), env-steps/s, layers, row 5's probe,
    and anymal_c_flat's flat branch of step_batched."""
    env = make_env("pointfoot_flat", num_envs=NUM_ENVS,
                   cfg_patch=policy_eval.FLAT_PATCH)
    if not (env.is_plane and env.height_fn.is_flat):
        raise AssertionError("pointfoot_flat should be on plane terrain")
    policy = policy_eval.inference_policy(
        policy_eval.load_actor(env, "pointfoot_flat"))
    state, actions = warm_with_push(env, policy, 7)
    check_env_rollout(env, state, actions, "plane terrain")
    c = env.cfg.control
    state_rows = sp.pack_state(state.physics, state.last_qvel)
    ctrl_rows = sp.pack_ctrl(actions, state.params, state.push_force)
    step_args = (mc, state_rows, ctrl_rows, None, True,
                 env.default_qpos_values, c.action_scale, c.control_type,
                 env.cfg.sim.dt, env.cfg.sim.gravity)
    step_err, state_err, force_err, _ = check_rollout_step(mc, step_args)
    for num in RAGGED:
        part = ragged_columns((state_rows, ctrl_rows), num)
        errs = check_rollout_step(mc, (mc, *part) + step_args[3:])
        log(f"[kernels] rollout_substep without surface rows B={num}: max "
            f"|err| {errs[0]:.3g} (state rows {errs[1]:.3g}, forces "
            f"{errs[2]:.3g})")
    check_same_bits("rollout_substep without surface rows",
                    lambda: sp.rollout_step(*step_args))
    times = kernel_ms(lambda: sp.rollout_step(*step_args))
    log(f"[kernels] rollout_substep without surface rows B={NUM_ENVS}: max "
        f"|err| {step_err:.3g} (state rows {state_err:.3g}, forces "
        f"{force_err:.3g}); {times['ms']:.4f} ms/launch on the device, "
        f"{times['wrapper_ms']:.4f} in a loop of wrapper calls")

    state, out, launches = timed_steps(
        env, env.init_state(1), lambda t, obs: policy(obs), FLAT_STEPS,
        "flat", "pointfoot_flat")
    expect_counts(launches, rollout_substep=c.decimation * FLAT_STEPS)
    obs = out.obs
    acts = policy(obs)
    layers = {
        "env.step": cuda_ms(lambda: env.step(state, acts), 10),
        "policy": cuda_ms(lambda: policy(obs), 20),
        "physics rollout (4 kernel launches, no surface query)": cuda_ms(
            lambda: env._physics_rollout(state, acts), 10),
    }
    log_layers("pointfoot_flat", layers)

    probe_env = policy_eval.make_eval_env("pointfoot_flat", NUM_ENVS,
                                          policy_eval.FLAT_PATCH)
    rec = policy_eval.eval_config(probe_env, policy, None, 0.5, secs=6.0)
    log(f"[probe] pointfoot_flat model_82000 {json.dumps(rec)}")
    if not (rec["falls"] <= NUM_ENVS and rec["mean_vx"] >= 0.30):
        raise AssertionError(f"flat probe outside its band: {rec}")

    # anymal_c_flat: step_batched's mega-kernel route on flat ground, with
    # no sphere-xy FK and no surface query
    any_env = make_env("anymal_c_flat", num_envs=NUM_ENVS)
    signal = bench_signal(any_env)
    _, _, any_launches = timed_steps(
        any_env, any_env.init_state(0), lambda t, obs: signal(t),
        ANYMAL_FLAT_STEPS, "anymal-flat", "anymal_c_flat")
    expect_counts(any_launches,
                  substep=any_env.cfg.control.decimation * ANYMAL_FLAT_STEPS)
    return dict(no_surface_ms=times["ms"],
                no_surface_wrapper_ms=times["wrapper_ms"],
                no_surface_max_abs_err=step_err,
                no_surface_launches=launches["rollout_substep"])


# ------------------------------------------ 12. table terrain, 4096 envs

def table_phase(mc_pf, mc_any):
    """pointfoot_rough with its registered config (table terrain) and
    model_100000's actor: kernels 1-2 on the table's surface against their
    plain versions, the launch counts, env-steps/s, layers and row 1's
    probe; anymal_c_rough on the table: the mega-kernel route and kernels
    3-4 against the plain path on the same surface rows; then bench.main_env
    for both tasks."""
    env = make_env("pointfoot_rough", num_envs=NUM_ENVS)
    if env.cfg.terrain.procedural or env.is_plane:
        raise AssertionError("pointfoot_rough's registered terrain is the "
                             "table")
    policy = policy_eval.inference_policy(
        policy_eval.load_actor(env, "pointfoot_rough", MODEL_100000))
    state, actions = warm_with_push(env, policy, 8)
    check_env_rollout(env, state, actions, "table terrain")
    c = env.cfg.control
    state_rows = sp.pack_state(state.physics, state.last_qvel)
    ctrl_rows = sp.pack_ctrl(actions, state.params, state.push_force)
    xyz = sp.fk_rows_plain(mc_pf, state_rows)
    surf_rows = sp.surface_rows(env.height_fn, xyz, mc_pf.nc)
    step_args = (mc_pf, state_rows, ctrl_rows, surf_rows, True,
                 env.default_qpos_values, c.action_scale, c.control_type,
                 env.cfg.sim.dt, env.cfg.sim.gravity)
    for num in (NUM_ENVS,) + RAGGED:
        part = ragged_columns((state_rows, ctrl_rows, surf_rows), num)
        errs = check_rollout_step(mc_pf, (mc_pf, *part) + step_args[4:])
        log(f"[kernels] rollout_substep on table surface rows B={num}: max "
            f"|err| {errs[0]:.3g} (state rows {errs[1]:.3g}, forces "
            f"{errs[2]:.3g})")
    check_fk_rows(mc_pf, state_rows, "PointFoot table terrain")

    state, out, launches = timed_steps(
        env, env.init_state(1), lambda t, obs: policy(obs), TABLE_STEPS,
        "table", "pointfoot_rough (table)")
    expect_counts(launches, rollout_substep=c.decimation * TABLE_STEPS,
                  fk_from_state=TABLE_STEPS)
    obs = out.obs
    acts = policy(obs)
    layers = {
        "env.step": cuda_ms(lambda: env.step(state, acts), 10),
        "policy": cuda_ms(lambda: policy(obs), 20),
        "physics rollout (kernels + surface queries)": cuda_ms(
            lambda: env._physics_rollout(state, acts), 10),
        "surface query (one substep)": cuda_ms(
            lambda: sp.surface_rows(env.height_fn, xyz, mc_pf.nc), 20),
        "height scan (121 points)": cuda_ms(
            lambda: env._measured_heights(state.physics), 20),
    }
    log_layers("pointfoot_rough table", layers)

    probe_env = policy_eval.make_eval_env("pointfoot_rough", NUM_ENVS)
    rec = policy_eval.eval_config(probe_env, policy, 0, 0.4, secs=6.0)
    log(f"[probe] pointfoot_rough table model_100000 {json.dumps(rec)}")
    if not (rec["falls"] <= NUM_ENVS and rec["mean_vx"] >= 0.20):
        raise AssertionError(f"table probe outside its band: {rec}")

    any_env = make_env("anymal_c_rough", num_envs=NUM_ENVS)
    a_state, signal, push, tau = anymal_inputs(any_env, 9)
    phys, params = a_state.physics, a_state.params
    dt, grav = any_env.cfg.sim.dt, any_env.cfg.sim.gravity
    _, surface = check_route(any_env, phys, params, tau, push, "table")
    check_substep_and_fk_xy(mc_any, phys, params, tau, push, surface, dt,
                            grav, "table terrain")
    _, _, any_launches = timed_steps(
        any_env, a_state, lambda t, obs: signal(t), ANYMAL_TABLE_STEPS,
        "anymal-table", "anymal_c_rough (table)")
    n = any_env.cfg.control.decimation * ANYMAL_TABLE_STEPS
    expect_counts(any_launches, substep=n, fk_contact_xy=n)

    for task in ("pointfoot_rough", "anymal_c_rough"):
        rec = bench.main_env(task, NUM_ENVS, iters=BENCH_ITERS,
                             reps=BENCH_REPS)
        cond = rec["conditions"]
        if not (rec["value"] > 0 and cond["table_steps_per_sec"] > 0):
            raise AssertionError(f"bench record {rec}")
        log(f"[bench-env] {task}: procedural {rec['value']:.1f} env-steps/s "
            f"(reps {cond['reps_steps_per_sec']}, {cond['settle_iters']} "
            f"settle iterations), table {cond['table_steps_per_sec']:.1f}")

# ------------------------ 15. gait-MPC and iLQR closed loops, 4096 scenarios

def step_batched_launches(rows: int, steps: int) -> dict:
    """Launches of `steps` calls of dynamics.step_batched on `rows` CUDA
    rows with a terrain that has no `is_flat` (analytic.FLAT): its route
    by row count (physics/dynamics.py)."""
    if rows >= dynamics.MEGA_MIN_BATCH:
        return {"substep": steps, "fk_contact_xy": steps}
    if rows >= dynamics.CHOL_MIN_BATCH:
        return {"chol_solve": steps}
    return {}


def add_counts(*counts: dict) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def check_loop_step(model, params, phys, tau, dt, what: str):
    """Kernels 3 and 4 of `model` against their plain versions on the
    inputs one dynamics.step_batched call of a phase-15 loop gives them:
    analytic.FLAT queried at the spheres' xy, no push, the default gravity.
    Returns (substep max |err|, fk_contact_xy max |err|)."""
    xy = sp.fk_contact_xy_plain(model, phys)
    surface = query_surface(FLAT, xy[..., 0], xy[..., 1])
    out = check_substep_and_fk_xy(
        sp.model_consts(model), phys, params.broadcast(xy.shape[0]), tau,
        torch.zeros_like(phys.base_pos), surface, dt, 9.81, what)
    return out[4], out[5]


def perturbed_start(stack, num: int, seed: int):
    """`num` scenarios at the stack's spawn pose with sigma = GAIT_SIGMA
    m/s of noise on the base linear and angular velocities."""
    ctrl = stack.ctrl
    dev = ctrl.default_qpos.device
    g = torch.Generator(device=dev).manual_seed(seed)
    phys = PhysicsState.default(ctrl.model, stack.q0, num, dev,
                                base_height=stack.z0)
    return phys.replace(
        base_lin_vel=GAIT_SIGMA * torch.randn(num, 3, generator=g,
                                              device=dev),
        base_ang_vel=GAIT_SIGMA * torch.randn(num, 3, generator=g,
                                              device=dev))


def gait_lqr_kernel(stack, phys, cmd):
    """[gait-lqr]: kernel 6 on the frozen-contact SRB problems of the first
    gait tick of the battery, against sequential_srb_lqr."""
    ctrl = stack.ctrl
    T = ctrl.srb.horizon
    gs = ctrl.init(phys.base_pos.shape[0], phys)
    prob = ctrl.srb_tick_problem(phys, ctrl.placement(phys, cmd, gs))
    staged = rk.stage(*prob)
    err = check_srb_lqr(staged, T, "gait tick problems m=6")
    fs_k = rk.srb_lqr(*prob, horizon=T)
    fs_p = srb.sequential_srb_lqr(*prob, horizon=T)[0]
    torch.cuda.synchronize()
    f_err, f_share = check_close(fs_k, fs_p, LQR_TOL, LQR_TOL,
                                 "gait tick: kernel 6 vs sequential_srb_lqr")
    check_same_bits("srb_lqr gait tick problems",
                    lambda: rk.srb_lqr_lanes(*staged, T))
    log(f"[gait-lqr] PointFoot gait tick, {NUM_ENVS} scenarios: kernel 6 "
        f"vs sequential_srb_lqr max |err| {f_err:.3g} N "
        f"({100 * f_share:.2g}% of rtol/atol {LQR_TOL})")
    return max(err, f_err), prob


def gait_layers(stack, phys, cmd, gs, params, prob):
    """A PointFoot gait tick split into its stages, and its op count."""
    ctrl = stack.ctrl
    plan = ctrl.placement(phys, cmd, gs)
    f0, _ = ctrl.stance_force(phys, plan)
    tau = ctrl.torques(phys, plan, f0)
    dt = stack.ctrl_dt / stack.substeps

    def physics():
        p = phys
        for _ in range(stack.substeps):
            p = dynamics.step_batched(ctrl.model, params, p, tau, FLAT, dt)
        return p

    layers = {
        "tick (control)": cuda_ms(lambda: ctrl.control(phys, cmd, gs), 5),
        "FK and placement": cuda_ms(
            lambda: ctrl.placement(phys, cmd, gs), 5),
        "SRB assembly": cuda_ms(lambda: ctrl.srb_tick_problem(phys, plan),
                                5),
        "kernel 6 (wrapper, staging included)": cuda_ms(
            lambda: rk.srb_lqr(*prob, horizon=ctrl.srb.horizon), 10),
        "torque map": cuda_ms(lambda: ctrl.torques(phys, plan, f0), 5),
        f"{stack.substeps} physics substeps (step_batched)": cuda_ms(
            physics, 5),
    }
    log_layers(f"gait tick, PointFoot, {NUM_ENVS} scenarios", layers)
    log(f"[layers] a PointFoot gait tick dispatches "
        f"{count_calls(lambda: ctrl.control(phys, cmd, gs))} aten operations")


def gait_loop(stack, phys, cmd, ticks: int, params, track):
    """Drive `ticks` control ticks, each followed by the stack's physics
    substeps through dynamics.step_batched on analytic.FLAT; `track(tick,
    phys)` sees every post-tick state.  Returns (wall s, launches)."""
    ctrl = stack.ctrl
    gs = ctrl.init(phys.base_pos.shape[0], phys)
    dt = stack.ctrl_dt / stack.substeps
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for tick in range(ticks):
        tau, gs = ctrl.control(phys, cmd, gs)
        for _ in range(stack.substeps):
            phys = dynamics.step_batched(ctrl.model, params, phys, tau, FLAT,
                                         dt)
        track(tick, phys)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, read_counts(), phys


def gait_phase() -> dict:
    """[gait-lqr], [gait] and [gait-a1], with kernels 3 and 4 of PointFoot
    and A1 held to their plain versions on each loop's first
    step_batched inputs; returns the launches of kernels 6, 4 and 3 in the
    two loops and the kernels' max |err|s."""
    stack = gait_mpc.make_controller("pointfoot")
    ctrl = stack.ctrl
    dev = ctrl.default_qpos.device
    params = PhysicsParams.nominal(ctrl.model, NUM_ENVS, dev)
    phys0 = perturbed_start(stack, NUM_ENVS, GAIT_SEED)
    cmd = torch.tensor([GAIT_VX, 0.0, 0.0], device=dev).expand(NUM_ENVS, 3)
    err, prob = gait_lqr_kernel(stack, phys0, cmd)
    tau0, _ = ctrl.control(phys0, cmd, ctrl.init(NUM_ENVS, phys0))
    step_errs = [check_loop_step(ctrl.model, params, phys0, tau0,
                                 stack.ctrl_dt / stack.substeps,
                                 "PointFoot gait tick 1")]

    min_z = torch.full((NUM_ENVS,), float("inf"), device=dev)
    vx_sum = torch.zeros(NUM_ENVS, device=dev)

    def track(tick, p):
        torch.minimum(min_z, p.base_pos[:, 2], out=min_z)
        if tick >= GAIT_VX_FROM:
            vx_sum.add_(p.base_lin_vel[:, 0])

    wall, launches, phys = gait_loop(stack, phys0, cmd, GAIT_TICKS, params,
                                     track)
    expect_counts(launches, srb_lqr=GAIT_TICKS, **step_batched_launches(
        NUM_ENVS, GAIT_TICKS * stack.substeps))
    up = min_z >= GAIT_FALL_Z
    fall_share = 1.0 - float(up.float().mean())
    vx = float(vx_sum[up].mean()) / (GAIT_TICKS - GAIT_VX_FROM)
    rate = NUM_ENVS * GAIT_TICKS / wall
    log(f"[gait] PointFoot gait-MPC, {NUM_ENVS} scenarios, flat, cmd vx "
        f"{GAIT_VX}, sigma {GAIT_SIGMA} m/s, {GAIT_TICKS} ticks x "
        f"{stack.substeps} substeps in {wall:.2f} s: fall share "
        f"{fall_share:.4f} (base below {GAIT_FALL_Z} m; bound "
        f"{GAIT_MAX_FALL_SHARE}), mean vx {vx:.4f} m/s over ticks "
        f"{GAIT_VX_FROM}-{GAIT_TICKS} of the scenarios that stayed up, "
        f"{rate:.1f} scenario-ticks/s, {rate / (NUM_ENVS * 50.0):.4f} x "
        f"real time ({NUM_ENVS} x 50 Hz), {wall / GAIT_TICKS * 1e3:.2f} "
        f"ms/tick, launches {launches}")
    if not bool(torch.isfinite(phys.base_pos).all()) or \
            fall_share > GAIT_MAX_FALL_SHARE:
        raise AssertionError(f"gait closed loop: fall share {fall_share} "
                             f"above {GAIT_MAX_FALL_SHARE} or non-finite")
    gait_layers(stack, phys0, cmd, ctrl.init(NUM_ENVS, phys0), params, prob)

    a1 = gait_mpc.make_controller("a1")
    params = PhysicsParams.nominal(a1.ctrl.model, NUM_ENVS, dev)
    phys0 = PhysicsState.default(a1.ctrl.model, a1.q0, NUM_ENVS, dev,
                                 base_height=a1.z0)
    min_z = torch.full((NUM_ENVS,), float("inf"), device=dev)
    max_tilt = torch.zeros(NUM_ENVS, device=dev)
    vx_sum.zero_()
    down = torch.tensor([0.0, 0.0, -1.0], device=dev).expand(NUM_ENVS, 3)
    tau0, _ = a1.ctrl.control(phys0, cmd, a1.ctrl.init(NUM_ENVS, phys0))
    step_errs.append(check_loop_step(a1.ctrl.model, params, phys0, tau0,
                                     a1.ctrl_dt / a1.substeps,
                                     "A1 trot tick 1"))

    def track_a1(tick, p):
        torch.minimum(min_z, p.base_pos[:, 2], out=min_z)
        grav_b = quat.rotate_inverse(p.base_quat, down)
        torch.maximum(max_tilt, torch.arccos(torch.clamp(-grav_b[:, 2], -1,
                                                         1)), out=max_tilt)
        if tick >= A1_VX_FROM:
            vx_sum.add_(p.base_lin_vel[:, 0])

    a1_calls = count_calls(lambda: a1.ctrl.control(
        phys0, cmd, a1.ctrl.init(NUM_ENVS, phys0)))
    wall, a1_launches, phys = gait_loop(a1, phys0, cmd, A1_TICKS, params,
                                        track_a1)
    expect_counts(a1_launches, **step_batched_launches(
        NUM_ENVS, A1_TICKS * a1.substeps))
    rec = {"min_z": float(min_z.min()), "max_tilt": float(max_tilt.max()),
           "mean_vx": float(vx_sum.mean()) / (A1_TICKS - A1_VX_FROM)}
    rate = NUM_ENVS * A1_TICKS / wall
    log(f"[gait-a1] A1 trot, {NUM_ENVS} scenarios, flat, cmd vx {GAIT_VX}, "
        f"{A1_TICKS} ticks at 200 Hz in {wall:.2f} s: {json.dumps(rec)} "
        f"(mean vx over ticks {A1_VX_FROM}-{A1_TICKS}), {rate:.1f} "
        f"scenario-ticks/s, {rate / (NUM_ENVS * 200.0):.4f} x real time "
        f"({NUM_ENVS} x 200 Hz), {wall / A1_TICKS * 1e3:.2f} ms/tick "
        f"({a1_calls} aten operations a tick), launches {a1_launches}")
    if not (rec["min_z"] > 0.15 and rec["max_tilt"] < 0.3
            and rec["mean_vx"] > 0.2):
        raise AssertionError(f"A1 trot outside the bounds of "
                             f"tests/test_gait.py:395-437: {rec}")
    return dict(err=err, launches=add_counts(launches, a1_launches),
                substep_err=max(e[0] for e in step_errs),
                fk_xy_err=max(e[1] for e in step_errs))


def ilqr_layers(ctrl, phys, cmd, ms):
    """One chunk of a plan split into its layers, and the linearization's
    peak memory."""
    C = ctrl.chunk
    T = ctrl.cfg.horizon
    x0 = mpc_costs.state_to_vec(phys)[:C]
    us = ms.us_warm[:C]
    cost_fn = ctrl.cost_fn(cmd[:C])
    with torch.no_grad():
        xs = ilqr._rollout(ctrl.dyn, x0, us)
        derivs = ilqr._linearize(ctrl.dyn_plain, cost_fn, xs, us, T)
        Ks, ks, _ = ilqr.backward_pass(*derivs, ctrl.cfg.reg_init)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        derivs = ilqr._linearize(ctrl.dyn_plain, cost_fn, xs, us, T)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        layers = {
            "rollout": cuda_ms(lambda: ilqr._rollout(ctrl.dyn, x0, us), 2,
                               warmup=1),
            "linearization": cuda_ms(lambda: ilqr._linearize(
                ctrl.dyn_plain, cost_fn, xs, us, T), 2, warmup=1),
            "backward pass": cuda_ms(lambda: ilqr.backward_pass(
                *derivs, ctrl.cfg.reg_init), 2, warmup=1),
            "forward pass (line search)": cuda_ms(
                lambda: ilqr._forward_pass(ctrl.dyn, cost_fn, xs, us, Ks, ks,
                                           ctrl.cfg.alphas, T), 2, warmup=1),
        }
    log_layers(f"iLQR plan, one chunk of {C} scenarios (a plan: "
               f"{NUM_ENVS // C} chunks x (rollout + {ctrl.cfg.iterations} x "
               f"(linearization + backward + forward)))", layers)
    log(f"[ilqr] linearization peak memory {peak / 2**30:.2f} GiB a chunk of "
        f"{C} scenarios ({(ctrl.nx + ctrl.nj) * C * T} replicated rows)")


def ilqr_check_scenarios(dev: torch.device, num: int, horizon: int,
                         nudge: int = 0):
    """bench.make_mpc_ilqr's controller at `horizon` on `dev`, and `num`
    perturbed PointFoot scenarios from a seeded state, warm start and
    commands: (ctrl, phys, us_warm, cmd).  A `nudge` seed moves the
    velocities by about one float32 ulp."""
    ctrl, phys, _, _ = bench.make_mpc_ilqr(num, dev)
    ctrl.cfg = replace(ctrl.cfg, horizon=horizon)
    g = torch.Generator().manual_seed(ILQR_CHECK_SEED)

    def randn(*shape, gen=g):
        return torch.randn(*shape, generator=gen).to(dev)

    phys = phys.replace(
        base_pos=phys.base_pos + 0.02 * randn(num, 3),
        base_quat=quat.normalize(phys.base_quat + 0.03 * randn(num, 4)),
        base_lin_vel=0.2 * randn(num, 3), base_ang_vel=0.2 * randn(num, 3),
        qpos=0.1 * randn(num, 6), qvel=0.3 * randn(num, 6))
    us_warm = 0.5 * randn(num, horizon, 6)
    cmd = 0.3 * randn(num, 3)
    if nudge:
        gn = torch.Generator().manual_seed(nudge)
        phys = phys.replace(
            base_lin_vel=phys.base_lin_vel * (1 + 1.2e-7 * randn(num, 3,
                                                                 gen=gn)),
            qvel=phys.qvel * (1 + 1.2e-7 * randn(num, 6, gen=gn)))
    return ctrl, phys, us_warm, cmd


def ilqr_check_solve(dev: torch.device, num: int, horizon: int,
                     nudge: int = 0, plain: bool = False,
                     capture: dict | None = None):
    """MPCController.solve of ilqr_check_scenarios(dev, num, horizon,
    nudge); `plain` steps the rollouts and the line search with dyn_plain
    instead of the kernel routes of dyn; `capture` receives the controller
    and the (x, u) rows of the first line-search step."""
    ctrl, phys, us_warm, cmd = ilqr_check_scenarios(dev, num, horizon, nudge)
    if plain:
        ctrl.dyn = ctrl.dyn_plain
    if capture is not None:
        dyn, rows = ctrl.dyn, len(ctrl.cfg.alphas) * num

        def dyn_capture(x, u):
            if x.shape[0] == rows and "x" not in capture:
                capture.update(ctrl=ctrl, x=x.clone(), u=u.clone())
            return dyn(x, u)

        ctrl.dyn = dyn_capture
    sol = ctrl.solve(phys, cmd, us_warm)
    return sol.us.cpu(), sol.cost.cpu(), sol.improved.cpu(), ctrl.cfg


def ilqr_first_iteration(dev: torch.device, num: int, horizon: int):
    """(warm-start cost, finite gains) of every scenario of
    ilqr_check_scenarios: the cost of the rollout of the warm start, and
    whether the first iteration's Riccati sweep gave finite gains."""
    ctrl, phys, us, cmd = ilqr_check_scenarios(dev, num, horizon)
    cost_fn = ctrl.cost_fn(cmd)
    xs = ilqr._rollout(ctrl.dyn, mpc_costs.state_to_vec(phys), us)
    warm = ilqr._total_cost(cost_fn, xs, us, horizon)
    Ks, _, _ = ilqr.backward_pass(
        *ilqr._linearize(ctrl.dyn_plain, cost_fn, xs, us, horizon),
        torch.full_like(warm, ctrl.cfg.reg_init))
    return warm.cpu(), torch.isfinite(Ks).flatten(1).all(1).cpu()


def ilqr_check():
    """[ilqr-check]: the card's MPCController.solve against the CPU port's,
    from the same perturbed states, warm start and commands: the controls
    (the torque and the warm start the plan leaves), the costs, and the
    improved flags exactly; and kernels 3 and 4 held to their plain
    versions on the card solve's first line-search step.  Returns their
    max |err|s."""
    torch.cuda.synchronize()
    reset_counts()
    batch = {}
    us_c, cost_c, imp_c, cfg = ilqr_check_solve(
        bench.resolve_device(None), ILQR_CHECK_ENVS, ILQR_CHECK_HORIZON,
        capture=batch)
    torch.cuda.synchronize()
    launches = read_counts()
    T, A = cfg.horizon, len(cfg.alphas)
    expect_counts(launches, **add_counts(
        step_batched_launches(ILQR_CHECK_ENVS, T),
        *[step_batched_launches(A * ILQR_CHECK_ENVS, T)] * cfg.iterations))
    ctrl = batch["ctrl"]
    step_errs = check_loop_step(
        ctrl.model, ctrl.params,
        mpc_costs.vec_to_state(batch["x"], PhysicsState.default(
            ctrl.model, ctrl.default_qpos, 1, ctrl.default_qpos.device),
            ctrl.nj),
        torch.minimum(torch.maximum(batch["u"], -ctrl.model.effort_limit),
                      ctrl.model.effort_limit),
        ctrl.dt / ctrl.substeps, "PointFoot iLQR line search")
    cpu = torch.device("cpu")
    us_p, cost_p, imp_p, _ = ilqr_check_solve(cpu, ILQR_CHECK_ENVS,
                                              ILQR_CHECK_HORIZON)
    # the CPU's own sensitivity: the same solve from velocities nudged by
    # one ulp
    us_n, cost_n, imp_n, _ = ilqr_check_solve(cpu, ILQR_CHECK_ENVS,
                                              ILQR_CHECK_HORIZON, nudge=1)
    flips = torch.nonzero(imp_c != imp_p).flatten().tolist()
    (u_rtol, u_atol), (c_rtol, c_atol) = ILQR_CHECK_TOL

    def errs(us, cost):
        return (float((us - us_p).abs().max()),
                float(((cost - cost_p).abs() / cost_p.abs()).max()))

    u_err, c_err = errs(us_c, cost_c)
    u_nudge, c_nudge = errs(us_n, cost_n)
    log(f"[ilqr-check] card vs CPU, {ILQR_CHECK_ENVS} perturbed scenarios, "
        f"horizon {T}, {cfg.iterations} iterations: improved "
        f"{int(imp_c.sum())} / {int(imp_p.sum())} of {ILQR_CHECK_ENVS}, "
        f"flags differing at {flips}; controls max |err| {u_err:.3g} N·m of "
        f"up to {float(us_p.abs().max()):.3g}, costs max relative err "
        f"{c_err:.3g}; the CPU's own solve from velocities nudged by one "
        f"ulp moved by {u_nudge:.3g} N·m and {c_nudge:.3g} relative, "
        f"{int((imp_n != imp_p).sum())} flags; launches {launches}")
    if flips:
        raise AssertionError(
            f"[ilqr-check] improved flags differ at scenarios {flips}: card "
            f"{imp_c[flips].tolist()} cost {cost_c[flips].tolist()}, CPU "
            f"{imp_p[flips].tolist()} cost {cost_p[flips].tolist()}")
    check_close(us_c, us_p, u_rtol, u_atol, "[ilqr-check] controls")
    check_close(cost_c, cost_p, c_rtol, c_atol, "[ilqr-check] costs")
    return step_errs


def ilqr_witness():
    """[ilqr-witness]: the card's solve at the bench's horizon through the
    kernel routes against the same solve through the plain dynamics.step
    on the card, beside the plain route's own moves under one-ulp nudges
    (ILQR_WITNESS_NUDGES); then the card against the CPU on
    ILQR_WITNESS_CPU_ENVS scenarios at that horizon, each scenario apart
    held to the card's nudged solves."""
    dev = bench.resolve_device(None)
    (u_rtol, u_atol), (c_rtol, c_atol) = ILQR_CHECK_TOL

    def solve(**kw):
        return ilqr_check_solve(dev, ILQR_CHECK_ENVS, ILQR_WITNESS_HORIZON,
                                **kw)

    def beyond(got, ref):
        """(B,) scenarios whose controls or cost leave ILQR_CHECK_TOL."""
        du = (got[0] - ref[0]).abs().flatten(1)
        lim = u_atol + u_rtol * ref[0].abs().flatten(1)
        dc = (got[1] - ref[1]).abs()
        return (du > lim).any(1) | (dc > c_atol + c_rtol * ref[1].abs())

    def moved(got, ref):
        """Scenarios beyond the tolerance, flipped improved flags, and the
        largest control move (N·m)."""
        return (int(beyond(got, ref).sum()), int((got[2] != ref[2]).sum()),
                float((got[0] - ref[0]).abs().max()))

    torch.cuda.synchronize()
    reset_counts()
    kern = solve()
    torch.cuda.synchronize()
    launches = read_counts()
    cfg = kern[3]
    T, A = cfg.horizon, len(cfg.alphas)
    expect_counts(launches, **add_counts(
        step_batched_launches(ILQR_CHECK_ENVS, T),
        *[step_batched_launches(A * ILQR_CHECK_ENVS, T)] * cfg.iterations))
    warm, finite = ilqr_first_iteration(dev, ILQR_CHECK_ENVS,
                                        ILQR_WITNESS_HORIZON)
    log(f"[ilqr-witness] horizon {T}, {ILQR_CHECK_ENVS} perturbed "
        f"scenarios: improved in the last iteration "
        f"{int(kern[2].sum())}, final cost below the warm start's "
        f"{int((kern[1] < warm - 1e-9).sum())}; the first iteration's "
        f"gains not finite in {int((~finite).sum())} (a Riccati sweep "
        f"that lost definiteness: the line search's costs are NaN and the "
        f"scenario keeps its warm start, as in JAX, "
        f"tests/test_torch_ilqr.py::"
        f"test_horizon25_unimproved_scenarios_match_jax)")
    plain = solve(plain=True)
    got = moved(kern, plain)
    nudged = [moved(solve(plain=True, nudge=k), plain)
              for k in ILQR_WITNESS_NUDGES]
    log(f"[ilqr-witness] {ILQR_CHECK_ENVS} perturbed scenarios, horizon "
        f"{T}, {cfg.iterations} iterations, improved {int(kern[2].sum())} "
        f"of {ILQR_CHECK_ENVS}: kernel routes vs the plain dynamics.step on "
        f"the card: {got[0]} scenarios beyond {ILQR_CHECK_TOL}, {got[1]} "
        f"flags flipped, controls moved up to {got[2]:.4g} N·m; the plain "
        f"route nudged by one ulp (seeds {ILQR_WITNESS_NUDGES}): "
        f"{[n[0] for n in nudged]} scenarios, {[n[1] for n in nudged]} "
        f"flags, up to {[round(n[2], 4) for n in nudged]} N·m; launches "
        f"{launches}")
    if got[0] > min(n[0] for n in nudged) or \
            got[1] > min(n[1] for n in nudged):
        raise AssertionError(
            f"[ilqr-witness] the kernel routes moved the horizon-{T} solve "
            f"more than a one-ulp nudge of the plain route: {got} against "
            f"{nudged}")

    num = ILQR_WITNESS_CPU_ENVS
    card = ilqr_check_solve(dev, num, T)
    cpu = ilqr_check_solve(torch.device("cpu"), num, T)
    apart = beyond(card, cpu)
    landed = torch.stack([
        ~beyond(ilqr_check_solve(dev, num, T, nudge=k), cpu)
        for k in ILQR_WITNESS_CPU_NUDGES]).any(0)
    gap = (card[0] - cpu[0]).abs().flatten(1).amax(1)
    log(f"[ilqr-witness] {num} perturbed scenarios, horizon {T}, card vs "
        f"CPU: scenarios {torch.nonzero(apart).flatten().tolist()} beyond "
        f"the tolerance (controls {[round(v, 4) for v in gap.tolist()]} "
        f"N·m apart), of which "
        f"{torch.nonzero(apart & landed).flatten().tolist()} land on the "
        f"CPU's solution under a one-ulp nudge of the card (seeds "
        f"{ILQR_WITNESS_CPU_NUDGES})")
    if bool((apart & ~landed).any()) or not torch.equal(card[2], cpu[2]):
        raise AssertionError(
            f"[ilqr-witness] card vs CPU at horizon {T}: scenarios "
            f"{torch.nonzero(apart & ~landed).flatten().tolist()} apart "
            f"under every nudge, or improved flags differ")


def ilqr_phase() -> dict:
    """[ilqr], [ilqr-check], [ilqr-witness] and [mpc-balance]; returns the
    launches of one bench run and the max |err|s of kernels 3 and 4 on a
    line-search step."""
    torch.cuda.synchronize()
    reset_counts()
    rec = bench.main_mpc_ilqr(NUM_ENVS, iters=ILQR_ITERS, chunk=ILQR_CHUNK)
    launches = read_counts()
    plans = 1 + ILQR_ITERS
    chunks = NUM_ENVS // ILQR_CHUNK
    A = len(ilqr.ILQRConfig().alphas)
    T, iters = rec["conditions"]["horizon"], rec["conditions"]["iterations"]
    per_chunk = add_counts(
        step_batched_launches(ILQR_CHUNK, T),  # the initial rollout
        *[step_batched_launches(A * ILQR_CHUNK, T)] * iters)  # line search
    expect_counts(launches, **{k: v * plans * chunks
                               for k, v in per_chunk.items()})
    if rec["metric"] != f"ilqr_scenario_solves_per_sec@{NUM_ENVS}" or \
            not rec["value"] > 0:
        raise AssertionError(f"bench record {rec}")
    log(f"[ilqr] full-model iLQR, PointFoot, {NUM_ENVS} scenarios in chunks "
        f"of {ILQR_CHUNK}, horizon {T}, {iters} iterations: "
        f"{rec['value']:.1f} solves/s, {rec['conditions']['s_per_plan']:.3f}"
        f" s a plan, {rec['vs_baseline']:.6f} x real time ({NUM_ENVS} x "
        f"50 Hz), launches of {plans} plans {launches}")
    ctrl, phys, cmd, ms = bench.make_mpc_ilqr(
        NUM_ENVS, bench.resolve_device(None), ILQR_CHUNK)
    ilqr_layers(ctrl, phys, cmd, ms)
    substep_err, fk_xy_err = ilqr_check()
    ilqr_witness()
    mpc_balance()
    return dict(launches=launches, substep_err=substep_err,
                fk_xy_err=fk_xy_err)


def mpc_balance():
    """[mpc-balance]: the recipe of tests/test_mpc.py:110-175 at
    BALANCE_ENVS scenarios for BALANCE_TICKS ticks (the recipe's 50 take
    ~9 minutes of eager host time), with its gates; the same robot given
    no torque must fail them in that time, so the cut gate still
    separates a standing robot from a falling one."""
    dev = bench.resolve_device(None)
    model = get_model("pointfoot").to(dev)
    ctrl = MPCController(model, PhysicsParams.nominal(model, 1, dev), FLAT,
                         np.zeros(6, np.float32),
                         weights=mpc_costs.CostWeights(base_height=50.0),
                         cfg=ilqr.ILQRConfig(horizon=15, iterations=5,
                                             reg_init=0.1),
                         dt=0.02, substeps=4)
    params = PhysicsParams.nominal(model, BALANCE_ENVS, dev)
    phys = PhysicsState.default(model, np.zeros(6, np.float32), BALANCE_ENVS,
                                dev, base_height=0.62)
    command = torch.zeros(BALANCE_ENVS, 3, device=dev)
    ms = ctrl.init(BALANCE_ENVS)
    min_z = torch.full((BALANCE_ENVS,), float("inf"), device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BALANCE_TICKS):
        torque, ms, cost = ctrl.plan(phys, command, ms)
        for _ in range(4):
            phys = dynamics.step_batched(model, params, phys, torque, FLAT,
                                         0.005)
        torch.minimum(min_z, phys.base_pos[:, 2], out=min_z)
        finite &= torch.isfinite(cost).all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the gate's teeth at this depth: the same robot given no torque
    idle = PhysicsState.default(model, np.zeros(6, np.float32), 1, dev,
                                base_height=0.62)
    idle_params = PhysicsParams.nominal(model, 1, dev)
    for _ in range(4 * BALANCE_TICKS):
        idle = dynamics.step_batched(model, idle_params, idle,
                                     torch.zeros(1, 6, device=dev), FLAT,
                                     0.005)
    rec = {"min_z": float(min_z.min()),
           "min_final_z": float(phys.base_pos[:, 2].min()),
           "min_abs_quat_w": float(phys.base_quat[:, 3].abs().min()),
           "finite_costs": bool(finite),
           "final_z_without_torque": float(idle.base_pos[0, 2])}
    log(f"[mpc-balance] PointFoot iLQR balance, {BALANCE_ENVS} scenarios, "
        f"horizon 15, 5 iterations, planner substeps 4, {BALANCE_TICKS} "
        f"ticks x 4 substeps in {wall:.2f} s ({wall / BALANCE_TICKS:.3f} "
        f"s/tick): {json.dumps(rec)}")
    if not (rec["min_z"] > 0.40 and rec["min_final_z"] > 0.50
            and rec["min_abs_quat_w"] > 0.95 and rec["finite_costs"]
            and rec["final_z_without_torque"] < 0.50):
        raise AssertionError(f"MPC balance outside the bounds of "
                             f"tests/test_mpc.py:110-175: {rec}")


# ------------------------------------------------------ 16. sys-ID

def sysid_identifier(num_envs: int, policy) -> dict:
    """[sysid] identifier: one IdentifierTrainer.train_step of
    pointfoot_flat at `num_envs` envs (the CLI's window, warm-up, hidden
    width and command), its seconds, simulated env-steps/s, num_valid, MSE,
    peak memory and launch counts."""
    env = make_env("pointfoot_flat", num_envs=num_envs)
    trainer = IdentifierTrainer(env, policy, window=SYSID_WINDOW,
                                warmup=SYSID_WARMUP, hidden=SYSID_HIDDEN)
    gen = torch.Generator().manual_seed(SYSID_SEED)
    trainer.init(gen)
    state = env.init_state(SYSID_SEED)
    cmd = torch.tensor(SYSID_CMD, device=env.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    m = trainer.train_step(state, cmd, generator=gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = SYSID_WARMUP + SYSID_WINDOW
    mse, valid = float(m["mse"]), int(m["num_valid"])
    log(f"[sysid] identifier, pointfoot_flat, {num_envs} envs, window "
        f"{SYSID_WINDOW} after a warm-up of {SYSID_WARMUP}, LSTM "
        f"{SYSID_HIDDEN}: one train_step {dt:.3f} s, "
        f"{num_envs * steps / dt:,.1f} simulated env-steps/s, num_valid "
        f"{valid} of {num_envs}, mse {mse:.6g}, peak memory {peak:.2f} GiB; "
        f"launches {launches}")
    if not (np.isfinite(mse) and 0 < valid <= num_envs):
        raise AssertionError(f"[sysid] identifier at {num_envs} envs: mse "
                             f"{mse}, num_valid {valid}")
    return dict(env=env, trainer=trainer, launches=launches, seconds=dt)


def sysid_kernel_rows(env, trainer, policy) -> float:
    """[sysid] kernel 1 on the identifier's rows: the fused rollout of the
    first step of a wide identifier simulation (distinct per-env friction,
    mass and CoM pinned) against its plain version, bit for bit, at the
    full width and at RAGGED rows.  Returns the max |err|."""
    target = trainer.sample_params(torch.Generator().manual_seed(SYSID_SEED))
    state = env.init_state(SYSID_SEED)
    state = env.update_frictions(state, target[:, :6])
    state = env.update_added_mass_and_base_com(state, target[:, 6],
                                               target[:, 7:10])
    state = env.update_cmd(state, torch.tensor(SYSID_CMD,
                                               device=env.device))
    p = state.params
    if not (torch.unique(p.joint_friction, dim=0).shape[0] == NUM_ENVS
            and torch.unique(p.added_mass).shape[0] == NUM_ENVS
            and torch.unique(p.com_offset, dim=0).shape[0] == NUM_ENVS):
        raise AssertionError("[sysid] the rows' parameters are not distinct")
    err = 0.0
    with torch.no_grad():
        actions = policy(torch.zeros(NUM_ENVS, env.num_obs,
                                     device=env.device))
        for num in (NUM_ENVS,) + RAGGED:
            idx = torch.arange(num, device=env.device) % NUM_ENVS
            part = state.replace(
                params=take_rows(state.params, idx),
                physics=take_rows(state.physics, idx),
                last_qvel=state.last_qvel[idx],
                push_force=state.push_force[idx])
            errs = check_env_rollout(env, part, actions[idx],
                                     f"the identifier's rows, B={num}")
            err = max([err] + list(errs.values()))
    log(f"[sysid] kernel 1 on the identifier's rows (per-env friction, mass "
        f"and CoM): bit for bit against its plain version at "
        f"{NUM_ENVS}, {', '.join(map(str, RAGGED))} rows; max |err| {err}")
    return err


def sysid_real_windows(policy, length: int, warmup: int, chunk: int,
                       overlap: int):
    """Windows of a "real" trajectory: env 0 of a pointfoot_flat rollout at
    REAL_PARAMS (4096 envs, no gradient: kernel 1's route)."""
    env = make_env("pointfoot_flat", num_envs=NUM_ENVS)
    real = torch.tensor(REAL_PARAMS, device=env.device)
    with torch.no_grad():
        traj, _ = simulate_trajectory(
            env, env.init_state(SYSID_SEED + 1), policy, real[:6], real[6],
            real[7:10], torch.tensor(SYSID_CMD, device=env.device),
            length=length, warmup=warmup)
    log(f"[sysid] real windows: env 0 of a {NUM_ENVS}-env rollout at "
        f"friction {list(REAL_PARAMS[:6])}, added mass {REAL_PARAMS[6]}, "
        f"CoM {list(REAL_PARAMS[7:])}, seed {SYSID_SEED + 1}")
    return chunk_windows(traj.obs[:, :1], chunk=chunk, overlap=overlap)


def sysid_gans(policy, length: int, warmup: int) -> dict:
    """[sysid] gan and wgan: one train_step each through the simulator on
    the plain route (1 env, `warmup` + `length` steps, windows of
    `length`): seconds, losses and each generator's largest gradient norm,
    all finite and nonzero."""
    env = make_env("pointfoot_flat", num_envs=1)
    state = env.init_state(SYSID_SEED)
    cmd = torch.tensor(SYSID_CMD, device=env.device)
    out = {}
    for name, cls in (("gan", GANTrainer), ("wgan", WGANTrainer)):
        trainer = cls(env, policy, sim_length=length, warmup=warmup,
                      chunk=length)
        if "real" not in out:
            out["real"] = sysid_real_windows(policy, length, warmup,
                                             trainer.chunk, trainer.overlap)
        gen = torch.Generator().manual_seed(SYSID_SEED)
        trainer.init(gen)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        m = trainer.train_step(state, out["real"], cmd, generator=gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_counts()
        expect_counts(launches)  # one env: the plain route
        gens = trainer.generators if name == "gan" else (trainer.gen,)
        norms = [max(float(torch.linalg.vector_norm(p.grad))
                     for p in net.parameters()) for net in gens]
        losses = {k: float(v) for k, v in m.items()}
        log(f"[sysid] {name}: one train_step through the simulator, 1 env, "
            f"{warmup} + {length} steps, chunks of {trainer.chunk}: "
            f"{dt:.3f} s ({(warmup + length) / dt:.2f} env-steps/s "
            f"with the backward pass), losses {json.dumps(losses)}, largest "
            f"gradient norm of each generator {norms}")
        if not (all(np.isfinite(v) for v in losses.values())
                and all(np.isfinite(n) and n > 0 for n in norms)):
            raise AssertionError(f"[sysid] {name}: losses {losses}, "
                                 f"generator gradient norms {norms}")
        out[name] = dt
    return out


@contextlib.contextmanager
def leaky_inputs(rec: list):
    """Records every input of torch.nn.functional.leaky_relu, as float64
    on the CPU, while the block runs."""
    F = torch.nn.functional
    orig = F.leaky_relu

    def recording(x, *args, **kwargs):
        rec.append(x.detach().cpu().double())
        return orig(x, *args, **kwargs)

    F.leaky_relu = recording
    try:
        yield rec
    finally:
        F.leaky_relu = orig


def sysid_card_vs_cpu(real: torch.Tensor):
    """[sysid] card vs cpu: the four trainers' nets, forward and backward,
    on the same windows on the card and on the CPU in float32, against the
    CPU in float64: outputs and gradients within SYSID_NET_TOL of each
    tensor's largest entry; the critic's loss holds the gradient penalty, a
    double backward through its LSTM.  The CPU's float32 may go beyond the
    tolerance only where a LeakyReLU input changes sign against float64
    (a kink: the slope differs, and the gradient with it); the line prints
    how many did."""
    cpu, dev = torch.device("cpu"), bench.resolve_device(None)
    g = torch.Generator().manual_seed(SYSID_SEED)
    win = (real.cpu() + 0.05 * torch.randn(8, *real.shape[1:], generator=g))
    fake = win.flip(0) * 0.9
    eps = torch.rand(8, 1, 1, generator=g)
    z = torch.randn(8, 64, generator=g)
    direct = DirectTrajectoryGAN(window=win.shape[1], z_dim=64, device=cpu)
    nets = {
        "gan generator (friction)": (
            MLPGenerator(6, 6, FRIC_RANGE, generator=g),
            lambda n, x: n(z[:, :6].to(x))),
        "gan discriminator": (
            MLPDiscriminator(27, out_dim=1, generator=g),
            lambda n, x: _bce(n(x), torch.ones(len(x), 1).to(x))),
        "wgan generator": (
            MLPGenerator(10, 10, PARAM_RANGE, generator=g),
            lambda n, x: n(z[:, :10].to(x))),
        "wgan critic + gradient penalty": (
            MLPCritic(27, generator=g),
            lambda n, x: n(x).mean() + 10.0 * gradient_penalty(
                n, x, fake.to(x), eps.to(x))),
        f"identifier (LSTM {SYSID_HIDDEN})": (
            LSTMIdentifier(27, SYSID_HIDDEN, 10, generator=g),
            lambda n, x: n(x)),
        "direct-GAN generator": (direct.gen, lambda n, x: n(z.to(x))),
        "direct-GAN discriminator": (direct.disc, lambda n, x: n(x)),
    }

    def run(net, fn, d, dtype):
        """(output and gradients as float64 on the CPU, LeakyReLU inputs)"""
        m = copy.deepcopy(net).to(d, dtype)
        with leaky_inputs([]) as kinks:
            y = fn(m, win.to(d, dtype))
        grads = grads_of(y.sum(), list(m.parameters()))
        return [t.detach().cpu().double() for t in [y] + list(grads)], kinks

    def rel(got, ref):
        return max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(got, ref))

    def flips(got, ref):
        """(count of inputs of another sign, the float64 and float32 values
        of the one of them furthest from the kink)"""
        n, far = 0, (0.0, 0.0)
        for a, b in zip(got, ref):
            other = (a > 0) != (b > 0)
            n += int(other.sum())
            if other.any():
                i = torch.argmax(torch.where(other, b.abs(), -1.0))
                if abs(float(b.flatten()[i])) >= abs(far[0]):
                    far = (float(b.flatten()[i]), float(a.flatten()[i]))
        return n, far

    worst = 0.0
    for what, (net, fn) in nets.items():
        ref, ref_in = run(net, fn, cpu, torch.float64)
        card, card_in = run(net, fn, dev, torch.float32)
        cpu32, cpu32_in = run(net, fn, cpu, torch.float32)
        err, err32 = rel(card, ref), rel(cpu32, ref)
        (kink, far), (kink32, far32) = (flips(card_in, ref_in),
                                        flips(cpu32_in, ref_in))
        worst = max(worst, err)

        def signs(n, far):
            return (f"{n} LeakyReLU inputs of another sign" + (
                f" (float64 {far[0]:.3g}, float32 {far[1]:.3g})" if n
                else ""))

        log(f"[sysid] card vs cpu, {what}: output and gradients on the card "
            f"within {err:.3g} of the CPU's float64, of each tensor's "
            f"largest entry, {signs(kink, far)}; the CPU's float32 within "
            f"{err32:.3g}, {signs(kink32, far32)}")
        if not err <= SYSID_NET_TOL:
            raise AssertionError(f"[sysid] card vs cpu, {what}: {err} beyond "
                                 f"{SYSID_NET_TOL}")
        if not (err32 <= SYSID_NET_TOL or kink32 > 0):
            raise AssertionError(f"[sysid] card vs cpu, {what}: the CPU's "
                                 f"float32 {err32} beyond {SYSID_NET_TOL} "
                                 f"with no LeakyReLU input at its kink")
    return worst


def sysid_phase() -> dict:
    """Phase 16: the identifier at the CLI's batch and at full width,
    kernel 1 on the identifier's rows, one GAN and one WGAN step through
    the simulator, and the nets on the card against the CPU.  Returns
    kernel 1's launches in the full-width identifier step and its max
    |err| on the identifier's rows."""
    policy = load_policy_as_torch(FLAT_EXPORTED)
    small = sysid_identifier(SYSID_BATCH, policy)
    expect_counts(small["launches"])  # 64 rows: the plain route
    wide = sysid_identifier(NUM_ENVS, policy)
    decimation = wide["env"].cfg.control.decimation
    expect_counts(wide["launches"], rollout_substep=decimation * (
        SYSID_WARMUP + SYSID_WINDOW))
    err = sysid_kernel_rows(wide["env"], wide["trainer"], policy)
    launches = wide["launches"]["rollout_substep"]
    del small, wide
    gans = sysid_gans(policy, *GAN_SMOKE)
    sysid_card_vs_cpu(gans["real"])
    return dict(launches=launches, err=err)


# ------------------------------- 17. data parallelism, 2 ranks on one card

def dp_global_state(env):
    """A state of the env's whole batch DP_STATE_STEPS random-action steps
    in, with a push queued, and the next random actions."""
    g = torch.Generator(device=env.device).manual_seed(DP_SEED)
    B, na = env.num_envs, env.num_actions

    def rand_actions():
        return 0.3 * torch.randn(B, na, generator=g, device=env.device)

    state = env.init_state(0)
    for _ in range(DP_STATE_STEPS):
        state, _ = env.step(state, rand_actions())
    push = 200.0 * (2.0 * torch.rand(B, 3, generator=g, device=env.device)
                    - 1.0)
    return state.replace(push_force=push), rand_actions()


def timed_iteration(runner, es, obs, priv, perms):
    """One training iteration with the launch counters reset just before
    and read just after: (state, obs, priv, metrics, iteration s,
    rollout s, launches)."""
    marks = []
    rollout = runner.rollout

    def timed_rollout(*args, **kwargs):
        result = rollout(*args, **kwargs)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return result

    runner.rollout = timed_rollout
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    es, obs, priv, metrics = runner.train_iteration(es, obs, priv,
                                                    perms=perms)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_counts()
    del runner.rollout
    return es, obs, priv, metrics, t1 - t0, marks[0] - t0, launches


def dp_perms(runner):
    """Per-epoch permutations of the global samples, the same on every
    rank."""
    alg = runner.cfg.algorithm
    n = runner.cfg.runner.num_steps_per_env * runner.env.global_num_envs
    g = torch.Generator().manual_seed(DP_SEED)
    return [torch.randperm(n, generator=g)
            for _ in range(alg.num_learning_epochs)]


def to_cpu(tree):
    """A nested dict of tensors, on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def dp_rank(rank: int, tmp: str) -> int:
    """One rank of phase 17 (run as `chip_smoke.py --dp-rank RANK DIR`):
    gloo with CUDA tensors, both ranks on cuda:0."""
    pm.init_distributed("gloo", "file://" + os.path.join(tmp, "rdzv"),
                        world_size=DP_RANKS, rank=rank,
                        timeout_s=DP_TIMEOUT_S)
    try:
        mesh = pm.make_mesh("cuda:0")
        out = dp_rank_checks(mesh, tmp)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def dp_rank_checks(mesh, tmp: str) -> dict:
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    env = make_env(DP_TASK, num_envs=DP_RANKS * NUM_ENVS, device=mesh.device)
    runner = make_alg_runner(env, DP_TASK, mesh=mesh, log_dir=os.path.join(
        tmp, f"rank{mesh.rank}"))
    out = {}

    # (a) the sharded rollout on this rank's rows of the parent's state
    state = env.shard_state(inp["state"])
    actions = env.shard_rows(inp["actions"])
    args = rollout_args(env, state, actions)
    reset_counts()
    phys, tau, sphere = sp.rollout_substeps_sharded(mesh, env.model, *args)
    torch.cuda.synchronize()
    out["rollout_launches"] = read_counts()
    out["rollout"] = [x.cpu() for x in (
        *(getattr(phys, f) for f in phys.__dataclass_fields__), tau,
        sphere)]

    # (b) kernels 1 and 2 on this rank's rows against their plain versions
    errs = check_rollout((phys, tau, sphere),
                         sp.rollout_substeps_sharded_plain(mesh, env.model,
                                                           *args))
    out["kernel_err"] = max(errs.values())

    # training, fresh from seed 0: warm iterations, then one timed with
    # the counters (c), after which the ranks' PPO states must agree (d)
    es = runner.init(0)
    es, o = env.step(es, torch.zeros(env.num_envs, env.num_actions,
                                      device=env.device))
    obs, priv = o.obs, o.privileged_obs
    perms = dp_perms(runner)
    for _ in range(DP_WARM):
        es, obs, priv, _ = runner.train_iteration(es, obs, priv)
    net0 = copy.deepcopy(runner.network)
    state0 = copy.deepcopy(runner.ppo.state_dict())
    es, obs, priv, metrics, secs, roll_secs, launches = timed_iteration(
        runner, es, obs, priv, perms)
    check_train_state(runner, state0["update_count"], metrics,
                      f"DP rank {mesh.rank}")
    out.update(launches=launches, secs=secs, rollout_secs=roll_secs,
               metrics={k: v.cpu() for k, v in metrics.items()},
               ppo=to_cpu(runner.ppo.state_dict()),
               learning_rate=float(runner.ppo.learning_rate))

    # the gradient all-reduce of one minibatch, alone
    grads = [p.grad for p in runner.network.parameters()]
    pm.all_reduce_sum_(grads, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_ALLREDUCE_REPS):
        pm.all_reduce_sum_(grads, mesh)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) / DP_ALLREDUCE_REPS \
        * 1e3
    out["grad_floats"] = sum(g.numel() for g in grads)

    # (e) the DP update against one process's update of the gathered
    # rollout, from the same parameters, Adam state and permutations
    roll = pm.all_gather_rows(runner.storage, mesh, dim=1)
    with torch.no_grad():
        last = pm.all_gather_rows(net0.value(priv), mesh)
    if mesh.rank == 0:
        alg = runner.cfg.algorithm
        t0 = time.perf_counter()
        ppo = one_process_update(net0, state0, alg, roll, last, perms)
        torch.cuda.synchronize()
        out["single_update_secs"] = time.perf_counter() - t0
        out["vs_single"] = compare_updates(
            runner.ppo, ppo, alg, "DP vs one process",
            witness=one_process_update(net0, state0, alg, roll, last, perms,
                                       nudge=True))
    del roll

    # (f) a collective save: rank 0 writes the global batch
    runner.current_iteration = DP_WARM + 1
    out["checkpoint"] = runner.save(es)
    return out


def dp_phase() -> dict:
    """17. Two ranks on the one card (gloo), 4096 envs each of the
    registered pointfoot_rough; then one rank on nccl.  Returns kernel 1's
    and 2's launches a rank in one iteration and the largest error of the
    sharded rollout and of kernel 1 on the ranks' rows."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    env = make_env(DP_TASK, num_envs=DP_RANKS * NUM_ENVS)
    state, actions = dp_global_state(env)
    torch.save({"state": state, "actions": actions},
               os.path.join(tmp, "inputs.pt"))
    want = sp.rollout_substeps(env.model, *rollout_args(env, state, actions))
    want = [x.cpu() for x in (*(getattr(want[0], f)
                                for f in want[0].__dataclass_fields__),
                              *want[1:])]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--dp-rank", str(r), tmp])
             for r in range(DP_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=DP_TIMEOUT_S + 60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"[dp] ranks exited with "
                             f"{[p.returncode for p in procs]}")
    outs = [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(DP_RANKS)]
    wall = time.perf_counter() - t0

    # (a) the union of the ranks' sharded rollouts, bit for bit
    err = 0.0
    for i, w in enumerate(want):
        got = torch.cat([o["rollout"][i] for o in outs])
        err = max(err, max_err(got, w))
        if not torch.equal(got, w):
            raise AssertionError(f"[dp] sharded rollout output {i}: not "
                                 f"bit-identical to the single-process "
                                 f"rollout, max |err| {max_err(got, w)}")
    for o in outs:
        expect_counts(o["rollout_launches"],
                      rollout_substep=env.cfg.control.decimation,
                      fk_from_state=1)
    log(f"[dp] rollout_substeps_sharded: the union of {DP_RANKS} ranks' "
        f"outputs on a {env.num_envs}-env state is bit-identical to the "
        f"single-process rollout_substeps of the same rows; launches a rank "
        f"{outs[0]['rollout_launches']}")
    kerr = max(o["kernel_err"] for o in outs)
    log(f"[dp] rollout_substeps_sharded on each rank's {NUM_ENVS} rows: "
        f"bit-identical to rollout_substeps_sharded_plain (max |err| "
        f"{kerr})")

    # (c) the launches of one iteration on each rank
    T = get_cfgs(DP_TASK)[1].runner.num_steps_per_env
    for o in outs:
        expect_counts(o["launches"],
                      rollout_substep=env.cfg.control.decimation * T,
                      fk_from_state=T)

    # (d) the ranks agree bit for bit after the update
    a, b = outs[0]["ppo"], outs[1]["ppo"]
    same = (a["learning_rate"] == b["learning_rate"]
            and a["update_count"] == b["update_count"]
            and a["adam_step"] == b["adam_step"]
            and all(torch.equal(a["params"][k], b["params"][k])
                    and all(torch.equal(a["adam"][k][m], b["adam"][k][m])
                            for m in ("exp_avg", "exp_avg_sq"))
                    for k in a["params"]))
    if not same:
        raise AssertionError("[dp] the ranks' parameters, Adam moments or "
                             "learning rates differ after the update")

    # (f) rank 0 alone wrote the checkpoint, of the global batch
    path = outs[0]["checkpoint"]
    other = os.path.join(tmp, "rank1")
    if os.path.exists(other) and os.listdir(other):
        raise AssertionError(f"[dp] rank 1 wrote {os.listdir(other)}")
    loader = make_alg_runner(env, DP_TASK)
    loaded = loader.load(path, env.init_state(1))
    if loaded.physics.base_pos.shape[0] != env.num_envs or \
            loader.current_iteration != DP_WARM + 1 or not all(
                torch.equal(v.cpu(), a["params"][k]) for k, v in
                loader.ppo.state_dict()["params"].items()):
        raise AssertionError(f"[dp] checkpoint {path}: "
                             f"{loaded.physics.base_pos.shape[0]} rows, "
                             f"iteration {loader.current_iteration}")

    c = outs[0]["vs_single"]
    steps = T * env.num_envs
    secs = max(o["secs"] for o in outs)
    log(f"[dp] {DP_TASK} (table), {DP_RANKS} ranks x {NUM_ENVS} envs "
        f"sharing cuda:0 on gloo: one iteration {secs:.3f} s, "
        f"{steps / secs:.0f} global env-steps/s including the update; "
        f"rollout s {[round(o['rollout_secs'], 4) for o in outs]}, update s "
        f"{[round(o['secs'] - o['rollout_secs'], 4) for o in outs]}; "
        f"gradient all-reduce {[round(o['allreduce_ms'], 4) for o in outs]} "
        f"ms a minibatch ({outs[0]['grad_floats']} floats); launches a "
        f"rank {outs[0]['launches']}; ranks bit-identical after the update "
        f"(parameters, Adam moments, learning rate "
        f"{outs[0]['learning_rate']:.6g}); phase wall {wall:.1f} s")
    log(f"[dp] the DP update against one process's update of the gathered "
        f"{env.num_envs}-env rollout ({outs[0]['single_update_secs']:.3f} "
        f"s): losses and KL within rtol {PPO_RTOL}, learning rates equal "
        f"over {c['upto']} of {c['minibatches']} minibatches, final params "
        f"max abs {c['worst']:.3e} (Adam bound {c['bound']:.3e}), "
        f"{c['loose']} of {c['nparams']} entries beyond 1e-6, Adam moments "
        f"{c['moment']:.3e} of their largest entry (the one-process update "
        f"of observations one ulp up: {c['spread']:.3e}); rank 0 alone "
        f"wrote "
        f"{os.path.basename(path)} with {env.num_envs} rows, loaded by one "
        f"process")
    del loader, env
    shutil.rmtree(tmp, ignore_errors=True)
    nccl = dp_nccl_world1()
    return dict(launches=[o["launches"] for o in outs],
                err=max(err, kerr), nccl=nccl)


def dp_nccl_world1() -> dict:
    """One rank on nccl: a DP iteration at 4096 envs through the DP code
    path against the runner without a mesh, from the same state: both
    take a warm iteration, then the DP runner takes the other's PPO state
    (their updates differ in last bits) and both take the timed one."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "rdzv"), world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    try:
        mesh = pm.make_mesh("cuda:0")
        runs = []
        for m in (None, mesh):
            env = make_env(DP_TASK, num_envs=NUM_ENVS)
            runner = make_alg_runner(env, DP_TASK, mesh=m)
            es = runner.init(0)
            es, o = env.step(es, torch.zeros(NUM_ENVS, env.num_actions,
                                             device=env.device))
            runs.append([runner, *runner.train_iteration(
                es, o.obs, o.privileged_obs)[:3]])  # warm-up
        runs[1][0].ppo.load_state_dict(runs[0][0].ppo.state_dict())
        net0 = copy.deepcopy(runs[0][0].network)
        state0 = copy.deepcopy(runs[0][0].ppo.state_dict())
        perms = dp_perms(runs[0][0])
        res = []
        for runner, es, obs, priv in runs:
            _, _, priv, _, secs, roll_secs, launches = timed_iteration(
                runner, es, obs, priv, perms)
            res.append((runner, secs, roll_secs, launches))
        (r0, s0, rs0, l0), (r1, s1, rs1, l1) = res
        with torch.no_grad():
            last = net0.value(priv)
        for k, v in r0.storage._asdict().items():
            if not torch.equal(getattr(r1.storage, k), v):
                raise AssertionError(f"[dp-nccl] rollout {k} differs from "
                                     f"the runner without a mesh")
        if l0 != l1:
            raise AssertionError(f"[dp-nccl] launches {l1} != {l0}")
        c = compare_updates(
            r1.ppo, r0.ppo, r0.cfg.algorithm, "nccl DP vs one process",
            witness=one_process_update(net0, state0, r0.cfg.algorithm,
                                       r0.storage, last, perms,
                                       nudge=True))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[dp-nccl] one rank on {backend}, {NUM_ENVS} envs: the DP iteration "
        f"{s1:.3f} s (rollout {rs1:.3f}), without a mesh {s0:.3f} s "
        f"(rollout {rs0:.3f}); rollouts bit-identical, launches {l1}; "
        f"update: losses and KL within rtol {PPO_RTOL}, learning rates equal "
        f"over {c['upto']} of {c['minibatches']}, final params max abs "
        f"{c['worst']:.3e} (Adam bound {c['bound']:.3e}), Adam moments "
        f"{c['moment']:.3e} of their largest entry (the one-process update "
        f"of observations one ulp up: {c['spread']:.3e})")
    return l1


# ------------------------------------------------- 18. the last modules

def env_phases_phase() -> dict:
    """[env-phases]: bench.main_env_phases at NUM_ENVS procedural envs,
    at most ENV_PHASES_SETTLE_MAX settle iterations a variant, each
    variant's launches counted around its own measurement: kernel 1 four
    times and kernel 2 once a step, no other kernel."""
    inner = bench.bench_env
    per_variant = []

    def counted(*args, **kwargs):
        torch.cuda.synchronize()
        reset_counts()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        per_variant.append((out[2], read_counts()))
        return out

    settle_max = bench.SETTLE_MAX
    bench.bench_env, bench.SETTLE_MAX = counted, ENV_PHASES_SETTLE_MAX
    try:
        rec = bench.main_env_phases("pointfoot_rough", NUM_ENVS,
                                    iters=ENV_PHASES_ITERS)
    finally:
        bench.bench_env, bench.SETTLE_MAX = inner, settle_max
    total = {}
    for (name, ablate), (settles, counts) in zip(
            bench.PHASE_VARIANTS.items(), per_variant):
        # one warm iteration, the settle loop's, the timed ones
        steps = bench.STEPS_PER_ITER * (1 + settles + ENV_PHASES_ITERS)
        expect_counts(counts, rollout_substep=4 * steps,
                      fk_from_state=steps)
        total = add_counts(total, counts)
        sps = rec["phases"][name]
        log(f"[env-phases] {name} (ablated {list(ablate)}): {sps:.1f} "
            f"env-steps/s, {NUM_ENVS / sps * 1e6:.1f} us a step, "
            f"{rec['phase_gain_us_per_step'].get(name, 0.0)} us a step "
            f"below the full step; {steps} steps, launches {counts}")
    return total


def device_timeline(trace_dir: str) -> dict:
    """Busy share, top operations and idle gaps of the device events of
    the newest Chrome trace in `trace_dir` (utils.profiling.trace)."""
    files = sorted((f for f in os.listdir(trace_dir)
                    if f.endswith(".pt.trace.json")),
                   key=lambda f: os.path.getmtime(os.path.join(trace_dir, f)))
    with open(os.path.join(trace_dir, files[-1])) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in events
                 if e.get("cat") in DEVICE_EVENTS)
    if not dev:
        raise AssertionError(f"[profile] no device events in {files[-1]}")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, gaps, end = 0.0, [], None
    for a, b, _ in dev:
        if end is None or a > end:
            if end is not None:
                gaps.append((a - end, end))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name = {}
    for a, b, name in dev:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + b - a, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:PROFILE_TOP]
    return dict(window_us=t1 - t0, busy_us=busy, events=len(dev),
                busy_share=busy / (t1 - t0), top=top,
                gaps=sorted(gaps, reverse=True)[:PROFILE_TOP],
                t0=t0, file=files[-1])


def profile_phase(env, policy):
    """[profile]: utils.profiling.trace around PROFILE_STEPS procedural
    env steps at NUM_ENVS envs; the device's busy share of the traced
    window, its top operations and longest idle gaps; utils.profiling.
    timed of the same step beside its CUDA-event time."""
    state, act = warm_with_push(env, policy, seed=5)
    trace_dir = os.path.join(PHASE18_DIR, "profile")
    shutil.rmtree(trace_dir, ignore_errors=True)
    torch.cuda.synchronize()
    with profiling.trace(trace_dir):
        s = state
        for _ in range(PROFILE_STEPS):
            s, o = env.step(s, act)
        torch.cuda.synchronize()
    tl = device_timeline(trace_dir)
    log(f"[profile] procedural pointfoot_rough, {NUM_ENVS} envs, "
        f"{PROFILE_STEPS} env steps traced ({tl['file']}): device busy "
        f"{tl['busy_us'] / 1e3:.3f} of {tl['window_us'] / 1e3:.3f} ms, "
        f"share {tl['busy_share']:.4f}, {tl['events']} device events")
    for name, (tot, n) in tl["top"]:
        log(f"[profile]   top device op {tot / 1e3:.3f} ms in {n} x "
            f"{name[:90]}")
    for gap, at in tl["gaps"]:
        log(f"[profile]   idle gap {gap / 1e3:.3f} ms at "
            f"{(at - tl['t0']) / 1e3:.3f} ms")
    raw = os.path.join(trace_dir, tl["file"])
    with open(raw, "rb") as f, gzip.open(raw + ".gz", "wb",
                                         compresslevel=1) as g:
        shutil.copyfileobj(f, g)
    os.remove(raw)
    t_timed = profiling.timed(env.step, state, act, iters=3, warmup=1)
    t_events = cuda_ms(lambda: env.step(state, act), 3)
    log(f"[profile] env.step: utils.profiling.timed {t_timed * 1e3:.3f} "
        f"ms, CUDA events {t_events:.3f} ms ([layers] env.step)")
    return tl


def capture_stdout(fn):
    """(fn's result, the lines it printed)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def play_phase(tmp: str) -> str:
    """[play]: play.run of the flagship (procedural), the registered
    pointfoot_rough (table) and pointfoot_flat (plane) at the CLI's
    width, PLAY_CMD pinned; the flagship from a copy of its committed
    actor with --export.  Returns the exported ONNX file."""
    actor = os.path.join(tmp, "flagship", "actor.npz")
    os.makedirs(os.path.dirname(actor))
    shutil.copy(policy_eval.FLAGSHIP_ACTOR, actor)
    for task, label, fk in ((None, "flagship (procedural)", 1),
                            ("pointfoot_rough", "pointfoot_rough (table)",
                             1),
                            ("pointfoot_flat", "pointfoot_flat (plane)",
                             0)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        (logger, rec), printed = capture_stdout(lambda: play.run(
            task, actor if task is None else None, NUM_ENVS, PLAY_STEPS,
            cmd=PLAY_CMD, export=task is None))
        wall = time.perf_counter() - t0
        launches = read_counts()
        steps = PLAY_STEPS + 1  # and the zero-action step
        expect_counts(launches, rollout_substep=4 * steps,
                      fk_from_state=fk * steps)
        log_ = logger.state_log
        for k, v in log_.items():
            if not np.isfinite(np.asarray(v, np.float64)).all():
                raise AssertionError(f"[play] {label}: non-finite {k}")
        if len(log_["command_x"]) != PLAY_STEPS or any(
                v != np.float32(PLAY_CMD[0]) for v in log_["command_x"]):
            raise AssertionError(f"[play] {label}: command_x not pinned at "
                                 f"{PLAY_CMD[0]}: {log_['command_x']}")
        _, rewards = capture_stdout(logger.print_rewards)
        log(f"[play] {label}, {NUM_ENVS} envs, {PLAY_STEPS} steps in "
            f"{wall:.2f} s: {json.dumps(rec)}; {len(log_)} logged keys "
            f"finite, command_x {PLAY_CMD[0]} in every step; "
            f"print_rewards: {rewards[-1]}; launches {launches}; "
            f"{printed[-1] if printed else ''}")
    onnx_path = os.path.join(tmp, "flagship", "exported", "policy.onnx")
    if not os.path.exists(onnx_path):
        raise AssertionError(f"[play] --export wrote no {onnx_path}")
    return onnx_path


def tlog_play(env, policy, path_env0: str, path_all: str):
    """One flagship play of TLOG_STEPS steps from the same seed (level 0,
    vx 0.4): env 0's observations and all rows logged; returns (the
    recorders' counts, env 0's rows, all rows, the last observations)."""
    rows0, rows_all, last = [], [], []
    rec0 = TrajectoryRecorder(path_env0, env.num_obs)
    rec_all = TrajectoryRecorder(path_all, env.num_obs,
                                 capacity=1 << (TLOG_STEPS * NUM_ENVS - 1)
                                 .bit_length())

    def hook(state, out, action):
        obs = out.obs.cpu().numpy()
        rows0.append(obs[0].copy())
        rows_all.append(obs)
        rec0.push(obs[0])
        rec_all.push_batch(obs)
        last[:] = [out.obs]

    try:
        policy_eval.eval_config(env, policy, 0, 0.4, secs=TLOG_STEPS * env.dt,
                                on_step=hook)
        rec0.flush()
        rec_all.flush()
        counts = [(r.written, r.dropped) for r in (rec0, rec_all)]
    finally:
        rec0.close()
        rec_all.close()
    return counts, np.stack(rows0), np.concatenate(rows_all), last[0]


def tlog_phase(tmp: str):
    """[tlog]: TrajectoryRecorder logs of the flagship's observations, env 0
    and all rows, read back bit for bit; shape on a log against itself;
    then a second play from the same seed, and whether the card's rollout
    repeats (reported, not gated).  Returns the env, its policy and the
    last observations."""
    env = policy_eval.make_eval_env("pointfoot_rough", NUM_ENVS,
                                    policy_eval.FLAGSHIP_PATCH)
    policy = policy_eval.inference_policy(
        policy_eval.load_actor(env, "pointfoot_rough"))
    paths = [os.path.join(tmp, f"{k}.tlog") for k in ("a0", "a", "b0", "b")]
    counts, rows0, rows_all, obs = tlog_play(env, policy, *paths[:2])
    want = [(TLOG_STEPS, 0), (TLOG_STEPS * NUM_ENVS, 0)]
    if counts != want:
        raise AssertionError(f"[tlog] (written, dropped) {counts} != {want}")
    for path, rows in ((paths[0], rows0), (paths[1], rows_all)):
        back, size = read_log(path)
        if size != env.num_obs or not np.array_equal(back, rows):
            raise AssertionError(f"[tlog] {path} does not read back")
    _, same = capture_stdout(lambda: shape.main([paths[0], paths[0]]))
    if not same[-1].startswith("EQUAL"):
        raise AssertionError(f"[tlog] shape of a log against itself: {same}")
    log(f"[tlog] flagship, {NUM_ENVS} envs, {TLOG_STEPS} steps: env 0 "
        f"({counts[0][0]} written, {counts[0][1]} dropped) and all rows "
        f"({counts[1][0]} written, {counts[1][1]} dropped) read back bit "
        f"for bit; shape on env 0's log against itself: {same[-1]}")
    _, rows0_b, rows_all_b, _ = tlog_play(env, policy, *paths[2:])
    _, verdict = capture_stdout(lambda: shape.main([paths[0], paths[2]]))
    differ = np.nonzero((rows_all != rows_all_b).any(axis=1))[0]
    first = ("none" if differ.size == 0 else
             f"step {differ[0] // NUM_ENVS} (env {differ[0] % NUM_ENVS}), "
             f"{np.unique(differ // NUM_ENVS).size} of {TLOG_STEPS} steps "
             f"differ")
    log(f"[tlog] determinism, two plays from seed 11: env 0: "
        f"{verdict[-1]}; all {NUM_ENVS} rows bit-identical: "
        f"{differ.size == 0}, first difference: {first}")
    return env, obs


def native_policy_phase(onnx_path: str, env, obs):
    """[native-policy]: the exported flagship actor through the C++ runner
    on the card's observations of NUM_ENVS envs, copied to the host,
    against the torch actor on the card."""
    net = policy_eval.load_actor(env, "pointfoot_rough")
    with torch.no_grad():
        want = net.act_mean(obs).cpu().numpy()
    pol = NativePolicy(onnx_path)
    t0 = time.perf_counter()
    got = pol(obs.cpu().numpy())
    wall = time.perf_counter() - t0
    pol.close()
    err = float(np.abs(got - want).max())
    log(f"[native-policy] {onnx_path}: {got.shape[0]} observations in "
        f"{wall * 1e3:.1f} ms on the host, max |err| {err:.3g} against the "
        f"torch actor on the card (tolerance {NATIVE_POLICY_TOL}; actions "
        f"up to {float(np.abs(want).max()):.3g})")
    if not err <= NATIVE_POLICY_TOL:
        raise AssertionError(f"[native-policy] max |err| {err}")


def test_env_phase():
    """[test-env]: `python -m pointfoot_tpu_torch.test_env` for every
    registered task at its 10 envs for TEST_ENV_EPISODES x the episode
    length, one process a task, all at once (each is host-bound)."""
    t0 = time.perf_counter()
    procs = {task: subprocess.Popen(
        [sys.executable, "-m", "pointfoot_tpu_torch.test_env", "--task",
         task, "--episodes", str(TEST_ENV_EPISODES)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for task in TASKS}
    try:
        outs = {task: p.communicate(timeout=TEST_ENV_TIMEOUT_S)[0]
                for task, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    steps = int(TEST_ENV_EPISODES * 1000)
    for task, p in procs.items():
        lines = outs[task].strip().splitlines()
        if p.returncode != 0 or lines[-1:] != ["Done"]:
            raise AssertionError(f"[test-env] {task}: exit {p.returncode}: "
                                 f"{lines[-5:]}")
    log(f"[test-env] {len(procs)} tasks ({', '.join(procs)}), {steps} "
        f"zero-action steps of 10 envs each, one process a task on the "
        f"card, in {wall:.2f} s: finite rewards, Done")


def gait_diag_phase() -> dict:
    """[gait-diag]: gait_diag.main at NUM_ENVS scenarios, vx GAIT_VX,
    GAIT_DIAG_TICKS ticks: kernel 6 once and kernels 3 and 4 four times a
    tick."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rep, printed = capture_stdout(lambda: gait_diag.main(
        ["--b", str(NUM_ENVS), "--vx", str(GAIT_VX), "--ticks",
         str(GAIT_DIAG_TICKS)]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    expect_counts(launches, srb_lqr=GAIT_DIAG_TICKS, **step_batched_launches(
        NUM_ENVS, 4 * GAIT_DIAG_TICKS))
    falls = next(p for p in printed if p.startswith("falls: "))
    log(f"[gait-diag] PointFoot, {NUM_ENVS} scenarios, vx {GAIT_VX}, "
        f"{rep['ticks']} ticks in {wall:.2f} s (report included): {falls}; "
        f"launches {launches}")
    for line in printed:
        if line.startswith("  ") and ": t<1s mean" in line:
            log(f"[gait-diag] {line.strip()}")
    return launches


def last_modules_phase(pf_env, policy) -> dict:
    """Phase 18; returns the launches of [env-phases] and [gait-diag]."""
    os.makedirs(PHASE18_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p18_")
    try:
        env_phases = env_phases_phase()
        profile_phase(pf_env, policy)
        onnx_path = play_phase(tmp)
        env, obs = tlog_phase(tmp)
        native_policy_phase(onnx_path, env, obs)
        del env, obs
        test_env_phase()
        gait = gait_diag_phase()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(env_phases=env_phases, gait_diag=gait)


# -------------------------------- 19. the run-diagnostic and validation CLIs

def timed_tool(tag: str, fn):
    """Run a tool's main with the launch counts zeroed just before and read
    just after: (its result, the lines it printed, wall s, launches)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rec, printed = capture_stdout(fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    log(f"[{tag}] {wall:.2f} s, launches {launches}")
    return rec, printed, wall, launches


def catapult_phase() -> dict:
    """[catapult-hunt]: kernel 1 on the hunt's first step (the state after
    its zero-action step, the policy's mean plus exploration), then
    catapult_hunt.main at NUM_ENVS plane envs: four launches a step."""
    env = make_env("pointfoot_flat", num_envs=NUM_ENVS)
    policy = policy_eval.inference_policy(
        policy_eval.load_actor(env, "pointfoot_flat", policy_eval.FLAT_ACTOR))
    gen = torch.Generator(device=env.device).manual_seed(42)
    with torch.no_grad():
        state, out = env.step(env.init_state(3), torch.zeros(
            NUM_ENVS, env.num_actions, device=env.device))
        act = policy(out.obs) + 0.6 * torch.randn(
            NUM_ENVS, env.num_actions, generator=gen, device=env.device)
        errs = check_env_rollout(env, state, act, "catapult hunt, plane")
    del env, state, out, act
    rec, printed, wall, launches = timed_tool(
        "catapult-hunt", lambda: catapult_hunt.main(
            ["--envs", str(NUM_ENVS), "--steps", str(CATAPULT_STEPS),
             "--load_run", policy_eval.FLAT_ACTOR]))
    steps = rec["steps"]
    expect_counts(launches, rollout_substep=4 * (1 + steps))
    found = ("no catapult events detected" if not rec["events"] else
             "events at steps " + ", ".join(
                 f"{e['t']} (env {e['env']}, {e['count']} envs)"
                 for e in rec["events"]))
    log(f"[catapult-hunt] pointfoot_flat (registered: noise, domain "
        f"randomization, pushes), {NUM_ENVS} envs, the flat actor + 0.6 "
        f"exploration, {steps} steps in {wall:.2f} s "
        f"({NUM_ENVS * steps / wall:.0f} env-steps/s, host sync a step): "
        f"{found}")
    for line in printed[:40] if rec["events"] else ():
        log(f"[catapult-hunt] {line}")
    return dict(launches=launches, err=max(errs.values()))


def ctrlseq_phase() -> dict:
    """[ctrlseq]: kernel 6 at 1 scenario on the comparison's first gait
    tick, then ctrlseq_compare.main at CTRLSEQ_STEPS ticks: kernel 6 once a
    tick of each of its two gait loops; its numbers against the JAX
    script's."""
    env = make_env("pointfoot_flat", num_envs=1,
                   cfg_patch=ctrlseq_compare.EVAL_PATCH)
    model, dev = env.model, env.device
    mpc = SteppingController(model, PhysicsParams.nominal(model, 1, dev),
                             model.collision_indices("foot"),
                             np.zeros(model.nj))
    cmd = [0.4, 0.0, 0.0]  # ctrlseq_compare's default --vx
    with torch.no_grad():
        state, step = ctrlseq_compare.rl_start(env, 0)
        state, _ = step(env.update_cmd(state, cmd),
                        torch.zeros(1, env.num_actions, device=dev))
        phys = state.physics
        cmd_t = torch.tensor([cmd], device=dev)
        prob = mpc.srb_tick_problem(phys, mpc.placement(
            phys, cmd_t, mpc.init(1, phys)))
    T = mpc.srb.horizon
    staged = rk.stage(*prob)
    err = check_srb_lqr(staged, T, "ctrl-seq tick 1, 1 scenario", sizes=(1,))
    f_err, share = check_close(rk.srb_lqr(*prob, horizon=T),
                               srb.sequential_srb_lqr(*prob, horizon=T)[0],
                               LQR_TOL, LQR_TOL,
                               "ctrl-seq tick: kernel 6 vs sequential")
    check_same_bits("srb_lqr ctrl-seq tick 1",
                    lambda: rk.srb_lqr_lanes(*staged, T))
    log(f"[ctrlseq] kernel 6 at 1 scenario vs sequential_srb_lqr max |err| "
        f"{f_err:.3g} N ({100 * share:.2g}% of rtol/atol {LQR_TOL})")
    rec, printed, wall, launches = timed_tool(
        "ctrlseq", lambda: ctrlseq_compare.main(
            ["--steps", str(CTRLSEQ_STEPS)]))
    expect_counts(launches, srb_lqr=2 * CTRLSEQ_STEPS)
    for line in printed:
        log(f"[ctrlseq] {line}")
    for line in (rec["ctrlseq"], rec["tracking"]):
        if not all(np.isfinite(v) for v in line.values()
                   if not isinstance(v, str)):
            raise AssertionError(f"ctrlseq_compare: non-finite {line}")
    got = {**rec["ctrlseq"], **rec["tracking"]}
    for k, want in CTRLSEQ_JAX.items():
        log(f"[ctrlseq] {k} {got[k]} on the card, {want} from the JAX "
            f"script (tolerance {CTRLSEQ_TOL[k]})")
        if not abs(got[k] - want) <= CTRLSEQ_TOL[k]:
            raise AssertionError(f"ctrlseq_compare: {k} {got[k]} against "
                                 f"the JAX script's {want}")
    log(f"[ctrlseq] {wall / CTRLSEQ_STEPS * 1e3:.2f} ms of the tool's wall "
        f"a tick: two gait ticks, one with 4 dynamics.step substeps, and "
        f"two 1-env env steps (1 scenario, plain route)")
    return dict(launches=launches, err=max(err, f_err))


def profile_substep_phase(pf_env, mc_pf) -> dict:
    """[profile-substep]: kernels 1-2 on the env.step row's first inputs
    and kernels 3-5 on the substep rows', then profile_substep.main at
    NUM_ENVS envs."""
    dev = pf_env.device
    with torch.no_grad():
        st = pf_env.init_state(0)
        zeros = torch.zeros(NUM_ENVS, pf_env.num_actions, device=dev)
        roll_err = max(check_env_rollout(pf_env, st, zeros,
                                         "profile_substep env.step").values())
        fk_err = check_fk_rows(mc_pf, sp.pack_state(st.physics, st.last_qvel),
                               "profile_substep env.step")
        del st
        model = get_model("pointfoot").to(dev)
        pp = PhysicsParams.nominal(model, NUM_ENVS, dev)
        phys = PhysicsState.default(model, torch.zeros(6), NUM_ENVS, dev,
                                    base_height=0.62)
        tau = torch.zeros(NUM_ENVS, model.nj, device=dev)
        sub_err, xy_err = check_loop_step(model, pp, phys, tau,
                                          profile_substep.DT,
                                          "profile_substep step_batched")
        A, rhs, _ = dynamics.assemble_velocity_solve(
            model, pp, phys, tau, FLAT, profile_substep.DT)
        nv = model.nv
        chol_err = check_cholesky(
            A.reshape(NUM_ENVS, nv * nv).t().contiguous(),
            rhs.t().contiguous(), f"profile_substep n={nv} B={NUM_ENVS}")
    profile_substep.B = NUM_ENVS
    rec, printed, wall, launches = timed_tool(
        "profile-substep", lambda: profile_substep.main([]))
    n = PROFILE_CALLS
    expect_counts(launches, rollout_substep=4 * n, fk_from_state=n,
                  substep=n, fk_contact_xy=n, chol_solve=n)
    for line in printed:
        if line.strip():
            log(f"[profile-substep] {line}")
    return dict(launches=launches, roll_err=roll_err, fk_err=fk_err,
                sub_err=sub_err, xy_err=xy_err, chol_err=chol_err,
                rows=rec["rows"])


def golden_phase(tmp: str):
    """[regen-golden]: regen_golden.main into a copy of tests/golden, the
    card's anchor held to the repository's, then replay_archive there."""
    gdir = os.path.join(tmp, "golden")
    shutil.copytree(regen_golden.GOLDEN_DIR, gdir)
    rec, printed, wall, launches = timed_tool(
        "regen-golden", lambda: regen_golden.main(
            ["--reason", "chip_smoke phase 19 on the card", "--golden_dir",
             gdir]))
    expect_counts(launches)  # 1 env: the plain route
    for line in printed:
        log(f"[regen-golden] {line}")
    with np.load(os.path.join(gdir, regen_golden.ANCHOR_NAME)) as new, \
            np.load(os.path.join(regen_golden.GOLDEN_DIR,
                                 regen_golden.ANCHOR_NAME)) as ref:
        errs = {k: float(np.abs(new[k] - ref[k]).max())
                for k in ("torques", "obs")}
        close = all(np.allclose(new[k], ref[k], atol=GOLDEN_ATOL,
                                rtol=GOLDEN_RTOL) for k in errs)
        ref_tau = ref["torques"]
    log(f"[regen-golden] generation {rec['generation']} on the card vs the "
        f"repository's anchor, max |err|: {json.dumps(errs)} (atol "
        f"{GOLDEN_ATOL}, rtol {GOLDEN_RTOL})")
    if not close:
        raise AssertionError(f"regen_golden on the card: anchor beyond the "
                             f"golden tolerance, {errs}")
    drifts, printed = capture_stdout(
        lambda: regen_golden.replay_archive(gdir, "cuda"))
    for name, drift in drifts.items():
        with np.load(os.path.join(gdir, "archive", name)) as a:
            want = float(np.abs(a["torques"] - ref_tau).max())
        log(f"[regen-golden] replay {name}: drift {drift:.4f} N·m on the "
            f"card, {want:.4f} against the repository's anchor")
        if not abs(drift - want) <= GOLDEN_ATOL:
            raise AssertionError(f"replay_archive {name}: drift {drift} "
                                 f"vs {want}")


def storm_terrain_phase(tmp: str, pf_env, pf_state):
    """[storm-guard] on the committed flagship run's log, which reads calm
    (tests/test_torch_diagnostics.py holds the guard to JAX's on it);
    [terrain-stats] on a checkpoint of the flagship env's state after
    [rollout]."""
    # check, not main: main would append an alarm beside a committed log
    code, msg = storm_guard.check(STORM_LOG)
    log(f"[storm-guard] {STORM_LOG}: code {code}: {msg}")
    if code != 0:
        raise AssertionError(f"storm_guard on {STORM_LOG}: code {code}: "
                             f"{msg}")
    runner = make_alg_runner(pf_env, "pointfoot_rough",
                             log_dir=os.path.join(tmp, "rough"))
    ckpt = runner.save(pf_state)
    rec, _ = capture_stdout(lambda: terrain_family_stats.main([ckpt]))
    log(f"[terrain-stats] the flagship's state after [rollout]: "
        f"{json.dumps({k: v for k, v in rec.items() if k != 'ckpt'})}")
    if sum(f["envs"] for f in rec["families"]) != NUM_ENVS:
        raise AssertionError(f"terrain_family_stats: families do not cover "
                             f"the {NUM_ENVS} envs: {rec}")


def multihost_phase():
    """[multihost]: two gloo ranks sharing the card sum their shards."""
    rec, printed, wall, _ = timed_tool("multihost",
                                       lambda: multihost_smoke.main([]))
    for line in printed:
        log(f"[multihost] {line}")
    if not (rec["ok"] and rec["total"] == rec["expected"]):
        raise AssertionError(f"multihost_smoke: {rec}")


def contact_phase():
    """[contact]: contact_calibration's CONTACT_EXPERIMENTS on the card
    (one robot: the plain route), the feet's normal forces within
    CONTACT_WEIGHT_TOL of the weight."""
    rec, printed, wall, launches = timed_tool(
        "contact", lambda: contact_calibration.main(
            ["--experiments", CONTACT_EXPERIMENTS]))
    expect_counts(launches)
    for line in printed:
        log(f"[contact] {line}")
    s = rec["static"]
    log(f"[contact] {CONTACT_EXPERIMENTS} in {wall:.2f} s; feet's normal "
        f"forces {s['fz_sum']:.3f} N against the weight {s['weight']:.3f} N")
    if not abs(s["fz_sum"] - s["weight"]) <= CONTACT_WEIGHT_TOL * s["weight"]:
        raise AssertionError(f"contact calibration: {s}")


def diagnostics_phase(pf_env, mc_pf, pf_state) -> dict:
    """Phase 19; returns each kernel's launches and max |err| here."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p19_")
    try:
        cat = catapult_phase()
        ctrl = ctrlseq_phase()
        prof = profile_substep_phase(pf_env, mc_pf)
        golden_phase(tmp)
        storm_terrain_phase(tmp, pf_env, pf_state)
        multihost_phase()
        contact_phase()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = add_counts(cat["launches"], ctrl["launches"],
                          prof["launches"])
    log(f"[diagnostics] phase 19 in {time.perf_counter() - t0:.1f} s; "
        f"launches {launches}")
    errs = {"rollout_substep": max(cat["err"], prof["roll_err"]),
            "fk_from_state": prof["fk_err"], "substep": prof["sub_err"],
            "fk_contact_xy": prof["xy_err"], "chol_solve": prof["chol_err"],
            "srb_lqr": ctrl["err"]}
    return {k: dict(diag_launches=launches.get(k, 0), diag_max_abs_err=e)
            for k, e in errs.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of phase 17
        return dp_rank(int(sys.argv[2]), sys.argv[3])
    t_start = time.perf_counter()
    card = bench.card_line(torch.device("cuda"))
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    pf_env = make_env("pointfoot_rough", num_envs=NUM_ENVS,
                      cfg_patch=policy_eval.FLAGSHIP_PATCH)
    any_env = make_env("anymal_c_rough", num_envs=NUM_ENVS,
                       cfg_patch=ANYMAL_PATCH)
    mc_pf = sp.model_consts(pf_env.model)
    mc_any = sp.model_consts(any_env.model)
    a1_model = get_model("a1").to(pf_env.device)
    mc_a1 = sp.model_consts(a1_model)
    build_kernels(mc_pf, mc_any, mc_a1)
    policy = policy_eval.inference_policy(
        policy_eval.load_actor(pf_env, "pointfoot_rough"))

    roll, fk, pf_state, xyz = pointfoot_kernels(pf_env, mc_pf, policy)
    sub, fkxy, chol, lay = anymal_kernels(any_env, mc_any, pf_env,
                                          pf_state)
    check_fk_rows(mc_a1, substep_inputs(a1_model, A1_QDEF, 0.3, NUM_ENVS, 3,
                                        pf_env.device)[2], "A1 perturbed")
    log(f"[t] kernels checked at {time.perf_counter() - t_start:.1f} s")
    pf_launches, pf_after = pointfoot_rollout(pf_env, mc_pf, policy, xyz)
    any_launches = anymal_rollout(any_env, lay)
    physical_gate()
    chol_launches = cholesky_route()
    log(f"[t] env paths done at {time.perf_counter() - t_start:.1f} s")

    pf_ctrl = bench.make_mpc(NUM_ENVS, pf_env.device)[0]
    a1_ctrl = srb.SRBController(
        a1_model, PhysicsParams.nominal(a1_model, NUM_ENVS, pf_env.device),
        a1_model.collision_indices("foot"), A1_QDEF,
        srb.SRBConfig(height_target=0.28))
    lqr = riccati_kernels(pf_ctrl, a1_ctrl)
    mpc_launches = mpc_tick(pf_ctrl, lqr["ms"])
    srb_gate(a1_model)
    log(f"[t] MPC paths done at {time.perf_counter() - t_start:.1f} s")
    train_phase("pointfoot_rough", policy_eval.FLAGSHIP_PATCH, TRAIN_WARM,
                TRAIN_TIMED, "train", card_vs_cpu=True)
    log(f"[t] training done at {time.perf_counter() - t_start:.1f} s")
    flat = flat_phase(mc_pf)
    log(f"[t] plane terrain done at {time.perf_counter() - t_start:.1f} s")
    table_phase(mc_pf, mc_any)
    log(f"[t] table terrain done at {time.perf_counter() - t_start:.1f} s")
    train_phase("pointfoot_flat", policy_eval.FLAT_PATCH, FLAT_TRAIN_WARM,
                FLAT_TRAIN_TIMED, "train-flat", card_vs_cpu=False)
    log(f"[t] plane training done at {time.perf_counter() - t_start:.1f} s")
    rnn_launches = recurrent_phase()
    log(f"[t] recurrent policy done at {time.perf_counter() - t_start:.1f} s")
    gait = gait_phase()
    log(f"[t] gait-MPC done at {time.perf_counter() - t_start:.1f} s")
    ilqr_run = ilqr_phase()
    log(f"[t] iLQR done at {time.perf_counter() - t_start:.1f} s")
    sysid = sysid_phase()
    log(f"[t] sys-ID done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()  # the ranks of phase 17 share the card
    dp = dp_phase()
    log(f"[t] data parallelism done at {time.perf_counter() - t_start:.1f} s")
    last = last_modules_phase(pf_env, policy)
    log(f"[t] the last modules done at {time.perf_counter() - t_start:.1f} s")
    diag = diagnostics_phase(pf_env, mc_pf, pf_after)
    del pf_after
    log(f"[t] the diagnostic CLIs done at "
        f"{time.perf_counter() - t_start:.1f} s")
    p18 = {k: dict(env_phases_launches=last["env_phases"].get(k, 0))
           for k in ("rollout_substep", "fk_from_state")}
    p18.update({k: dict(gait_diag_launches=last["gait_diag"].get(k, 0))
                for k in ("substep", "fk_contact_xy", "srb_lqr")})
    phase15 = {k: dict(gait_launches=gait["launches"].get(k, 0),
                       ilqr_launches=ilqr_run["launches"][k])
               for k in ("substep", "fk_contact_xy", "chol_solve", "srb_lqr")}
    for k, err in (("substep", "substep_err"), ("fk_contact_xy", "fk_xy_err")):
        phase15[k].update(gait_max_abs_err=gait[err],
                          ilqr_max_abs_err=ilqr_run[err])

    kernels = [
        dict(kernel_record("rollout_substep_kernel", SUBSTEP_SRC,
                           "pointfoot_tpu/ops/pallas/substep.py:273",
                           pf_launches["rollout_substep"], **roll), **flat,
             rnn_train_launches=rnn_launches["rollout_substep"],
             sysid_launches=sysid["launches"],
             sysid_max_abs_err=sysid["err"],
             dp_launches=[c["rollout_substep"] for c in dp["launches"]],
             dp_nccl_launches=dp["nccl"]["rollout_substep"],
             dp_max_abs_err=dp["err"], **p18["rollout_substep"],
             **diag["rollout_substep"]),
        dict(kernel_record("fk_from_state_kernel", SUBSTEP_SRC,
                           "pointfoot_tpu/ops/pallas/substep.py:328",
                           pf_launches["fk_from_state"], **fk),
             rnn_train_launches=rnn_launches["fk_from_state"],
             dp_launches=[c["fk_from_state"] for c in dp["launches"]],
             dp_nccl_launches=dp["nccl"]["fk_from_state"],
             dp_max_abs_err=dp["err"], **p18["fk_from_state"],
             **diag["fk_from_state"]),
        dict(kernel_record("substep_kernel", SUBSTEP_SRC,
                           "pointfoot_tpu/ops/pallas/substep.py:65",
                           any_launches["substep"], **sub),
             **phase15["substep"], **p18["substep"], **diag["substep"]),
        dict(kernel_record("fk_contact_xy_kernel", SUBSTEP_SRC,
                           "pointfoot_tpu/ops/pallas/substep.py:201",
                           any_launches["fk_contact_xy"], **fkxy),
             **phase15["fk_contact_xy"], **p18["fk_contact_xy"],
             **diag["fk_contact_xy"]),
        dict(kernel_record("chol_solve_kernel", CHOL_SRC,
                           "pointfoot_tpu/ops/pallas/cholesky.py:35",
                           chol_launches["chol_solve"], **chol),
             **phase15["chol_solve"], **diag["chol_solve"]),
        dict(kernel_record("srb_lqr_kernel", RICCATI_SRC,
                           "pointfoot_tpu/ops/pallas/riccati.py:32",
                           mpc_launches["srb_lqr"], **lqr),
             **phase15["srb_lqr"], gait_max_abs_err=gait["err"],
             **p18["srb_lqr"], **diag["srb_lqr"]),
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
