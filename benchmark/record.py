"""The first training iterations of a runner, recorded for the comparison
that decides `correct`.

The port's `OnPolicyRunner` and the reference's `Runner` take the same
calls, so one function drives either: `init(seed, random_episode_step)`
(`learn` passes True), one zero-action env step for the first observations,
then the warm training iterations through the call the window loops
(`train_iteration`, or `train_iteration_recurrent` with its carry).  Those
iterations are the set-up's warm iterations and the ones compared.

Recorded: the parameters before, after the first iteration and after the
last, each iteration's loss (the surrogate plus the weighted value loss
minus the weighted entropy, means over the minibatches), the first
gradient as the optimizer got it (Adam's first moment after its first
step, divided by 1 - beta1), and the first iteration's rollout storage.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

ROLLOUT_FIELDS = ("obs", "priv_obs", "action", "reward", "done", "value",
                  "log_prob")


@dataclasses.dataclass
class Loop:
    """What one training iteration hands the next."""

    state: object
    obs: torch.Tensor
    priv_obs: Optional[torch.Tensor]
    carry: object = None


@dataclasses.dataclass
class Record:
    params0: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    params: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    params_first: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    grad_first: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    losses: List[float] = dataclasses.field(default_factory=list)
    rollout: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)


def _params(net) -> Dict[str, torch.Tensor]:
    return {k: p.detach().to("cpu", copy=True)
            for k, p in net.named_parameters()}


def iterate(runner, loop: Loop) -> dict:
    """One training iteration through the runner's own call; returns its
    metrics."""
    if runner.recurrent:
        (loop.state, loop.obs, loop.priv_obs, loop.carry,
         metrics) = runner.train_iteration_recurrent(
            loop.state, loop.obs, loop.priv_obs, loop.carry)
    else:
        loop.state, loop.obs, loop.priv_obs, metrics = \
            runner.train_iteration(loop.state, loop.obs, loop.priv_obs)
    return metrics


def total_loss(metrics: dict, alg) -> float:
    return float(metrics["surrogate_loss"]
                 + alg.value_loss_coef * metrics["value_loss"]
                 - alg.entropy_coef * metrics["entropy"])


def start(runner, env, seed: int, traffic: dict) -> Tuple[Loop, Record]:
    """Initialise from `seed` (random episode steps where the traffic
    says so), take the zero-action step and the traffic's warm iterations,
    recorded.  Returns the loop state the window goes on from and the
    record."""
    state = runner.init(seed, bool(traffic["random_episode_step"]))
    state, out0 = env.step(state, torch.zeros(
        env.num_envs, env.num_actions, device=env.device))
    loop = Loop(state, out0.obs, out0.privileged_obs)
    if runner.recurrent:
        loop.carry = runner.network.initialize_carry(env.num_envs)
    rec = Record(params0=_params(runner.network))
    opt = runner.ppo.optimizer
    beta1 = opt.param_groups[0]["betas"][0]
    names = {id(p): k for k, p in runner.network.named_parameters()}

    def first_step(optimizer, args, kwargs):
        for p in optimizer.param_groups[0]["params"]:
            st = optimizer.state.get(p)
            if st and "exp_avg" in st:
                rec.grad_first[names[id(p)]] = (
                    st["exp_avg"].detach().to("cpu", copy=True)
                    / (1.0 - beta1))
        hook.remove()

    hook = opt.register_step_post_hook(first_step)
    try:
        for k in range(int(traffic["warm_iterations"])):
            metrics = iterate(runner, loop)
            rec.losses.append(total_loss(metrics, runner.cfg.algorithm))
            if k == 0:
                rec.params_first = _params(runner.network)
                st = runner.storage
                rec.rollout = {f: getattr(st, f).detach().to(
                    "cpu", torch.float32, copy=True) for f in ROLLOUT_FIELDS}
    finally:
        hook.remove()
    rec.params = _params(runner.network)
    return loop, rec
