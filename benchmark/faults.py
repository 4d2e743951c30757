"""Faults planted in the port for the checks that the comparison catches
them (benchmark/calibrate.py on the card, benchmark/tests on the CPU).

Each is a context manager that patches the port's classes while it is
open:

- `state_unchanged`: the optimizer's step does nothing, so an update
  returns the parameters it was given;
- `half_batch`: every minibatch loss takes the first half of its samples
  (of its envs for the recurrent PPO), the mean over them;
- `answer_altered`: the env's step returns each reward 1% higher than the
  one it computed;
- `exchange_dropped`: the optimizer step of a data-parallel run skips the
  gradients' `all_reduce_sum_`, so each rank steps on its own share of the
  gradient (the other collectives still run); a run on one rank has no
  exchange to drop;
- `jax_loaded`: a stand-in module named `jax` in `sys.modules`, as if the
  port had imported JAX; not a fault of the numbers: a run where it is
  open prints no result (benchmark/run.py, and each spawned rank of
  benchmark/drivers/ppo_train_dp.py).

A fault records its name while it is open (`active`), so that a driver
that starts ranks as processes of their own opens the same faults there
(`opened`).
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Sequence

_OPEN: List[str] = []  # the names of the faults open in this process


def active() -> List[str]:
    """The faults open in this process, in the order they were opened."""
    return list(_OPEN)


def _fault(fn):
    """A fault's context manager that records its name while open."""
    cm = contextlib.contextmanager(fn)

    @functools.wraps(fn)
    @contextlib.contextmanager
    def opened_fault():
        with cm():
            _OPEN.append(fn.__name__)
            try:
                yield
            finally:
                _OPEN.remove(fn.__name__)
    return opened_fault


@contextlib.contextmanager
def opened(names: Sequence[str]):
    """Every fault of `names` open, in that order."""
    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(FAULTS[name]())
        yield


@contextlib.contextmanager
def _patched(obj, attr, fn):
    old = getattr(obj, attr)
    setattr(obj, attr, fn)
    try:
        yield
    finally:
        setattr(obj, attr, old)


@_fault
def state_unchanged():
    from pointfoot_tpu_torch.rl import ppo
    sgd = ppo.PPO._sgd_step

    def no_step(self, kl):
        self.optimizer.step = lambda closure=None: None
        try:
            sgd(self, kl)
        finally:
            del self.optimizer.step

    with _patched(ppo.PPO, "_sgd_step", no_step):
        yield


@_fault
def half_batch():
    from pointfoot_tpu_torch.rl import ppo
    from pointfoot_tpu_torch.rl.networks import map_carry
    ff, rec = ppo.PPO.loss_and_grad, ppo.RecurrentPPO.loss_and_grad

    def ff_half(self, batch, advantages, returns, count=None):
        n = batch.obs.shape[0] // 2
        return ff(self, ppo.Transition(*(x[:n] for x in batch)),
                  advantages[:n], returns[:n], count)

    def rec_half(self, carry0, batch, advantages, returns, count=None):
        n = batch.obs.shape[1] // 2
        return rec(self, map_carry(lambda c: c[:n], carry0),
                   ppo.Transition(*(x[:, :n] for x in batch)),
                   advantages[:, :n], returns[:, :n], count)

    with _patched(ppo.PPO, "loss_and_grad", ff_half), \
            _patched(ppo.RecurrentPPO, "loss_and_grad", rec_half):
        yield


@_fault
def answer_altered():
    from pointfoot_tpu_torch.envs.legged_env import LeggedEnv
    step = LeggedEnv.step

    def altered(self, state, actions):
        state, out = step(self, state, actions)
        return state, out._replace(reward=out.reward * 1.01)

    with _patched(LeggedEnv, "step", altered):
        yield


@_fault
def exchange_dropped():
    from pointfoot_tpu_torch.rl import ppo
    sgd = ppo.PPO._sgd_step

    def alone(self, kl):
        # `_sgd_step` reads the mesh for the gradients' all-reduce alone
        mesh, self.mesh = self.mesh, None
        try:
            sgd(self, kl)
        finally:
            self.mesh = mesh

    with _patched(ppo.PPO, "_sgd_step", alone):
        yield


@_fault
def jax_loaded():
    import sys
    import types
    if "jax" in sys.modules:
        raise RuntimeError("jax is loaded already")
    sys.modules["jax"] = types.ModuleType("jax")
    try:
        yield
    finally:
        del sys.modules["jax"]


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered,
          "exchange_dropped": exchange_dropped, "jax_loaded": jax_loaded}
