"""Faults planted in the port for the checks that the comparison catches
them (benchmark/calibrate.py on the card, benchmark/tests on the CPU).

Each is a context manager that patches the port's classes while it is
open:

- `state_unchanged`: the optimizer's step does nothing, so an update
  returns the parameters it was given;
- `half_batch`: every minibatch loss takes the first half of its samples
  (of its envs for the recurrent PPO), the mean over them;
- `answer_altered`: the env's step returns each reward 1% higher than the
  one it computed.

The exchange between chips has no fault here: no cell runs on more than
one chip.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, attr, fn):
    old = getattr(obj, attr)
    setattr(obj, attr, fn)
    try:
        yield
    finally:
        setattr(obj, attr, old)


@contextlib.contextmanager
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


@contextlib.contextmanager
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


@contextlib.contextmanager
def answer_altered():
    from pointfoot_tpu_torch.envs.legged_env import LeggedEnv
    step = LeggedEnv.step

    def altered(self, state, actions):
        state, out = step(self, state, actions)
        return state, out._replace(reward=out.reward * 1.01)

    with _patched(LeggedEnv, "step", altered):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}
