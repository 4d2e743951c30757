"""The port's bench/trainer handshake (pointfoot_tpu_torch/utils/
benchlock.py): the cases of tests/test_benchlock.py on the port's module,
the lock shared with the JAX package's module in both directions, and
`OnPolicyRunner.learn` pausing for a bench on the CPU."""

import json
import os
import threading
import time
from dataclasses import replace

import pytest

from pointfoot_tpu.utils import benchlock as jax_benchlock
from pointfoot_tpu_torch.utils import benchlock
from pointfoot_tpu_torch.utils.registry import (get_cfgs, make_alg_runner,
                                                make_env)


@pytest.fixture
def lockdir(tmp_path, monkeypatch):
    lock = str(tmp_path / "bench_lock")
    monkeypatch.setenv("POINTFOOT_BENCH_LOCK", lock)
    yield lock


def _ack(lockdir):
    return lockdir + f".ack.{os.getpid()}"


def _wait_for(path, timeout=10.0):
    deadline = time.time() + timeout
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.02)
    return os.path.exists(path)


def test_heartbeat_fast_path_without_lock(lockdir):
    assert benchlock.trainer_heartbeat() == 0.0
    assert not os.path.exists(_ack(lockdir))


def test_quiesce_no_trainer(lockdir):
    assert benchlock.quiesce(timeout_s=5.0) == "no_trainer"
    assert os.path.exists(lockdir)  # the bench holds the lock
    benchlock.release()
    assert not os.path.exists(lockdir)


def test_trainer_pauses_until_release(lockdir):
    benchlock.trainer_register()
    drained, paused_s = [], []

    def trainer():
        paused_s.append(benchlock.trainer_heartbeat(
            drain=lambda: drained.append(True)))

    # the bench takes the lock before the trainer's heartbeat
    assert benchlock.quiesce(timeout_s=0.1) == "timeout_no_ack"
    t = threading.Thread(target=trainer)
    t.start()
    assert _wait_for(_ack(lockdir)), "trainer never acked"
    assert drained, "trainer must drain device work before acking"
    assert t.is_alive(), "trainer must stay paused while the lock is held"
    benchlock.release()
    t.join(timeout=10)
    assert not t.is_alive()
    assert paused_s and paused_s[0] > 0.0
    assert not os.path.exists(_ack(lockdir))
    benchlock.trainer_unregister()


def test_quiesce_sees_ack(lockdir):
    benchlock.trainer_register()
    stop = threading.Event()

    def trainer():
        while not stop.is_set():
            benchlock.trainer_heartbeat()
            time.sleep(0.02)

    t = threading.Thread(target=trainer)
    t.start()
    try:
        assert benchlock.quiesce(timeout_s=10.0) == "trainer_paused"
    finally:
        benchlock.release()
        stop.set()
        t.join(timeout=10)
        benchlock.trainer_unregister()
    assert not t.is_alive()


def test_stale_lock_does_not_hang_trainer(lockdir, monkeypatch):
    # a bench that died without cleanup must not stall training forever
    monkeypatch.setenv("BENCH_LOCK_MAX_PAUSE_S", "0.2")
    with open(lockdir, "w") as f:
        f.write("999999")  # not a live pid, never releases
    paused = benchlock.trainer_heartbeat()
    assert 0.0 < paused < 5.0


def test_lock_root_is_the_jax_package_s(monkeypatch):
    """Unset, both modules put the lock at the repository root."""
    monkeypatch.delenv("POINTFOOT_BENCH_LOCK", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert benchlock._lock_path() == jax_benchlock._lock_path() == \
        os.path.join(repo, ".bench_lock")


@pytest.mark.parametrize("bench, trainer", [
    (jax_benchlock, benchlock), (benchlock, jax_benchlock)],
    ids=["jax_bench_port_trainer", "port_bench_jax_trainer"])
def test_bench_of_one_package_quiesces_trainer_of_other(lockdir, bench,
                                                        trainer):
    trainer.trainer_register()
    stop = threading.Event()
    paused = []

    def loop():
        while not stop.is_set():
            paused.append(trainer.trainer_heartbeat())
            time.sleep(0.02)

    t = threading.Thread(target=loop)
    t.start()
    try:
        assert bench.quiesce(timeout_s=10.0) == "trainer_paused"
        assert os.path.exists(_ack(lockdir))
        assert t.is_alive()
    finally:
        bench.release()
        stop.set()
        t.join(timeout=10)
        trainer.trainer_unregister()
    assert not t.is_alive()
    assert max(paused) > 0.0
    assert not os.path.exists(lockdir)


@pytest.mark.parametrize("bench, trainer", [
    (jax_benchlock, benchlock), (benchlock, jax_benchlock)],
    ids=["jax_lock_port_heartbeat", "port_lock_jax_heartbeat"])
def test_lock_of_one_package_pauses_heartbeat_of_other(lockdir, bench,
                                                       trainer):
    assert bench.quiesce(timeout_s=5.0) == "no_trainer"
    paused = []
    t = threading.Thread(
        target=lambda: paused.append(trainer.trainer_heartbeat()))
    t.start()
    assert _wait_for(_ack(lockdir))
    time.sleep(0.2)
    assert t.is_alive()
    bench.release()
    t.join(timeout=10)
    assert not t.is_alive() and paused[0] >= 0.2


def test_learn_pauses_for_a_bench_and_takes_the_pause_off_its_rate(
        lockdir, tmp_path, monkeypatch):
    """learn at 8 envs on the CPU: a bench takes the lock after the first
    iteration and holds it for HOLD_S; the trainer acks, pauses, resumes,
    and its steps/s clock leaves the pause out."""
    HOLD_S, ITERS = 1.5, 3
    env = make_env("pointfoot_flat", num_envs=8, device="cpu")
    tc = get_cfgs("pointfoot_flat")[1]
    tc = replace(tc, runner=replace(tc.runner, num_steps_per_env=2),
                 policy=replace(tc.policy, actor_hidden_dims=(32,),
                                critic_hidden_dims=(32,)))
    log_dir = str(tmp_path / "run")
    runner = make_alg_runner(env, "pointfoot_flat", log_dir=log_dir,
                             train_cfg=tc)
    registered, acked, pauses = [], [], []
    heartbeat = benchlock.trainer_heartbeat

    def spy_heartbeat(drain=None):
        registered.append(os.path.exists(
            lockdir + f".trainer.{os.getpid()}"))
        pauses.append(heartbeat(drain=drain))
        return pauses[-1]

    monkeypatch.setattr(benchlock, "trainer_heartbeat", spy_heartbeat)
    iteration = runner.train_iteration

    def bench_after_first(*args):
        out = iteration(*args)
        if runner.current_iteration == 0:  # the first iteration's end
            with open(lockdir, "w") as f:
                f.write("1")

            def hold():
                acked.append(_wait_for(_ack(lockdir)))
                time.sleep(HOLD_S)
                os.remove(lockdir)

            threading.Thread(target=hold).start()
        return out

    runner.train_iteration = bench_after_first
    t0 = time.time()
    runner.learn(ITERS, seed=0, log_every=1)
    wall = time.time() - t0
    assert acked == [True]
    assert all(registered)
    assert not os.path.exists(lockdir + f".trainer.{os.getpid()}")
    assert not os.path.exists(_ack(lockdir))
    # one heartbeat before the loop and one an iteration; the second
    # iteration's waited for the bench
    assert len(pauses) == ITERS + 1
    assert pauses[0] == pauses[1] == pauses[3] == 0.0
    assert pauses[2] >= HOLD_S - 0.1
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        last = [json.loads(line) for line in f][-1]
    steps = ITERS * 2 * 8
    clock = steps / last["steps_per_sec"]
    assert clock < wall - pauses[2] + 0.05
