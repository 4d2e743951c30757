"""Bench/trainer handshake (pointfoot_tpu/utils/benchlock.py, the same
protocol and file names).

A benchmark run that overlaps a live trainer on the same device
time-slices it and under-reports.  This module is the lockfile protocol
that lets bench.py quiesce the trainer:

  trainer (rl/runner.learn):  calls `trainer_heartbeat()` once per
      iteration.  Registers itself in ``.bench_lock.trainer.<pid>``.  When
      ``.bench_lock`` exists it drains queued device work, writes
      ``.bench_lock.ack.<pid>`` and sleeps until the lock disappears.
  bench (bench.py):           calls `quiesce()` before touching the
      device.  Creates ``.bench_lock``, waits for the acks (or for no
      live trainer), runs, and removes the lock (`release`, also at
      exit).

All files live at the repo root, which is also the JAX package's lock
root, so a trainer and a bench of either package quiesce each other
regardless of cwd; POINTFOOT_BENCH_LOCK overrides the lock's path.
"""

from __future__ import annotations

import atexit
import os
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _lock_path() -> str:
    return os.environ.get(
        "POINTFOOT_BENCH_LOCK", os.path.join(_REPO_ROOT, ".bench_lock"))


def _ack_path(pid: int = None) -> str:
    # per-pid: several trainers can coexist (e.g. a short verify run next
    # to the long background queue); each acks independently
    return f"{_lock_path()}.ack.{pid if pid is not None else os.getpid()}"


def _alive_path(pid: int = None) -> str:
    return f"{_lock_path()}.trainer.{pid if pid is not None else os.getpid()}"


def _registered_trainers() -> list:
    """Live registered trainer pids; stale registrations are reaped."""
    import glob

    pids = []
    for p in glob.glob(_lock_path() + ".trainer.*"):
        try:
            pid = int(p.rsplit(".", 1)[-1])
        except ValueError:
            continue
        if _pid_alive(pid):
            pids.append(pid)
        else:
            try:
                os.remove(p)
                os.remove(_ack_path(pid))
            except OSError:
                pass
    return pids


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except PermissionError:
        return True  # pid exists but isn't ours
    except OSError:
        return False


def _read_pid(path: str) -> int:
    try:
        with open(path) as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return 0


# ----------------------------------------------------------------- trainer

def trainer_register() -> None:
    """Record this process as the live trainer (called at learn() start)."""
    try:
        with open(_alive_path(), "w") as f:
            f.write(str(os.getpid()))
        atexit.register(trainer_unregister)
    except OSError:
        pass


def trainer_unregister() -> None:
    for p in (_alive_path(), _ack_path()):
        try:
            os.remove(p)
        except OSError:
            pass


def trainer_heartbeat(drain=None) -> float:
    """Pause while a bench holds the lock.  Call once per train iteration.

    `drain`: optional zero-arg callable that blocks until this process's
    queued device work has completed (e.g. block_until_ready on the last
    metrics), so the chip is actually idle when we ack.

    Returns seconds spent paused (0.0 on the fast path — one stat call).
    """
    lock = _lock_path()
    if not os.path.exists(lock):
        return 0.0
    t0 = time.time()
    if drain is not None:
        drain()
    ack = _ack_path()
    try:
        with open(ack, "w") as f:
            f.write(str(os.getpid()))
    except OSError:
        pass
    # cap the pause: if the bench dies without cleanup (stale lock), resume
    # rather than hanging the training queue forever
    max_pause_s = float(os.environ.get("BENCH_LOCK_MAX_PAUSE_S", "1800"))
    while os.path.exists(lock) and time.time() - t0 < max_pause_s:
        time.sleep(0.5)
    try:
        os.remove(ack)
    except OSError:
        pass
    return time.time() - t0


# ------------------------------------------------------------------- bench

def quiesce(timeout_s: float = 300.0) -> str:
    """Take the bench lock and wait until the chip is quiet.

    Returns the measurement condition for the bench JSON:
      "no_trainer"      — no live trainer was registered
      "trainer_paused"  — a trainer acked the lock and is sleeping
      "timeout_no_ack"  — a trainer looks alive but never acked (measure
                          anyway, flagged so the number is interpretable)
    The lock is removed at interpreter exit.
    """
    lock = _lock_path()
    with open(lock, "w") as f:
        f.write(str(os.getpid()))
    atexit.register(release)
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        trainers = _registered_trainers()
        if not trainers:
            return "no_trainer"
        if all(os.path.exists(_ack_path(p)) for p in trainers):
            return "trainer_paused"
        time.sleep(1.0)
    return "timeout_no_ack"


def release() -> None:
    try:
        if _read_pid(_lock_path()) == os.getpid():
            os.remove(_lock_path())
    except OSError:
        pass
