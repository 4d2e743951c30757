"""The two-process collective smoke test (pointfoot_tpu_torch.multihost_smoke,
scripts/multihost_smoke.py of the JAX package) on the CPU: two gloo
processes on a free loopback port sum their shards to the JAX script's
expected total; a wait past its time limit fails the run and leaves no
worker behind."""

import subprocess

import pytest

from pointfoot_tpu_torch import multihost_smoke


def test_two_processes_sum_their_shards(capsys, monkeypatch):
    monkeypatch.delenv("SMOKE_PORT", raising=False)
    monkeypatch.setattr(multihost_smoke, "WAIT_TIMEOUT_S", 120.0)
    rec = multihost_smoke.main(["--device", "cpu"])
    assert rec["ok"] and rec["rcs"] == [0, 0]
    # the JAX script's total: sum(range(12)) * 2 + 100 * 12 * sum(range(2))
    assert rec["expected"] == 1332.0 and rec["total"] == 1332.0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("multihost_smoke OK: psum-total 1332.0 "
                             "(expected 1332.0) across 2 processes")
    assert out[-1] == "all workers exited cleanly"


def test_a_late_worker_fails_the_run(monkeypatch):
    monkeypatch.setattr(multihost_smoke, "WAIT_TIMEOUT_S", 0.0)
    started = []
    popen = subprocess.Popen

    def record(*args, **kwargs):
        started.append(popen(*args, **kwargs))
        return started[-1]

    monkeypatch.setattr(subprocess, "Popen", record)
    with pytest.raises(subprocess.TimeoutExpired):
        multihost_smoke.main(["--device", "cpu"])
    assert len(started) == 2
    assert all(p.poll() is not None for p in started)  # none left running
