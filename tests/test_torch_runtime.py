"""The port's native runtime (pointfoot_tpu_torch/runtime/): the cases of
tests/test_runtime.py on the port's recorder and policy runner, the
runner on the port's exported ONNX against the port's ActorCritic, both
packages' runners and log readers on each other's files, the byte copies
of the C++ sources, and the comparison and shape CLIs."""

import os
import time

import numpy as np
import pytest
import torch

from pointfoot_tpu.runtime import NativePolicy as JaxNativePolicy
from pointfoot_tpu.runtime import TrajectoryRecorder as JaxRecorder
from pointfoot_tpu.runtime import read_log as jax_read_log
from pointfoot_tpu_torch import comparison, shape
from pointfoot_tpu_torch.export.onnx import export_policy_as_onnx
from pointfoot_tpu_torch.rl.networks import ActorCritic
from pointfoot_tpu_torch.runtime import (NativePolicy, TrajectoryRecorder,
                                         read_log)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY_ATOL = 2e-5  # tests/test_runtime.py's tolerance against flax


def test_recorder_roundtrip(tmp_path):
    path = str(tmp_path / "run.tlog")
    rng = np.random.default_rng(0)
    data = rng.normal(size=(500, 27)).astype(np.float32)
    with TrajectoryRecorder(path, record_size=27, capacity=128) as rec:
        for i in range(100):
            assert rec.push(data[i])
        n = rec.push_batch(data[100:500])
        rec.flush()
        written = rec.written
        dropped = rec.dropped
    assert written + dropped == 100 + n + (400 - n)
    out, rs = read_log(path)
    assert rs == 27
    assert out.shape[0] == written
    # every written record is one of the source rows, in order
    np.testing.assert_array_equal(out[:100], data[:100])


def test_recorder_nonblocking_under_overflow(tmp_path):
    """A tiny ring drops rather than blocks when the producer outruns the
    writer thread."""
    path = str(tmp_path / "over.tlog")
    row = np.zeros(8, np.float32)
    with TrajectoryRecorder(path, record_size=8, capacity=4) as rec:
        t0 = time.perf_counter()
        for _ in range(20000):
            rec.push(row)
        elapsed = time.perf_counter() - t0
        rec.flush()
        total = rec.written + rec.dropped
        written = rec.written
    assert total == 20000
    assert elapsed < 2.0  # never blocked
    out, _ = read_log(path)
    assert out.shape[0] == written


def test_reader_rejects_garbage(tmp_path):
    p = tmp_path / "bad.tlog"
    p.write_bytes(b"not a tlog file at all")
    with pytest.raises(ValueError):
        read_log(str(p))


def _actor(actor_hidden, seed):
    torch.manual_seed(seed)
    return ActorCritic(27, 27, 6, actor_hidden, (16,)).eval()


@pytest.mark.parametrize("actor_hidden, layers", [((64, 32), 3), ((16,), 2)],
                         ids=["mlp", "wide_input"])
def test_native_policy_runner_matches_actor(tmp_path, actor_hidden, layers):
    """The C++ runner decodes the port's exported .onnx actor and matches
    the port's forward pass, batched and for one observation (the robot's
    control loop); (16,) is the case of an observation wider than every
    hidden layer."""
    net = _actor(actor_hidden, 3)
    path = export_policy_as_onnx(net, 27, str(tmp_path / "p.onnx"))
    pol = NativePolicy(path)
    assert (pol.obs_dim, pol.act_dim, pol.num_layers) == (27, 6, layers)
    obs = np.random.default_rng(4).normal(size=(16, 27)).astype(np.float32)
    with torch.no_grad():
        ref = net.act_mean(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(pol(obs), ref, atol=POLICY_ATOL)
    np.testing.assert_allclose(pol(obs[0]), ref[0], atol=POLICY_ATOL)
    with pytest.raises(ValueError, match="obs dim"):
        pol(obs[:, :26])
    pol.close()


def test_port_and_jax_runners_agree_bit_for_bit(tmp_path):
    net = _actor((64, 32), 5)
    path = export_policy_as_onnx(net, 27, str(tmp_path / "p.onnx"))
    obs = np.random.default_rng(6).normal(size=(32, 27)).astype(np.float32)
    port, ref = NativePolicy(path), JaxNativePolicy(path)
    np.testing.assert_array_equal(port(obs), ref(obs))
    port.close()
    ref.close()


@pytest.mark.parametrize("writer, reader", [
    (TrajectoryRecorder, jax_read_log), (JaxRecorder, read_log)],
    ids=["port_writes_jax_reads", "jax_writes_port_reads"])
def test_logs_cross_packages(tmp_path, writer, reader):
    path = str(tmp_path / "x.tlog")
    data = np.random.default_rng(7).normal(size=(50, 27)).astype(np.float32)
    with writer(path, record_size=27) as rec:
        assert rec.push_batch(data) == 50
        rec.flush()
    out, rs = reader(path)
    assert rs == 27
    np.testing.assert_array_equal(out, data)


@pytest.mark.parametrize("name", ["trajectory_log.cpp", "policy_runner.cpp"])
def test_cpp_sources_are_byte_copies(name):
    rel = os.path.join("runtime", "src", name)
    with open(os.path.join(REPO, "pointfoot_tpu", rel), "rb") as a, \
            open(os.path.join(REPO, "pointfoot_tpu_torch", rel), "rb") as b:
        assert a.read() == b.read()


def test_libraries_build_into_the_port_s_own_directory():
    from pointfoot_tpu_torch.runtime import native, policy, recorder

    for mod in (recorder, policy):
        lib = mod._load() if mod is recorder else mod._load_lib()
        assert os.path.dirname(lib._name) == native.BUILD_DIR
    assert native.BUILD_DIR == os.path.join(REPO, "pointfoot_tpu_torch",
                                            "_build")


def _write_log(path, data):
    with TrajectoryRecorder(path, record_size=data.shape[1]) as rec:
        rec.push_batch(data)
        rec.flush()
    return path


def test_shape_cli(tmp_path, capsys):
    data = np.random.default_rng(8).normal(size=(40, 27)).astype(np.float32)
    a = _write_log(str(tmp_path / "a.tlog"), data)
    assert shape.main([a, a]) == "EQUAL within atol=1e-06 over 40 steps"
    other = data.copy()
    other[17, 5] += 1e-3
    b = _write_log(str(tmp_path / "b.tlog"), other)
    line = shape.main([a, b])
    assert line.startswith("DIVERGE at step 17") and line.endswith("(dim 5)")
    np.save(tmp_path / "c.npy", data[:30])
    assert shape.main([a, str(tmp_path / "c.npy")]) == \
        "EQUAL within atol=1e-06 over 30 steps"
    assert "length mismatch: 40 vs 30" in capsys.readouterr().out


def test_comparison_cli(tmp_path, capsys):
    rng = np.random.default_rng(9)
    sim = rng.normal(size=(60, 27)).astype(np.float32)
    real = sim + 0.5
    # real data as the sys-ID tools read it: an npy of dicts with 'obs'
    entries = np.empty(len(real), dtype=object)
    entries[:] = [{"obs": row} for row in real]
    np.save(tmp_path / "real.npy", entries, allow_pickle=True)
    out = str(tmp_path / "cmp.png")
    err = comparison.main(["--sim", _write_log(str(tmp_path / "s.tlog"), sim),
                           "--real", str(tmp_path / "real.npy"),
                           "--out", out])
    np.testing.assert_allclose(err, 0.5, atol=1e-6)
    assert err.shape == (27,) and os.path.getsize(out) > 0
    assert "overall max err: 0.5000" in capsys.readouterr().out
