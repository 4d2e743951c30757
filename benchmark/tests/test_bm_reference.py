"""The comparison that decides `correct`, on the CPU at a tiny size: the
port and the reference agree on every cell, and each fault a training cell
can have, planted in the port, makes `correct` come out false.  The control
(the reference with TF32 matrix products) exists on the card only.

The runs skip the harness's look for a chip: they call the cell's driver
with a CPU device, 4 envs and 4-step iterations.  At that batch the port
would take the scan path of `step_batched`; `MEGA_MIN_BATCH` is lowered so
that it takes the fused rollout, the route of the cells (through the plain
versions of kernels 1-2 on the CPU)."""

from __future__ import annotations

import json
import time
import types

import pytest
import torch

from benchmark import compare, faults, spec
from benchmark.drivers import ppo_train

CELLS = [w["name"] for w in spec.load_json(
    f"{spec.ROOT}/BENCHMARK.json")["workloads"] if w["chips"] == 1]


def tiny(name: str, envs: int = 4, steps: int = 4) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config = json.loads(json.dumps(cell.config))
    cell.config["train"]["runner"]["num_steps_per_env"] = steps
    cell.traffic = dict(cell.traffic, envs_per_rank=envs, warm_iterations=2)
    return cell


@pytest.fixture
def fused_route(monkeypatch):
    import pointfoot_tpu_torch.physics.dynamics as dynamics
    monkeypatch.setattr(dynamics, "MEGA_MIN_BATCH", 1)


def run_cpu(cell, seed=2**31 + 11):
    args = types.SimpleNamespace(seed=seed, seconds=0.0, trace=0)
    return ppo_train.run(cell, args, time.perf_counter(),
                         device=torch.device("cpu"))


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_reference(fused_route, name):
    cell = tiny(name)
    out = run_cpu(cell)
    assert out["numbers"] == {k: 0.0 for k in compare.NUMBERS}
    assert compare.verdict(out["numbers"], cell.limits)
    assert out["iterations"] >= 1 and out["rate"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("name", ["pf_mlp_train_table",
                                  "pf_lstm_train_table"])
def test_a_planted_fault_is_not_correct(fused_route, name, fault):
    cell = tiny(name, envs=8)
    with faults.FAULTS[fault]():
        out = run_cpu(cell)
    assert not compare.verdict(out["numbers"], cell.limits), out["numbers"]


def test_unchanged_state_reads_one():
    ref = types.SimpleNamespace(
        params0={"w": torch.zeros(3)}, params={"w": torch.ones(3)},
        grad_first={"w": torch.ones(3)}, losses=[1.0],
        rollout={"obs": torch.ones(2)})
    prog = types.SimpleNamespace(
        params0={"w": torch.zeros(3)}, params={"w": torch.zeros(3)},
        grad_first={}, losses=[1.0], rollout={"obs": torch.ones(2)})
    nums = compare.numbers(prog, ref)
    assert nums["param_change"] == 1.0 and nums["grad_first"] == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name):
    """The reference with TF32 matrix products in the port's place, at 256
    envs, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 exists on the card only")
    cell = tiny(name, envs=256, steps=24)
    dev = torch.device("cuda", 0)
    for seed in (5, 6, 7):
        ref = ppo_train.reference_record(cell, seed, dev)
        ctl = ppo_train.reference_record(cell, seed, dev, tf32=True)
        nums = compare.numbers(ctl, ref)
        assert not compare.verdict(nums, cell.limits), nums
