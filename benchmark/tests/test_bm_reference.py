"""The comparison that decides `correct`, on the CPU at a tiny size: the
port and the reference agree on every cell, and each fault a training cell
can have, planted in the port, makes `correct` come out false.  The control
(the reference with TF32 matrix products) exists on the card only.

Each cell is reached through its own driver, found by the name its traffic
gives (`drivers/<driver>.py`).  The runs skip the harness's look for a
chip: they call the driver with a CPU device, 4 envs a rank (2 a rank on
gloo ranks for a multi-rank cell) and 4-step iterations.  At that batch
the port would take the scan path of `step_batched`; the driver's
`cpu_route` makes it take the cells' route (for the PPO drivers, the fused
rollout through the plain versions of kernels 1-2)."""

from __future__ import annotations

import json
import sys
import time
import types

import pytest
import torch

from benchmark import compare, faults, spec

CELLS = [w["name"] for w in spec.load_json(
    f"{spec.ROOT}/BENCHMARK.json")["workloads"]]
MULTI_RANK = [c for c in CELLS if spec.load_cell(c).ranks > 1]


def tiny(name: str, envs: int = 4, steps: int = 4) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config = json.loads(json.dumps(cell.config))
    cell.config["train"]["runner"]["num_steps_per_env"] = steps
    cell.traffic = dict(cell.traffic, envs_per_rank=envs, warm_iterations=2)
    return cell


def tiny_envs(name: str) -> int:
    """Envs a rank of a tiny run: 4, or 2 on each rank of a multi-rank
    cell."""
    return 4 if spec.load_cell(name).ranks == 1 else 2


def driver(cell: spec.Cell):
    return spec.load_module("drivers", cell.traffic["driver"])


def run_cpu(cell, seed=2**31 + 11):
    args = types.SimpleNamespace(seed=seed, seconds=0.0, trace=0)
    drv = driver(cell)
    with drv.cpu_route():
        return drv.run(cell, args, time.perf_counter(),
                       device=torch.device("cpu"))


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_reference(name):
    """Every number 0 on one rank.  Across gloo ranks the rollout (before
    any update) is still exact, but the all-reduces sum in another order
    than the reference's plain sums in rank order, so the rest is held to
    the cell's limits."""
    cell = tiny(name, envs=tiny_envs(name))
    out = run_cpu(cell)
    if cell.ranks == 1:
        assert out["numbers"] == {k: 0.0 for k in compare.NUMBERS}
    assert out["numbers"]["rollout"] == 0.0, out["numbers"]
    assert compare.verdict(out["numbers"], cell.limits), out["numbers"]
    assert out["iterations"] >= 1 and out["rate"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("name", ["pf_mlp_train_procedural",
                                  "pf_lstm_train_table"])
def test_a_planted_fault_is_not_correct(name, fault):
    cell = tiny(name, envs=8)
    with faults.FAULTS[fault]():
        out = run_cpu(cell)
    assert not compare.verdict(out["numbers"], cell.limits), out["numbers"]


@pytest.mark.parametrize("fault", ["exchange_dropped", "state_unchanged",
                                   "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", MULTI_RANK)
def test_a_planted_fault_is_not_correct_across_ranks(name, fault):
    """The faults reach the spawned ranks; dropping the gradients'
    exchange is a fault of a multi-rank cell alone."""
    cell = tiny(name, envs=2)
    with faults.FAULTS[fault]():
        assert faults.active() == [fault]
        out = run_cpu(cell)
    assert not compare.verdict(out["numbers"], cell.limits), out["numbers"]


@pytest.mark.parametrize("name", MULTI_RANK)
def test_a_rank_that_loaded_jax_gives_no_result(name, capfd):
    """A spawned rank that finds JAX in `sys.modules` once its window has
    closed exits with code 3 and writes no output, so rank 0 raises and
    the run prints no result (rank 0's own look is benchmark/run.py's)."""
    cell = tiny(name, envs=2)
    with faults.FAULTS["jax_loaded"]():
        with pytest.raises(RuntimeError, match="exited with code 3"):
            run_cpu(cell)
    assert "jax" not in sys.modules
    assert "loaded ['jax']; no result" in capfd.readouterr().err


@pytest.mark.parametrize("name", CELLS)
def test_port_records_start_each_task_afresh(name):
    """`port_records` (benchmark/calibrate.py) gives each task what a run
    from that seed alone records, on every rank, though a driver may keep
    its env and runner from task to task; a fault open for one task alone
    moves that task's record only."""
    cell = tiny(name, envs=tiny_envs(name))
    drv = driver(cell)
    seed = 2**31 + 11
    with drv.cpu_route():
        recs = list(drv.port_records(
            cell, [(seed, []), (seed + 1, []), (seed, ["answer_altered"]),
                   (seed, [])], torch.device("cpu")))
    assert faults.active() == []
    ref = drv.reference_record(cell, seed, torch.device("cpu"))
    zero = {k: 0.0 for k in compare.NUMBERS}
    first, _, bad, again = (drv.numbers(r, ref) for r in recs)
    if cell.ranks == 1:
        assert first == again == zero
    assert again == first, (first, again)
    assert not compare.verdict(bad, cell.limits), bad


def test_unchanged_state_reads_one():
    ref = types.SimpleNamespace(
        params0={"w": torch.zeros(3)}, params={"w": torch.ones(3)},
        grad_first={"w": torch.ones(3)}, losses=[1.0],
        rollout={"obs": torch.ones(2)})
    prog = types.SimpleNamespace(
        params0={"w": torch.zeros(3)}, params={"w": torch.zeros(3)},
        grad_first={}, losses=[1.0], rollout={"obs": torch.ones(2)})
    ref.params_first, prog.params_first = ref.params, prog.params
    nums = compare.numbers(prog, ref)
    assert nums["param_change"] == 1.0 and nums["grad_first"] == 1.0
    first = compare.first_numbers(prog, ref)
    assert first == {"loss_first": 0.0, "param_change_first": 1.0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name):
    """The reference with TF32 matrix products in the port's place, at 256
    envs a rank, on three seeds (a multi-rank cell's reference runs its
    shards in one process, on one card)."""
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 exists on the card only")
    cell = tiny(name, envs=256, steps=24)
    drv = driver(cell)
    dev = torch.device("cuda", 0)
    for seed in (5, 6, 7):
        ref = drv.reference_record(cell, seed, dev)
        ctl = drv.reference_record(cell, seed, dev, tf32=True)
        nums = drv.numbers(ctl, ref)
        assert not compare.verdict(nums, cell.limits), nums
