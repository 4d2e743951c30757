"""The port's `anymal_c_rough` (ANYmal C with the ANYdrive v3 actuator LSTM
on the scan path) against the benchmark's plain reference of it
(benchmark/reference/anymal_env.py), on the CPU at 8 envs, on seeded
random policy weights.

Both sides run the same float32 operations in the same order on one device:
the reference is a frozen copy of the port's plain route.  So every
comparison here is exact (tolerance 0), and any difference is a change of
the mathematics or of its order.  The port runs through the driver's
`cpu_route`, under which `step_batched` takes its mega-kernel route through
the plain versions of kernels 4 and 3 (`fk_xy_rows_plain`,
`step_rows_plain`), as the card takes the kernels, and not the batched
Cholesky assembly it takes on the CPU otherwise.  A reference with TF32
matrix products (on the card) or with a dropped actuator tick is not
correct by the cell's limits."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from benchmark import compare, spec
from benchmark.reference import actuator as ref_act
from benchmark.reference import anymal_env as ref_anymal
from benchmark.reference.config import LeggedEnvCfg
from pointfoot_tpu_torch.ops.cuda import substep as substep_cuda
from pointfoot_tpu_torch.physics import actuator as act
from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.utils.registry import make_env

CELL = "anymal_c_train_table"
B = 8
SEED = 2**31 + 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # identical float32 sums on both sides need one intra-op partitioning
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(envs: int = B, steps: int = 4) -> spec.Cell:
    """The cell at `envs` envs and `steps`-step iterations, 2 recorded."""
    cell = spec.load_cell(CELL)
    cell.config = json.loads(json.dumps(cell.config))
    cell.config["train"]["runner"]["num_steps_per_env"] = steps
    cell.traffic = dict(cell.traffic, envs_per_rank=envs, warm_iterations=2)
    return cell


def driver(cell: spec.Cell):
    return spec.load_module("drivers", cell.traffic["driver"])


def _leaves(x, prefix=""):
    """(name, tensor) of every tensor of nested dataclasses, tuples and
    dicts."""
    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{prefix}.{f.name}")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{prefix}[{k}]")
    elif isinstance(x, tuple):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{prefix}[{i}]")


def assert_same(port, ref):
    p, r = dict(_leaves(port)), dict(_leaves(ref))
    assert p.keys() == r.keys()
    diff = [k for k in p if not torch.equal(p[k], r[k])]
    assert not diff, diff


def test_actuator_ticks_and_carry_match_exactly():
    """Four ticks of the LSTM from a zero carry on seeded inputs: torques
    and carries equal bit for bit, and the reference's copy of the weights
    is the port's."""
    w_port = act.load_anydrive_weights("cpu")
    w_ref = ref_act.load_anydrive_weights("cpu")
    assert_same(tuple(w_port), tuple(w_ref))
    g = torch.Generator().manual_seed(SEED)
    c_port = act.init_carry((B, 12))
    c_ref = ref_act.init_carry((B, 12), "cpu")
    for _ in range(4):
        pos_err = 0.3 * torch.randn(B, 12, generator=g)
        vel = 2.0 * torch.randn(B, 12, generator=g)
        t_port, c_port = act.actuator_net_torque(w_port, c_port, pos_err, vel)
        t_ref, c_ref = ref_act.actuator_net_torque(w_ref, c_ref, pos_err, vel)
        assert torch.equal(t_port, t_ref) and torch.equal(c_port, c_ref)
    assert c_port.abs().max() > 0 and t_port.abs().max() > 0


def test_env_step_matches_reference_on_the_kernels_plain_route(monkeypatch):
    """From one seed, the state and outputs of one env step with seeded
    actions are equal field by field; the port's 4 substeps took the plain
    versions of kernels 4 and 3, not the Cholesky assembly."""
    cell = tiny()
    values = spec.env_values(cell)
    calls = {"fk": 0, "step": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def refused(*a, **kw):
        raise AssertionError("the Cholesky assembly ran")

    monkeypatch.setattr(substep_cuda, "fk_xy_rows_plain",
                        counted("fk", substep_cuda.fk_xy_rows_plain))
    monkeypatch.setattr(substep_cuda, "step_rows_plain",
                        counted("step", substep_cuda.step_rows_plain))
    monkeypatch.setattr(dynamics, "assemble_velocity_solve", refused)
    port = make_env("anymal_c_rough", num_envs=B, device="cpu",
                    cfg_patch={k: spec.tuples(v) for k, v in values.items()})
    ref = ref_anymal.AnymalEnv(spec.overlay(LeggedEnvCfg(), values), "cpu")
    s_port = port.init_state(SEED, True)
    s_ref = ref.init_state(SEED, True)
    assert_same(s_port, s_ref)
    actions = torch.randn(B, 12, generator=torch.Generator().manual_seed(3))
    with driver(cell).cpu_route():
        s_port, out_port = port.step(s_port, actions)
    s_ref, out_ref = ref.step(s_ref, actions)
    assert calls == {"fk": 4, "step": 4}
    assert_same(s_port, s_ref)
    assert_same(tuple(out_port), tuple(out_ref))
    assert s_port.actuator_carry.shape == (B, 12, 2, 2, 8)
    assert s_port.actuator_carry.abs().max() > 0


def test_first_iterations_match_reference():
    """Two 4-step iterations from one seed: every number of the comparison
    is 0, the first iteration's loss and parameter change too, and the
    parameters moved."""
    cell = tiny()
    drv = driver(cell)
    with drv.cpu_route():
        prog, = drv.port_records(cell, [(SEED, [])], torch.device("cpu"))
    ref = drv.reference_record(cell, SEED, torch.device("cpu"))
    assert drv.numbers(prog, ref) == {k: 0.0 for k in compare.NUMBERS}
    assert compare.first_numbers(prog, ref) == {
        "loss_first": 0.0, "param_change_first": 0.0}
    moved = compare.change(prog)
    assert max(float(v.abs().max()) for v in moved.values()) > 0
    assert compare.verdict(drv.numbers(prog, ref), cell.limits)


def test_a_dropped_actuator_tick_is_not_correct(monkeypatch):
    """A reference that drops the last actuator tick of every env step (the
    third tick's torque and carry stand for the fourth) reads past the
    cell's limits against the port."""
    cell = tiny()
    drv = driver(cell)
    with drv.cpu_route():
        prog, = drv.port_records(cell, [(SEED, [])], torch.device("cpu"))
    tick = ref_anymal.actuator_net_torque
    last = {}

    def dropping(weights, carry, pos_err, vel):
        last["n"] = last.get("n", 0) + 1
        if last["n"] % 4 == 0:
            return last["out"]
        last["out"] = tick(weights, carry, pos_err, vel)
        return last["out"]

    monkeypatch.setattr(ref_anymal, "actuator_net_torque", dropping)
    ref = drv.reference_record(cell, SEED, torch.device("cpu"))
    nums = drv.numbers(prog, ref)
    assert not compare.verdict(nums, cell.limits), nums
    assert nums["rollout"] > cell.limits["rollout"], nums


@pytest.mark.cuda
def test_tf32_reference_is_not_correct_on_the_card():
    """The reference with TF32 matrix products against itself in float32,
    at 256 envs and 24-step iterations, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 exists on the card only")
    cell = tiny(envs=256, steps=24)
    drv = driver(cell)
    dev = torch.device("cuda", 0)
    for seed in (5, 6, 7):
        ref = drv.reference_record(cell, seed, dev)
        ctl = drv.reference_record(cell, seed, dev, tf32=True)
        nums = drv.numbers(ctl, ref)
        assert not compare.verdict(nums, cell.limits), nums
