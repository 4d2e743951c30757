"""The cell `anymal_c_train_table` on the CPU: its files found by name and
checked, kernel 3's bytes against a hand count, its two per-layer readers
on made-up observations (and on a program without the actuator's span),
and the reference's ANYmal modules importing nothing of the port, with a
planted import that the check catches."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import compare, counts_scan, spec

CELL = "anymal_c_train_table"
ROOT = spec.ROOT
REFERENCE = ("benchmark.reference.anymal_env", "benchmark.reference.actuator",
             "benchmark.reference.scan_substep")
PORT_OR_JAX = {"pointfoot_tpu_torch", "pointfoot_tpu", "jax", "jaxlib",
               "flax"}


def test_batched_substep_bytes_hand_count():
    # ANYmal C: 12 joints, 13 collision spheres.  In: pose 3 + 4, velocities
    # 3 + 3, qpos 12, qvel 12 (37), then torque 12, push 3, friction 13,
    # joint friction 12, added mass 1, CoM 3, contact k 1 and d 1 (46);
    # surface: 13 heights and 13 x 3 normal components (52); out: the
    # state's 37 and 13 x 3 contact forces (39)
    assert counts_scan.batched_substep_rows(12, 13) == {
        "state_in": 37, "inputs": 46, "surface": 52, "state_out": 37,
        "contact_out": 39}
    assert counts_scan.batched_substep_bytes(12, 13, 32768) \
        == 4 * 211 * 32768 == 27_656_192
    assert counts_scan.batched_substep_bytes(12, 13, 32768, surface=False) \
        == 4 * 159 * 32768


def test_cell_files_found_by_name_and_checked():
    cell = spec.load_cell(CELL)
    bench = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    w = {x["name"]: x for x in bench["workloads"]}[CELL]
    assert w["chips"] == 1 and w["traffic"] == "anymal_table_32k"
    assert cell.config["name"] == w["config"] == "anymal_c_rough_mlp"
    assert cell.config["task"] == "anymal_c_rough"
    assert cell.traffic["driver"] == "ppo_train_anymal"
    assert cell.traffic["envs_per_rank"] == 32768 and cell.ranks == 1
    drv = spec.load_module("drivers", cell.traffic["driver"])
    assert set(cell.limits) == set(drv.NUMBERS) == set(compare.NUMBERS)
    drv.check_config(cell)
    names = {m["name"] for m in cell.per_layer}
    assert {"actuator_ms_per_step", "batched_substep_roofline"} <= names
    for m in cell.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    # the registered task as it runs: every width and recipe number as
    # registered, the env count the traffic's
    from pointfoot_tpu_torch.utils.registry import get_cfgs
    env, train = get_cfgs("anymal_c_rough")
    want = spec.lists(dataclasses.asdict(env))
    want["env"]["num_envs"] = cell.traffic["envs_per_rank"]
    assert cell.config["env"] == want
    assert cell.config["train"] == spec.lists(dataclasses.asdict(train))
    assert cell.config["env"]["control"]["use_actuator_network"] is True


def _rows(actuator_s):
    spans = {"env.step": {"count": 24, "total_s": 0.5, "self_s": 0.1}}
    if actuator_s is not None:
        spans["actuator.torque"] = {"count": 96, "total_s": actuator_s,
                                    "self_s": actuator_s}
    return [{"iteration": i, "spans": spans, "counters": {}}
            for i in range(3)]


def test_actuator_ms_per_step_reads_the_programs_span():
    read = spec.load_module("metrics", "actuator_ms_per_step").read
    # 3 rows of 24 steps, 0.072 s of ticks each: 0.216 s over 72 steps
    assert read({"program_rows": _rows(0.072)}) == pytest.approx(3.0)
    # a program without the span (the parent of the change that added it)
    assert read({"program_rows": _rows(None)}) is None
    assert read({}) is None


def test_batched_substep_roofline_reads_kernel_3_alone():
    read = spec.load_module("metrics", "batched_substep_roofline").read
    cfg = spec.load_cell(CELL).config
    bw = 3.35e12
    need = 4 * 211 * 32768 / bw  # 8.2556 us
    kernels = {
        "(anonymous namespace)::substep_kernel(float const*, float*)":
            [96, 96 * 4 * need],
        "(anonymous namespace)::rollout_substep_kernel(float const*)":
            [96, 1.0]}
    obs = {"device_name": "NVIDIA H100 80GB HBM3", "envs": 32768,
           "model": {"nj": 12, "nc": 13}, "config": cfg,
           "profiles": [{"kernels": kernels}]}
    assert read(obs) == pytest.approx(25.0)
    only_rollout = {"(anonymous namespace)::rollout_substep_kernel(float)":
                    [96, 1.0]}
    assert read(dict(obs, profiles=[{"kernels": only_rollout}])) is None
    assert read(dict(obs, device_name="cpu")) is None


def _fresh_modules(code: str, cwd: str, path: str) -> set:
    env = dict(os.environ, PYTHONPATH=path)
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
        check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_port(tmp_path):
    """The ANYmal reference and the driver's reference record load neither
    the port nor JAX; the same look finds an import of the port planted in
    a copy of the reference."""
    code = "import " + ", ".join(REFERENCE)
    assert not _fresh_modules(code, ROOT, ROOT) & PORT_OR_JAX
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    planted = tmp_path / "benchmark" / "reference" / "scan_substep.py"
    planted.write_text(planted.read_text()
                       + "\nimport pointfoot_tpu_torch.physics.rowdyn\n")
    # the copy first on the path, the port importable behind it
    found = _fresh_modules(code, str(tmp_path), f"{tmp_path}{os.pathsep}"
                           f"{ROOT}")
    assert found & PORT_OR_JAX == {"pointfoot_tpu_torch"}
