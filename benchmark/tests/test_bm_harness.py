"""The harness on the CPU: BENCHMARK.json against its contract, every file a
cell names found by name, the counts against hand counts, the result line's
keys, and the runs that must fail (no card, a bare directory, JAX loaded)."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark import compare, counts, run, spec

ROOT = spec.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in CELLS
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.isfile(
            os.path.join(ROOT, c["file"]))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] in {x["name"] for x in BENCH["configs"]}
    spec.load_module("drivers", c.traffic["driver"])
    for m in c.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    assert c.limits is not None
    assert set(c.limits) == set(compare.NUMBERS)
    # the port and the reference take the configuration as the file has it
    from benchmark.drivers import ppo_train
    from benchmark.reference.config import LeggedEnvCfg, TrainCfg
    spec.check_same(spec.overlay(LeggedEnvCfg(), spec.env_values(c)),
                    spec.env_values(c), "reference")
    spec.check_same(spec.overlay(TrainCfg(), c.config["train"]),
                    c.config["train"], "reference")
    assert ppo_train.build_port  # the port is built on the card only


def test_network_flops_hand_counts():
    mlp = spec.load_json(os.path.join(spec.BENCH_DIR, "configs",
                                      "pointfoot_rough_mlp.json"))
    m = counts.network_macs(mlp)
    # actor 27-512-256-128-6, critic 148-512-256-128-1
    assert m["actor"] == 27 * 512 + 512 * 256 + 256 * 128 + 128 * 6
    assert m["critic"] == 148 * 512 + 512 * 256 + 256 * 128 + 128
    assert m["actor"] + m["critic"] == 418_176
    f = counts.network_flops_per_iteration(mlp, 4096)
    T, fwd = 24, 418_176
    bwd = 2 * fwd - (27 * 512 + 148 * 512)
    assert f == 2.0 * (T * 4096 * fwd + 4096 * m["critic"]
                       + 5 * T * 4096 * (fwd + bwd))
    lstm = spec.load_json(os.path.join(spec.BENCH_DIR, "configs",
                                       "pointfoot_rough_lstm.json"))
    r = counts.network_macs(lstm)
    assert r["actor"] == 4 * 256 * (27 + 256) + 256 * 512 + 512 * 256 \
        + 256 * 128 + 128 * 6
    assert r["critic"] == 4 * 256 * (148 + 256) + 256 * 512 + 512 * 256 \
        + 256 * 128 + 128
    assert r["actor"] + r["critic"] == 1_294_208


def test_substep_bytes_hand_count():
    # PointFoot: 6 joints, 9 collision spheres
    rows = counts.substep_rows(6, 9)
    assert rows == {"state_in": 31, "ctrl": 42, "surface": 36,
                    "state_out": 31, "extra": 60}
    assert counts.substep_bytes(6, 9, 4096) == 4 * 200 * 4096
    assert counts.substep_bytes(6, 9, 4096, surface=False) == 4 * 164 * 4096


def _fake_out(trace: bool):
    obs = {"profiles": [{"busy_s": 0.2, "window_s": 1.0, "iterations": 1,
                         "kernels": {"rollout_substep_kernel": [96, 0.003]},
                         "device_ops": [["k", 0.1]],
                         "idle_gaps": [["bm.update: aten::item", 0.01]]}],
           "spans": types.SimpleNamespace(
               host={"rollout": [0.3], "update": [0.1]},
               events={"env_step": [10.0], "terrain_per_step": [2.0]}),
           "iteration_s": 0.4, "envs": 4096, "ranks": 1,
           "device_name": "NVIDIA H100 80GB HBM3",
           "model": {"nj": 6, "nc": 9},
           "config": spec.load_json(os.path.join(
               spec.BENCH_DIR, "configs", "pointfoot_rough_mlp.json"))}
    return {"numbers": {k: 0.0 for k in compare.NUMBERS}, "rate": 2e5,
            "setup_s": 12.0, "memory_peak_bytes": 1 << 30, "iterations": 9,
            "window_s": 20.1, "observed": obs if trace else {}}


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contract_keys(monkeypatch, trace):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(run, "card", lambda *a: {})
    cell = spec.load_cell("pf_mlp_train_table")
    args = types.SimpleNamespace(trace=trace)
    res = run.result_line(cell, args, _fake_out(bool(trace)))
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "compared"
    assert res["correct"] is True
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
        assert 0 < res["metrics"]["rollout_substep_roofline"]["value"] <= 100
    else:
        assert set(res["metrics"]) == {"train_env_steps_per_s", "setup_s"}
    json.dumps(res)


def _run_bench(cwd, *extra):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "pf_mlp_train_table", "--seed", "3", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_no_card_fails_without_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    p = _run_bench(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_bare_directory_fails_without_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_bench(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _fresh_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_the_benchmark_runs_loads_jax():
    mods = _fresh_modules(
        "from benchmark import run, spec, calibrate, faults\n"
        "from benchmark.drivers import ppo_train\n"
        "import pointfoot_tpu_torch.utils.registry, "
        "pointfoot_tpu_torch.rl.runner\n"
        "for m in spec.load_json('BENCHMARK.json')['per_layer']:\n"
        "    spec.load_module('metrics', m['name'])\n"
        "import benchmark.reference.runner\n")
    assert not mods & set(run.FORBIDDEN)
    assert "pointfoot_tpu_torch" in mods


def test_reference_imports_nothing_of_the_port():
    mods = _fresh_modules(
        "import benchmark.reference.runner, benchmark.reference.legged_env")
    assert not mods & {"pointfoot_tpu_torch", "pointfoot_tpu", "jax",
                       "jaxlib", "flax"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pointfoot_tpu_torch_x", types)
    assert "pointfoot_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pointfoot_tpu.envs", types)
    assert "pointfoot_tpu" in run.forbidden_modules()
