"""The PyTorch port stands alone: no JAX, nothing of the JAX package, its
own asset copy, and entry points that refuse to drop to the CPU.

The benchmarks take a bench lock of their own, not the repository's, so
that they never pause a trainer of another test process (the subprocesses
inherit it)."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pointfoot_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


@pytest.fixture(autouse=True)
def private_bench_lock(tmp_path, monkeypatch):
    monkeypatch.setenv("POINTFOOT_BENCH_LOCK", str(tmp_path / "bench_lock"))


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".h")):
                yield os.path.join(root, f)
    yield SMOKE


def test_every_module_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'flax', 'orbax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "import pointfoot_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'pointfoot_tpu' or "
        "m.startswith('pointfoot_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 64


def test_sources_do_not_mention_jax_package():
    pattern = re.compile(
        r"pointfoot_tpu\.|^\s*(import|from)\s+(jax|flax|orbax|optax)\b",
        re.MULTILINE)
    hits = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            for m in pattern.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0)}")
    assert not hits, hits


def test_asset_copy_is_byte_identical():
    rel = os.path.join("physics", "_assets", "pointfoot.json")
    with open(os.path.join(REPO, "pointfoot_tpu", rel), "rb") as a, \
            open(os.path.join(PORT, rel), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["anymal_c", "actuator_anydrive_v3_lstm",
                                  "anymal_b", "a1", "cassie"])
def test_new_asset_copies_are_byte_identical(name):
    rel = os.path.join("physics", "_assets", f"{name}.json")
    with open(os.path.join(REPO, "pointfoot_tpu", rel), "rb") as a, \
            open(os.path.join(PORT, rel), "rb") as b:
        assert a.read() == b.read()


def test_slice_modules_import_without_jax():
    """The modules of the step_batched slice, by name, with JAX blocked."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'orbax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "for n in ('ops.spatial', 'ops.linalg', 'ops.quat', "
        "'physics.contact', 'physics.dynamics', 'physics.rowdyn', "
        "'physics.actuator', 'physics.assets', 'ops.cuda.substep', "
        "'ops.cuda.cholesky', 'ops.cuda.build', 'envs.config', "
        "'envs.robot_configs', 'envs.legged_env', 'utils.registry', "
        "'utils.convert', 'terrain.grid', 'terrain.heightfield', "
        "'eval_policy', 'utils.policy_eval'):\n"
        "    importlib.import_module('pointfoot_tpu_torch.' + n)\n"
        "from pointfoot_tpu_torch.physics.assets import get_model\n"
        "m = get_model('anymal_c')\n"
        "assert (m.nb, m.nv, len(m.collision_body)) == (13, 18, 13)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_mpc_slice_modules_import_without_jax():
    """The modules of the SRB-MPC slice, by name, with JAX blocked; the
    bench's tick runs on the CPU when asked to."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'orbax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "for n in ('mpc', 'mpc.riccati', 'mpc.srb', 'ops.cuda.riccati', "
        "'ops.cuda.build', 'ops.quat', 'physics.model', 'utils.convert', "
        "'bench'):\n"
        "    importlib.import_module('pointfoot_tpu_torch.' + n)\n"
        "from pointfoot_tpu_torch import bench\n"
        "rec = bench.main(['--mode', 'mpc', '--device', 'cpu', "
        "'--num_envs', '4', '--iters', '1', '--reps', '1'])\n"
        "assert rec['metric'] == 'srb_mpc_scenario_solves_per_sec@4'\n"
        "assert rec['conditions']['solver'] == 'kernel'\n"
        "assert rec['conditions']['horizon'] == 12\n"
        "bad = [m for m in sys.modules if m == 'pointfoot_tpu' or "
        "m.startswith('pointfoot_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_gait_and_ilqr_modules_import_without_jax():
    """The modules of the gait-MPC and iLQR slice, by name, with JAX
    blocked; a gait tick and a one-step plan run on the CPU when asked
    to."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'orbax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "for n in ('terrain.analytic', 'mpc.costs', 'mpc.ilqr', "
        "'mpc.controller', 'mpc.gait', 'mpc'):\n"
        "    importlib.import_module('pointfoot_tpu_torch.' + n)\n"
        "import torch\n"
        "from pointfoot_tpu_torch.mpc import make_controller, ILQRConfig\n"
        "from pointfoot_tpu_torch.mpc.controller import MPCController\n"
        "from pointfoot_tpu_torch.physics.model import PhysicsState\n"
        "from pointfoot_tpu_torch.physics.model import PhysicsParams\n"
        "from pointfoot_tpu_torch.terrain.analytic import make_terrain\n"
        "st = make_controller('pointfoot', device='cpu')\n"
        "p = PhysicsState.default(st.ctrl.model, st.q0, 2, 'cpu', "
        "base_height=st.z0)\n"
        "tau, g = st.ctrl.control(p, torch.zeros(2, 3), "
        "st.ctrl.init(2, p))\n"
        "assert tau.shape == (2, 6) and bool(torch.isfinite(tau).all())\n"
        "m = st.ctrl.model\n"
        "c = MPCController(m, PhysicsParams.nominal(m, 1, 'cpu'), "
        "make_terrain('flat'), st.q0, cfg=ILQRConfig(horizon=1, "
        "iterations=1))\n"
        "u, ms, cost = c.plan(p, torch.zeros(2, 3), c.init(2))\n"
        "assert bool(torch.isfinite(cost).all())\n"
        "bad = [m for m in sys.modules if m == 'pointfoot_tpu' or "
        "m.startswith('pointfoot_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_sysid_modules_import_without_jax():
    """The modules of the sys-ID slice, by name, with JAX blocked; the
    exported actor loads as a torch function and an identifier step runs
    on the CPU when asked to."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'orbax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "for n in ('models', 'models.nets', 'sysid', 'sysid.simulate', "
        "'sysid.realdata', 'sysid.gan', 'sysid.wgan', 'sysid.identifier', "
        "'sysid.direct_gan', 'export.onnx', 'utils.convert', 'gan', "
        "'identifier', 'inference'):\n"
        "    importlib.import_module('pointfoot_tpu_torch.' + n)\n"
        "import torch\n"
        "from pointfoot_tpu_torch.export.onnx import load_policy_as_torch\n"
        "from pointfoot_tpu_torch.sysid import IdentifierTrainer\n"
        "from pointfoot_tpu_torch.utils.registry import make_env\n"
        "pol = load_policy_as_torch('logs/pointfoot_flat/tpu_run7/exported/"
        "policy.pt', device='cpu')\n"
        "env = make_env('pointfoot_flat', num_envs=2, device='cpu')\n"
        "t = IdentifierTrainer(env, pol, window=3, warmup=1, hidden=8)\n"
        "m = t.train_step(env.init_state(0), torch.zeros(3))\n"
        "assert bool(torch.isfinite(m['mse']))\n"
        "bad = [m for m in sys.modules if m == 'pointfoot_tpu' or "
        "m.startswith('pointfoot_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_parallel_slice_modules_import_without_jax():
    """The modules of the data-parallel slice, by name, with JAX blocked;
    one process on a mesh of its own (no process group) trains an
    iteration on the CPU."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'orbax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "for n in ('parallel', 'parallel.mesh', 'scaling_bench', 'train', "
        "'rl', 'rl.ppo', 'rl.runner', 'envs', 'envs.legged_env', "
        "'physics', 'terrain', 'ops.cuda.substep', 'utils.registry'):\n"
        "    importlib.import_module('pointfoot_tpu_torch.' + n)\n"
        "import torch\n"
        "from pointfoot_tpu_torch.parallel import make_mesh\n"
        "from pointfoot_tpu_torch.utils.registry import (make_env, "
        "make_alg_runner)\n"
        "mesh = make_mesh('cpu')\n"
        "env = make_env('pointfoot_flat', num_envs=2, device='cpu')\n"
        "r = make_alg_runner(env, 'pointfoot_flat', mesh=mesh)\n"
        "es = r.init(0)\n"
        "es, o = env.step(es, torch.zeros(2, 6))\n"
        "es, _, _, m = r.train_iteration(es, o.obs, o.privileged_obs)\n"
        "assert bool(torch.isfinite(m['kl']))\n"
        "bad = [m for m in sys.modules if m == 'pointfoot_tpu' or "
        "m.startswith('pointfoot_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_last_modules_import_without_jax(tmp_path):
    """The modules of the last slice (utils, runtime, the URDF compiler,
    the CLIs), by name, with JAX blocked; a log round trip, a URDF
    compile and the CLIs' helpers run on the CPU."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'orbax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "for n in ('utils.helpers', 'utils.logger', 'utils.profiling', "
        "'utils.visualizer', 'utils.benchlock', 'runtime', "
        "'runtime.recorder', 'runtime.policy', 'runtime.native', "
        "'physics.urdf', 'physics.assets', 'play', 'test_env', "
        "'gait_diag', 'make_gif', 'comparison', 'shape', 'bake_assets', "
        "'bench'):\n"
        "    importlib.import_module('pointfoot_tpu_torch.' + n)\n"
        "import numpy as np\n"
        "from pointfoot_tpu_torch.runtime import TrajectoryRecorder, "
        "read_log\n"
        "from pointfoot_tpu_torch.physics import load_urdf\n"
        "from pointfoot_tpu_torch import shape\n"
        "d = sys.argv[1]\n"
        "with TrajectoryRecorder(d + '/a.tlog', 3) as r:\n"
        "    r.push_batch(np.ones((4, 3))); r.flush()\n"
        "assert read_log(d + '/a.tlog')[0].shape == (4, 3)\n"
        "assert shape.main([d + '/a.tlog', d + '/a.tlog']).startswith("
        "'EQUAL')\n"
        "open(d + '/r.urdf', 'w').write('<robot name=\"r\"><link "
        "name=\"base\"/><link name=\"leg\"/><joint name=\"j\" "
        "type=\"revolute\"><parent link=\"base\"/><child "
        "link=\"leg\"/></joint></robot>')\n"
        "m, jmap = load_urdf(d + '/r.urdf')\n"
        "assert (m.nb, jmap) == (2, {'j': 0})\n"
        "bad = [m for m in sys.modules if m == 'pointfoot_tpu' or "
        "m.startswith('pointfoot_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_diagnostic_clis_import_without_jax(tmp_path):
    """The run-diagnostic and validation CLIs, by name, with JAX blocked;
    the storm guard and the terrain-family split run on a port run's
    files."""
    code = (
        "import sys, importlib, json\n"
        "for m in ('jax', 'jaxlib', 'flax', 'orbax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "for n in ('storm_guard', 'terrain_family_stats', 'regen_golden', "
        "'contact_calibration', 'catapult_hunt', 'ctrlseq_compare', "
        "'profile_substep', 'multihost_smoke'):\n"
        "    importlib.import_module('pointfoot_tpu_torch.' + n)\n"
        "import torch\n"
        "from pointfoot_tpu_torch import storm_guard, terrain_family_stats\n"
        "d = sys.argv[1]\n"
        "open(d + '/metrics.jsonl', 'w').write(''.join(json.dumps(dict("
        "it=i, value_loss=1.0, noise_std=0.4)) + '\\n' for i in range(20)))\n"
        "assert storm_guard.main([d])['code'] == 0\n"
        "torch.save({'iteration': 3, 'env_state': {'terrain_level': "
        "torch.arange(40) % 10, 'terrain_type': torch.arange(40) % 20}}, "
        "d + '/model_3.pt')\n"
        "out = terrain_family_stats.main([d + '/model_3.pt'])\n"
        "assert sum(f['envs'] for f in out['families']) == 40\n"
        "bad = [m for m in sys.modules if m == 'pointfoot_tpu' or "
        "m.startswith('pointfoot_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


# JAX's names the port's packages do not export, and why: TrainState has no
# counterpart (rl/__init__.py), multihost_init is init_distributed
REEXPORT_GAPS = {"rl": {"TrainState"}, "parallel": {"multihost_init"}}
REEXPORT_EXTRA = {"parallel": {"init_distributed", "Mesh", "all_reduce_sum_",
                               "all_reduce_mean_", "all_gather_rows"}}


@pytest.mark.parametrize("package", ["envs", "rl", "physics", "terrain",
                                     "parallel", "runtime"])
def test_package_reexports_match_jax(package):
    import importlib

    jax_pkg = importlib.import_module(f"pointfoot_tpu.{package}")
    port = importlib.import_module(f"pointfoot_tpu_torch.{package}")
    want = set(jax_pkg.__all__) - REEXPORT_GAPS.get(package, set())
    assert set(port.__all__) == want | REEXPORT_EXTRA.get(package, set())
    for name in port.__all__:
        obj = getattr(port, name)
        assert obj.__module__.startswith("pointfoot_tpu_torch."), name
        if name in jax_pkg.__all__:
            assert obj.__name__ == getattr(jax_pkg, name).__name__


def test_bench_record_and_unported_modes(capsys):
    import json

    from pointfoot_tpu_torch import bench

    rec = bench.main(["--mode", "mpc", "--device", "cpu", "--num_envs", "3",
                      "--iters", "1", "--reps", "2", "--solver", "plain"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert set(rec) == {"metric", "value", "unit", "vs_baseline",
                        "conditions"}
    assert rec["unit"] == "solves/s"
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / (3 * 50.0),
                                               abs=1e-3)
    cond = rec["conditions"]
    assert cond["solver"] == "plain" and cond["card"] == "cpu"
    assert len(cond["reps_solves_per_sec"]) == 2
    assert cond["trainer"] == "no_trainer"
    # every mode runs: env_phases, the last one ported, gives its record
    assert set(bench.MODES) == set(bench.ITERS)
    rec = bench.main(["--mode", "env_phases", "--device", "cpu",
                      "--num_envs", "1", "--iters", "1", "--steps", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert set(rec) == {"metric", "value", "unit", "vs_baseline",
                        "conditions", "phases", "phase_gain_us_per_step",
                        "num_envs"}
    assert len(rec["phases"]) == 6 and rec["conditions"]["card"] == "cpu"


def test_bench_mpc_ilqr_record(capsys):
    """bench --mode mpc_ilqr on the CPU at 2 scenarios, one timed plan."""
    import json

    from pointfoot_tpu_torch import bench

    rec = bench.main(["--mode", "mpc_ilqr", "--device", "cpu",
                      "--num_envs", "2", "--iters", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert set(rec) == {"metric", "value", "unit", "vs_baseline",
                        "conditions"}
    assert rec["metric"] == "ilqr_scenario_solves_per_sec@2"
    assert rec["unit"] == "solves/s" and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / (2 * 50.0),
                                               rel=1e-2)
    cond = rec["conditions"]
    assert cond["card"] == "cpu" and cond["chunk"] == 2
    assert cond["reps"] == 1 and cond["horizon"] == 25


def _entry_points():
    from pointfoot_tpu_torch import (bench, catapult_hunt,
                                     contact_calibration, ctrlseq_compare,
                                     device, eval_policy, export_policy,
                                     gait_diag, gan, identifier, inference,
                                     make_gif, multihost_smoke, play,
                                     profile_substep, regen_golden,
                                     scaling_bench, test_env, train)
    from pointfoot_tpu_torch.parallel import mesh
    from pointfoot_tpu_torch.export.onnx import load_policy_as_torch
    from pointfoot_tpu_torch.utils import policy_eval, registry

    return {
        "resolve_device": lambda: device.resolve_device(),
        "make_env": lambda: registry.make_env("pointfoot_rough", num_envs=2),
        "make_env_anymal": lambda: registry.make_env(
            "anymal_c_rough", num_envs=2,
            cfg_patch={"terrain": {"procedural": True}}),
        "make_eval_env": lambda: policy_eval.make_eval_env(
            "pointfoot_rough", 2, policy_eval.FLAGSHIP_PATCH),
        "play": lambda: play.main(["--num_envs", "2", "--steps", "1"]),
        "bench_mpc": lambda: bench.main(["--mode", "mpc", "--num_envs", "2"]),
        "bench_mpc_ilqr": lambda: bench.main(["--mode", "mpc_ilqr",
                                              "--num_envs", "2"]),
        "train": lambda: train.main(["--num_envs", "2",
                                     "--max_iterations", "1"]),
        "bench_train": lambda: bench.main(["--mode", "train",
                                           "--num_envs", "2"]),
        "make_env_flat": lambda: registry.make_env("pointfoot_flat",
                                                   num_envs=2),
        "bench_env": lambda: bench.main(["--mode", "env", "--num_envs", "2"]),
        "bench_actuator_net": lambda: bench.main(["--mode", "actuator_net",
                                                  "--num_envs", "2"]),
        "eval_policy": lambda: eval_policy.main(["--num_envs", "2",
                                                 "--secs", "0.1"]),
        "export_policy": lambda: export_policy.main(
            ["--load_run", policy_eval.FLAT_ACTOR, "--out", os.devnull]),
        "gan": lambda: gan.main(["--real", os.devnull]),
        "identifier": lambda: identifier.main(["--iters", "1"]),
        "inference": lambda: inference.main(["--ckpt", os.devnull]),
        "load_policy_as_torch": lambda: load_policy_as_torch(os.path.join(
            REPO, "logs", "pointfoot_flat", "tpu_run7", "exported",
            "policy.pt")),
        "make_mesh": lambda: mesh.make_mesh(),
        "scaling_bench": lambda: scaling_bench.main([]),
        "play_task": lambda: play.main(["--task", "pointfoot_flat",
                                        "--num_envs", "2", "--steps", "1"]),
        "bench_env_phases": lambda: bench.main(["--mode", "env_phases",
                                                "--num_envs", "2"]),
        "test_env": lambda: test_env.main(["--episodes", "0.001"]),
        "gait_diag": lambda: gait_diag.main(["--b", "2", "--ticks", "1"]),
        "make_gif_policy": lambda: make_gif.main(["--steps", "1",
                                                  "--out", os.devnull]),
        "make_gif_gait": lambda: make_gif.main(["--mode", "gait", "--steps",
                                                "1", "--out", os.devnull]),
        "contact_calibration": lambda: contact_calibration.main(
            ["--experiments", "static"]),
        "catapult_hunt": lambda: catapult_hunt.main(
            ["--load_run", policy_eval.FLAT_ACTOR, "--envs", "2",
             "--steps", "1"]),
        "ctrlseq_compare": lambda: ctrlseq_compare.main(["--steps", "1"]),
        "profile_substep": lambda: profile_substep.main([]),
        "regen_golden": lambda: regen_golden.main(
            ["--reason", "r", "--golden_dir", os.devnull]),
        "multihost_smoke": lambda: multihost_smoke.main([]),
    }


@pytest.mark.parametrize("name", ["resolve_device", "make_env",
                                  "make_env_anymal", "make_eval_env",
                                  "play", "bench_mpc", "bench_mpc_ilqr",
                                  "train",
                                  "bench_train", "make_env_flat",
                                  "bench_env", "bench_actuator_net",
                                  "eval_policy", "export_policy", "gan",
                                  "identifier", "inference",
                                  "load_policy_as_torch", "make_mesh",
                                  "scaling_bench", "play_task",
                                  "bench_env_phases", "test_env",
                                  "gait_diag", "make_gif_policy",
                                  "make_gif_gait", "contact_calibration",
                                  "catapult_hunt", "ctrlseq_compare",
                                  "profile_substep", "regen_golden",
                                  "multihost_smoke"])
def test_entry_points_raise_without_cuda(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, SMOKE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
