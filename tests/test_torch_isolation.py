"""The PyTorch port stands alone: no JAX, nothing of the JAX package, its
own asset copy, and entry points that refuse to drop to the CPU."""

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
    assert int(proc.stdout.split()[-1]) >= 15


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


def _entry_points():
    from pointfoot_tpu_torch import device, play
    from pointfoot_tpu_torch.utils import policy_eval, registry

    return {
        "resolve_device": lambda: device.resolve_device(),
        "make_env": lambda: registry.make_env("pointfoot_rough", num_envs=2),
        "make_eval_env": lambda: policy_eval.make_eval_env(
            "pointfoot_rough", 2, policy_eval.FLAGSHIP_PATCH),
        "play": lambda: play.main(["--num_envs", "2", "--steps", "1"]),
    }


@pytest.mark.parametrize("name", ["resolve_device", "make_env",
                                  "make_eval_env", "play"])
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
