"""The run-diagnostic and validation CLIs of the port against the JAX
package's scripts (scripts/storm_guard.py, terrain_family_stats.py,
regen_golden.py, contact_calibration.py, catapult_hunt.py,
ctrlseq_compare.py, profile_substep.py), on the CPU at small sizes.

- storm_guard: the JAX test's four cases, every committed metrics.jsonl
  and a port training run give the same code and message in both; the
  reward-clip guard of tests/test_storm_guard.py under the port.
- terrain_family_stats: model_234000's terrain state in a port checkpoint
  gives the JAX tool's JSON on the Orbax original.
- regen_golden: the committed recipe is JAX's random inputs exactly; the
  CLI on a copy of tests/golden archives, records provenance and the
  history row, and its anchor equals the repository's at the golden
  tolerance (tests/test_golden_trajectory.py:49-50); replay_archive gives
  each archive's drift against the current anchor.
- contact_calibration: `run` against JAX's `run` over 40 steps at the step
  tolerances of tests/test_torch_dynamics.py; the static experiment's
  weight balance; the whole script against JAX's printed numbers (slow).
- catapult_hunt, ctrlseq_compare, profile_substep: the printed records and
  the reductions; the committed default actor equals its Orbax original.
"""

import glob
import importlib.util
import json
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from _torch_parity import export_fields
from pointfoot_tpu_torch import (catapult_hunt, contact_calibration,
                                 ctrlseq_compare, profile_substep,
                                 regen_golden, storm_guard,
                                 terrain_family_stats)
from pointfoot_tpu_torch.utils import convert, policy_eval
from pointfoot_tpu_torch.utils.registry import make_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
FLAGSHIP = os.path.join(REPO, "logs", "pointfoot_rough", "tpu_r4_storm",
                        "model_234000")
RUN7 = os.path.join(REPO, "logs", "pointfoot_flat", "tpu_run7",
                    "model_4500")
METRICS = sorted(glob.glob(os.path.join(REPO, "logs", "**", "metrics.jsonl"),
                           recursive=True))


def _script(name: str):
    """A JAX script of scripts/ as a module (as tests/test_storm_guard.py
    loads storm_guard.py)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def private_bench_lock(tmp_path, monkeypatch):
    monkeypatch.setenv("POINTFOOT_BENCH_LOCK", str(tmp_path / "bench_lock"))


# ----------------------------------------------------------- storm_guard

def _rows(case: str):
    # tests/test_storm_guard.py::test_metrics_storm_detector's regimes
    calm = [{"it": i, "value_loss": 2.5 + (350 if i % 37 == 0 else 0),
             "noise_std": 0.44} for i in range(60)]
    return {
        "calm": (calm, 0, "calm"),
        "storm": ([{"it": i, "value_loss": 3000.0 + 50 * i,
                    "noise_std": 0.6} for i in range(60)], 1, "value_loss"),
        "noise_inflation": ([{"it": i, "value_loss": 5.0, "noise_std": 0.9}
                             for i in range(60)], 1, "noise_std"),
        "too_few_rows": (calm[:3], 2, "only 3 rows"),
    }[case]


@pytest.mark.parametrize("case", ["calm", "storm", "noise_inflation",
                                  "too_few_rows"])
def test_storm_guard_cases_match_jax(tmp_path, case):
    rows, code, word = _rows(case)
    p = tmp_path / "metrics.jsonl"
    p.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    got = storm_guard.check(str(p))
    assert got == _script("storm_guard").check(str(p))
    assert got[0] == code and word in got[1]


@pytest.mark.parametrize("path", METRICS,
                         ids=[os.path.relpath(os.path.dirname(p), REPO)
                              for p in METRICS])
def test_storm_guard_on_committed_logs(path):
    assert storm_guard.check(path) == _script("storm_guard").check(path)


def test_storm_guard_on_a_port_training_run(tmp_path, capsys):
    """A 1-iteration CPU run's metrics.jsonl (too few rows: code 2 in
    both); then the CLI's alarm file on a storm, and none when calm."""
    from pointfoot_tpu_torch import train

    run = tmp_path / "run"
    train.main(["--task", "pointfoot_flat", "--device", "cpu", "--num_envs",
                "8", "--max_iterations", "1", "--log_every", "1",
                "--log_dir", str(run)])
    path = str(run / "metrics.jsonl")
    row = json.loads(open(path).readline())
    assert {"it", "value_loss", "noise_std"} <= set(row)
    got = storm_guard.check(path)
    assert got == _script("storm_guard").check(path) and got[0] == 2

    for case, alarm in (("calm", False), ("storm", True)):
        d = tmp_path / case
        d.mkdir()
        rows, code, _ = _rows(case)
        (d / "metrics.jsonl").write_text(
            "\n".join(json.dumps(r) for r in rows) + "\n")
        rec = storm_guard.main([str(d)])
        assert rec["code"] == code
        assert capsys.readouterr().out.strip().endswith(rec["message"])
        assert (d / "STORM_ALARM").exists() == alarm
        if alarm:
            assert (d / "STORM_ALARM").read_text() == rec["message"] + "\n"


def test_default_clip_is_storm_safe():
    """tests/test_storm_guard.py under the port."""
    from pointfoot_tpu_torch.envs.config import RewardsCfg

    assert RewardsCfg().clip_reward <= 20.0 + 1e-9
    env = make_env("pointfoot_rough", num_envs=1, device="cpu")
    assert env.cfg.rewards.clip_reward <= 20.0 + 1e-9


def test_finite_garbage_step_is_clipped():
    """A finite-but-huge state (the storm igniter) may not produce a
    reward outside the guard band (tests/test_storm_guard.py)."""
    env = make_env("pointfoot_flat", num_envs=8, device="cpu")
    state = env.init_state(0)
    phys = state.physics
    qvel, lin = phys.qvel.clone(), phys.base_lin_vel.clone()
    qvel[3] = 1e4
    lin[3] = torch.tensor([1e4, -1e4, 1e4])
    state = state.replace(physics=phys.replace(qvel=qvel, base_lin_vel=lin))
    clip = env.cfg.rewards.clip_reward
    with torch.no_grad():
        _, out = env.step(state, torch.zeros(8, 6))
    r = out.reward.numpy()
    assert np.isfinite(r).all()
    assert np.abs(r).max() <= clip + 1e-6, (
        f"reward {np.abs(r).max()} escaped the +-{clip} guard band")


# -------------------------------------------------- terrain_family_stats

def test_terrain_family_stats_match_jax(tmp_path, capsys, monkeypatch):
    """model_234000's terrain state, restored with Orbax and written into a
    port checkpoint: the same JSON as the JAX tool's on the original, apart
    from `ckpt`."""
    import orbax.checkpoint as ocp

    raw = ocp.PyTreeCheckpointer().restore(FLAGSHIP)
    es = raw["env_state"]
    path = str(tmp_path / "model_234000.pt")
    torch.save({"iteration": int(raw["iteration"]), "env_state": {
        k: torch.from_numpy(np.asarray(es[k]).astype(np.int64))
        for k in ("terrain_level", "terrain_type")}}, path)
    got = terrain_family_stats.main([path])
    assert json.loads(capsys.readouterr().out) == got

    monkeypatch.setattr(sys, "argv", ["terrain_family_stats.py", FLAGSHIP])
    _script("terrain_family_stats").main()
    want = json.loads(capsys.readouterr().out)
    assert got["ckpt"] == path and want["ckpt"] == FLAGSHIP
    got.pop("ckpt"), want.pop("ckpt")
    assert got == want
    assert len(got["families"]) == 5 and got["iteration"] == 234000


# ------------------------------------------------------------ regen_golden

def jax_recipe(jenv, seed: int, steps: int, prefix: str = "") -> dict:
    """A JAX env's random inputs (utils/recipe.py): the initial state of
    PRNGKey(seed) (the port's EnvState fields) and, for each of `steps`
    steps, the reset draws its `_reset_envs` would make, keyed as the JAX
    step splits the state's key."""
    import dataclasses

    import jax

    from pointfoot_tpu_torch.envs.legged_env import EnvState

    js = jenv.init_state(jax.random.PRNGKey(seed))
    fields = export_fields(js)
    out = {}
    for f in dataclasses.fields(EnvState):
        v = fields[f.name]
        if isinstance(v, dict):
            out.update({f"state/{f.name}/{k}": a for k, a in v.items()})
        else:
            out[f"state/{f.name}"] = v
    B, nj = jenv.num_envs, jenv.model.nj
    key, qs, vel = js.rng, [], []
    for _ in range(steps):
        k = jax.random.split(jax.random.split(key, 5)[2], 6)
        qs.append(np.asarray(jax.random.uniform(k[1], (B, nj), minval=0.5,
                                                maxval=1.5)))
        vel.append(np.asarray(jax.random.uniform(k[3], (B, 6), minval=-0.5,
                                                 maxval=0.5)))
        key = jax.random.split(key, 5)[0]
    out["reset_qpos_scale"] = np.stack(qs)
    out["reset_vel"] = np.stack(vel)
    return {prefix + k: v for k, v in out.items()}


def jax_golden_recipe() -> dict:
    """The golden anchor's: PRNGKey(42), 50 steps (tests/test_torch_flat.py,
    before the recipe moved into regen_golden).  `np.savez_compressed(
    regen_golden.RECIPE, **jax_golden_recipe())` wrote the committed
    file."""
    from pointfoot_tpu.envs.config import override as joverride
    from pointfoot_tpu.envs.legged_env import LeggedEnv as JaxEnv
    from pointfoot_tpu.utils.registry import task_registry

    jenv = JaxEnv(joverride(task_registry.get_cfgs("pointfoot_flat")[0],
                            **regen_golden.GOLDEN_PATCH))
    return jax_recipe(jenv, 42, regen_golden.STEPS)


def _assert_recipe(path: str, want: dict):
    with np.load(path) as f:
        assert sorted(f.files) == sorted(want)
        for k, v in want.items():
            assert f[k].dtype == v.dtype, k
            np.testing.assert_array_equal(f[k], v, err_msg=k)


def test_golden_recipe_is_jax_exactly():
    _assert_recipe(regen_golden.RECIPE, jax_golden_recipe())


def _digest(root: str) -> dict:
    out = {}
    for p in sorted(glob.glob(os.path.join(root, "**", "*"),
                              recursive=True)):
        if os.path.isfile(p):
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_regen_golden_cli(tmp_path, capsys):
    before = _digest(GOLDEN)
    gdir = tmp_path / "golden"
    shutil.copytree(GOLDEN, gdir)
    with np.load(os.path.join(GOLDEN, regen_golden.ANCHOR_NAME),
                 allow_pickle=True) as ref:
        ref = {k: ref[k] for k in ref.files}
    gen, rev = int(ref["generation"]), str(ref["git_rev"])
    rec = regen_golden.main(["--reason", "a test's regeneration",
                             "--golden_dir", str(gdir), "--device", "cpu"])
    out = capsys.readouterr().out
    name = f"pointfoot_flat_50step_gen{gen:02d}_{rev}.npz"
    assert rec["archived"] == name and rec["generation"] == gen + 1
    assert f"archived generation {gen} -> archive/{name}" in out
    assert _digest(str(gdir / "archive"))[name] == \
        before[regen_golden.ANCHOR_NAME]
    with np.load(gdir / regen_golden.ANCHOR_NAME) as new:
        assert sorted(new.files) == sorted(
            ["obs", "torques", "generation", "git_rev", "date", "reason"])
        assert int(new["generation"]) == gen + 1
        assert str(new["git_rev"]) == rec["git_rev"] == \
            regen_golden.git_revision()
        assert str(new["reason"]) == "a test's regeneration"
        assert re.fullmatch(r"\d{4}-\d\d-\d\d", str(new["date"]))
        np.testing.assert_allclose(new["torques"], ref["torques"],
                                   atol=2e-3, rtol=1e-4)
        np.testing.assert_allclose(new["obs"], ref["obs"], atol=2e-3,
                                   rtol=1e-4)
        date = str(new["date"])
    hist = (gdir / "archive" / "HISTORY.md").read_text().splitlines()
    assert hist[:-1] == before[os.path.join("archive", "HISTORY.md")
                               ].decode().splitlines()
    assert hist[-1] == (f"| {gen + 1} | {date} | {rec['git_rev']} | "
                        f"a test's regeneration |")
    assert _digest(GOLDEN) == before  # the repository's copy is untouched


def test_regen_golden_requires_a_reason(tmp_path):
    with pytest.raises(SystemExit):
        regen_golden.main(["--golden_dir", str(tmp_path), "--device", "cpu"])
    assert not os.listdir(tmp_path)


def test_replay_archive(capsys):
    """Every archived anchor replays; its drift against the port's physics
    is within 2e-3 of its distance from the current anchor."""
    drifts = regen_golden.replay_archive(GOLDEN, "cpu")
    names = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(GOLDEN, "archive", "*.npz")))
    assert sorted(drifts) == names and len(names) == 3
    with np.load(os.path.join(GOLDEN, regen_golden.ANCHOR_NAME)) as cur:
        tau = cur["torques"]
    for name, drift in drifts.items():
        with np.load(os.path.join(GOLDEN, "archive", name)) as a:
            want = float(np.abs(a["torques"] - tau).max())
        assert abs(drift - want) <= 2e-3, (name, drift, want)
    assert capsys.readouterr().out.count("max torque drift") == 3


# ---------------------------------------------------- contact_calibration

def test_contact_run_matches_jax():
    """40 substeps of A1 under the stance PD from 0.30 m, with a lateral
    push: base position, velocity and contact force at the one-step
    tolerances of tests/test_torch_dynamics.py."""
    import jax.numpy as jnp

    from pointfoot_tpu.physics.assets import get_model as jget_model
    from pointfoot_tpu.physics.model import PhysicsParams as JParams
    from pointfoot_tpu.physics.model import PhysicsState as JState
    from pointfoot_tpu_torch.physics.assets import get_model
    from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState

    cc = contact_calibration
    jcc = _script("contact_calibration")
    jm = jget_model("a1")
    _, (jpos, jvel, jcf) = jcc.run(
        jm, JParams.nominal(jm), JState.default(jm, jcc.QDEF,
                                                base_height=0.30),
        40, ext=jnp.asarray([30.0, 0.0, 0.0]))
    m = get_model("a1")
    _, (pos, vel, cf) = cc.run(
        m, PhysicsParams.nominal(m, 1, "cpu"),
        PhysicsState.default(m, cc.QDEF, 1, "cpu", base_height=0.30), 40,
        ext=torch.tensor([[30.0, 0.0, 0.0]]))
    np.testing.assert_allclose(pos[:, 0].numpy(), jpos, atol=2e-5)
    np.testing.assert_allclose(vel[:, 0].numpy(), jvel, atol=3e-4,
                               rtol=3e-4)
    np.testing.assert_allclose(cf[:, 0].numpy(), jcf, atol=0.1, rtol=1e-3)
    assert float(cf[-1, 0, :, 2].sum()) > 0  # the feet are loaded


def test_contact_static_balances_the_weight(capsys):
    rec = contact_calibration.main(["--device", "cpu", "--experiments",
                                    "static"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("model mass 12.454 kg")
    assert out[1].startswith("1. static: foot normal forces")
    s = rec["static"]
    assert len(s["foot_fz"]) == 4
    assert abs(s["fz_sum"] - rec["weight"]) <= 0.05 * rec["weight"]


def _numbers(lines):
    return [float(x) for ln in lines
            for x in re.findall(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?|nan", ln)]


@pytest.mark.slow
def test_contact_calibration_script_matches_jax(capsys):
    """The whole script (3,500 eager substeps, ~1 min here) against the JAX
    script's printed numbers."""
    contact_calibration.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    _script("contact_calibration").main()
    want = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in got] == [ln.split()[0] for ln in want]
    np.testing.assert_allclose(_numbers(got), _numbers(want), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------- catapult_hunt

def test_catapult_hunt_quiet(capsys):
    rec = catapult_hunt.main(["--device", "cpu", "--envs", "16", "--steps",
                              "20", "--load_run", policy_eval.FLAT_ACTOR])
    out = capsys.readouterr().out
    if rec["events"]:
        assert "flew" in out and "ep_step=" in out
    else:
        assert rec["steps"] == 20
        assert out.strip() == "no catapult events detected"


def test_catapult_hunt_dump(capsys):
    """--z_hi 0 flags every env: the event at t = 0 is dumped without
    ending the hunt (the JAX script's quirk), the one at t = 1 ends it
    with every field of JAX's dump, the state two steps back included."""
    rec = catapult_hunt.main(["--device", "cpu", "--envs", "16", "--steps",
                              "20", "--z_hi", "0", "--load_run",
                              policy_eval.FLAT_ACTOR])
    assert rec["steps"] == 2 and [e["t"] for e in rec["events"]] == [0, 1]
    first, second = rec["events"]
    assert "t-2" not in first and second["count"] == 16
    keys = {"t", "env", "count", "before", "after", "push", "q_lower",
            "q_upper", "kp", "kd", "friction", "added_mass", "com", "k_c",
            "d_c", "ep_step", "t-2"}
    assert set(second) == keys
    for row in ("before", "after", "t-2"):
        assert set(second[row]) == {"z", "vz", "v", "w", "qpos", "qvel",
                                    "fz"}
    assert second["t-2"]["z"] == first["before"]["z"]
    assert second["before"]["z"] == first["after"]["z"]
    assert second["ep_step"] == first["ep_step"] + 1
    out = capsys.readouterr().out
    for field in ("[t=1] env 0 flew (16 total this step)", "  before: z=",
                  "  after : z=", "    qpos=", "    qvel=", "    fz=",
                  "    push=", "    limits lo=", "           hi=", "    kp=",
                  "    kd=", "    friction=", "    added_mass=", " com=",
                  "    k_c=", " d_c=", "    ep_step=", "  two steps back:",
                  "  t-2   : z="):
        assert field in out, field


def _masked(text: str) -> str:
    """Printed lines with every number as # and runs of blanks as one."""
    text = re.sub(r"[-+]?\d+(\.\d*)?(e[-+]?\d+)?", "#", text)
    return re.sub(r"\[ ", "[", re.sub(r" \]", "]", re.sub(r"[ \t]+", " ",
                                                        text)))


def test_catapult_hunt_dump_matches_jax(capsys, monkeypatch):
    """--z_hi 0 under both on the same actor (logs/pointfoot_flat/tpu_run7
    model_4500): the same event steps and counts, and the same dump line
    for line, numbers aside (the states differ: JAX's threefry draws, not
    torch's generator, make the initial state, the domain randomization
    and the exploration); the joint limits, which nothing draws, print
    the same."""
    flags = ["--envs", "16", "--steps", "20", "--z_hi", "0"]
    catapult_hunt.main(flags + ["--device", "cpu", "--load_run",
                                ctrlseq_compare.DEFAULT_ACTOR])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["catapult_hunt.py", "--load_run",
                                      RUN7] + flags)
    _script("catapult_hunt").main()
    want = capsys.readouterr().out
    assert _masked(got) == _masked(want)
    for prefix in ("[t=", "    limits lo=", "           hi="):
        assert [ln for ln in got.splitlines() if ln.startswith(prefix)] == \
            [ln for ln in want.splitlines() if ln.startswith(prefix)], prefix


# -------------------------------------------------------- ctrlseq_compare

CTRLSEQ_TICKS = 60


def jax_ctrlseq_recipe() -> dict:
    """The JAX script's two RL loops (scripts/ctrlseq_compare.py:50-70,
    :132-135): PRNGKey(0) and PRNGKey(1), 1 + 250 env steps each.
    `np.savez_compressed(ctrlseq_compare.RECIPE, **jax_ctrlseq_recipe())`
    wrote the committed file."""
    from pointfoot_tpu.utils.registry import task_registry

    jenv = task_registry.make_env("pointfoot_flat", num_envs=1,
                                  cfg_patch=ctrlseq_compare.EVAL_PATCH)
    return {**jax_recipe(jenv, 0, 251, "key0/"),
            **jax_recipe(jenv, 1, 251, "key1/")}


def test_ctrlseq_recipe_is_jax_exactly():
    _assert_recipe(ctrlseq_compare.RECIPE, jax_ctrlseq_recipe())



@pytest.fixture(scope="module")
def ctrlseq_runs():
    """The port's tool and the JAX script at CTRLSEQ_TICKS ticks, same
    actor: (the port's record, its printed lines, the JAX script's printed
    lines)."""
    import contextlib
    import io

    argv = ["--steps", str(CTRLSEQ_TICKS)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rec = ctrlseq_compare.main(argv + ["--device", "cpu"])
    port = [json.loads(ln) for ln in out.getvalue().splitlines()]
    jax_main = _script("ctrlseq_compare").main
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["ctrlseq_compare.py", "--load_run", RUN7]
                   + argv)
        jax_main()
    return rec, port, [json.loads(ln) for ln in out.getvalue().splitlines()]


def test_ctrlseq_compare_lines(ctrlseq_runs):
    rec, lines, _ = ctrlseq_runs
    assert lines == [rec["ctrlseq"], rec["tracking"]]
    assert list(lines[0]) == ["metric", "rms_Nm", "max_Nm", "rl_rms_Nm",
                              "normalized_rms", "vx", "steps"]
    assert list(lines[1]) == ["metric", "cmd", "mpc_vx", "rl_vx",
                              "mpc_err_pct", "rl_err_pct"]
    assert lines[0]["metric"] == "ctrlseq_torque_err_vs_rl_policy"
    assert lines[1]["metric"] == "closed_loop_vx_tracking"
    for line in lines:
        assert all(np.isfinite(v) for v in line.values()
                   if not isinstance(v, str))


def test_ctrlseq_compare_matches_jax(ctrlseq_runs):
    """Both lines against the JAX script's on the same actor: the MPC's
    loop from the fixed default state, the RL loops from JAX's initial
    states and reset draws (the committed recipe).  The numbers are
    printed rounded to 3 decimals (err_pct to 1); torque reductions within
    0.1%, speeds within 2e-3 m/s."""
    _, port, want = ctrlseq_runs
    assert [list(ln) for ln in port] == [list(ln) for ln in want]
    for got, ref in zip(port, want):
        for k, v in ref.items():
            if isinstance(v, str) or k in ("vx", "steps", "cmd"):
                assert got[k] == v, k
            elif k.endswith("_Nm"):
                np.testing.assert_allclose(got[k], v, rtol=1e-3, err_msg=k)
            elif k.endswith("_pct"):
                np.testing.assert_allclose(got[k], v, atol=0.6, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], v, atol=2e-3, err_msg=k)


def test_ctrlseq_reductions_match_jax_formulas():
    """The JAX script's reductions (scripts/ctrlseq_compare.py:84-96,
    :149-156) on fixed arrays."""
    g = np.random.default_rng(3)
    tau_mpc = g.normal(0, 5, (120, 6)).astype(np.float32)
    tau_rl = g.normal(0, 4, (120, 6)).astype(np.float32)
    sl = slice(50, None)
    diff = tau_mpc[sl] - tau_rl[sl]
    rms = float(np.sqrt(np.mean(diff ** 2)))
    scale = float(np.sqrt(np.mean(tau_rl[sl] ** 2)))
    assert ctrlseq_compare.torque_errors(tau_mpc, tau_rl) == {
        "rms_Nm": round(rms, 3), "max_Nm": round(float(np.abs(diff).max()), 3),
        "rl_rms_Nm": round(scale, 3),
        "normalized_rms": round(rms / max(scale, 1e-9), 3)}
    v_mpc, v_rl, vx = 0.3712, 0.4471, 0.4
    assert ctrlseq_compare.tracking(v_mpc, v_rl, vx) == {
        "cmd": vx, "mpc_vx": round(v_mpc, 3), "rl_vx": round(v_rl, 3),
        "mpc_err_pct": round(100 * abs(v_mpc - vx) / max(vx, 1e-9), 1),
        "rl_err_pct": round(100 * abs(v_rl - vx) / max(vx, 1e-9), 1)}


def test_ctrlseq_default_actor_equals_checkpoint():
    """The default --load_run is the JAX script's model_4500, whose actor
    the committed npz holds exactly."""
    import orbax.checkpoint as ocp

    assert ctrlseq_compare.DEFAULT_ACTOR == os.path.join(
        policy_eval.WEIGHTS, "pointfoot_flat_tpu_run7_model_4500_actor.npz")
    raw = ocp.PyTreeCheckpointer().restore(RUN7)
    want = convert.actor_critic_state_dict(raw["train_state"]["params"])
    with np.load(ctrlseq_compare.DEFAULT_ACTOR) as f:
        got = convert.actor_critic_state_dict({k: f[k] for k in f.files})
    assert sorted(got) == sorted(k for k in want
                                 if not k.startswith("critic."))
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)


# -------------------------------------------------------- profile_substep

def test_profile_substep_table(capsys, monkeypatch):
    monkeypatch.setattr(profile_substep, "B", 64)
    rec = profile_substep.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "<!-- measurement condition: trainer=no_trainer, " \
                     "B=64 -->"
    rows = [ln for ln in out if ln.startswith("| ") and " us |" in ln]
    assert len(rows) == 5 and len(rec["rows"]) == 5
    assert rows[3].startswith("| solve (plain Cholesky) |")
    assert all(ln.endswith("| n/a |") for ln in rows)  # no card, no share
    assert any(ln.startswith("substep minus parts: ") for ln in out)
    assert any(re.match(r"4 substeps = \d+ us of the \d+ us env.step "
                        r"\(\d+%\)", ln) for ln in out)
    assert out[-1] == "profiler trace: not captured"
    for r in rec["rows"]:
        assert r["s"] > 0 and r["bytes"] > 0 and r["roofline"] is None
    assert rec["rows"][0]["flops"] > 0  # the policy-free step has matmuls


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                       ("NVIDIA H100 PCIe", None),
                                       ("NVIDIA H100 NVL", None)])
def test_roofline_peak_only_for_the_named_card(monkeypatch, name, peak):
    """The share's denominator is the H100 SXM's 3.35 TB/s by the card's
    exact name; another H100 (HBM2e, another rate) gets no share."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert profile_substep.peak_bytes_per_s(torch.device("cuda")) == peak
    assert profile_substep.peak_bytes_per_s(torch.device("cpu")) is None


def test_byte_counter_counts_inputs_and_outputs():
    a = torch.ones(3, 4)
    b = torch.ones(3, 4)
    assert profile_substep.count_bytes(lambda: a + b) == 3 * 12 * 4
    # views and allocations move nothing; a copy reads and writes
    assert profile_substep.count_bytes(lambda: a.t().reshape(-1)) == 2 * 48
    assert profile_substep.count_bytes(lambda: torch.empty(5, 5)) == 0
    d = torch.ones(2, dtype=torch.float64)
    assert profile_substep.count_bytes(lambda: d * 2.0) == 2 * 16
