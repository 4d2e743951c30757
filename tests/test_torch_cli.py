"""The port's CLIs on the CPU at 2 envs: the eval CLI
(pointfoot_tpu_torch/eval_policy.py, the counterpart of
scripts/eval_policy.py) with an actor npz, the task's committed actor and a
`model_<it>.pt` of the train CLI; `bench --mode env` and `--mode
actuator_net` (the procedural headline and the table leg); `train` on
pointfoot_flat and on pointfoot_rough with their registered configs, and
with the flagship continuation's promotion knob; and the sys-ID CLIs (gan,
identifier, inference: scripts/gan.py, identifier.py, inference.py) at
tiny sizes."""

import functools
import json
import os

import numpy as np
import pytest
import torch

from pointfoot_tpu_torch import (bench, eval_policy, gan, identifier,
                                 inference, train)
from pointfoot_tpu_torch.utils import policy_eval

# a 1-iteration run of 2-step rollouts and one-layer networks
TINY = ["--device", "cpu", "--num_envs", "2", "--max_iterations", "1",
        "--log_every", "1", "--train_override",
        "runner.num_steps_per_env=2", "--train_override",
        "policy.actor_hidden_dims=(32,)", "--train_override",
        "policy.critic_hidden_dims=(32,)"]


def _json_lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()
            if s.startswith("{")]


def test_eval_cli_on_plane_evaluates_level_none_only(capsys):
    recs = eval_policy.main(["--task", "pointfoot_flat", "--device", "cpu",
                             "--num_envs", "2", "--secs", "0.2", "--vx",
                             "0.25", "0.5", "--levels", "0", "3"])
    lines = _json_lines(capsys)
    assert lines[:-1] == recs
    assert [r["level"] for r in recs] == [None, None]
    assert [r["cmd_vx"] for r in recs] == [0.25, 0.5]
    assert lines[-1] == {"total_falls": sum(r["falls"] for r in recs),
                         "configs": 2}


def test_eval_cli_on_table_with_an_npz(capsys):
    npz = (policy_eval.WEIGHTS
           + "/pointfoot_rough_model_100000_actor.npz")
    recs = eval_policy.main(["--task", "pointfoot_rough", "--load_run", npz,
                             "--device", "cpu", "--num_envs", "2", "--secs",
                             "0.1", "--levels", "0", "2", "--vx", "0.4"])
    assert [(r["level"], r["cmd_vx"], r["envs"]) for r in recs] == \
        [(0, 0.4, 2), (2, 0.4, 2)]
    assert _json_lines(capsys)[-1]["configs"] == 2


def test_eval_cli_takes_overrides_and_a_checkpoint_of_train(tmp_path,
                                                          capsys):
    """train --task pointfoot_flat with its registered config writes a
    model_1.pt that the eval CLI loads; the eval CLI's --override reaches
    the env."""
    # the registered networks (128/64/32), which the eval CLI builds
    runner = train.main(TINY[:-4] + ["--task", "pointfoot_flat",
                                     "--log_dir", str(tmp_path)])
    assert runner.cfg.policy.actor_hidden_dims == (128, 64, 32)
    assert runner.env.is_plane
    assert (tmp_path / "model_1.pt").exists()
    capsys.readouterr()
    recs = eval_policy.main([
        "--task", "pointfoot_flat", "--load_run",
        str(tmp_path / "model_1.pt"), "--device", "cpu", "--num_envs", "2",
        "--secs", "0.1", "--vx", "0.3", "--override",
        "rewards.tracking_rel_vref=1.0"])
    assert len(recs) == 1 and recs[0]["level"] is None
    with pytest.raises(KeyError, match="no committed actor"):
        eval_policy.main(["--task", "anymal_c_flat", "--device", "cpu",
                          "--num_envs", "2", "--secs", "0.1"])


def test_train_cli_on_the_registered_table_and_promotion_knob(tmp_path):
    runner = train.main(TINY + [
        "--task", "pointfoot_rough", "--log_dir", str(tmp_path),
        "--override", "terrain.cmd_conditioned_promotion=true"])
    cfg = runner.env.cfg.terrain
    assert cfg.cmd_conditioned_promotion is True
    assert not cfg.procedural and not runner.env.is_plane
    line = json.loads((tmp_path / "run_config.jsonl").read_text())
    assert line["env_cfg"]["terrain"]["cmd_conditioned_promotion"] is True


@pytest.mark.parametrize("mode,task", [("env", "pointfoot_rough"),
                                       ("actuator_net", "anymal_c_rough")])
def test_bench_env_modes(capsys, mode, task):
    rec = bench.main(["--mode", mode, "--device", "cpu", "--num_envs", "2",
                      "--iters", "1", "--reps", "2", "--steps", "2"])
    assert _json_lines(capsys)[-1] == rec
    assert rec["metric"] == f"env_steps_per_sec@2envs_{task}"
    assert rec["unit"] == "steps/s" and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 100.0,
                                               abs=1e-3)
    cond = rec["conditions"]
    assert cond["terrain"] == "procedural" and cond["card"] == "cpu"
    assert len(cond["reps_steps_per_sec"]) == 2
    assert cond["table_steps_per_sec"] > 0
    assert 1 <= cond["settle_iters"] <= bench.SETTLE_MAX
    assert cond["steps_per_iter"] == 2


# ------------------------------------------------------ the sys-ID CLIs

EXPORTED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "logs", "pointfoot_flat", "tpu_run7", "exported",
    "policy.pt")


def _short_warmup(monkeypatch, module, name, steps):
    """`module`'s trainer class `name` with a warm-up of `steps` env steps
    in place of its default of 100, so a CLI test stays short."""
    monkeypatch.setattr(module, name, functools.partial(
        getattr(module, name), warmup=steps))


@pytest.mark.parametrize("wgan", [False, True], ids=["gan", "wgan"])
def test_gan_cli(tmp_path, capsys, monkeypatch, wgan):
    """Two command buckets of 30 and 10 rows: with --min_bucket 20 one
    update an epoch, through a 1 + 8-step rollout of the exported actor
    (the trainer's warm-up cut to 1 step); one JSON line of finite losses
    an update."""
    _short_warmup(monkeypatch, gan, "WGANTrainer" if wgan else "GANTrainer",
                  1)
    rng = np.random.default_rng(0)
    entries = [{"obs": np.r_[rng.normal(size=24), cmd].astype(np.float32)}
               for cmd in [(0.5, 0.0, 0.0)] * 30 + [(0.0, 0.0, 0.0)] * 10]
    real = tmp_path / "rr1.npy"
    np.save(real, np.asarray(entries, dtype=object), allow_pickle=True)
    path = gan.main(["--real", str(real), "--policy", EXPORTED, "--epochs",
                     "2", "--sim_length", "8", "--min_bucket", "20", "--log_dir", str(tmp_path / "log"),
                     "--device", "cpu"] + (["--wgan"] if wgan else []))
    assert "2 command buckets; sizes [30, 10]" in capsys.readouterr().out
    lines = [json.loads(s) for s in open(path)]
    loss = "critic_loss" if wgan else "disc_loss"
    assert [ln["epoch"] for ln in lines] == [0, 1]
    assert all(set(ln) == {"gen_loss", loss, "epoch"} for ln in lines)
    assert all(np.isfinite(ln["gen_loss"]) and np.isfinite(ln[loss])
               for ln in lines)
    with pytest.raises(SystemExit, match="min_bucket"):
        gan.main(["--real", str(real), "--min_bucket", "30", "--device",
                  "cpu"])


def test_identifier_and_inference_cli(tmp_path, capsys, monkeypatch):
    """Two identifier iterations at 2 envs (windows of 8 steps, the
    trainer's warm-up cut to 2 steps) save identifier_0.pt and
    identifier_1.pt with the default LSTM of 512; the inference CLI reads
    them through a glob and prints one finite MSE each."""
    for module in (identifier, inference):
        _short_warmup(monkeypatch, module, "IdentifierTrainer", 2)
    small = ["--device", "cpu", "--window", "8"]
    saved = identifier.main(small + ["--iters", "2", "--batch", "2",
                                     "--save_every", "1", "--log_dir",
                                     str(tmp_path)])
    assert [os.path.basename(p) for p in saved] == ["identifier_0.pt",
                                                    "identifier_1.pt"]
    sd = torch.load(saved[-1])
    assert sd["lstm.cell.weight_h"].shape == (512, 2048)
    assert "it 0: mse" in capsys.readouterr().out
    out = inference.main(small + ["--ckpt", str(tmp_path / "*.pt"),
                                  "--batch", "2"])
    assert sorted(out) == sorted(saved)
    assert all(np.isfinite(v) for v in out.values())
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("identifier_0.pt: mse ")
