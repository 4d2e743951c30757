"""The port's utils (pointfoot_tpu_torch/utils/): helpers, logger,
visualizer and profiling against the JAX package's where it has numbers."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pointfoot_tpu.physics.assets import get_model as jax_get_model
from pointfoot_tpu.physics.model import PhysicsParams as JaxParams
from pointfoot_tpu.physics.model import PhysicsState as JaxState
from pointfoot_tpu.utils import helpers as jax_helpers
from pointfoot_tpu.utils import visualizer as jax_visualizer
from pointfoot_tpu.utils.logger import Logger as JaxLogger
from pointfoot_tpu.utils.registry import task_registry
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
from pointfoot_tpu_torch.terrain.analytic import AnalyticTerrain, make_terrain
from pointfoot_tpu_torch.utils import helpers, profiling, visualizer
from pointfoot_tpu_torch.utils.logger import Logger
from pointfoot_tpu_torch.utils.registry import TASKS, get_cfgs

FK_ATOL = 1e-5


def _touch(path):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"")


def test_get_load_path(tmp_path):
    for run, its in (("Jan01_00-00-00", (5,)),
                     ("Jan02_00-00-00", (50, 100, 9))):
        for it in its:
            _touch(tmp_path / run / f"model_{it}.pt")
    (tmp_path / "Jan02_00-00-00" / "model_x.pt").write_bytes(b"")
    (tmp_path / "Jan02_00-00-00" / "metrics.jsonl").write_bytes(b"")
    (tmp_path / "notes.txt").write_bytes(b"")
    last = str(tmp_path / "Jan02_00-00-00")
    # the newest run by sort order, its highest iteration (not the
    # lexically last name)
    assert helpers.get_load_path(str(tmp_path)) == \
        os.path.join(last, "model_100.pt")
    assert helpers.get_load_path(str(tmp_path), load_run="-1") == \
        os.path.join(last, "model_100.pt")
    assert helpers.get_load_path(str(tmp_path), "Jan01_00-00-00") == \
        str(tmp_path / "Jan01_00-00-00" / "model_5.pt")
    assert helpers.get_load_path(str(tmp_path), checkpoint=50) == \
        os.path.join(last, "model_50.pt")
    with pytest.raises(FileNotFoundError, match="no runs"):
        helpers.get_load_path(str(tmp_path / "absent"))
    (tmp_path / "Jan03_00-00-00").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        helpers.get_load_path(str(tmp_path))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no runs"):
        helpers.get_load_path(str(empty))


def _paths(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# config fields of the JAX package that no port code reads, left out of
# the port's dataclasses
JAX_ONLY_FIELDS = {
    "commands.num_commands", "terrain.dynamic_friction",
    "terrain.slope_treshold", "terrain.vertical_scale",
    "terrain.restitution", "terrain.measure_heights",
    "asset.fix_base_link", "asset.self_collisions", "init_state.lin_vel",
    "init_state.ang_vel", "env.send_timeouts"}


@pytest.mark.parametrize("task", sorted(TASKS))
def test_class_to_dict_matches_jax(task):
    """Every field the port's configs hold equals JAX's, as plain values."""
    for port_cfg, jax_cfg in zip(get_cfgs(task),
                                 task_registry.get_cfgs(task)):
        got = _paths(helpers.class_to_dict(port_cfg))
        want = _paths(jax_helpers.class_to_dict(jax_cfg))
        assert not set(got) - set(want)
        assert set(want) - set(got) <= JAX_ONLY_FIELDS
        for k, v in got.items():
            assert v == want[k], k
    d = helpers.class_to_dict(get_cfgs(task)[0])
    assert isinstance(d["env"], dict)
    assert isinstance(d["init_state"]["pos"], tuple)


def _feed(logger, rng):
    for t in range(20):
        logger.log_states({
            "base_vel_x": rng.normal(), "command_x": 0.4,
            "base_vel_y": rng.normal(), "command_y": 0.0,
            "base_vel_yaw": rng.normal(), "command_yaw": 0.1,
            "base_vel_z": rng.normal(), "dof_pos": rng.normal(),
            "dof_pos_target": rng.normal(), "dof_vel": rng.normal(),
            "dof_torque": rng.normal(),
            "contact_forces_z": np.float32(rng.normal(size=2)),
        })
        if t % 7 == 6:
            ep = np.float32(rng.normal(size=3))
            logger.log_rewards({"rew_a": ep[0], "rew_b": ep[1],
                                "other": ep[2]}, t // 7 + 1)


def test_logger_matches_jax(tmp_path, capsys):
    port, ref = Logger(0.02), JaxLogger(0.02)
    _feed(port, np.random.default_rng(0))
    _feed(ref, np.random.default_rng(0))
    assert port.num_episodes == ref.num_episodes == 3
    assert dict(port.rew_log) == dict(ref.rew_log)
    assert set(port.state_log) == set(ref.state_log)
    for k in ref.state_log:
        np.testing.assert_array_equal(np.asarray(port.state_log[k]),
                                      np.asarray(ref.state_log[k]))
    capsys.readouterr()
    port.print_rewards()
    got = capsys.readouterr().out
    ref.print_rewards()
    assert got == capsys.readouterr().out
    assert "Total number of episodes: 3" in got
    png = port.plot_states(str(tmp_path / "dash.png"))
    with Image.open(png) as im:
        assert im.format == "PNG" and im.size[0] > 1000
    port.reset()
    assert not port.state_log and port.num_episodes == 0


def test_logger_takes_tensors():
    log = Logger(0.02)
    log.log_state("dof_pos", torch.tensor(0.5))
    log.log_state("contact_forces_z", torch.tensor([1.0, 2.0]))
    log.log_rewards({"rew_x": torch.tensor(0.25)}, 4)
    assert log.state_log["dof_pos"][0] == 0.5
    np.testing.assert_array_equal(log.state_log["contact_forces_z"][0],
                                  [1.0, 2.0])
    assert log.rew_log["rew_x"] == [1.0]


def _random_state(name, seed):
    """One env's pose of robot `name` as numpy, and its nominal params."""
    m = get_model(name)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    return dict(
        base_pos=np.float32(rng.normal(size=3) + [0, 0, 0.6]),
        base_quat=np.float32(q / np.linalg.norm(q)),
        base_lin_vel=np.float32(rng.normal(size=3)),
        base_ang_vel=np.float32(rng.normal(size=3)),
        qpos=np.float32(rng.normal(size=m.nj)),
        qvel=np.float32(rng.normal(size=m.nj)),
        contact_force=np.zeros((len(m.collision_body), 3), np.float32))


@pytest.mark.parametrize("name", ["pointfoot", "anymal_c", "a1", "cassie"])
def test_body_positions_match_jax(name):
    s = _random_state(name, 3)
    m = get_model(name)
    port = visualizer.body_positions(
        m, PhysicsState(**{k: torch.from_numpy(v[None])
                           for k, v in s.items()}),
        PhysicsParams.nominal(m, 1, "cpu"))
    jm = jax_get_model(name)
    ref = jax_visualizer.body_positions(
        jm, JaxState(**{k: jnp.asarray(v) for k, v in s.items()}),
        JaxParams.nominal(jm))
    assert port.shape == (m.nb, 3)
    np.testing.assert_allclose(port, np.asarray(ref), atol=FK_ATOL)


@pytest.mark.parametrize("terrain", [None, "wave:0.04"])
def test_render_rollout_writes_a_gif(tmp_path, terrain):
    m = get_model("pointfoot")
    params = PhysicsParams.nominal(m, 1, "cpu")
    frames = []
    for i in range(3):
        s = _random_state("pointfoot", i)
        frames.append(PhysicsState(**{k: torch.from_numpy(v[None])
                                      for k, v in s.items()}))
    out = visualizer.render_rollout(
        m, frames, params, str(tmp_path / "walk.gif"),
        terrain=None if terrain is None
        else AnalyticTerrain(make_terrain(terrain)))
    with Image.open(out) as im:
        assert im.format == "GIF" and im.n_frames == 3
    one = visualizer.render_rollout(m, frames[:1], params,
                                    str(tmp_path / "one.png"))
    with Image.open(one) as im:
        assert im.format == "PNG"


def test_trace_writes_a_trace_file(tmp_path):
    lin = torch.nn.Linear(16, 8)
    with profiling.trace(str(tmp_path / "tr")) as d:
        lin(torch.randn(4, 16)).sum()
    files = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(d, files[0])) as f:
        text = f.read()
    assert '"traceEvents"' in text and "aten::" in text


def test_timed_is_positive():
    lin = torch.nn.Linear(16, 8)
    t = profiling.timed(lin, torch.randn(4, 16), iters=3, warmup=1)
    assert 0.0 < t < 10.0
    # outputs in any pytree, tensors or not
    assert profiling.timed(lambda: {"a": (1, torch.ones(2))}, iters=2) > 0


@pytest.mark.parametrize("B, n_in, n_out", [(4, 16, 8), (3, 7, 5)])
def test_flops_estimate_of_a_linear(B, n_in, n_out):
    lin = torch.nn.Linear(n_in, n_out)
    assert profiling.flops_estimate(lin, torch.randn(B, n_in)) == \
        {"flops": 2 * B * n_in * n_out}


def test_class_to_dict_keeps_sequences():
    @dataclasses.dataclass
    class Inner:
        a: tuple = (1, 2)

    @dataclasses.dataclass
    class Outer:
        inner: Inner = dataclasses.field(default_factory=Inner)
        items: list = dataclasses.field(default_factory=lambda: [Inner()])

    assert helpers.class_to_dict(Outer()) == {
        "inner": {"a": (1, 2)}, "items": [{"a": (1, 2)}]}
