"""parallel/mesh.py and the fused rollout on a rank's rows of the PyTorch
port against the JAX package's parallel/mesh.py and its sharded fused
rollout (tests/test_sharding.py), and the env's route gate.

- `shard_batch` placement and replication as in test_sharding.py:22-32,
  on meshes of 8 ranks made up in one process (no collective runs).
- Two gloo ranks on the CPU (tests/_torch_dp_worker.py): an all-reduce
  against JAX's psum over a 2-device mesh; `all_gather_rows` undoing
  `shard_batch`; the port's `rollout_substeps` on each rank's rows (the
  plain route on CPU tensors) on the inputs of test_sharding.py:67-111 (16
  envs of the registered pointfoot_rough after 3 steps, random actions)
  against JAX's `rollout_substeps_sharded` on the 8-device CPU mesh in
  interpret mode, at the tolerances of tests/test_pallas_substep.py:141-151
  (as tests/test_torch_substep.py), and bit for bit against the port's
  single-process plain rollout of the same rows; envs whose shards differ
  in size raise on both ranks when the mesh is attached.
- The env's gate (JAX legged_env.py:442-472): a rank takes the fused
  route on its rows only with 4096 envs or more of its own, by a spy on
  the routes.
- `scaling_bench` on the CPU.
"""

import dataclasses
import tempfile
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_dp_worker import run_ranks
from _torch_parity import export_fields
from pointfoot_tpu.parallel import mesh as jmesh
from pointfoot_tpu.utils.registry import task_registry
from pointfoot_tpu_torch import scaling_bench
from pointfoot_tpu_torch.envs import legged_env
from pointfoot_tpu_torch.ops.cuda import substep as sp
from pointfoot_tpu_torch.parallel import mesh as pm
from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.utils import convert
from pointfoot_tpu_torch.utils.registry import make_env

B = 16
ROLLOUT_TOL = {"qvel": 2e-3, "base_lin_vel": 5e-4, "base_pos": 5e-5}
TAU_TOL, SPHERE_TOL = 5e-3, 5e-5  # tests/test_pallas_substep.py:141-151
FORCE_TOL = dict(atol=0.05, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake_mesh(rank, world):
    """A rank's record without a process group: enough for `shard_batch`
    and the env's gate, which run no collective."""
    return pm.Mesh(rank=rank, world_size=world, device=torch.device("cpu"))


class _Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


@dataclasses.dataclass(frozen=True)
class _Rec:
    x: torch.Tensor
    counter: torch.Tensor
    pair: _Pair
    rng: torch.Tensor


def test_shard_batch_placement_and_replication():
    x = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
    for r in range(8):
        placed = pm.shard_batch({"a": x, "scalar": torch.tensor(1.0)},
                                _fake_mesh(r, 8))
        assert placed["a"].shape == (2, 3)
        torch.testing.assert_close(placed["a"], x[2 * r:2 * r + 2],
                                   rtol=0, atol=0)
        assert float(placed["scalar"]) == 1.0
    # nested trees; a field named in `replicate` stays whole even with the
    # batch's leading dim, other leaves with another leading dim replicate
    tree = _Rec(x=x, counter=torch.tensor(3), pair=_Pair(x[:, 0], x[:4]),
                rng=torch.arange(16))
    got = pm.shard_batch(tree, _fake_mesh(1, 2), replicate=("rng",))
    torch.testing.assert_close(got.x, x[8:], rtol=0, atol=0)
    torch.testing.assert_close(got.pair.a, x[8:, 0], rtol=0, atol=0)
    assert got.pair.b is tree.pair.b and got.counter is tree.counter
    assert got.rng is tree.rng
    assert pm.env_sharding(_fake_mesh(3, 4), 16) == slice(12, 16)


def test_shard_batch_refuses_indivisible_batch():
    with pytest.raises(ValueError, match="does not divide"):
        pm.shard_batch({"a": torch.zeros(9, 2)}, _fake_mesh(0, 2))
    env = make_env("pointfoot_flat", num_envs=9, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        env.shard_mesh = _fake_mesh(0, 2)


def test_init_distributed_is_a_noop_at_world_size_one(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pm.init_distributed("gloo") is False
    assert pm.init_distributed("nccl", world_size=1, rank=0) is False
    assert not dist.is_initialized()
    mesh = pm.make_mesh("cpu")
    assert (mesh.rank, mesh.world_size) == (0, 1)
    # without a process group the collectives are the identity
    t = torch.ones(3)
    pm.all_reduce_sum_([t], mesh)
    pm.all_reduce_mean_([t], None)
    torch.testing.assert_close(t, torch.ones(3), rtol=0, atol=0)
    assert pm.all_gather_rows(t, mesh) is t
    pm.same_rows(mesh, 5)


# ------------------------------------------------ two gloo ranks, the CPU

@pytest.fixture(scope="module")
def ranks():
    """JAX's psum and sharded rollout on its meshes, and the port's on two
    ranks, from one set of inputs."""
    jenv = task_registry.make_env("pointfoot_rough", num_envs=B)
    state = jenv.init_state(jax.random.PRNGKey(3))
    step = jax.jit(jenv.step)
    for _ in range(3):
        state, _ = step(state, 0.15 * jnp.ones((B, 6)))
    actions = 0.3 * jax.random.normal(jax.random.PRNGKey(7), (B, 6))

    mesh = jmesh.make_mesh(8)
    from pointfoot_tpu.ops.pallas import substep as jsp

    state_sh = jmesh.shard_batch(state, mesh)
    jphys, jtau, jsphere = jsp.rollout_substeps_sharded(
        mesh, "dp", jenv.model, state_sh.params, state_sh.physics,
        jax.device_put(actions, jmesh.env_sharding(mesh)),
        state_sh.last_qvel, state_sh.push_force, jenv._height_fn(),
        jenv.cfg.sim.dt, jenv.cfg.control.decimation, jenv.default_qpos,
        jenv.cfg.control.action_scale, jenv.cfg.control.control_type,
        gravity=jenv.cfg.sim.gravity, interpret=True)

    x = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
    mesh2 = jmesh.make_mesh(2)
    psum = jax.jit(jax.shard_map(
        lambda v: jax.lax.psum(v, "dp"), mesh=mesh2, in_specs=P("dp"),
        out_specs=P(None)))(
        jax.device_put(jnp.asarray(x), jmesh.env_sharding(mesh2)))

    ts = convert.env_state_from_numpy(export_fields(state))
    inputs = dict(task="pointfoot_rough", num_envs=B, params=ts.params,
                  phys=ts.physics, actions=torch.from_numpy(
                      np.array(actions)), last_qvel=ts.last_qvel,
                  push=ts.push_force, state=ts, psum=torch.from_numpy(x))
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_ranks("rollout", inputs, tmp)

    tenv = make_env("pointfoot_rough", num_envs=B, device="cpu")
    c = tenv.cfg.control
    single = sp.rollout_substeps_plain(
        tenv.model, ts.params, ts.physics, inputs["actions"], ts.last_qvel,
        ts.push_force, tenv.height_fn, tenv.cfg.sim.dt, c.decimation,
        tenv.default_qpos_values, c.action_scale, c.control_type,
        gravity=tenv.cfg.sim.gravity)
    got = [torch.cat([o[k] for o in outs]) for k in ("tau", "sphere_pos")]
    phys = {f: torch.cat([getattr(o["phys"], f) for o in outs])
            for f in ("base_pos", "base_quat", "base_lin_vel",
                      "base_ang_vel", "qpos", "qvel", "contact_force")}
    return dict(outs=outs, phys=phys, tau=got[0], sphere=got[1],
                jphys=jphys, jtau=jtau, jsphere=jsphere, single=single,
                psum=np.asarray(psum), x=x, inputs=inputs, jenv=jenv)


def test_all_reduce_over_two_ranks_matches_jax_psum(ranks):
    for o in ranks["outs"]:
        np.testing.assert_array_equal(o["psum"].numpy(), ranks["psum"][0])
        np.testing.assert_array_equal(o["psum"].numpy(),
                                      ranks["x"].sum(axis=0))


def test_all_gather_rows_undoes_shard_batch(ranks):
    want = ranks["inputs"]["state"]
    for o in ranks["outs"]:
        assert o["local_rows"] == B // 2
        for f in ("base_pos", "qvel", "contact_force"):
            torch.testing.assert_close(getattr(o["gathered"].physics, f),
                                       getattr(want.physics, f), rtol=0,
                                       atol=0)
        torch.testing.assert_close(o["gathered"].common_step,
                                   want.common_step, rtol=0, atol=0)


def test_sharded_rollout_matches_jax_sharded_rollout(ranks):
    phys, jphys = ranks["phys"], ranks["jphys"]
    assert np.abs(np.asarray(jphys.contact_force)).max() > 10.0
    for name, tol in ROLLOUT_TOL.items():
        np.testing.assert_allclose(phys[name].numpy(),
                                   np.asarray(getattr(jphys, name)),
                                   atol=tol, rtol=0, err_msg=name)
    np.testing.assert_allclose(phys["contact_force"].numpy(),
                               np.asarray(jphys.contact_force), **FORCE_TOL)
    np.testing.assert_allclose(ranks["tau"].numpy(), np.asarray(
        ranks["jtau"]), atol=TAU_TOL, rtol=0)
    np.testing.assert_allclose(ranks["sphere"].numpy(), np.asarray(
        ranks["jsphere"]), atol=SPHERE_TOL, rtol=0)


def test_sharded_rollout_equals_single_process_rollout(ranks):
    """Physics is env-parallel: the union of the ranks' outputs is the
    single-process rollout of the same rows, bit for bit."""
    sphys, stau, ssphere = ranks["single"]
    for name, v in ranks["phys"].items():
        torch.testing.assert_close(v, getattr(sphys, name), rtol=0, atol=0)
    torch.testing.assert_close(ranks["tau"], stau, rtol=0, atol=0)
    torch.testing.assert_close(ranks["sphere"], ssphere, rtol=0, atol=0)


def test_uneven_shards_raise_on_every_rank(ranks):
    """Ranks whose envs were built with 8 and 10 envs (shards of 4 and 5)
    both raise when the mesh is attached, and stay unattached."""
    for o in ranks["outs"]:
        assert o["uneven"] is not None and not o["uneven_attached"]
        assert "not the shards of one global batch" in o["uneven"]


# -------------------------------------------------------- the route gate

class _Taken(Exception):
    pass


@pytest.mark.parametrize("world, per_rank, route", [
    (2, dynamics.MEGA_MIN_BATCH, "fused"),
    (2, dynamics.MEGA_MIN_BATCH - 1, "scan"),
    (1, dynamics.MEGA_MIN_BATCH, "fused"),
    (1, dynamics.MEGA_MIN_BATCH - 1, "scan"),
])
def test_env_route_gate(monkeypatch, world, per_rank, route):
    """JAX legged_env.py:442-472: one process, or a rank of a larger
    world, takes the fused rollout on its own rows when they are
    MEGA_MIN_BATCH envs or more, and otherwise the scan path on them."""
    env = make_env("pointfoot_flat", num_envs=world * per_rank,
                   device="cpu")
    env.shard_mesh = _fake_mesh(world - 1, world)
    state = env.init_state(0)
    assert env.num_envs == per_rank
    assert state.physics.base_pos.shape[0] == per_rank
    taken = []

    def spy(name):
        def fn(*args, **kwargs):
            # the physics state follows model, params
            taken.append((name, args[2].base_pos.shape[0]))
            raise _Taken
        return fn

    monkeypatch.setattr(legged_env, "rollout_substeps", spy("fused"))
    monkeypatch.setattr(dynamics, "step_batched", spy("scan"))
    with pytest.raises(_Taken):
        env._physics_rollout(state, torch.zeros(per_rank, 6))
    assert taken == [(route, per_rank)]


def test_sharded_env_state_is_the_global_one():
    """Every rank draws the global batch's initial state from the seed and
    keeps its rows, then steps on a random stream of its own."""
    whole = make_env("pointfoot_flat", num_envs=8, device="cpu")
    want = whole.init_state(0, random_episode_step=True)
    draws = []
    for r in range(2):
        env = make_env("pointfoot_flat", num_envs=8, device="cpu")
        env.shard_mesh = _fake_mesh(r, 2)
        got = env.init_state(0, random_episode_step=True)
        for f in ("base_pos", "qpos"):
            torch.testing.assert_close(getattr(got.physics, f),
                                       getattr(want.physics, f)[4 * r:
                                                               4 * r + 4],
                                       rtol=0, atol=0)
        torch.testing.assert_close(got.episode_step,
                                   want.episode_step[4 * r:4 * r + 4],
                                   rtol=0, atol=0)
        torch.testing.assert_close(got.lin_vel_x_range,
                                   want.lin_vel_x_range, rtol=0, atol=0)
        draws.append(torch.rand(4, generator=env.generator))
    assert not torch.equal(draws[0], draws[1])


def test_scaling_bench_on_cpu(capsys):
    recs = scaling_bench.main(["--device", "cpu", "--envs_per_rank", "2",
                               "--steps", "1", "--max_ranks", "2",
                               "--task", "pointfoot_flat"])
    assert [r["ranks"] for r in recs] == [1, 2]
    assert [r["envs"] for r in recs] == [2, 4]
    assert recs[0]["efficiency"] == pytest.approx(1.0)
    assert all(r["steps_per_sec"] > 0 and r["card"] == "cpu"
               and not r["shared_device"] for r in recs)
    assert [r["backend"] for r in recs] == [None, "gloo"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
