"""Sys-ID under the port (pointfoot_tpu_torch/sysid) against the JAX package
(pointfoot_tpu/sysid), on pointfoot_flat at 2 envs with observation noise
and pushes off, and the fast cases of tests/test_sysid.py under the port.

- `simulate_trajectory` from a JAX-made state (the two packages' random
  streams differ, ROADMAP trap (b)), with distinct per-env friction, mass,
  CoM and the committed exported actor (`load_policy_as_jax` /
  `load_policy_as_torch`), 24 recorded steps after a warm-up of 3: every
  observation within SIM_ATOL, the window tolerance of
  tests/test_torch_flat.py, and no env falls.
- d(mean obs^2)/d(added_mass) through 2 + 10 steps against JAX's.
- `IdentifierTrainer.train_step` against JAX's from the same network
  parameters and JAX's candidate draws: the masked MSE, `num_valid` and the
  updated parameters within tests/_torch_parity.py::adam_bound.
- `chunk_windows`, the real-data round trip and `read_rosbag` exactly.
Each JAX function is jitted once.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import adam_bound, export_fields
from pointfoot_tpu.export.onnx import load_policy_as_jax
from pointfoot_tpu.sysid import identifier as jident
from pointfoot_tpu.sysid import simulate as jsim
from pointfoot_tpu_torch.export.onnx import load_policy_as_torch
from pointfoot_tpu_torch.sysid import (IdentifierTrainer, chunk_windows,
                                       simulate_trajectory)
from pointfoot_tpu_torch.sysid.realdata import (categorize_data_by_cmd,
                                                read_rosbag, real_to_tensor)
from pointfoot_tpu_torch.utils import convert
from pointfoot_tpu_torch.utils.registry import make_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = os.path.join(REPO, "logs", "pointfoot_flat", "tpu_run7", "exported",
                      "policy.pt")
B = 2
SIM_LEN, WARM = 24, 3
SIM_ATOL = 2e-3  # tests/test_torch_flat.py's window tolerance
PATCH = dict(noise=dict(add_noise=False),
             domain_rand=dict(push_robots=False))
FRIC = np.array([[0.02, 0.12, 0.05, 0.18, 0.08, 0.15],
                 [0.10, 0.03, 0.16, 0.07, 0.11, 0.01]], np.float32)
MASS = np.array([0.5, -0.4], np.float32)
COM = np.array([[0.01, -0.015, 0.02], [-0.02, 0.01, -0.01]], np.float32)
CMD = np.array([0.3, 0.0, 0.1], np.float32)


@pytest.fixture(scope="module")
def rig():
    from pointfoot_tpu.utils.registry import task_registry

    jenv = task_registry.make_env("pointfoot_flat", num_envs=B,
                                  cfg_patch=PATCH)
    tenv = make_env("pointfoot_flat", num_envs=B, device="cpu",
                    cfg_patch=PATCH)
    js = jenv.init_state(jax.random.PRNGKey(0))
    ts = convert.env_state_from_numpy(export_fields(js))
    return jenv, tenv, js, ts


def _zero_policy(obs):
    return jnp.zeros(obs.shape[:-1] + (6,))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_simulate_trajectory_matches_jax(rig):
    jenv, tenv, js, ts = rig
    jpol = load_policy_as_jax(POLICY)
    tpol = load_policy_as_torch(POLICY, device="cpu")
    sim = jax.jit(lambda s, f, m, c, cmd: jsim.simulate_trajectory(
        jenv, s, jpol, f, m, c, cmd, length=SIM_LEN, warmup=WARM))
    want, _ = sim(js, *map(jnp.asarray, (FRIC, MASS, COM, CMD)))
    got, final = simulate_trajectory(tenv, ts, tpol, *map(_t, (
        FRIC, MASS, COM, CMD)), length=SIM_LEN, warmup=WARM)
    assert got.obs.shape == (SIM_LEN, B, 27) and got.fell.shape == (B,)
    assert not np.asarray(want.fell).any() and not got.fell.any()
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs),
                               atol=SIM_ATOL, rtol=0)
    # the pins reached the params, the command the observations
    np.testing.assert_array_equal(final.params.joint_friction.numpy(), FRIC)
    np.testing.assert_array_equal(final.params.added_mass.numpy(), MASS)
    np.testing.assert_array_equal(final.params.com_offset.numpy(), COM)
    np.testing.assert_allclose(got.obs[-1, :, 24].numpy(), 0.6, atol=1e-6)
    # the starting state is not written to
    again, _ = simulate_trajectory(tenv, ts, tpol, *map(_t, (
        FRIC, MASS, COM, CMD)), length=2, warmup=WARM)
    assert torch.equal(again.obs, got.obs[:2])


def test_gradient_through_simulator_matches_jax(rig):
    """tests/test_sysid.py::test_gradients_flow_through_simulator on both
    sides: the port's reverse mode against JAX's derivative, to GRAD_RTOL
    of its size (float32 roundoff through 12 steps of contact dynamics).
    JAX's side is forward mode (jax.jvp): the derivative of a scalar in a
    scalar is the same, and jax.grad's reverse-mode compile of the rollout
    takes ~140 s on a CPU against ~50 s."""
    GRAD_RTOL = 1e-3
    jenv, tenv, js, ts = rig
    cmd = np.zeros(3, np.float32)

    def jloss(added_mass):
        traj, _ = jsim.simulate_trajectory(
            jenv, js, _zero_policy, friction=0.08, added_mass=added_mass,
            com_offset=jnp.zeros(3), cmd=jnp.asarray(cmd), length=10,
            warmup=2)
        return jnp.mean(traj.obs ** 2)

    want = float(jax.jit(lambda m: jax.jvp(jloss, (m,), (jnp.ones(()),))[1])(
        jnp.asarray(0.5)))
    mass = torch.tensor(0.5, requires_grad=True)
    traj, _ = simulate_trajectory(
        tenv, ts, lambda obs: torch.zeros(obs.shape[:-1] + (6,)),
        friction=0.08, added_mass=mass, com_offset=torch.zeros(3),
        cmd=_t(cmd), length=10, warmup=2)
    got, = torch.autograd.grad(torch.mean(traj.obs ** 2), mass)
    assert np.isfinite(want) and abs(want) > 0.0
    assert abs(float(got) - want) <= GRAD_RTOL * abs(want), (float(got), want)


def test_identifier_train_step_matches_jax(rig):
    jenv, tenv, js, ts = rig
    hidden, lr = 32, 1e-3
    jt = jident.IdentifierTrainer(jenv, _zero_policy, window=SIM_LEN,
                                  warmup=2, lr=lr, hidden=hidden)
    ident = jt.init(jax.random.PRNGKey(8))
    key = jax.random.PRNGKey(9)
    target = np.asarray(jt.sample_params(jax.random.split(key)[0]))
    new, m = jt.train_step(ident, js, jnp.asarray(CMD), key)

    tt = IdentifierTrainer(tenv, lambda obs: torch.zeros(obs.shape[:-1]
                                                         + (6,)),
                           window=SIM_LEN, warmup=2, lr=lr, hidden=hidden)
    tt.net.load_state_dict(convert.net_state_dict(
        tt.net, jax.tree.map(np.asarray, ident.params)))
    before = copy.deepcopy(tt.net)
    got = tt.train_step(ts, _t(CMD), target=_t(target))
    assert int(got["num_valid"]) == int(m["num_valid"]) == B
    np.testing.assert_allclose(float(got["mse"]), float(m["mse"]),
                               rtol=1e-5)
    # the gradients of the step (the port's), for the Adam bound
    windows, valid = tt.simulate(ts, _t(CMD), _t(target))
    per = torch.mean((before(windows) - _t(target)) ** 2, dim=-1)
    loss = torch.sum(torch.where(valid, per, 0.0)) / valid.sum()
    names = [n for n, _ in before.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        before.parameters()))))
    want = convert.net_state_dict(tt.net, jax.tree.map(np.asarray,
                                                       new.params))
    for name, p in tt.net.named_parameters():
        bound = adam_bound([grads], [{"lr_intra": lr}], name)
        assert (np.abs(p.detach().numpy() - want[name].numpy())
                <= bound).all(), name


def test_identifier_masks_fallen_rollouts(monkeypatch):
    """The MSE averages over the rollouts that did not fall only; with none
    standing it is 0 (the JAX formula's max(n_valid, 1))."""
    env = make_env("pointfoot_flat", num_envs=2, device="cpu")
    t = IdentifierTrainer(env, None, window=5, warmup=0, hidden=8)
    win = torch.randn(2, 5, 27, generator=torch.Generator().manual_seed(0))
    target = t.sample_params(torch.Generator().manual_seed(1))
    assert bool(((target >= t.lo) & (target <= t.hi)).all())
    with torch.no_grad():
        per = torch.mean((t.net(win) - target) ** 2, dim=-1)
    for valid, want in (([True, False], per[0]), ([False, False], 0.0)):
        monkeypatch.setattr(t, "simulate", lambda *a, v=valid: (
            win, torch.tensor(v)))
        m = t.train_step(None, None, target=target)
        np.testing.assert_allclose(float(m["mse"]), float(want), rtol=1e-6)
        assert int(m["num_valid"]) == sum(valid)
    assert t.predict(win).shape == (2, 10)


def test_chunk_windows_matches_jax():
    traj = np.arange(100 * 2 * 3, dtype=np.float32).reshape(100, 2, 3)
    w = chunk_windows(_t(traj), chunk=40, overlap=10)
    assert w.shape == (6, 40, 3)
    np.testing.assert_array_equal(w[0].numpy(), traj[0:40, 0])
    rng = np.random.default_rng(0)
    for T_, chunk, overlap in ((37, 16, 4), (400, 400, 100), (25, 8, 0)):
        x = rng.normal(size=(T_, 3, 5)).astype(np.float32)
        np.testing.assert_array_equal(
            chunk_windows(_t(x), chunk=chunk, overlap=overlap).numpy(),
            np.asarray(jsim.chunk_windows(jnp.asarray(x), chunk=chunk,
                                          overlap=overlap)))


def test_real_data_roundtrip_matches_jax(tmp_path):
    from pointfoot_tpu.sysid import realdata as jreal

    entries = []
    for i in range(10):
        obs = np.zeros(30, np.float32)
        obs[:27] = np.random.default_rng(i).normal(size=27)
        obs[24:27] = [0.5, 0.0, 0.1] if i % 2 == 0 else [0.0, 0.0, 0.0]
        entries.append({"obs": obs})
    path = str(tmp_path / "rr1.npy")
    np.save(path, np.asarray(entries, dtype=object), allow_pickle=True)
    data = real_to_tensor(path)
    assert data.shape == (10, 1, 27) and data.dtype == np.float32
    np.testing.assert_array_equal(data, jreal.real_to_tensor(path))
    buckets = categorize_data_by_cmd(data)
    want = jreal.categorize_data_by_cmd(data)
    assert list(buckets) == list(want) == [(0.5, 0.0, 0.1), (0.0, 0.0, 0.0)]
    for k in want:
        np.testing.assert_array_equal(buckets[k], want[k])
    assert sorted(v.shape[0] for v in buckets.values()) == [5, 5]


def test_read_rosbag_needs_rosbag(tmp_path):
    with pytest.raises(ImportError, match="rosbag is not installed"):
        read_rosbag(str(tmp_path / "x.bag"))


def test_load_policy_as_torch_matches_jax():
    jpol = load_policy_as_jax(POLICY)
    tpol = load_policy_as_torch(POLICY, device="cpu")
    obs = np.random.default_rng(4).normal(size=(16, 27)).astype(np.float32)
    want = np.asarray(jpol(jnp.asarray(obs)))
    got = tpol(_t(obs))
    assert got.shape == (16, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # autograd runs through it
    x = _t(obs).requires_grad_(True)
    g, = torch.autograd.grad(tpol(x).sum(), x)
    assert bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)
    for act in ("relu", "tanh"):
        np.testing.assert_allclose(
            load_policy_as_torch(POLICY, act, device="cpu")(_t(obs)).numpy(),
            np.asarray(load_policy_as_jax(POLICY, act)(jnp.asarray(obs))),
            rtol=1e-5, atol=1e-5)


def _one_ulp_nudges(cmd, base_pos):
    """(command, base position) pairs one ulp off the given ones: the
    command's vx and the base's height, each up and down."""
    out = []
    for to in (np.inf, -np.inf):
        c = cmd.copy()
        c[0] = np.nextafter(c[0], np.float32(to))
        out.append((c, base_pos))
        b = base_pos.copy()
        b[..., 2] = np.nextafter(b[..., 2], np.float32(to))
        out.append((cmd, b))
    return out


def _mass_derivative_rig(length, warmup):
    """d(mean obs^2)/d(added mass) of one pointfoot_flat env driven by the
    exported actor, from JAX's PRNGKey(0) state, at mass 0.5: (JAX's
    forward mode as a function of the command and the base position, the
    command, the base position, the port's mean obs^2 as a function of the
    added mass, the port's reverse mode)."""
    from pointfoot_tpu.utils.registry import task_registry

    jenv = task_registry.make_env("pointfoot_flat", num_envs=1,
                                  cfg_patch=PATCH)
    tenv = make_env("pointfoot_flat", num_envs=1, device="cpu",
                    cfg_patch=PATCH)
    js = jenv.init_state(jax.random.PRNGKey(0))
    ts = convert.env_state_from_numpy(export_fields(js))
    jpol = load_policy_as_jax(POLICY)
    tpol = load_policy_as_torch(POLICY, device="cpu")
    cmd = np.array([0.5, 0.0, 0.0], np.float32)

    def jloss(m, c, base_pos):
        s = js.replace(physics=js.physics.replace(base_pos=base_pos))
        traj, _ = jsim.simulate_trajectory(
            jenv, s, jpol, 0.08, m, jnp.zeros(3), c, length=length,
            warmup=warmup)
        return jnp.mean(traj.obs ** 2)

    jvp = jax.jit(lambda c, b: jax.jvp(lambda m: jloss(m, c, b),
                                       (jnp.float32(0.5),),
                                       (jnp.ones(()),))[1])

    def want(c, b):
        return float(jvp(jnp.asarray(c), jnp.asarray(b)))

    def loss(m):
        traj, _ = simulate_trajectory(tenv, ts, tpol, 0.08, m, torch.zeros(3),
                                      _t(cmd), length=length, warmup=warmup)
        return torch.mean(traj.obs ** 2)

    mass = torch.tensor(0.5, requires_grad=True)
    got, = torch.autograd.grad(loss(mass), mass)
    return want, cmd, np.asarray(js.physics.base_pos), loss, float(got)


@pytest.mark.slow
def test_gradient_through_simulator_grows_with_length():
    """d(mean obs^2)/d(added mass) of one env driven by the exported actor,
    the port's reverse mode against JAX's forward mode, at 5 + 20 and
    30 + 120 steps: within 2% at the short length; at the long one both
    are over five times larger and of one sign, and the port lies no
    further from JAX than JAX moves under a one-ulp nudge of its own
    command or base height: the gap is roundoff, which a long contact
    rollout's sensitivity amplifies in either package."""
    got = {}
    for length, warmup in ((20, 5), (120, 30)):
        want, cmd, base, _, port = _mass_derivative_rig(length, warmup)
        jax_d = want(cmd, base)
        moves = [abs(want(c, b) - jax_d) for c, b in _one_ulp_nudges(cmd,
                                                                     base)]
        got[length] = (port, jax_d, max(moves))
        print(f"{warmup} + {length} steps: port {port:.6g}, JAX {jax_d:.6g}, "
              f"JAX's largest move under a one-ulp nudge {max(moves):.6g}")
    (short_t, short_j, _), (long_t, long_j, long_move) = got[20], got[120]
    assert abs(short_t - short_j) <= 0.02 * abs(short_j)
    assert min(abs(long_t), abs(long_j)) > 5 * max(abs(short_t),
                                                    abs(short_j))
    assert np.sign(long_t) == np.sign(long_j)
    assert abs(long_t - long_j) <= long_move, (long_t, long_j, long_move)


@pytest.mark.slow
def test_gradient_through_simulator_at_gan_defaults():
    """The same derivative at the GAN CLI's 100 + 400 steps (~10 minutes on
    a CPU host): JAX's is over 1e4 (0.2 at 5 + 20 steps) and a one-ulp
    nudge of its command or base height moves it by more than half its
    size, so roundoff decides it; the port's reverse mode lies within that
    spread of JAX's and agrees with its own forward mode to 1e-3, so the
    port's reverse mode is the derivative of its rollout."""
    want, cmd, base, loss, port = _mass_derivative_rig(400, 100)
    jax_d = want(cmd, base)
    move = max(abs(want(c, b) - jax_d) for c, b in _one_ulp_nudges(cmd, base))
    fwd = float(torch.func.jvp(loss, (torch.tensor(0.5),),
                               (torch.tensor(1.0),))[1])
    print(f"100 + 400 steps: port reverse {port:.6g}, forward {fwd:.6g}; "
          f"JAX {jax_d:.6g}, its largest move under a one-ulp nudge "
          f"{move:.6g}")
    assert min(abs(jax_d), abs(port)) > 1e4
    assert move > 0.5 * abs(jax_d)
    assert abs(port - jax_d) <= move
    assert abs(port - fwd) <= 1e-3 * abs(fwd)


@pytest.mark.slow
def test_per_joint_friction_recovery():
    """tests/test_sysid.py::test_per_joint_friction_recovery under the
    port: six distinct per-joint frictions recovered by Gauss-Newton on the
    trajectory map, its Jacobian by forward mode (torch.func.jacfwd), from
    the JAX test's starting state (PRNGKey(0)).  The open-loop excitation
    topples the robot and the env resets it; JAX draws the reset from the
    state's key, the same on every call, so the port's map reseeds the
    env's generator on every call, and the Jacobian's batch of tangents
    shares one draw (randomness "same")."""
    from pointfoot_tpu.utils.registry import task_registry

    jenv = task_registry.make_env("pointfoot_flat", num_envs=B,
                                  cfg_patch=PATCH)
    state = convert.env_state_from_numpy(export_fields(
        jenv.init_state(jax.random.PRNGKey(0))))
    env = make_env("pointfoot_flat", num_envs=B, device="cpu",
                   cfg_patch=PATCH)
    steps, amp = 40, 0.3

    def traj_of(fric6):
        env.generator.manual_seed(0)
        s = env.update_frictions(state, fric6)
        s = env.update_cmd(s, torch.zeros(3))
        obs = []
        for t in range(steps):
            a = amp * torch.sin(0.3 * t + torch.arange(6.0))
            s, out = env.step(s, a[None, :].repeat(B, 1))
            obs.append(out.obs)
        return torch.stack(obs).reshape(-1)

    true_fric = torch.tensor([0.02, 0.12, 0.05, 0.18, 0.08, 0.15])
    target = traj_of(true_fric)
    fric = torch.full((6,), 0.10)
    for _ in range(3):
        r = traj_of(fric) - target
        J = torch.func.jacfwd(traj_of, randomness="same")(fric)
        JtJ = J.T @ J + 1e-8 * torch.eye(6)
        fric = fric - torch.linalg.solve(JtJ, J.T @ r)
    svals = torch.linalg.svdvals(J)
    assert float(svals[-1]) > 1e-6 * float(svals[0])
    np.testing.assert_allclose(fric.numpy(), true_fric.numpy(), atol=0.01)
    assert np.unique(np.round(fric.numpy(), 3)).size == 6
