"""The recurrent policy of the PyTorch port against the JAX package's:
rl/networks.ActorCriticRecurrent, rl/ppo.RecurrentPPO, the recurrent paths
of rl/runner.OnPolicyRunner and the train CLI.

- The network on converted flax weights, five steps with the carry, at
  tests/test_export_lstm.py's atol 1e-5.
- One `RecurrentPPO.update` on tests/test_ppo.py:111's recipe (a done mid
  window) with JAX's permutations, and one recurrent iteration of
  pointfoot_flat at 8 envs against a jitted JAX
  `train_iteration_recurrent`, with JAX's action noise and permutations:
  at tests/test_torch_ppo.py's and tests/test_torch_runner.py's
  tolerances, whose module docstrings explain them (Adam's bound:
  `_torch_parity.adam_bound`).
- The stateful inference policy, and the asymmetric task where it cannot
  exist: the JAX package raises flax's shape error there, the port a
  ValueError that says why.
"""

import json
from dataclasses import replace

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_parity import adam_bound, export_fields, jax_minibatches
from pointfoot_tpu.envs import config as jconfig
from pointfoot_tpu.rl import networks as jnet
from pointfoot_tpu.rl import ppo as jppo_mod
from pointfoot_tpu.utils.registry import task_registry
from pointfoot_tpu_torch import export_policy, train
from pointfoot_tpu_torch.envs import config as tconfig
from pointfoot_tpu_torch.export import onnx as export
from pointfoot_tpu_torch.rl.networks import ActorCriticRecurrent
from pointfoot_tpu_torch.rl.ppo import RecurrentPPO, Transition
from pointfoot_tpu_torch.utils import convert
from pointfoot_tpu_torch.utils.registry import (get_cfgs, make_alg_runner,
                                                make_env)

ATOL = 2e-3  # tests/test_torch_runner.py (transitions, carries)
RTOL = 1e-5  # tests/test_torch_ppo.py (losses, KL, metrics)
NET_ATOL = 1e-5  # tests/test_export_lstm.py


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _np_carry(carry):
    return jax.tree.map(np.asarray, carry)


def _t_carry(carry):
    return tuple(tuple(torch.from_numpy(np.array(x)) for x in c)
                 for c in carry)


def _assert_carry_close(got, want, atol, what):
    for (gc, gh), (wc, wh) in zip(got, want):
        for g, w, name in ((gc, wc, "c"), (gh, wh, "h")):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       atol=atol, rtol=0,
                                       err_msg=f"{what} {name}")


# ------------------------------------------------------------- network

def test_network_matches_flax_over_five_steps():
    """rnn 16, heads (16,), obs 27 / privileged obs 148, 6 actions."""
    net = jnet.ActorCriticRecurrent(num_actions=6, rnn_hidden=16,
                                    actor_hidden=(16,), critic_hidden=(16,))
    B = 5
    carry = net.initialize_carry((B,))
    params = net.init(jax.random.PRNGKey(0), carry, jnp.zeros((B, 27)),
                      jnp.zeros((B, 148)))
    # a non-zero bias and log_std, so each reaches the comparison
    params = jax.tree.map(lambda x: x, params)
    params["params"]["actor_rnn"]["hf"]["bias"] = jnp.full(16, 0.3)
    params["params"]["log_std"] = jnp.full(6, -0.4)
    tnet = ActorCriticRecurrent(27, 148, 6, 16, (16,), (16,))
    tnet.load_state_dict(convert.actor_critic_state_dict(
        jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(0)
    tcarry = tnet.initialize_carry(B)
    for step in range(5):
        obs = rng.standard_normal((B, 27)).astype(np.float32)
        priv = rng.standard_normal((B, 148)).astype(np.float32)
        carry, (mean, std, value) = net.apply(params, carry, obs, priv)
        with torch.no_grad():
            tcarry, (tmean, tstd, tvalue) = tnet(tcarry, *_t(obs, priv))
        for got, want, name in ((tmean, mean, "mean"), (tstd, std, "std"),
                                (tvalue, value, "value")):
            assert got.shape == want.shape, name
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=NET_ATOL, rtol=0,
                                       err_msg=f"step {step} {name}")
        _assert_carry_close(tcarry, carry, NET_ATOL, f"step {step}")
    assert float(np.abs(np.asarray(carry[0][0])).max()) > 0.1


def test_reset_parameters_draws_as_flax():
    """Orthogonal hidden kernels (WᵀW = I for each gate), LeCun-normal
    input kernels (std sqrt(1/fan_in), as flax's), zero biases and log_std
    at log(init_noise_std); the same seed gives the same network."""
    H = 64
    net = ActorCriticRecurrent(27, 148, 6, H, (32,), (32,),
                               init_noise_std=0.5)
    net.reset_parameters(torch.Generator().manual_seed(0))
    jnet_ = jnet.ActorCriticRecurrent(num_actions=6, rnn_hidden=H,
                                      actor_hidden=(32,),
                                      critic_hidden=(32,))
    jp = jnet_.init(jax.random.PRNGKey(0), jnet_.initialize_carry((1,)),
                    jnp.zeros((1, 27)), jnp.zeros((1, 148)))["params"]
    for cell, n_in in (("actor_rnn", 27), ("critic_rnn", 148)):
        mod = getattr(net, cell)
        for k, g in enumerate("ifgo"):
            W = mod.weight_h[:, k * H:(k + 1) * H].detach().double()
            np.testing.assert_allclose((W.T @ W).numpy(), np.eye(H),
                                       atol=1e-5, err_msg=f"{cell} h{g}")
            jW = np.asarray(jp[cell][f"h{g}"]["kernel"], np.float64)
            np.testing.assert_allclose(jW.T @ jW, np.eye(H), atol=1e-5)
        Wi = mod.weight_i.detach().numpy()
        jWi = np.concatenate([np.asarray(jp[cell][f"i{g}"]["kernel"])
                              for g in "ifgo"], axis=-1)
        assert Wi.shape == jWi.shape == (n_in, 4 * H)
        for w in (Wi, jWi):
            assert abs(w.std() * np.sqrt(n_in) - 1.0) < 0.1, cell
            assert np.abs(w).max() <= 2.0 / np.sqrt(n_in) / 0.8796 + 1e-6
        assert float(mod.bias_h.abs().max()) == 0.0
    np.testing.assert_allclose(net.log_std.detach().numpy(),
                               np.log(0.5), rtol=1e-6)
    again = ActorCriticRecurrent(27, 148, 6, H, (32,), (32,),
                                 init_noise_std=0.5)
    again.reset_parameters(torch.Generator().manual_seed(0))
    for (k, a), b in zip(net.state_dict().items(),
                         again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_replay_equals_forward_step_by_step():
    """`replay` (the cells through time, the heads once over the window) is
    `forward` stepped over the window with the carry zeroed at resets."""
    net = ActorCriticRecurrent(27, 148, 6, 16, (32, 16), (32, 16))
    net.reset_parameters(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    T, B = 6, 5
    obs, priv = torch.randn(T, B, 27, generator=g), torch.randn(
        T, B, 148, generator=g)
    reset = torch.zeros(T, B)
    reset[2, 1] = reset[4, 3] = reset[0, 0] = 1.0
    carry = tuple((torch.randn(B, 16, generator=g),
                   torch.randn(B, 16, generator=g)) for _ in range(2))
    with torch.no_grad():
        got = net.replay(carry, obs, priv, reset)
        outs = []
        for t in range(T):
            keep = (1.0 - reset[t])[:, None]
            carry = tuple((c * keep, h * keep) for c, h in carry)
            carry, out = net(carry, obs[t], priv[t])
            outs.append(out)
    for name, a, b in zip(("mean", "std", "value"), got, zip(*outs)):
        torch.testing.assert_close(a, torch.stack(b), rtol=0, atol=1e-6,
                                   msg=name)


# -------------------------------- RecurrentPPO.update (tests/test_ppo.py:111)

@pytest.fixture(scope="module")
def update_pair():
    """tests/test_ppo.py:111: rnn 8, heads (16,), obs 6, 2 actions, a T 8 x
    B 4 rollout with a done at t 3 of env 1, 2 epochs x 2 minibatches of
    2 envs; both packages update from the same parameters with JAX's
    permutations."""
    from test_ppo import _make_rollout

    net = jnet.ActorCriticRecurrent(num_actions=2, rnn_hidden=8,
                                    actor_hidden=(16,), critic_hidden=(16,))
    params = net.init(jax.random.PRNGKey(0), net.initialize_carry((1,)),
                      jnp.zeros((1, 6)), jnp.zeros((1, 6)))
    cfg = dict(num_mini_batches=2, num_learning_epochs=2)
    jppo = jppo_mod.RecurrentPPO(net, jconfig.AlgorithmCfg(**cfg))
    ts0 = jppo.init_train_state(params)
    roll = _make_rollout(jax.random.PRNGKey(1))
    roll = roll._replace(done=roll.done.at[3, 1].set(1.0))
    carry0 = net.initialize_carry((4,))
    key = jax.random.PRNGKey(2)
    last = jnp.zeros(4)
    ts_update, jmetrics = jax.jit(jppo.update)(ts0, roll, last, key,
                                               carry0=carry0)
    perms = [np.asarray(jax.random.permutation(k, 4))
             for k in jax.random.split(key, 2)]
    mb, grads, ts_loop = jax_minibatches(jppo, ts0, roll, last, perms,
                                         carry0=carry0)

    tnet = ActorCriticRecurrent(6, 6, 2, 8, (16,), (16,))
    tnet.load_state_dict(convert.actor_critic_state_dict(
        jax.tree.map(np.asarray, params)))
    before = {k: v.clone() for k, v in tnet.state_dict().items()}
    tppo = RecurrentPPO(tnet, tconfig.AlgorithmCfg(**cfg))
    troll = Transition(*_t(*roll))
    tmetrics = tppo.update(troll, torch.zeros(4),
                           [torch.from_numpy(p.astype(np.int64))
                            for p in perms],
                           carry0=tnet.initialize_carry(4))
    return dict(jmetrics=jmetrics, mb=mb, grads=grads, ts_update=ts_update,
                ts_loop=ts_loop, tppo=tppo, tmetrics=tmetrics,
                before=before, roll=troll)


def test_recurrent_update_unrolled_is_jax_update(update_pair):
    a = convert.actor_critic_state_dict(jax.tree.map(
        np.asarray, update_pair["ts_update"].params))
    b = convert.actor_critic_state_dict(jax.tree.map(
        np.asarray, update_pair["ts_loop"].params))
    assert "actor_rnn.weight_h" in a
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-7,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["surrogate_loss", "value_loss", "entropy",
                                  "kl"])
def test_recurrent_update_minibatch_metrics_match_jax(update_pair, name):
    got = update_pair["tppo"].minibatch_metrics[name].numpy()
    want = np.array([m[name] for m in update_pair["mb"]])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_recurrent_update_rates_and_means_match_jax(update_pair):
    """The adaptive rule takes the same branch at each minibatch (no KL
    within the KL tolerance of a threshold); the mean metrics agree."""
    dkl = update_pair["tppo"].cfg.desired_kl
    kl = np.array([m["kl"] for m in update_pair["mb"]])
    for edge in (2.0 * dkl, dkl / 2.0):
        assert (np.abs(kl - edge) > RTOL * edge + 1e-6 * edge).all()
    got = update_pair["tppo"].minibatch_metrics["lr_intra"].numpy()
    want = np.array([m["lr_intra"] for m in update_pair["mb"]])
    got = np.append(got, update_pair["tppo"].learning_rate)
    want = np.append(want, np.float32(update_pair["ts_loop"].learning_rate))
    np.testing.assert_allclose(got, want, rtol=len(got) * 1.2e-7, atol=0)
    jm, tm = update_pair["jmetrics"], update_pair["tmetrics"]
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   atol=1e-6, err_msg=k)


def test_recurrent_update_params_match_jax_and_train_the_cells(update_pair):
    p = update_pair
    want = convert.actor_critic_state_dict(jax.tree.map(
        np.asarray, p["ts_loop"].params))
    state = p["tppo"].state_dict()
    assert state["update_count"] == int(p["ts_loop"].update_count) == 4
    for k, got in state["params"].items():
        err = np.abs(got.numpy() - want[k].numpy())
        assert (err <= adam_bound(p["grads"], p["mb"], k)).all(), \
            (k, err.max())
    # BPTT reaches both cells (tests/test_ppo.py:111)
    for cell in ("actor_rnn", "critic_rnn"):
        for leaf in ("weight_i", "weight_h", "bias_h"):
            k = f"{cell}.{leaf}"
            assert float((state["params"][k] - p["before"][k]).abs().max()) \
                > 0, k


def test_recurrent_update_zeroes_the_carry_after_a_done(update_pair):
    """Replayed from a non-zero carry, env 1's outputs from t 4 on are
    those of a zero carry at t 4: the done of t 3 cut the carry."""
    tppo = update_pair["tppo"]
    net = tppo.network
    roll = update_pair["roll"]
    g = torch.Generator().manual_seed(0)
    carry = tuple((torch.randn(4, 8, generator=g),
                   torch.randn(4, 8, generator=g)) for _ in range(2))
    with torch.no_grad():
        mean, _, value = tppo.sequence_outputs(carry, roll)
        tail = Transition(*(x[4:, 1:2] for x in roll))
        mean0, _, value0 = tppo.sequence_outputs(net.initialize_carry(1),
                                                 tail)
        from_zero = tppo.sequence_outputs(net.initialize_carry(4), roll)[0]
    torch.testing.assert_close(mean[4:, 1:2], mean0, rtol=0, atol=1e-6)
    torch.testing.assert_close(value[4:, 1:2], value0, rtol=0, atol=1e-6)
    assert float((mean[:4, 1] - from_zero[:4, 1]).abs().max()) > 1e-4


def test_recurrent_update_needs_carry0(update_pair):
    with pytest.raises(ValueError, match="carry0"):
        update_pair["tppo"].update(update_pair["roll"], torch.zeros(4))


# ---------------------- one recurrent iteration of pointfoot_flat, 8 envs

B, T = 8, 4
FLAT_PATCH = dict(noise=dict(add_noise=False),
                  domain_rand=dict(push_robots=False))


def _recurrent(tc, **runner):
    return replace(
        tc, policy=replace(tc.policy, rnn_hidden_size=16,
                           actor_hidden_dims=(32,), critic_hidden_dims=(32,)),
        runner=replace(tc.runner, policy_class_name="ActorCriticRecurrent",
                       num_steps_per_env=T, **runner))


@pytest.fixture(scope="module")
def iteration_pair():
    jenv = task_registry.make_env("pointfoot_flat", num_envs=B,
                                  cfg_patch=FLAT_PATCH)
    _, jtc = task_registry.get_cfgs("pointfoot_flat")
    jr = task_registry.make_alg_runner(jenv, "pointfoot_flat",
                                       train_cfg=_recurrent(jtc))
    assert jr.recurrent

    def iteration(ts, es, obs, priv, carry, key):
        """JAX's `train_iteration_recurrent`, also returning the rollout
        and the bootstrap value."""
        k_roll, k_update = jax.random.split(key)
        es, obs, priv, carry1, roll, infos = jr.rollout_recurrent(
            ts, es, obs, priv, carry, k_roll)
        _, (_, _, last) = jr.network.apply(ts.params, carry1, obs, priv)
        ts, metrics = jr.ppo.update(ts, roll, last, k_update, carry0=carry)
        return jr._finish_iteration(ts, es, obs, priv, roll, infos,
                                    metrics) + (carry1, roll, last)

    it = jax.jit(iteration)
    ts, es = jr.init(jax.random.PRNGKey(0))
    ts = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), ts)
    obs = jnp.zeros((B, jenv.num_obs))
    priv = jnp.zeros((B, jenv.num_privileged_obs))
    carry = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)),
                         jr.network.initialize_carry((B,)))
    ts1, es1, obs1, priv1, _, carry1, _, _ = it(ts, es, obs, priv, carry,
                                                jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    ts2, es2, _, _, jm, carry2, jroll, jlast = it(ts1, es1, obs1, priv1,
                                                  carry1, key)
    k_roll, k_update = jax.random.split(key)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, 6)))
                      for k in jax.random.split(k_roll, T)])
    perms = [np.asarray(jax.random.permutation(k, B))
             for k in jax.random.split(k_update, 5)]
    mb, grads, ts_loop = jax_minibatches(jr.ppo, ts1, jroll, jlast, perms,
                                         carry0=carry1)
    jpol = jr.get_inference_policy(ts1)

    tenv = make_env("pointfoot_flat", num_envs=B, device="cpu",
                    cfg_patch=FLAT_PATCH)
    tr = make_alg_runner(tenv, "pointfoot_flat",
                         train_cfg=_recurrent(get_cfgs("pointfoot_flat")[1]))
    tr.ppo.load_state_dict(convert.train_state_from_numpy(
        serialization.to_state_dict(jax.device_get(ts1))))
    tpol = tr.get_inference_policy()  # a copy of ts1's parameters
    tes = convert.env_state_from_numpy(export_fields(es1))
    tcarry1 = _t_carry(_np_carry(carry1))
    tes2, _, _, tcarry2, tm = tr.train_iteration_recurrent(
        tes, torch.from_numpy(np.array(obs1)),
        torch.from_numpy(np.array(priv1)), tcarry1,
        noise=torch.from_numpy(noise),
        perms=[torch.from_numpy(p.astype(np.int64)) for p in perms])
    return dict(jenv=jenv, es1=es1, es2=es2, jroll=jroll, jm=jm, ts2=ts2,
                mb=mb, grads=grads, ts_loop=ts_loop, carry1=carry1,
                carry2=carry2, jpol=jpol, tr=tr, tes2=tes2, tm=tm,
                tcarry1=tcarry1, tcarry2=tcarry2, tpol=tpol)


def test_recurrent_window_is_deterministic(iteration_pair):
    p = iteration_pair
    assert not np.asarray(p["jroll"].done).any()
    assert not bool(p["tr"].storage.done.any())
    steps = np.asarray(p["es1"].episode_step)[None] + np.arange(1, T + 1)[
        :, None]
    assert (steps % p["jenv"].resample_interval != 0).all()
    np.testing.assert_array_equal(p["tes2"].episode_step.numpy(),
                                  np.asarray(p["es2"].episode_step))


@pytest.mark.parametrize("name", ["obs", "priv_obs", "action", "reward",
                                  "done", "time_out", "value", "log_prob",
                                  "mean", "std"])
def test_recurrent_transitions_match_jax(iteration_pair, name):
    got = getattr(iteration_pair["tr"].storage, name).numpy()
    want = np.asarray(getattr(iteration_pair["jroll"], name))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), atol=ATOL, rtol=0,
                               err_msg=name)


def test_recurrent_carries_match_jax(iteration_pair):
    """The window's starting carry is non-zero (after a warm iteration) and
    kept in the runner's storage; the carry it ends with matches JAX's."""
    p = iteration_pair
    assert max(float(np.abs(np.asarray(x)).max())
               for x in jax.tree.leaves(p["carry1"])) > 0.01
    _assert_carry_close(p["tr"].carry0, p["carry1"], 0.0, "carry0")
    assert p["tr"].carry0[0][0] is not p["tcarry1"][0][0]
    _assert_carry_close(p["tcarry2"], p["carry2"], ATOL, "carry")


def test_recurrent_iteration_metrics_and_params_match_jax(iteration_pair):
    p = iteration_pair
    jm, tm = p["jm"], p["tm"]
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(np.asarray(tm[k], np.float64),
                                   np.asarray(jm[k], np.float64), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    got = p["tr"].ppo.minibatch_metrics["lr_intra"].numpy()
    want = np.array([m["lr_intra"] for m in p["mb"]])
    np.testing.assert_array_equal(np.sign(np.diff(got)),
                                  np.sign(np.diff(want)))
    np.testing.assert_allclose(got, want, rtol=len(got) * 1.2e-7, atol=0)
    want_p = convert.actor_critic_state_dict(jax.tree.map(np.asarray,
                                                          p["ts2"].params))
    loop = convert.actor_critic_state_dict(jax.tree.map(
        np.asarray, p["ts_loop"].params))
    state = p["tr"].ppo.state_dict()
    assert state["update_count"] == int(p["ts2"].update_count)
    for k, v in state["params"].items():
        np.testing.assert_allclose(loop[k].numpy(), want_p[k].numpy(),
                                   atol=1e-7, rtol=0, err_msg=k)
        err = np.abs(v.numpy() - want_p[k].numpy())
        assert (err <= adam_bound(p["grads"], p["mb"], k)).all(), \
            (k, err.max())


def test_stateful_inference_policy_matches_jax(iteration_pair):
    """The policy of ts1's parameters (taken before the port's iteration)
    keeps its carry across calls, starts over at a new batch size, takes a
    single observation, and `reset` zeroes it."""
    jpol, tpol = iteration_pair["jpol"], iteration_pair["tpol"]
    rng = np.random.default_rng(1)
    for b in (8, 8, 8, 3, 3, None, None):
        obs = rng.standard_normal((b, 27) if b else 27).astype(np.float32)
        got = tpol(torch.from_numpy(obs))
        want = np.asarray(jpol(jnp.asarray(obs)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=NET_ATOL, rtol=0)
    obs = torch.from_numpy(rng.standard_normal((3, 27)).astype(np.float32))
    a, b = tpol(obs), tpol(obs)
    assert float((a - b).abs().max()) > 1e-4  # the carry moved
    tpol.reset(3)
    torch.testing.assert_close(tpol(obs), a, rtol=0, atol=0)


def test_inference_policy_on_asymmetric_task_raises_as_jax_does():
    """pointfoot_rough's critic cell reads 148-d privileged observations:
    JAX's inference policy, which feeds it the 27-d observations, fails in
    flax; the port refuses up front, naming the widths."""
    jenv = task_registry.make_env("pointfoot_rough", num_envs=2)
    jtc = _recurrent(task_registry.get_cfgs("pointfoot_rough")[1])
    jr = task_registry.make_alg_runner(jenv, "pointfoot_rough",
                                       train_cfg=jtc)
    net = jr.network
    params = net.init(jax.random.PRNGKey(0), net.initialize_carry((1,)),
                      jnp.zeros((1, 27)), jnp.zeros((1, 148)))
    ts = jr.ppo.init_train_state(params)
    policy, carry0 = jr.get_inference_policy_recurrent(ts)
    with pytest.raises(flax.errors.ScopeParamShapeError, match="critic_rnn"):
        policy(carry0(2), jnp.zeros((2, 27)))

    env = make_env("pointfoot_rough", num_envs=2, device="cpu")
    tr = make_alg_runner(env, "pointfoot_rough",
                         train_cfg=_recurrent(get_cfgs("pointfoot_rough")[1]))
    for make in (tr.get_inference_policy, tr.get_inference_policy_recurrent):
        with pytest.raises(ValueError, match="148-d privileged"):
            make()


# -------------------------------------------------------- the train CLI

def test_train_cli_recurrent_runs_resumes_and_exports(tmp_path, capsys):
    """The recurrent override through train.py at 2 envs (2 minibatches
    of one env each): 2 iterations, then one more resumed from model_2.pt;
    the checkpoint exports as the LSTM TorchScript, which reproduces the
    trained actor."""
    common = ["--device", "cpu", "--num_envs", "2", "--log_dir",
              str(tmp_path), "--log_every", "1",
              "--train_override",
              "runner.policy_class_name=ActorCriticRecurrent",
              "--train_override", "runner.num_steps_per_env=4",
              "--train_override", "algorithm.num_mini_batches=2",
              "--train_override", "policy.rnn_hidden_size=16",
              "--train_override", "policy.actor_hidden_dims=(16,)",
              "--train_override", "policy.critic_hidden_dims=(16,)"]
    runner = train.main(common + ["--max_iterations", "2"])
    assert runner.recurrent and isinstance(runner.ppo, RecurrentPPO)
    assert runner.ppo.update_count == 20
    saved = runner.ppo.state_dict()["params"]
    runner = train.main(common + ["--max_iterations", "1", "--resume",
                                  "--load_run",
                                  str(tmp_path / "model_2.pt")])
    assert "resumed from" in capsys.readouterr().out
    assert runner.current_iteration == 3 and runner.ppo.update_count == 30
    assert (tmp_path / "model_3.pt").exists()
    lines = [json.loads(s) for s in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [m["it"] for m in lines] == [1, 2, 3]
    assert all(np.isfinite(m["kl"]) and np.isfinite(m["value_loss"])
               for m in lines)
    cfgs = [json.loads(s) for s in
            (tmp_path / "run_config.jsonl").read_text().splitlines()]
    assert cfgs[1]["train_cfg"]["runner"]["policy_class_name"] == \
        "ActorCriticRecurrent"

    out = export_policy.main(["--task", "pointfoot_rough", "--load_run",
                              str(tmp_path / "model_2.pt"), "--device",
                              "cpu"])
    assert out == str(tmp_path / "policy_lstm.pt")
    mod = torch.jit.load(out)
    net = ActorCriticRecurrent(27, 148, 6, 16, (16,), (16,))
    net.load_state_dict(saved)
    carry = net.initialize_carry(1)
    rng = np.random.default_rng(2)
    for _ in range(3):
        obs = torch.from_numpy(rng.standard_normal((1, 27)).astype(
            np.float32))
        with torch.no_grad():
            carry, (mean, _, _) = net(carry, obs, torch.zeros(1, 148))
            got = mod(obs)
        torch.testing.assert_close(got, mean, rtol=0, atol=NET_ATOL)
    assert export.load_onnx_policy(out)(obs.numpy()).shape == (1, 6)
