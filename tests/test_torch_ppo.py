"""rl/ppo.py of the PyTorch port against the JAX package's PPO.

The cases of tests/test_ppo.py and tests/test_grad_guard.py run on the
port; compute_gae, one whole `PPO.update` (small nets, shared minibatch
permutations) and one optimizer step from the Adam state of the flagship
checkpoint (through utils/convert.train_state_from_numpy) run on both
packages from the same numpy inputs.

Tolerances.  Both packages compute in float32 with sums in different
orders, so single values differ by a few float32 ulps: the losses, KL and
gradients of a minibatch are held to rtol 1e-5 (atol 1e-6 for values near
0).  The learning rate takes the same branch of the adaptive rule at every
minibatch, compared exactly: both keep the rate in float32 and apply the
rule to KLs that agree to rtol 1e-5, none of which lies within that of a
threshold (the test checks this); the rates themselves agree to float32
rounding (XLA may divide by a reciprocal).  Adam turns
roundoff into a step: its update m_hat / (sqrt(v_hat) + eps) is about
lr * sign(g) for any |g| >> eps, so where a gradient entry is roundoff
noise around zero, the two packages can step it in opposite directions,
2 lr apart.  After the update's 20 steps, an entry whose gradients all
stayed clear of zero (|g| > 1e-4 of its tensor's largest, every step) is
held to 1e-6; any other entry to 2 * (sum of the rates used) + 1e-6.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointfoot_tpu.envs import config as jconfig
from pointfoot_tpu.envs import pointfoot_config as jpf
from pointfoot_tpu.rl import networks as jnet
from pointfoot_tpu.rl import ppo as jppo_mod
from pointfoot_tpu.utils.registry import task_registry
from _torch_parity import adam_bound, jax_minibatches
from pointfoot_tpu_torch.envs import config as tconfig
from pointfoot_tpu_torch.rl.networks import (ActorCritic, gaussian_entropy,
                                             gaussian_log_prob, sample_action)
from pointfoot_tpu_torch.rl.ppo import (PPO, Transition,
                                        clip_by_global_norm_, compute_gae)
from pointfoot_tpu_torch.utils import convert
from pointfoot_tpu_torch.utils.registry import TASKS

REPO = os.path.join(os.path.dirname(__file__), "..")
FLAGSHIP = os.path.join(REPO, "logs/pointfoot_rough/tpu_r4_storm/model_234000")

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny matmuls are faster on one thread (ROADMAP §3 trap g)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# --------------------------------------------- GAE (tests/test_ppo.py:14-58)

def test_gae_golden_values():
    gamma, lam = 0.9, 0.8
    adv, ret = compute_gae(*_t(np.ones((3, 1), np.float32),
                               np.zeros((3, 1), np.float32),
                               np.zeros((3, 1), np.float32),
                               np.full((3, 1), 0.5, np.float32),
                               np.full(1, 0.5, np.float32)), gamma, lam)
    a2 = 0.95
    a1 = 0.95 + 0.72 * a2
    a0 = 0.95 + 0.72 * a1
    np.testing.assert_allclose(adv[:, 0].numpy(), [a0, a1, a2], rtol=1e-5)
    np.testing.assert_allclose(ret.numpy(), adv.numpy() + 0.5, rtol=1e-5)


def test_gae_done_cuts_bootstrap():
    adv, _ = compute_gae(*_t(np.array([[0.0], [1.0]], np.float32),
                             np.array([[1.0], [0.0]], np.float32),
                             np.zeros((2, 1), np.float32),
                             np.array([[0.3], [0.4]], np.float32),
                             np.array([0.7], np.float32)), 0.99, 0.95)
    np.testing.assert_allclose(float(adv[0, 0]), -0.3, rtol=1e-5)


def test_gae_timeout_bootstraps_value():
    """r += gamma * V(s) on time-out steps; the done still cuts."""
    adv, _ = compute_gae(*_t(np.array([[1.0]], np.float32),
                             np.array([[1.0]], np.float32),
                             np.array([[1.0]], np.float32),
                             np.array([[2.0]], np.float32),
                             np.array([9.9], np.float32)), 0.9, 1.0)
    np.testing.assert_allclose(float(adv[0, 0]), 0.8, rtol=1e-5)


def test_gae_matches_jax():
    rng = np.random.default_rng(0)
    T, B = 24, 16
    rewards = rng.standard_normal((T, B)).astype(np.float32)
    dones = rng.random((T, B)) < 0.1
    time_outs = (dones & (rng.random((T, B)) < 0.5)).astype(np.float32)
    values = rng.standard_normal((T, B)).astype(np.float32)
    last = rng.standard_normal(B).astype(np.float32)
    want = jppo_mod.compute_gae(jnp.asarray(rewards), jnp.asarray(dones),
                                jnp.asarray(time_outs), jnp.asarray(values),
                                jnp.asarray(last), 0.99, 0.95)
    got = compute_gae(*_t(rewards, dones, time_outs, values, last),
                      0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


# ------------------------------------------------------ Gaussian helpers

def test_gaussian_helpers_match_jax():
    rng = np.random.default_rng(1)
    mean = rng.standard_normal((5, 6)).astype(np.float32)
    std = rng.uniform(0.05, 1.5, (5, 6)).astype(np.float32)
    noise = rng.standard_normal((5, 6)).astype(np.float32)
    action = sample_action(*_t(mean, std), noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(action.numpy(), mean + std * noise)
    np.testing.assert_allclose(
        gaussian_log_prob(*_t(mean, std), action).numpy(),
        np.asarray(jnet.gaussian_log_prob(mean, std, action.numpy())),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        gaussian_entropy(torch.from_numpy(std)).numpy(),
        np.asarray(jnet.gaussian_entropy(std)), rtol=RTOL, atol=ATOL)
    g = torch.Generator().manual_seed(3)
    drawn = sample_action(*_t(mean, std), generator=g)
    assert drawn.shape == (5, 6) and bool(torch.isfinite(drawn).all())


# --------------------------------------------------------------- config

def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("group", ["policy", "algorithm", "runner", "seed"])
def test_train_config_defaults_match_jax(group):
    """Every field of PolicyCfg/AlgorithmCfg/RunnerCfg/TrainCfg, by name
    and default, and of every registered task's training config."""
    want, got = jconfig.TrainCfg(), tconfig.TrainCfg()
    if group == "seed":
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)]
        assert got.seed == want.seed
        return
    assert _fields(getattr(got, group)) == _fields(getattr(want, group))
    assert _fields(getattr(TASKS["pointfoot_rough"][1], group)) == \
        _fields(getattr(jpf.POINTFOOT_ROUGH_PPO, group))
    for name, (_, tc) in TASKS.items():
        _, jtc = task_registry.get_cfgs(name)
        assert _fields(getattr(tc, group)) == _fields(getattr(jtc, group)), \
            name


# ------------------------------------------------------------ clip, guard

@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    """Below the norm the gradients pass unchanged; above it they become
    (g / norm) * max_norm, optax's formula (not clip_grad_norm_'s
    max / (norm + 1e-6))."""
    rng = np.random.default_rng(2)
    arrays = [scale * rng.standard_normal(s).astype(np.float32)
              for s in ((4, 3), (3,), (2,))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(a) for a in arrays], optax.EmptyState())
    grads = _t(*[a.copy() for a in arrays])
    norm = clip_by_global_norm_(grads, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(sum(
        (a.astype(np.float64) ** 2).sum() for a in arrays)), rtol=1e-6)
    for g, w, a in zip(grads, want, arrays):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
        if scale < 1.0:
            np.testing.assert_array_equal(g.numpy(), a)


def _tiny_ppo(**cfg):
    torch.manual_seed(0)
    net = ActorCritic(4, 4, 2, (8,), (8,))
    return PPO(net, tconfig.AlgorithmCfg(**cfg))


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_non_finite_gradients_leave_adam_finite(bad):
    """tests/test_grad_guard.py on the port: an inf or NaN gradient is
    zeroed before the clip, so the step and the Adam moments stay finite,
    and a healthy step afterwards still moves every parameter."""
    ppo = _tiny_ppo()
    before = [p.detach().clone() for p in ppo.params]
    for p in ppo.params:
        p.grad = torch.full_like(p, bad)
    ppo._sgd_step(0.01)
    for p, b in zip(ppo.params, before):
        assert bool(torch.isfinite(p).all())
        st = ppo.optimizer.state[p]
        assert bool(torch.isfinite(st["exp_avg"]).all())
        assert bool(torch.isfinite(st["exp_avg_sq"]).all())
    mid = [p.detach().clone() for p in ppo.params]
    for p in ppo.params:
        p.grad = torch.full_like(p, 0.01)
    ppo._sgd_step(0.01)
    for p, m in zip(ppo.params, mid):
        assert bool(torch.isfinite(p).all())
        assert float((p - m).abs().min()) > 0  # not frozen


# --------------------------------------------- update (tests/test_ppo.py)

T, B, NO, NP, NA = 4, 8, 6, 9, 2


def _rollout(seed=1, T=8, B=4, obs_dim=6, act_dim=2):
    """tests/test_ppo.py's random rollout, drawn with numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    obs = f(T, B, obs_dim)
    action = f(T, B, act_dim)
    mean = 0.1 * f(T, B, act_dim)
    std = np.ones((T, B, act_dim), np.float32)
    return Transition(*_t(obs, obs, action, f(T, B), np.zeros((T, B), bool),
                          np.zeros((T, B), np.float32), 0.1 * f(T, B),
                          np.asarray(jnet.gaussian_log_prob(mean, std,
                                                            action)),
                          mean, std))


def _ppo16(**cfg):
    net = ActorCritic(6, 6, 2, (16,), (16,))
    net.reset_parameters(torch.Generator().manual_seed(0))
    return PPO(net, tconfig.AlgorithmCfg(**cfg))


def test_ppo_update_runs_and_changes_params():
    ppo = _ppo16(num_mini_batches=2, num_learning_epochs=2)
    before = [p.detach().clone() for p in ppo.params]
    m = ppo.update(_rollout(), torch.zeros(4))
    for k in ("surrogate_loss", "value_loss", "kl"):
        assert np.isfinite(float(m[k]))
    assert max(float((p - b).abs().max())
               for p, b in zip(ppo.params, before)) > 0
    assert ppo.update_count == 4
    assert ppo.minibatch_metrics["kl"].shape == (4,)


def test_adaptive_lr_moves():
    ppo = _ppo16(num_mini_batches=2, num_learning_epochs=4,
                 learning_rate=1e-3, desired_kl=1e-9)  # force KL > 2x
    ppo.update(_rollout(), torch.zeros(4))
    assert float(ppo.learning_rate) < 1e-3


def test_kl_winsor_bounds_rogue_sample_vote():
    """tests/test_ppo.py:234 on the port: one rogue sample with a huge
    per-sample KL rails the plain mean but not the winsorized one."""
    roll = _rollout()
    mean = roll.mean.clone()
    mean[0, 0] += 100.0
    roll = roll._replace(mean=mean, log_prob=torch.from_numpy(np.asarray(
        jnet.gaussian_log_prob(mean.numpy(), roll.std.numpy(),
                               roll.action.numpy()))))
    kls = {}
    for winsor in (0.0, 1.0):
        ppo = _ppo16(num_mini_batches=1, num_learning_epochs=1,
                     kl_winsor=winsor)
        kls[winsor] = float(ppo.update(roll, torch.zeros(4))["kl"])
    assert kls[0.0] > 50.0, kls
    assert kls[1.0] < 2.0, kls


# --------------------------------------------- one PPO.update against JAX

@pytest.fixture(scope="module")
def update_pair():
    """Small nets (hidden 16, obs 6, privileged obs 9, 2 actions), a T 4 x
    B 8 rollout whose old policy is the network itself plus a little
    noise (so the first KLs lie under desired_kl / 2 and later ones over
    2 desired_kl: both branches of the adaptive rule), a done and a
    time-out; both packages update from the same parameters with JAX's
    permutations."""
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    net = jnet.ActorCritic(num_actions=NA, actor_hidden=(16,),
                           critic_hidden=(16,))
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, NO)),
                      jnp.zeros((1, NP)))
    obs, priv = f(T, B, NO), f(T, B, NP)
    mean, std = net.apply(params, jnp.asarray(obs),
                          method=net.distribution)
    mean = np.asarray(mean) + 0.02 * f(T, B, NA)
    std = np.asarray(std)
    action = mean + std * f(T, B, NA)
    done = np.zeros((T, B), bool)
    done[1, 2] = done[2, 5] = True
    time_out = np.zeros((T, B), np.float32)
    time_out[2, 5] = 1.0
    arrays = (obs, priv, action, f(T, B), done, time_out, 0.1 * f(T, B),
              np.asarray(jnet.gaussian_log_prob(mean, std, action)), mean,
              std)
    last = 0.1 * f(B)
    cfg = dict(desired_kl=0.002, learning_rate=2e-4)
    jppo = jppo_mod.PPO(net, jconfig.AlgorithmCfg(**cfg))
    ts0 = jppo.init_train_state(params)
    jroll = jppo_mod.Transition(*(jnp.asarray(a) for a in arrays))
    key = jax.random.PRNGKey(2)
    ts_update, jmetrics = jax.jit(jppo.update)(ts0, jroll,
                                               jnp.asarray(last), key)
    perms = [np.asarray(jax.random.permutation(k, T * B))
             for k in jax.random.split(key, jppo.cfg.num_learning_epochs)]
    mb_metrics, grads, ts_loop = jax_minibatches(jppo, ts0, jroll,
                                                  jnp.asarray(last), perms)

    tnet = ActorCritic(NO, NP, NA, (16,), (16,))
    tnet.load_state_dict(convert.actor_critic_state_dict(
        jax.tree.map(np.asarray, params)))
    tppo = PPO(tnet, tconfig.AlgorithmCfg(**cfg))
    troll = Transition(*_t(*arrays))
    # the first minibatch's gradients, from the initial parameters
    adv, ret = compute_gae(troll.reward, troll.done, troll.time_out,
                           troll.value, torch.from_numpy(last), 0.99, 0.95)
    idx = torch.from_numpy(perms[0][:T * B // 4].astype(np.int64))
    flat = Transition(*(x.reshape((T * B,) + x.shape[2:]) for x in troll))
    tppo.loss_and_grad(Transition(*(x[idx] for x in flat)),
                       adv.reshape(-1)[idx], ret.reshape(-1)[idx])
    grad0 = {k: p.grad.clone() for k, p in tnet.named_parameters()}
    tmetrics = tppo.update(troll, torch.from_numpy(last),
                           [torch.from_numpy(p.astype(np.int64))
                            for p in perms])
    return dict(jmetrics=jmetrics, mb=mb_metrics, grads=grads,
                ts_update=ts_update, ts_loop=ts_loop, tppo=tppo,
                tmetrics=tmetrics, grad0=grad0,
                desired_kl=cfg["desired_kl"])


def test_update_unrolled_is_jax_update(update_pair):
    """The minibatch loop of the comparison is JAX's update itself."""
    a = convert.actor_critic_state_dict(jax.tree.map(
        np.asarray, update_pair["ts_update"].params))
    b = convert.actor_critic_state_dict(jax.tree.map(
        np.asarray, update_pair["ts_loop"].params))
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-7,
                                   rtol=0, err_msg=k)
    assert float(update_pair["ts_update"].learning_rate) == \
        float(update_pair["ts_loop"].learning_rate)


def test_update_first_gradients_match_jax(update_pair):
    want = update_pair["grads"][0]
    for k, g in update_pair["grad0"].items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=RTOL,
                                   atol=ATOL * float(want[k].abs().max()),
                                   err_msg=k)


@pytest.mark.parametrize("name", ["surrogate_loss", "value_loss", "entropy",
                                  "kl"])
def test_update_minibatch_metrics_match_jax(update_pair, name):
    got = update_pair["tppo"].minibatch_metrics[name].numpy()
    want = np.array([m[name] for m in update_pair["mb"]])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_update_lr_sequence_matches_jax(update_pair):
    """Both keep the rate in float32, and no minibatch's KL lies within the
    KL tolerance of 2 desired_kl or desired_kl / 2, so both take the same
    branch of the rule each time (compared exactly: raise, lower or keep);
    both branches are taken.  The rates agree to float32 rounding only:
    XLA may divide by 1.5 through a reciprocal, one ulp off IEEE division
    (measured: one rate of 20, 1.1e-7 relative)."""
    dkl = update_pair["desired_kl"]
    kl = np.array([m["kl"] for m in update_pair["mb"]])
    for edge in (2.0 * dkl, dkl / 2.0):
        assert (np.abs(kl - edge) > RTOL * edge + ATOL * edge).all()
    assert (kl < dkl / 2.0).any() and (kl > 2.0 * dkl).any()
    got = update_pair["tppo"].minibatch_metrics["lr_intra"].numpy()
    want = np.array([m["lr_intra"] for m in update_pair["mb"]])
    got = np.append(got, update_pair["tppo"].learning_rate)
    want = np.append(want, np.float32(update_pair["ts_loop"].learning_rate))
    np.testing.assert_array_equal(np.sign(np.diff(got)),
                                  np.sign(np.diff(want)))
    assert (np.diff(want) > 0).any() and (np.diff(want) < 0).any()
    np.testing.assert_allclose(got, want, rtol=len(got) * 1.2e-7, atol=0)


def test_update_mean_metrics_match_jax(update_pair):
    jm, tm = update_pair["jmetrics"], update_pair["tmetrics"]
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_update_params_and_adam_moments_match_jax(update_pair):
    ts = update_pair["ts_loop"]
    tppo = update_pair["tppo"]
    want_p = convert.actor_critic_state_dict(jax.tree.map(np.asarray,
                                                          ts.params))
    adam = ts.opt_state[2]
    want_mu = convert.actor_critic_state_dict(jax.tree.map(np.asarray,
                                                           adam.mu))
    want_nu = convert.actor_critic_state_dict(jax.tree.map(np.asarray,
                                                           adam.nu))
    state = tppo.state_dict()
    assert state["adam_step"] == int(adam.count) == 20
    assert state["update_count"] == int(ts.update_count) == 20
    for k, p in state["params"].items():
        err = np.abs(p.numpy() - want_p[k].numpy())
        assert (err <= adam_bound(update_pair["grads"], update_pair["mb"], k)).all(), (k, err.max())
        np.testing.assert_allclose(state["adam"][k]["exp_avg"].numpy(),
                                   want_mu[k].numpy(), rtol=1e-4,
                                   atol=ATOL * float(want_mu[k].abs().max()),
                                   err_msg=k)
        np.testing.assert_allclose(state["adam"][k]["exp_avg_sq"].numpy(),
                                   want_nu[k].numpy(), rtol=1e-4,
                                   atol=ATOL * float(want_nu[k].abs().max()),
                                   err_msg=k)


# ----------------------------------- the flagship's TrainState, converted

@pytest.fixture(scope="module")
def flagship():
    import orbax.checkpoint as ocp

    raw = ocp.PyTreeCheckpointer().restore(os.path.abspath(FLAGSHIP))
    return raw["train_state"]


def _flagship_ppo(flagship):
    state = convert.train_state_from_numpy(flagship)
    net = ActorCritic(27, 148, 6)
    ppo = PPO(net, TASKS["pointfoot_rough"][1].algorithm)
    ppo.load_state_dict(state)
    return ppo, state


def test_train_state_from_numpy_networks_match_flax(flagship):
    ppo, state = _flagship_ppo(flagship)
    # the flat form an npz export holds converts the same
    flat = convert.train_state_from_numpy(convert.flatten(flagship))
    for k, v in state["params"].items():
        torch.testing.assert_close(flat["params"][k], v, rtol=0, atol=0)
    for k, m in state["adam"].items():
        for name, v in m.items():
            torch.testing.assert_close(flat["adam"][k][name], v, rtol=0,
                                       atol=0)
    assert state["adam_step"] == int(flagship["opt_state"][2]["count"])
    assert state["learning_rate"] == float(flagship["learning_rate"])
    assert ppo.update_count == int(flagship["update_count"])
    net = jnet.ActorCritic(num_actions=6)
    rng = np.random.default_rng(4)
    obs = rng.standard_normal((16, 27)).astype(np.float32)
    priv = rng.standard_normal((16, 148)).astype(np.float32)
    mean, std, value = net.apply(flagship["params"], jnp.asarray(obs),
                                 jnp.asarray(priv))
    with torch.no_grad():
        t_mean, t_std, t_value = ppo.network(*_t(obs, priv))
    # standard normal inputs drive the trained nets far outside their
    # range (means up to 30): float32 roundoff relative to the output
    for got, want in ((t_mean, mean), (t_std, std), (t_value, value)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=RTOL)


def test_train_state_from_numpy_adam_step_matches_optax(flagship):
    """One step of the port's optimizer from the converted moments against
    JAX's `_sgd_step` from the checkpoint's, on the same gradient."""
    ppo, _ = _flagship_ppo(flagship)
    cfg = jpf.POINTFOOT_ROUGH_PPO.algorithm
    net = jnet.ActorCritic(num_actions=6)
    jppo = jppo_mod.PPO(net, cfg)
    params = jax.tree.map(jnp.asarray, flagship["params"])
    tmpl = jppo.tx.init(params)
    adam = flagship["opt_state"][2]
    opt_state = (tmpl[0], tmpl[1], tmpl[2]._replace(
        count=jnp.asarray(adam["count"]),
        mu=jax.tree.map(jnp.asarray, adam["mu"]),
        nu=jax.tree.map(jnp.asarray, adam["nu"])), tmpl[3])
    ts = jppo_mod.TrainState(
        params=params, opt_state=opt_state,
        learning_rate=jnp.asarray(flagship["learning_rate"]),
        update_count=jnp.asarray(flagship["update_count"]))
    rng = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda p: jnp.asarray(2e-3 * rng.standard_normal(p.shape),
                              jnp.float32), params)
    kl = cfg.desired_kl  # inside the corridor: the rate stays
    ts2 = jppo._sgd_step(ts, grads, {"kl": jnp.asarray(kl)})

    tg = convert.actor_critic_state_dict(jax.tree.map(np.asarray, grads))
    for name, p in ppo.network.named_parameters():
        p.grad = tg[name].clone()
    ppo._sgd_step(kl)
    want_p = convert.actor_critic_state_dict(jax.tree.map(np.asarray,
                                                          ts2.params))
    adam2 = ts2.opt_state[2]
    want_mu = convert.actor_critic_state_dict(jax.tree.map(np.asarray,
                                                           adam2.mu))
    want_nu = convert.actor_critic_state_dict(jax.tree.map(np.asarray,
                                                           adam2.nu))
    state = ppo.state_dict()
    assert state["adam_step"] == int(adam2.count)
    assert state["learning_rate"] == float(ts2.learning_rate)
    for k, p in state["params"].items():
        np.testing.assert_allclose(p.numpy(), want_p[k].numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)
        # torch's lerp and optax's b1 m + (1 - b1) g round apart where the
        # two terms cancel: atol relative to the tensor's largest moment
        for mine, theirs in (("exp_avg", want_mu), ("exp_avg_sq", want_nu)):
            w = theirs[k].numpy()
            np.testing.assert_allclose(
                state["adam"][k][mine].numpy(), w, rtol=1e-6,
                atol=1e-6 * float(np.abs(w).max()), err_msg=f"{k} {mine}")
