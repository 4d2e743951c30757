"""The sys-ID network zoo of the port (pointfoot_tpu_torch/models/nets.py)
against the JAX package's flax nets (pointfoot_tpu/models/nets.py).

Each net is initialised by flax, its parameters carried over with
utils/convert.net_state_dict (every parameter of the port's net must be
filled: strict load), and both nets run on the same inputs made with numpy
from a seed, at small widths and T = 20.  Outputs agree to NET_TOL (rtol and
atol 1e-5): float32 roundoff through at most 20 LSTM steps or two encoder
blocks.  Each JAX apply is jitted once.

The trainers' updates (GAN, WGAN with its gradient penalty, direct GAN) are
held to JAX's with the simulator replaced on both sides by one small
differentiable stand-in, and the port's GAN and WGAN take one step through
the simulator itself, as tests/test_sysid.py's slow cases do.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointfoot_tpu.models import nets as jnets
from pointfoot_tpu.sysid.direct_gan import _SeqGenerator as JSeqGenerator
from pointfoot_tpu_torch.models import nets
from pointfoot_tpu_torch.sysid.direct_gan import _SeqGenerator
from pointfoot_tpu_torch.utils import convert

NET_TOL = 1e-5  # rtol and atol
# a generator's gradient against jax.grad of the same loss: float32
# roundoff through the stand-in, the discriminator and four dense layers,
# as a share of each tensor's largest entry
GRAD_TOL = 1e-4
POLICY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "logs", "pointfoot_flat", "tpu_run7", "exported",
    "policy.pt")
T, B, D = 20, 3, 27
R6 = tuple((0.0, 0.2) for _ in range(6))


def _case(name):
    """(flax net, port net, input shape) of each net at a small width."""
    return {
        "mlp_generator": (jnets.MLPGenerator(6, R6),
                          nets.MLPGenerator(6, 6, R6), (B, 6)),
        "mlp_discriminator": (jnets.MLPDiscriminator(out_dim=1),
                              nets.MLPDiscriminator(D, out_dim=1),
                              (B, T, D)),
        "mlp_discriminator_pool_batch": (
            jnets.MLPDiscriminator(hidden=32, pool_time=False),
            nets.MLPDiscriminator(D, hidden=32, pool_time=False),
            (B, T, D)),
        "mlp_critic": (jnets.MLPCritic(), nets.MLPCritic(D), (B, T, D)),
        "lstm_identifier": (jnets.LSTMIdentifier(hidden=32),
                            nets.LSTMIdentifier(D, hidden=32), (B, T, D)),
        "attention": (jnets.AttentionModel(hidden=16),
                      nets.AttentionModel(D, hidden=16), (B, T, D)),
        "transformer_generator": (
            jnets.TransformerGenerator(6, R6, dim=16),
            nets.TransformerGenerator(6, 6, R6, dim=16), (B, T, 6)),
        "transformer_discriminator": (
            jnets.TransformerDiscriminator(dim=16),
            nets.TransformerDiscriminator(D, dim=16), (B, T, D)),
        "seq_generator": (JSeqGenerator(5, D), _SeqGenerator(8, 5, D),
                          (B, 8)),
    }[name]


CASES = ["mlp_generator", "mlp_discriminator", "mlp_discriminator_pool_batch",
         "mlp_critic", "lstm_identifier", "attention",
         "transformer_generator", "transformer_discriminator",
         "seq_generator"]


def converted(jnet, tnet, shape, seed=0):
    """The flax parameters of `jnet` (from PRNGKey(seed)) loaded into
    `tnet`; returns the flax parameters."""
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros(shape))
    tnet.load_state_dict(convert.net_state_dict(
        tnet, jax.tree.map(np.asarray, params)), strict=True)
    return params


@pytest.mark.parametrize("name", CASES)
def test_net_matches_flax(name):
    jnet, tnet, shape = _case(name)
    params = converted(jnet, tnet, shape)
    x = np.random.default_rng(CASES.index(name)).normal(
        size=shape).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=NET_TOL, atol=NET_TOL)


def test_critic_on_features_skips_the_lstm():
    """A (B, D) input goes straight to the dense layers, as in flax."""
    jnet, tnet = jnets.MLPCritic(hidden=16), nets.MLPCritic(D, hidden=16)
    params = jnet.init(jax.random.PRNGKey(1), jnp.zeros((B, D)))
    sd = convert.net_state_dict(tnet, jax.tree.map(np.asarray, params))
    assert not any(k.startswith("lstm.") for k in sd)
    tnet.load_state_dict(sd, strict=False)
    x = np.random.default_rng(9).normal(size=(B, D)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=NET_TOL, atol=NET_TOL)


def test_posenc_matches_flax():
    np.testing.assert_allclose(nets.posenc(T, 16).numpy(),
                               np.asarray(jnets._posenc(T, 16)),
                               rtol=NET_TOL, atol=NET_TOL)


def test_reset_parameters_follows_flax_defaults():
    """LeCun-normal kernels (std 1/sqrt(fan_in)) with zero biases, from
    the caller's generator: the same seed gives the same net."""
    a = nets.LSTMIdentifier(D, hidden=64,
                            generator=torch.Generator().manual_seed(3))
    b = nets.LSTMIdentifier(D, hidden=64,
                            generator=torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    w = a.hidden[0].weight.detach()
    assert abs(float(w.std()) - 64 ** -0.5) < 0.1 * 64 ** -0.5
    assert not a.hidden[0].bias.any() and not a.lstm.cell.bias_h.any()
    H = 64
    q = a.lstm.cell.weight_h[:, :H]  # each gate's recurrent kernel
    torch.testing.assert_close(q.T @ q, torch.eye(H), atol=1e-5, rtol=0)


def test_generator_output_in_range():
    g = nets.MLPGenerator(3, 3, ((-0.03, 0.03), (-0.02, 0.02), (0.0, 1.0)),
                          generator=torch.Generator().manual_seed(0))
    out = g(10.0 * torch.randn(100, 3))
    lo = torch.tensor([-0.03, -0.02, 0.0])
    hi = torch.tensor([0.03, 0.02, 1.0])
    assert bool(((out >= lo) & (out <= hi)).all())


# ------------------ the trainers' update logic, without the simulator

SIM, CHUNK, OVER = 40, 16, 4  # three windows of 16 a rollout


def _standin(lib):
    """A small differentiable stand-in for the simulator, the same function
    in jnp and torch: (fric (6,), mass (1,), com (3,)) -> a (SIM, 1, 27)
    trajectory."""
    rng = np.random.default_rng(11)
    A = rng.normal(size=(6, D)).astype(np.float32)
    m = rng.normal(size=D).astype(np.float32)
    C = rng.normal(size=(3, D)).astype(np.float32)
    S = np.sin(0.1 * np.arange(SIM)[:, None]
               * np.arange(1, D + 1)[None, :]).astype(np.float32)
    if lib is jnp:
        A, m, C, S = map(jnp.asarray, (A, m, C, S))
        return lambda f, ms, c: (S * (f @ A + ms[0] * m
                                      + jnp.tanh(c @ C)))[:, None, :]
    A, m, C, S = map(torch.from_numpy, (A, m, C, S))
    return lambda f, ms, c: (S * (f @ A + ms[0] * m
                                  + torch.tanh(c @ C)))[:, None, :]


def _record_grads(monkeypatch, module) -> dict:
    """Every gradient `module.apply_grads` applies, by parameter id."""
    rec, apply = {}, module.apply_grads

    def wrapped(opt, params, grads):
        for p, g in zip(params, grads):
            rec[id(p)] = g.detach().clone()
        apply(opt, params, grads)

    monkeypatch.setattr(module, "apply_grads", wrapped)
    return rec


def _check_update(tnet, jparams_new, rec, lr, what):
    """The port's updated `tnet` against JAX's new parameters, within
    tests/_torch_parity.py::adam_bound of the step's gradients."""
    from _torch_parity import adam_bound

    want = convert.net_state_dict(tnet, jax.tree.map(np.asarray,
                                                     jparams_new))
    for name, p in tnet.named_parameters():
        bound = adam_bound([{name: rec[id(p)]}], [{"lr_intra": lr}], name)
        err = np.abs(p.detach().numpy() - want[name].numpy())
        assert (err <= bound).all(), f"{what} {name}: {err.max()}"


def _check_grads(tnet, jgrads, rec, what):
    """The gradients the port applied to `tnet` (recorded by _record_grads)
    against JAX's `jgrads`, within GRAD_TOL of each tensor's largest entry;
    every tensor's gradient is nonzero."""
    want = convert.net_state_dict(tnet, jax.tree.map(np.asarray, jgrads))
    for name, p in tnet.named_parameters():
        w, g = want[name].numpy(), rec[id(p)].numpy()
        assert np.abs(w).max() > 0, f"{what} {name}: JAX's gradient is zero"
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=f"{what} {name}")


def _largest_grad(net) -> float:
    """The largest norm of a parameter's gradient from `net`'s last step."""
    return max(float(torch.linalg.vector_norm(p.grad))
               for p in net.parameters())


def _envs():
    from types import SimpleNamespace

    return (SimpleNamespace(num_obs=D),
            SimpleNamespace(num_obs=D, device=torch.device("cpu")))


def test_gan_update_matches_jax(monkeypatch):
    """GANTrainer.train_step with `_simulate` replaced by the stand-in on
    both sides, from the same parameters and JAX's noise: the losses to
    1e-5, the three generators' gradients against jax.grad of JAX's
    generator loss, and the three generators and the discriminator after
    their Adam steps.  The generator gradients reach the generators only
    through the stand-in, as they reach them through the simulator."""
    from pointfoot_tpu.sysid import gan as jgan
    from pointfoot_tpu.sysid.simulate import chunk_windows as jchunk
    from pointfoot_tpu_torch.sysid import gan as tgan
    from pointfoot_tpu_torch.sysid.simulate import SimTrajectory

    jenv, tenv = _envs()
    kw = dict(sim_length=SIM, warmup=0, chunk=CHUNK, overlap=OVER)
    jt, tt = jgan.GANTrainer(jenv, None, **kw), tgan.GANTrainer(tenv, None,
                                                                **kw)
    js_ = _standin(jnp)
    ts_ = _standin(torch)
    jt._simulate = lambda s, f, m, c, cmd: SimTrajectory(js_(f, m, c), None)
    tt._simulate = lambda s, f, m, c, cmd: SimTrajectory(ts_(f, m, c), None)
    gs = jt.init(jax.random.PRNGKey(1))
    for tnet, jp in zip(tt.generators + (tt.disc,),
                        (gs.gen_fric, gs.gen_mass, gs.gen_com, gs.disc)):
        tnet.load_state_dict(convert.net_state_dict(
            tnet, jax.tree.map(np.asarray, jp)))
    real = (0.1 * np.random.default_rng(2).normal(size=(4, CHUNK, D))
            ).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = [torch.from_numpy(np.asarray(jax.random.normal(k, (n,))))
             for k, n in zip(jax.random.split(key, 3), (6, 1, 3))]
    new, m = jt.train_step(gs, None, jnp.asarray(real), jnp.zeros(3), key)
    rec = _record_grads(monkeypatch, tgan)
    got = tt.train_step(None, torch.from_numpy(real), torch.zeros(3),
                        noise=noise)
    for k in ("gen_loss", "disc_loss"):
        np.testing.assert_allclose(float(got[k]), float(m[k]), rtol=1e-5,
                                   err_msg=k)

    def jgen_loss(gf, gm, gc):  # JAX's gen_loss_fn with the stand-in
        zf, zm, zc = (jnp.asarray(n.numpy()) for n in noise)
        sim_w = jchunk(js_(jt.gen_fric.apply(gf, zf),
                           jt.gen_mass.apply(gm, zm),
                           jt.gen_com.apply(gc, zc)),
                       chunk=CHUNK, overlap=OVER)
        score = jt.disc.apply(gs.disc, sim_w)
        return jgan._bce(score, jnp.ones_like(score))

    jgrads = jax.jit(jax.grad(jgen_loss, argnums=(0, 1, 2)))(
        gs.gen_fric, gs.gen_mass, gs.gen_com)
    for tnet, jg, what in zip(tt.generators, jgrads, ("fric", "mass", "com")):
        _check_grads(tnet, jg, rec, what)
    for tnet, jp, what in zip(tt.generators + (tt.disc,),
                              (new.gen_fric, new.gen_mass, new.gen_com,
                               new.disc), ("fric", "mass", "com", "disc")):
        _check_update(tnet, jp, rec, 1e-3, what)
    props = tt.propose(noise=noise)
    want = jt.propose(new, key)
    for a, b in zip(props, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_wgan_update_matches_jax(monkeypatch):
    """WGANTrainer.train_step with the stand-in (params10 -> three windows)
    on both sides, from the same parameters and JAX's z and eps: the losses
    to 1e-5, the generator's gradient against jax.grad of JAX's generator
    loss, the generator and the critic after their Adam steps; the critic's
    step differentiates the gradient penalty, a double backward through its
    LSTM."""
    from pointfoot_tpu.sysid import wgan as jwgan
    from pointfoot_tpu.sysid.simulate import chunk_windows as jchunk
    from pointfoot_tpu_torch.sysid import wgan as twgan
    from pointfoot_tpu_torch.sysid.simulate import chunk_windows

    jenv, tenv = _envs()
    kw = dict(sim_length=SIM, warmup=0, chunk=CHUNK, overlap=OVER)
    jt, tt = jwgan.WGANTrainer(jenv, None, **kw), twgan.WGANTrainer(
        tenv, None, **kw)
    js_, ts_ = _standin(jnp), _standin(torch)
    jt._simulate = lambda s, p, cmd: jchunk(
        js_(p[:6], p[6:7], p[7:10]), chunk=CHUNK, overlap=OVER)
    tt._simulate = lambda s, p, cmd: chunk_windows(
        ts_(p[:6], p[6:7], p[7:10]), chunk=CHUNK, overlap=OVER)
    ws = jt.init(jax.random.PRNGKey(5))
    for tnet, jp in ((tt.gen, ws.gen), (tt.critic, ws.critic)):
        tnet.load_state_dict(convert.net_state_dict(
            tnet, jax.tree.map(np.asarray, jp)))
    real = (0.1 * np.random.default_rng(6).normal(size=(4, CHUNK, D))
            ).astype(np.float32)
    key = jax.random.PRNGKey(7)
    k_z, k_gp = jax.random.split(key)
    z = torch.from_numpy(np.asarray(jax.random.normal(k_z, (10,))))
    eps = torch.from_numpy(np.asarray(jax.random.uniform(k_gp, (4, 1, 1))))
    new, m = jt.train_step(ws, None, jnp.asarray(real), jnp.zeros(3), key)
    rec = _record_grads(monkeypatch, twgan)
    got = tt.train_step(None, torch.from_numpy(real), torch.zeros(3), z=z,
                        eps=eps)
    for k in ("gen_loss", "critic_loss"):
        np.testing.assert_allclose(float(got[k]), float(m[k]), rtol=1e-5,
                                   err_msg=k)
    jgrad = jax.jit(jax.grad(lambda g: -jnp.mean(jt.critic.apply(
        ws.critic, jt._simulate(None, jt.gen.apply(g, jnp.asarray(z.numpy())),
                                None)))))(ws.gen)
    _check_grads(tt.gen, jgrad, rec, "gen")
    _check_update(tt.gen, new.gen, rec, 1e-4, "gen")
    _check_update(tt.critic, new.critic, rec, 1e-4, "critic")


def test_gradient_penalty_matches_jax():
    """_gradient_penalty on the same critic, windows and eps, with more
    real windows than fake ones (eps is drawn for the real batch and cut),
    to 1e-5; and its gradient in the critic's parameters (a double backward
    through the LSTM) to 1e-4 of each tensor's largest entry."""
    from pointfoot_tpu.sysid import wgan as jwgan
    from pointfoot_tpu_torch.sysid import wgan as twgan
    from pointfoot_tpu_torch.sysid.gan import grads_of

    jenv, tenv = _envs()
    jt, tt = jwgan.WGANTrainer(jenv, None, chunk=CHUNK), twgan.WGANTrainer(
        tenv, None, chunk=CHUNK)
    cp = jt.init(jax.random.PRNGKey(4)).critic
    tt.critic.load_state_dict(convert.net_state_dict(
        tt.critic, jax.tree.map(np.asarray, cp)))
    rng = np.random.default_rng(8)
    real = rng.normal(size=(5, CHUNK, D)).astype(np.float32)
    fake = rng.normal(size=(3, CHUNK, D)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda c: jt._gradient_penalty(c, jnp.asarray(real),
                                       jnp.asarray(fake), key)))(cp)
    eps = torch.from_numpy(np.asarray(jax.random.uniform(key, (5, 1, 1))))
    got = tt._gradient_penalty(torch.from_numpy(real),
                               torch.from_numpy(fake), eps)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    params = dict(tt.critic.named_parameters())
    grads = grads_of(got, params.values())  # the last bias's is zero
    jg = convert.net_state_dict(tt.critic, jax.tree.map(np.asarray, jgrad))
    for (name, _), g in zip(params.items(), grads):
        w = jg[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_direct_gan_update_matches_jax(monkeypatch):
    """DirectTrajectoryGAN.train_step from the same parameters and JAX's
    noise: the losses to 1e-5, the generator's gradient against jax.grad
    of JAX's generator loss, and both nets after their Adam steps."""
    from pointfoot_tpu.sysid import direct_gan as jdg
    from pointfoot_tpu_torch.sysid import direct_gan as tdg

    jg, tg = jdg.DirectTrajectoryGAN(window=5, z_dim=8), \
        tdg.DirectTrajectoryGAN(window=5, z_dim=8)
    gs = jg.init(jax.random.PRNGKey(2))
    for tnet, jp in ((tg.gen, gs.gen), (tg.disc, gs.disc)):
        tnet.load_state_dict(convert.net_state_dict(
            tnet, jax.tree.map(np.asarray, jp)))
    real = np.random.default_rng(3).normal(size=(4, 5, D)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    z = torch.from_numpy(np.asarray(jax.random.normal(key, (4, 8))))
    new, m = jg.train_step(gs, jnp.asarray(real), key)
    rec = _record_grads(monkeypatch, tdg)
    got = tg.train_step(torch.from_numpy(real), z=z)
    for k in ("gen_loss", "disc_loss"):
        np.testing.assert_allclose(float(got[k]), float(m[k]), rtol=1e-5,
                                   err_msg=k)

    def jgen_loss(g):
        score = jg.disc.apply(gs.disc, jg.gen.apply(g, jnp.asarray(z.numpy())))
        return jdg._bce(score, jnp.ones_like(score))

    _check_grads(tg.gen, jax.jit(jax.grad(jgen_loss))(gs.gen), rec, "gen")
    _check_update(tg.gen, new.gen, rec, 1e-3, "gen")
    _check_update(tg.disc, new.disc, rec, 1e-3, "disc")
    assert tg.sample(3).shape == (3, 5, D)


# ------------------ the trainers' steps through the simulator

@pytest.mark.parametrize("cls", ["gan", "wgan"])
def test_through_sim_step(cls):
    """tests/test_sysid.py's slow GAN / WGAN steps, on the port (1 env, 24
    steps, chunks of 16): finite losses, proposals in range and a nonzero
    gradient in every generator, which only the simulator carries."""
    from pointfoot_tpu_torch.export.onnx import load_policy_as_torch
    from pointfoot_tpu_torch.sysid import GANTrainer, WGANTrainer
    from pointfoot_tpu_torch.utils.registry import make_env

    env = make_env("pointfoot_flat", num_envs=1, device="cpu",
                   cfg_patch=dict(noise=dict(add_noise=False),
                                  domain_rand=dict(push_robots=False)))
    state = env.init_state(0)
    pol = load_policy_as_torch(POLICY, device="cpu")
    g = torch.Generator().manual_seed(2)
    real = 0.1 * torch.randn(4, 16, 27, generator=g)
    kw = dict(sim_length=24, warmup=2, chunk=16, overlap=4)
    if cls == "gan":
        t = GANTrainer(env, pol, **kw)
        t.init(torch.Generator().manual_seed(1))
        m = t.train_step(state, real, torch.zeros(3), generator=g)
        losses = (m["gen_loss"], m["disc_loss"])
        norms = [_largest_grad(n) for n in t.generators]
        fric, mass, com = t.propose(g)
        assert fric.shape == (6,) and mass.shape == (1,) and com.shape == (3,)
        assert 0.0 <= float(fric.min()) and float(fric.max()) <= 0.2
        assert -1.0 <= float(mass[0]) <= 2.0
        assert bool((com.abs() <= torch.tensor([0.03, 0.02, 0.03])).all())
    else:
        t = WGANTrainer(env, pol, **kw)
        t.init(torch.Generator().manual_seed(5))
        m = t.train_step(state, real, torch.zeros(3), generator=g)
        losses = (m["gen_loss"], m["critic_loss"])
        norms = [_largest_grad(t.gen)]
    assert all(np.isfinite(float(v)) for v in losses)
    assert all(n > 0.0 for n in norms), norms
