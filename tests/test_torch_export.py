"""The port's policy export (export/onnx_writer.py, export/onnx.py and the
export_policy CLI) against the JAX package's export/.

For the same layers the port writes the JAX writer's `.onnx` bytes; the
file reads back to the same layers and runs as the port's actor; the
TorchScript exports run as JAX's; the LSTM TorchScript of the recurrent
actor matches flax's (tests/test_export_lstm.py's atol 1e-5) and the port's
own ActorCriticRecurrent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointfoot_tpu.export import onnx as jexport
from pointfoot_tpu.export import onnx_writer as jwriter
from pointfoot_tpu.rl import networks as jnet
from pointfoot_tpu_torch import export_policy
from pointfoot_tpu_torch.export import onnx as export
from pointfoot_tpu_torch.export import onnx_writer
from pointfoot_tpu_torch.rl.networks import ActorCritic, ActorCriticRecurrent
from pointfoot_tpu_torch.utils import convert, policy_eval

ATOL = 1e-5  # tests/test_export.py, tests/test_export_lstm.py


def _flax_actor(hidden=(64, 32), seed=1):
    net = jnet.ActorCritic(num_actions=6, actor_hidden=hidden,
                           critic_hidden=(16,))
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 27)),
                      jnp.zeros((1, 27)))
    tnet = ActorCritic(27, 27, 6, hidden, (16,))
    tnet.load_state_dict(convert.actor_critic_state_dict(
        jax.tree.map(np.asarray, params)))
    return net, params, tnet


def _obs(n=4, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 27)).astype(
        np.float32)


@pytest.mark.parametrize("activation", ["elu", "relu", "tanh", "selu"])
def test_onnx_bytes_equal_jax_writer(tmp_path, activation):
    _, params, tnet = _flax_actor()
    want = jexport._actor_layers(params)
    got = export.actor_layers(tnet)
    for (gw, gb), (ww, wb) in zip(got, want):
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(gb, wb)
    a = onnx_writer.write_mlp_onnx(got, str(tmp_path / "port.onnx"),
                                   activation=activation)
    b = jwriter.write_mlp_onnx(want, str(tmp_path / "jax.onnx"),
                               activation=activation)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_onnx_export_equals_jax_and_round_trips(tmp_path):
    """export_policy_as_onnx from the network and from a state dict: both
    give the JAX export's bytes; read back, the opset-13 Gemm/Elu graph
    runs as the port's actor."""
    net, params, tnet = _flax_actor()
    b = jexport.export_policy_as_onnx(params, 27, str(tmp_path / "j.onnx"))
    a = export.export_policy_as_onnx(tnet, 27, str(tmp_path / "a.onnx"))
    c = export.export_policy_as_onnx(
        {k: v.clone() for k, v in tnet.state_dict().items()}, 27,
        str(tmp_path / "c.onnx"))
    data = open(b, "rb").read()
    assert open(a, "rb").read() == data == open(c, "rb").read()
    layers, activation, name_in, name_out, opset = \
        onnx_writer.read_mlp_onnx(a)
    assert (activation, name_in, name_out, opset) == ("elu", "obs",
                                                      "actions", 13)
    for (w, bias), (ww, wb) in zip(layers, export.actor_layers(tnet)):
        np.testing.assert_array_equal(w, ww)
        np.testing.assert_array_equal(bias, wb)
    obs = _obs()
    with torch.no_grad():
        want = tnet.act_mean(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(export.load_onnx_policy(a)(obs), want,
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        want, np.asarray(net.apply(params, jnp.asarray(obs),
                                   method=net.act_mean)), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="27-d obs, got 48"):
        export.export_policy_as_onnx(tnet, 48, str(tmp_path / "x.onnx"))


def test_torchscript_export_matches_jax(tmp_path):
    net, params, tnet = _flax_actor((32, 16), seed=0)
    a = export.export_policy_torchscript(tnet, 27, str(tmp_path / "a.pt"))
    b = jexport.export_policy_torchscript(params, 27, str(tmp_path / "b.pt"))
    obs = _obs(3)
    got = export.load_onnx_policy(a)(obs)
    np.testing.assert_array_equal(got, jexport.load_onnx_policy(b)(obs))
    np.testing.assert_allclose(
        got, np.asarray(net.apply(params, jnp.asarray(obs),
                                  method=net.act_mean)), atol=ATOL, rtol=0)


def test_lstm_export_matches_flax_and_the_port(tmp_path):
    """tests/test_export_lstm.py's recipe: five steps of one env, the
    TorchScript module against flax's recurrent actor and the port's;
    `reset_memory` starts the sequence over."""
    net = jnet.ActorCriticRecurrent(num_actions=6, rnn_hidden=16,
                                    actor_hidden=(16,), critic_hidden=(16,))
    carry0 = net.initialize_carry((1,))
    params = net.init(jax.random.PRNGKey(0), carry0, jnp.zeros((1, 27)),
                      jnp.zeros((1, 27)))
    params = jax.tree.map(lambda x: x, params)
    params["params"]["actor_rnn"]["hi"]["bias"] = jnp.full(16, 0.2)
    tnet = ActorCriticRecurrent(27, 27, 6, 16, (16,), (16,))
    tnet.load_state_dict(convert.actor_critic_state_dict(
        jax.tree.map(np.asarray, params)))
    mod = torch.jit.load(export.export_policy_lstm(
        tnet, 27, str(tmp_path / "lstm.pt")))
    jmod = torch.jit.load(jexport.export_policy_lstm(
        params, 27, str(tmp_path / "jlstm.pt")))
    obs_seq = np.random.default_rng(0).normal(size=(5, 1, 27)).astype(
        np.float32)
    carry, tcarry = carry0, tnet.initialize_carry(1)
    outs = []
    with torch.no_grad():
        for t in range(5):
            o = torch.from_numpy(obs_seq[t])
            got = mod(o)
            outs.append(got)
            np.testing.assert_array_equal(got.numpy(), jmod(o).numpy())
            tcarry, (tmean, _, _) = tnet(tcarry, o, o)
            carry, (mean, _, _) = net.apply(params, carry,
                                            jnp.asarray(obs_seq[t]),
                                            jnp.asarray(obs_seq[t]))
            np.testing.assert_allclose(got.numpy(), np.asarray(mean),
                                       atol=ATOL, rtol=0)
            np.testing.assert_allclose(got.numpy(), tmean.numpy(),
                                       atol=ATOL, rtol=0)
        assert float((outs[1] - mod(torch.from_numpy(obs_seq[1]))).abs()
                     .max()) > 1e-4  # the memory moved on
        mod.reset_memory()
        torch.testing.assert_close(mod(torch.from_numpy(obs_seq[0])),
                                   outs[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="27-d obs, got 30"):
        export.export_policy_lstm(tnet, 30, str(tmp_path / "x.pt"))


def test_export_cli_on_committed_flat_actor(tmp_path, capsys):
    """The committed model_82000 actor npz: the CLI's file equals the JAX
    export of the same arrays, and runs as the port's loaded actor."""
    npz = policy_eval.FLAT_ACTOR
    out = export_policy.main(["--task", "pointfoot_flat", "--load_run", npz,
                              "--out", str(tmp_path / "flat.onnx"),
                              "--device", "cpu"])
    assert capsys.readouterr().out.strip() == f"exported to {out}"
    with np.load(npz) as f:
        flat = {k: f[k] for k in f.files}
    tree = {}
    for key, arr in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    want = jexport.export_policy_as_onnx({"params": tree}, 27,
                                         str(tmp_path / "jax.onnx"))
    assert open(out, "rb").read() == open(want, "rb").read()
    sd = policy_eval.load_policy_state(npz)
    net = ActorCritic(27, 27, 6, (128, 64, 32), (128, 64, 32))
    net.load_state_dict(sd, strict=False)
    obs = _obs(5, seed=3)
    with torch.no_grad():
        act = net.act_mean(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(export.load_onnx_policy(out)(obs), act,
                               atol=ATOL, rtol=0)
