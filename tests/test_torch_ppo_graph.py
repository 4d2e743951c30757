"""RecurrentPPO's graph route (rl/ppo.py): on one card each minibatch's
forward, loss and backward is replayed as a CUDA graph; everywhere else the
eager route runs.

On the CPU: the route choice, the key a capture is filed under, the
route's bookkeeping (with the graph stood in for by an eager call), and an
update that takes the eager route and counts no graph.

On the card (marker `cuda`; skips without one): two updates at the
recurrent cell's widths (`pf_lstm_train_table`), graphed and forced eager
from one seed, bit for bit: the gradient each optimizer step takes, the 20
minibatch metrics and the parameters after each update, with and without a
`load_state_dict` between the updates; the counters; and a halved
minibatch, which captures a graph of its own.  The card has no JAX, so the
repo's conftest files are bypassed:

    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_ppo_graph.py
"""

import copy

import pytest
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from pointfoot_tpu_torch.envs.config import AlgorithmCfg
from pointfoot_tpu_torch.parallel.mesh import Mesh
from pointfoot_tpu_torch.rl import ppo as ppo_mod
from pointfoot_tpu_torch.rl.networks import (ActorCriticRecurrent,
                                             gaussian_log_prob, map_carry)
from pointfoot_tpu_torch.rl.ppo import (RecurrentPPO, Transition, graph_key,
                                        graph_route)
from pointfoot_tpu_torch.utils import profiling

# pointfoot_rough_lstm's widths and PPO (benchmark/configs), 4096 envs
CELL = dict(n_obs=27, n_priv=148, n_act=6, rnn=256, heads=(512, 256, 128),
            T=24, B=4096)
TINY = dict(n_obs=5, n_priv=7, n_act=2, rnn=8, heads=(16,), T=4, B=8)
COUNTERS = ("ppo.graph_capture", "ppo.graph_replay")


def _problem(w: dict, device, seed: int = 0):
    """A network drawn from `seed` and a synthetic (T, B) rollout with
    dones and time-outs, its starting carry, the bootstrap values and one
    permutation of the envs an epoch; on `device`."""
    gen = torch.Generator().manual_seed(seed)
    T, B, na, H = w["T"], w["B"], w["n_act"], w["rnn"]
    net = ActorCriticRecurrent(w["n_obs"], w["n_priv"], na, H, w["heads"],
                               w["heads"])
    net.reset_parameters(gen)

    def r(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen)

    mean, std = r(T, B, na, scale=0.3), torch.ones(T, B, na)
    action = mean + std * r(T, B, na)
    roll = Transition(
        obs=r(T, B, w["n_obs"]), priv_obs=r(T, B, w["n_priv"]),
        action=action, reward=r(T, B),
        done=torch.rand((T, B), generator=gen) < 0.05,
        time_out=(torch.rand((T, B), generator=gen) < 0.01).float(),
        value=r(T, B), log_prob=gaussian_log_prob(mean, std, action),
        mean=mean, std=std)
    carry0 = tuple((r(B, H, scale=0.1), r(B, H, scale=0.1))
                   for _ in range(2))
    last_value = r(B)
    perms = [torch.randperm(B, generator=gen)
             for _ in range(AlgorithmCfg().num_learning_epochs)]
    return (net.to(device), Transition(*(x.to(device) for x in roll)),
            map_carry(lambda c: c.to(device), carry0), last_value.to(device),
            perms)


def _minibatch(roll, carry0, idx):
    """`RecurrentPPO.update`'s minibatch of the envs `idx`, as it hands it
    to `loss_and_grad` (no mesh)."""
    return (map_carry(lambda c: c[idx], carry0),
            Transition(*(x[:, idx] for x in roll)))


def _counts(before: dict) -> dict:
    return {k: profiling.counter(k) - before.get(k, 0) for k in COUNTERS}


def _updates(w: dict, device, reload: bool = False):
    """Two updates of one problem: per update the counters' deltas, the
    minibatch metrics and the parameters after it; and the gradient each
    optimizer step took.  With `reload`, a `load_state_dict` of a copy of
    the state between the two."""
    net, roll, carry0, last_value, perms = _problem(w, device)
    ppo = RecurrentPPO(net, AlgorithmCfg())
    grads, sgd = [], ppo._sgd_step

    def step(kl):
        grads.append([p.grad.clone() for p in ppo.params])
        sgd(kl)

    ppo._sgd_step = step
    out = []
    for u in range(2):
        before = profiling.counters()
        ppo.update(roll, last_value, perms, carry0=carry0)
        out.append(dict(
            counts=_counts(before),
            metrics={k: v.clone() for k, v in ppo.minibatch_metrics.items()},
            params=[p.detach().clone() for p in ppo.params]))
        if reload and u == 0:
            ppo.load_state_dict(copy.deepcopy(ppo.state_dict()))
    return ppo, out, grads


class _EagerGraph:
    """`_MinibatchGraph`'s interface, run eagerly: the graph route's
    bookkeeping on the CPU."""

    def __init__(self, fn, args):
        self.fn = fn

    def __call__(self, args):
        return self.fn(*args)


def _assert_same(a, b):
    """Bit for bit: every tensor of `a` equals its twin in `b`."""
    ta, tb = tree_leaves(a), tree_leaves(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


# --------------------------------------------------------------- on the CPU

def test_graph_route_only_on_one_card_without_collectives(tmp_path):
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert not dist.is_initialized()
    assert graph_route(card, None)
    assert graph_route(card, Mesh(rank=0, world_size=1, device=card))
    assert not graph_route(cpu, None)
    assert not graph_route(cpu, Mesh(rank=0, world_size=1, device=cpu))
    assert not graph_route(card, Mesh(rank=0, world_size=2, device=card))
    assert not graph_route(card, Mesh(rank=1, world_size=4, device=card))
    # one rank with a process group runs the loss's collectives
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        assert not graph_route(card, Mesh(rank=0, world_size=1, device=card))
        assert graph_route(card, None)
    finally:
        dist.destroy_process_group()


def test_graph_key_follows_layout_gradients_count_and_tf32():
    net, roll, carry0, _, _ = _problem(TINY, "cpu")
    ppo = RecurrentPPO(net, AlgorithmCfg())
    for p in ppo.params:
        p.grad = torch.zeros_like(p)
    idx = torch.arange(4)
    c0, batch = _minibatch(roll, carry0, idx)
    adv, ret = roll.value[:, idx], roll.reward[:, idx]
    key = graph_key(ppo.params, None, (c0, batch, adv, ret))
    # other envs, other values, in-place steps: the same graph serves
    c1, batch1 = _minibatch(roll, carry0, idx + 4)
    with torch.no_grad():
        for p in ppo.params:
            p.add_(1.0)
            p.grad.normal_()
    assert graph_key(ppo.params, None, (c1, batch1, ret, adv)) == key
    # half the envs: another layout
    ch, bh = _minibatch(roll, carry0, idx[:2])
    assert graph_key(ppo.params, None,
                     (ch, bh, adv[:, :2], ret[:, :2])) != key
    # a non-contiguous view of the same shape: another layout
    assert graph_key(ppo.params, None,
                     (c0, batch, adv.t().contiguous().t(), ret)) != key
    assert graph_key(ppo.params, 96, (c0, batch, adv, ret)) != key
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not tf32
        assert graph_key(ppo.params, None, (c0, batch, adv, ret)) != key
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # a gradient replaced, or gone: the graph would write elsewhere
    g = ppo.params[3].grad
    ppo.params[3].grad = g.clone()
    assert graph_key(ppo.params, None, (c0, batch, adv, ret)) != key
    ppo.params[3].grad = None
    assert graph_key(ppo.params, None, (c0, batch, adv, ret)) != key
    ppo.params[3].grad = g
    assert graph_key(ppo.params, None, (c0, batch, adv, ret)) == key


def test_cpu_update_takes_the_eager_route():
    """The CPU's update captures nothing and leaves the graph counters at
    0; tests/test_torch_recurrent.py holds the same route to JAX."""
    before = profiling.counters()
    ppo, out, grads = _updates(TINY, "cpu")
    assert all(o["counts"] == dict.fromkeys(COUNTERS, 0) for o in out)
    assert _counts(before) == dict.fromkeys(COUNTERS, 0)
    assert ppo._graphs == {}
    assert len(grads) == 2 * 20


def test_graph_route_bookkeeping(monkeypatch):
    """The graph route with the graph run eagerly: one capture a key, a
    replay a minibatch, the numbers of the eager route; a new shape or a
    replaced gradient captures anew, and a capture drops the graphs of
    gradients the parameters no longer hold."""
    _, eager, eager_grads = _updates(TINY, "cpu")
    monkeypatch.setattr(ppo_mod, "graph_route", lambda device, mesh: True)
    monkeypatch.setattr(ppo_mod, "_MinibatchGraph", _EagerGraph)
    ppo, graphed, grads = _updates(TINY, "cpu")
    assert [o["counts"] for o in graphed] == [
        {"ppo.graph_capture": 1, "ppo.graph_replay": 20},
        {"ppo.graph_capture": 0, "ppo.graph_replay": 20}]
    for g, e in zip(graphed, eager):
        _assert_same((g["metrics"], g["params"]), (e["metrics"], e["params"]))
    _assert_same(grads, eager_grads)
    assert len(ppo._graphs) == 1

    net, roll, carry0, _, _ = _problem(TINY, "cpu", seed=1)
    idx = torch.arange(TINY["B"] // 4)
    c0, batch = _minibatch(roll, carry0, idx)
    args = (c0, batch, roll.value[:, idx], roll.reward[:, idx])
    before = profiling.counters()
    ppo.loss_and_grad(*args)
    assert _counts(before) == {"ppo.graph_capture": 0, "ppo.graph_replay": 1}
    half = (map_carry(lambda c: c[:1], c0),
            Transition(*(x[:, :1] for x in batch)), args[2][:, :1],
            args[3][:, :1])
    ppo.loss_and_grad(*half)
    assert _counts(before) == {"ppo.graph_capture": 1, "ppo.graph_replay": 2}
    assert len(ppo._graphs) == 2
    ppo.params[0].grad = None
    ppo.loss_and_grad(*args)
    assert ppo.params[0].grad is not None
    assert _counts(before) == {"ppo.graph_capture": 2, "ppo.graph_replay": 3}
    assert len(ppo._graphs) == 1


# -------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("reload", [False, True],
                         ids=["straight", "load_state_dict"])
def test_graphed_update_is_eager_bit_for_bit(card, monkeypatch, reload):
    ppo, graphed, grads = _updates(CELL, card, reload)
    assert [o["counts"] for o in graphed] == [
        {"ppo.graph_capture": 1, "ppo.graph_replay": 20},
        {"ppo.graph_capture": 0, "ppo.graph_replay": 20}]
    assert len(ppo._graphs) == 1
    monkeypatch.setattr(ppo_mod, "graph_route", lambda device, mesh: False)
    _, eager, eager_grads = _updates(CELL, card, reload)
    assert [o["counts"] for o in eager] == [dict.fromkeys(COUNTERS, 0)] * 2
    assert len(grads) == len(eager_grads) == 40
    for g, e in zip(grads, eager_grads):
        _assert_same(g, e)
    for g, e in zip(graphed, eager):
        assert set(g["metrics"]) == set(e["metrics"])
        assert all(v.numel() == 20 for v in g["metrics"].values())
        _assert_same((g["metrics"], g["params"]), (e["metrics"], e["params"]))


@pytest.mark.cuda
def test_halved_minibatch_captures_its_own_graph(card, monkeypatch):
    """A minibatch of half the envs (benchmark/faults.py's `half_batch`)
    captures a second graph, which gives the eager route's numbers; the
    full-size minibatch then replays the first.  The halves are made
    contiguous, as the graph's static copies of them are: the eager
    route's reductions over a strided view may sum in another order."""
    net, roll, carry0, _, perms = _problem(CELL, card)
    ppo = RecurrentPPO(net, AlgorithmCfg())
    idx = perms[0][:CELL["B"] // 4].to(card)
    c0, batch = _minibatch(roll, carry0, idx)
    args = (c0, batch, roll.value[:, idx], roll.reward[:, idx])
    n = idx.numel() // 2
    half = (map_carry(lambda c: c[:n].contiguous(), c0),
            Transition(*(x[:, :n].contiguous() for x in batch)),
            args[2][:, :n].contiguous(), args[3][:, :n].contiguous())

    def grads():
        return [p.grad.clone() for p in ppo.params]

    before = profiling.counters()
    full = ppo.loss_and_grad(*args), grads()
    halved = ppo.loss_and_grad(*half), grads()
    again = ppo.loss_and_grad(*args), grads()
    assert _counts(before) == {"ppo.graph_capture": 2, "ppo.graph_replay": 3}
    assert len(ppo._graphs) == 2
    _assert_same(again, full)
    monkeypatch.setattr(ppo_mod, "graph_route", lambda device, mesh: False)
    _assert_same(full, (ppo.loss_and_grad(*args), grads()))
    _assert_same(halved, (ppo.loss_and_grad(*half), grads()))
