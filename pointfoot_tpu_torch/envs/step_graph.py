"""`LeggedEnv.step` replayed as one CUDA graph on one card.

An env step is about a thousand small aten operations and kernel launches
(PointFoot at 4096 envs); dispatched eagerly they take the host ~10 ms a
step while the card needs ~1-2 ms of it, so the rollout runs at the host's
pace.  `StepGraph` captures the env's eager body once and replays it: the
same kernels in the same order on the same stream, so a replay gives the
eager body's numbers bit for bit.

`graph_route` picks the graph where the state lives on a CUDA device, the
env has no shard mesh (a rank's reset all-reduces the command curriculum's
sums inside the step) and no input requires grad (sys-ID differentiates
through the eager body).  `graph_key` names what a graph depends on:

- each input tensor's shape, strides and dtype: the body's reductions sum
  in an order that follows the layout of what they read, so a graph is
  captured for each layout it meets.  A state from `init_state` and a
  state from `step` differ there, so a training run captures two graphs,
  at the zero-action step and at the rollout's first step;
- the env's `_ablate`, `terrain` and `height_fn`, which a bench or a test
  may set after construction;
- `dynamics.MEGA_MIN_BATCH`, which picks the physics route, and the TF32
  switch, which picks the matrix products' kernels.

The capture follows PyTorch's recipe for whole-network capture: warm-up
runs on a side stream (they build the kernel libraries and set the
kernels' attributes), then the capture on it.  Around them:

- Inputs are copied into static tensors of the caller's layout.
- The env's generator is registered with the graph, so each replay draws
  what the eager body would at that point of the generator's stream; its
  state is restored after the warm-ups, so the capturing call returns
  what the eager step would have.
- Outputs are the caller's.  A field the step passes through unchanged
  comes back as the caller's own tensor; everything the step writes comes
  back as a fresh copy in the layout the eager body gives it, one buffer
  a dtype, and the extras in buffers of their own (a rollout keeps them
  for its whole window).  The next replay overwrites only the graph's
  own tensors.
- The counters of utils/profiling.py that the body adds to (kernel
  launches, terrain points, actuator rows) are added at each replay as
  the capture counted them, so they count what the card did; the spans
  inside the body run at capture only.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import torch

from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.utils import profiling

WARMUP = 3  # eager runs before the capture (PyTorch's recipe)
ALIGN = 512  # bytes between copies' starts: the caching allocator's


@functools.lru_cache(maxsize=None)
def _fields(cls) -> tuple:
    return tuple(f.name for f in dataclasses.fields(cls))


def _collect(tree, out: list) -> None:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif dataclasses.is_dataclass(tree):
        for name in _fields(type(tree)):
            _collect(getattr(tree, name), out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _collect(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _collect(v, out)


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dataclasses, dicts, tuples and lists, in
    field order; other leaves (None) are skipped."""
    out: list = []
    _collect(tree, out)
    return out


def rebuild(template, values):
    """`template` with its tensors replaced, in `leaves` order, by the
    iterator `values`."""
    if isinstance(template, torch.Tensor):
        return next(values)
    if dataclasses.is_dataclass(template):
        return type(template)(**{n: rebuild(getattr(template, n), values)
                                 for n in _fields(type(template))})
    if isinstance(template, dict):
        return {k: rebuild(v, values) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(rebuild(v, values) for v in template))
    if isinstance(template, (tuple, list)):
        return type(template)(rebuild(v, values) for v in template)
    return template


def graph_route(device: torch.device, mesh,
                tensors: List[torch.Tensor]) -> bool:
    """Whether a step of a state on `device`, with a shard mesh `mesh` (or
    None) and these input tensors, replays a CUDA graph: on a card, without
    a mesh, with no input that requires grad."""
    return (device.type == "cuda" and mesh is None
            and not any(t.requires_grad for t in tensors))


def graph_key(env, tensors: List[torch.Tensor]) -> tuple:
    """What a captured step of `env` depends on (module docstring)."""
    return (tuple((t.shape, t.stride(), t.dtype) for t in tensors),
            env._ablate, env.terrain, env.height_fn,
            dynamics.MEGA_MIN_BATCH, torch.backends.cuda.matmul.allow_tf32)


def _by_dtype(tensors: List[torch.Tensor]) -> List[List[int]]:
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


class StepGraph:
    """`body(state, actions)` captured as a CUDA graph over static copies
    of `args`; calling it with the tensors of new arguments (`leaves`
    order) copies them in, replays, and returns the step's result
    (module docstring)."""

    def __init__(self, body, args, generator: torch.Generator):
        tensors = leaves(args)
        self.inputs = [torch.empty_like(t) for t in tensors]
        self._in_groups = [([self.inputs[i] for i in g], g)
                           for g in _by_dtype(tensors)]
        self._copy_in(tensors)
        static = rebuild(args, iter(self.inputs))
        drawn = generator.get_state()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with profiling.counts_apart(), torch.cuda.stream(stream):
            for _ in range(WARMUP):
                body(*static)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        with profiling.counts_apart() as counts, \
                torch.cuda.graph(self.graph, stream=stream):
            self._pack(body(*static))
        torch.cuda.current_stream().wait_stream(stream)
        generator.set_state(drawn)
        self.counts = tuple(counts.items())

    def _copy_in(self, tensors: List[torch.Tensor]) -> None:
        for dst, idx in self._in_groups:
            torch._foreach_copy_(dst, [tensors[i] for i in idx])

    def _pack(self, out) -> None:
        """Inside the capture: lay out the copies of what the step wrote,
        one buffer per (extras or not, dtype), and copy into them; note for
        each output tensor where the caller gets it from."""
        self.template = out
        passed = {id(t): i for i, t in enumerate(self.inputs)}
        apart = {id(t) for t in leaves(out[1].extras)}
        slots, seen = [], {}
        lay = {}  # group: [(index in leaves(out), numel, view args)]
        for k, t in enumerate(leaves(out)):
            if id(t) in passed:
                slots.append((None, passed[id(t)]))
                continue
            if id(t) not in seen:
                group = (id(t) in apart, t.dtype)
                items = lay.setdefault(group, [])
                step = max(ALIGN // t.element_size(), 1)
                end = items[-1][2][2] + items[-1][1] if items else 0
                offset = -(-end // step) * step
                # the layout the eager body's tensor has, as `clone` keeps it
                stride = torch.empty_like(t, device="meta").stride()
                items.append((k, t.numel(), (t.shape, stride, offset)))
                seen[id(t)] = (group, (t.shape, stride, offset))
            slots.append(seen[id(t)])
        self.slots = slots
        self.buffers, self._sources, self._views = {}, {}, {}
        for group, items in lay.items():
            _, n, (_, _, offset) = items[-1]
            buf = torch.empty(offset + n, dtype=group[1],
                              device=self.inputs[0].device)
            self.buffers[group] = buf
            self._views[group] = [buf.as_strided(*v) for _, _, v in items]
            self._sources[group] = [k for k, _, _ in items]
        self._fill(out)

    def _fill(self, out) -> None:
        """Copy the step's output tensors into the buffers' views."""
        ls = leaves(out)
        for group, views in self._views.items():
            torch._foreach_copy_(views, [ls[k] for k in self._sources[group]])

    def __call__(self, tensors: List[torch.Tensor]):
        self._copy_in(tensors)
        self.graph.replay()
        fresh = {g: b.clone() for g, b in self.buffers.items()}
        values = [tensors[where] if group is None
                  else fresh[group].as_strided(*where)
                  for group, where in self.slots]
        for name, n in self.counts:
            profiling.count(name, n)
        return rebuild(self.template, iter(values))

