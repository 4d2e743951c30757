"""Spans and the device trace of a `--trace 1` run, taken from the
benchmark's own files around the calls into each layer of the port.

`Spans` wraps, on the instances only, the runner's rollout and update (host
clock with `torch.cuda.synchronize` at both ends), the env's `step` (CUDA
events) and the terrain's two queries where the env holds them: the
physics reads the surface through `env.height_fn.surface_fn`, bound when
the env was built, and the height scans through `env.terrain`.  Events are
read after each iteration, whose update already waits for the card.

`profile` runs whole iterations under `torch.profiler` and reduces the
trace in memory: device busy time as the union of the device's activity
intervals (the arithmetic of PR 13's `[profile]` over the port's
`utils/profiling.trace`), device time by kernel name, and the longest idle
gaps labelled by what the host was doing.  Busy time and kernel times come
from a trace of device activity alone; tracing every host operation too
slows the host about twofold, so that trace only labels the gaps.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

ANNOTATIONS = ("bm.rollout", "bm.update", "bm.env_step")


class Spans:
    def __init__(self, runner, env):
        self.runner, self.env = runner, env
        self.host: Dict[str, List[float]] = defaultdict(list)  # seconds
        self.events: Dict[str, List[float]] = defaultdict(list)  # ms
        self._pending = []  # (name, start event, end event, step index)
        self._undo = []
        self.steps = 0

    # ------------------------------------------------------------ wrapping

    def _set(self, obj, attr, fn):
        had = attr in vars(obj)
        old = vars(obj).get(attr)
        setattr(obj, attr, fn)
        self._undo.append((obj, attr, had, old))

    def install(self) -> "Spans":
        r, env = self.runner, self.env
        for attr in ("rollout", "rollout_recurrent"):
            self._set(r, attr, self._host_span("rollout", getattr(r, attr)))
        for attr in ("update", "update_recurrent"):
            self._set(r, attr, self._host_span("update", getattr(r, attr)))
        self._set(env, "step", self._event_span("env_step", env.step,
                                                step=True))
        hf = env.height_fn
        if getattr(hf, "surface_fn", None) is not None:
            self._set(hf, "surface_fn",
                      self._event_span("terrain", hf.surface_fn))
        if hasattr(env.terrain, "height_scan_at"):
            self._set(env.terrain, "height_scan_at",
                      self._event_span("terrain", env.terrain.height_scan_at))
        return self

    def remove(self) -> None:
        for obj, attr, had, old in reversed(self._undo):
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)
        self._undo.clear()
        self.runner = self.env = None

    def _host_span(self, name: str, fn: Callable) -> Callable:
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.host[name].append(time.perf_counter() - t0)
            self.flush()
            return out
        return wrapped

    def _event_span(self, name: str, fn: Callable, step: bool = False
                    ) -> Callable:
        def wrapped(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            self._pending.append((name, e0, e1, self.steps))
            if step:
                self.steps += 1
            return out
        return wrapped

    def flush(self) -> None:
        """Read the recorded events (the card has drained)."""
        per_step: Dict[int, float] = defaultdict(float)
        for name, e0, e1, k in self._pending:
            ms = e0.elapsed_time(e1)
            if name == "terrain":
                per_step[k] += ms
            else:
                self.events[name].append(ms)
        # a step's terrain queries: the surface queries of its substeps
        # (index of the step they ran in) and its height scans
        for k in sorted(per_step):
            self.events["terrain_per_step"].append(per_step[k])
        self._pending.clear()


def annotate(runner, env) -> Callable[[], None]:
    """Wrap the rollout, update and env step in profiler annotations (no
    synchronisation); returns the undo."""
    undo = []

    def wrap(obj, attr, label):
        fn = getattr(obj, attr)

        def wrapped(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        had = attr in vars(obj)
        old = vars(obj).get(attr)
        setattr(obj, attr, wrapped)
        undo.append((obj, attr, had, old))

    for attr in ("rollout", "rollout_recurrent"):
        wrap(runner, attr, "bm.rollout")
    for attr in ("update", "update_recurrent"):
        wrap(runner, attr, "bm.update")
    wrap(env, "step", "bm.env_step")

    def remove():
        for obj, attr, had, old in reversed(undo):
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)
    return remove


def _union(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(intervals):
    """(start, end) of the idle gaps between merged intervals."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def _on_device(ev) -> bool:
    """A kernel, copy or fill that ran on the device (not a CPU event, and
    not an annotation the profiler mirrors onto the device's timeline)."""
    if ev.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    return not (ev.is_user_annotation() or ev.name() in ANNOTATIONS)


def _events(step: Callable[[], None], iterations: int, activities):
    """(host seconds of `iterations` calls of `step` under the profiler,
    the trace's events)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iterations):
            step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return window_s, prof.profiler.kineto_results.events()


def profile(step: Callable[[], None], iterations: int) -> dict:
    """Run `step` (one whole iteration) `iterations` times under the
    profiler with device activity only, which costs the host little:
    window_s (host clock, drained card at both ends), busy_s (union of
    device activity), kernels {name: [count, seconds]}, device_ops (top 10
    by seconds).  Then one more iteration with the host's operations
    traced too, which slows the host, for idle_gaps: the 10 longest gaps
    between device activity, labelled by the host's annotation and
    innermost operation at their middle."""
    window_s, events = _events(
        step, iterations, [torch.profiler.ProfilerActivity.CUDA])
    dev = []
    kernels: Dict[str, List[float]] = {}
    for ev in events:
        if _on_device(ev):
            s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
            dev.append((s, e))
            k = kernels.setdefault(ev.name(), [0, 0.0])
            k[0] += 1
            k[1] += (e - s) * 1e-9
    busy_s = _union(dev) * 1e-9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]

    _, events = _events(step, 1, [torch.profiler.ProfilerActivity.CPU,
                                  torch.profiler.ProfilerActivity.CUDA])
    dev, host = [], []
    for ev in events:
        s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if _on_device(ev):
            dev.append((s, e))
        elif ev.device_type() != torch.autograd.DeviceType.CUDA:
            host.append((s, e, ev.name()))
    gaps = sorted(_gaps(dev), key=lambda g: g[0] - g[1])[:10]
    idle = []
    for gs, ge in gaps:
        mid = 0.5 * (gs + ge)
        cover = [h for h in host if h[0] <= mid <= h[1]]
        ann = [h for h in cover if h[2] in ANNOTATIONS]
        inner = min(cover, key=lambda h: h[1] - h[0])[2] if cover else "idle"
        label = (min(ann, key=lambda h: h[1] - h[0])[2] + ": "
                 if ann else "") + inner
        idle.append([label, (ge - gs) * 1e-9])
    return {"window_s": window_s, "busy_s": busy_s, "kernels": kernels,
            "device_ops": [[n, v[1]] for n, v in top],
            "idle_gaps": idle, "iterations": iterations}
