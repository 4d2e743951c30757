"""Profiling, timing and tracing (pointfoot_tpu/utils/profiling.py).

`trace()` wraps `torch.profiler` so any block of the training or MPC loop
can be captured as a Chrome / TensorBoard trace; `timed` gives wall-clock
seconds that wait for the device, as `jax.block_until_ready` does;
`flops_estimate` counts the floating-point operations of a call.

The port's own tracing lives here too, one registry a process:

- `count(name, n)` adds to a counter, always: the kernel wrappers'
  launches (`kernel.*`), the terrain's query points, the DP collectives'
  bytes.  `counters()` reads them.
- `span(name)`, a context manager or decorator, marks a region.  Inside
  `recording()`, the one switch (off by default), each span records its
  name, start and end, the enclosing span and the row it falls in.
  While a `torch.profiler` session is active, each span also opens a
  `record_function` range of its name, so the trace carries the program's
  regions.  Otherwise a span is a flag check and a shared no-op.
- `row()` groups one training iteration (the runner opens one around each
  `train_iteration`): when it closes, the row holds per span name the
  count, total and self seconds (self: minus what child spans cover) and
  the counters' deltas.  `rows()` and `records()` return what is kept, the
  newest `ROWS_KEPT` rows and `RECORDS_KEPT` span records.

Times are `time.time_ns()`, the clock of the profiler's events (Unix-epoch
ns), so a record lines up with the trace.  Spans time the host: dispatch
plus whatever blocks (a host sync, a collective); the device's time of
the same region is read from a profiler trace on the same clock.  Spans
nest per thread of control: record from one thread.
"""
from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "torch-trace")):
    """Capture a profiler trace of the block, CPU and (where there is one)
    CUDA activity; at exit a `<worker>.<ns>.pt.trace.json` lands in
    `log_dir` (Chrome's trace format, which TensorBoard's profile plugin
    reads).

    >>> with trace("/tmp/tr"):
    ...     runner.train_iteration(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir


def _sync(out) -> None:
    """Wait for the devices that hold the tensors of `out`."""
    devices = {t.device for t in tree_leaves(out)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 1,
          **kwargs) -> float:
    """Mean wall-clock seconds a call, the device's queue drained before
    the clock starts and before it stops."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _sync(out)
    return (time.perf_counter() - t0) / iters


def flops_estimate(fn: Callable, *args) -> dict:
    """{"flops": ...} of one call, by `torch.utils.flop_counter`.

    Use with `timed` for roofline checks:
    achieved_flops = flops_estimate(...)["flops"] / timed(...).
    Unlike XLA's cost analysis of the JAX package, it reports no bytes, it
    counts only the operations torch has formulas for (matrix products,
    convolutions, attention), and it cannot see into the hand-written CUDA
    kernels of `ops/cuda/`.
    """
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return {"flops": int(fc.get_total_flops())}


# ----------------------------------------------------------------- tracing

ROWS_KEPT = 4096  # rows: one a training iteration
RECORDS_KEPT = 1 << 18  # span records: ~700 iterations of ~380 spans


class SpanRecord(NamedTuple):
    """One closed span: `parent` is the enclosing span's id, `iteration`
    the id of the row it fell in (None outside a row), `self_ns` its
    duration less what its child spans cover."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    iteration: Optional[int]
    self_ns: int


class _Registry:
    """The process's counters, span records and rows."""

    def __init__(self):
        self.counters: Dict[str, int] = {}
        # SpanRecord's fields as plain tuples, which are cheaper to make
        self.records: deque = deque(maxlen=RECORDS_KEPT)
        self.rows: deque = deque(maxlen=ROWS_KEPT)
        self.stack: List["_Span"] = []  # the open spans that record
        self.next_id = 0
        self.next_row = 0
        self.row_id: Optional[int] = None  # the open row's iteration
        # where a closing span goes: the open row's own list, which joins
        # `records` when the row closes, else `records`
        self.sink = self.records


_REG = _Registry()
_recording = False  # the switch, read by every span


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (always, recording or not)."""
    c = _REG.counters
    c[name] = c.get(name, 0) + n


def counter(name: str) -> int:
    """The counter's value (0 before its first count)."""
    return _REG.counters.get(name, 0)


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_REG.counters)


class _Span:
    """A span that records (inside `recording()`) and/or opens a profiler
    range (while a profiler runs), as it found the switches on entry."""

    __slots__ = ("name", "_id", "_parent", "_start", "_child", "_range")

    def __init__(self, name: str):
        self.name = name
        self._id = None
        self._range = None

    def __enter__(self):
        if _recording:
            reg = _REG
            stack = reg.stack
            self._parent = stack[-1]._id if stack else None
            self._id = reg.next_id
            reg.next_id += 1
            self._child = 0
            stack.append(self)
            self._start = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if self._id is None:
            return False
        end = time.time_ns()
        reg = _REG
        stack = reg.stack
        if stack[-1] is self:
            stack.pop()
        else:  # closed out of order: drop it where it is
            stack.remove(self)
        dur = end - self._start
        if stack:
            stack[-1]._child += dur
        reg.sink.append((self._id, self.name, self._start, end,
                         self._parent, reg.row_id, dur - self._child))
        return False

    def __call__(self, fn: Callable) -> Callable:
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapped


class _Off(_Span):
    """The shared no-op of a name, while nothing records or profiles."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF: Dict[str, _Off] = {}


def span(name: str) -> _Span:
    """A traced region, as a context manager (`with span("env.step"):`)
    or a decorator (`@span("ppo.gae")`, decided at each call).  Records
    only inside `recording()`; opens `record_function(name)` only while a
    `torch.profiler` session is active."""
    if _recording or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name)
    return off


@contextlib.contextmanager
def recording():
    """The one switch: spans record, and rows close, inside the block."""
    global _recording
    was = _recording
    _recording = True
    try:
        yield
    finally:
        _recording = was


@contextlib.contextmanager
def row():
    """One training iteration's row, closed at the end of the block:
    {"iteration", "start_ns", "end_ns", "spans": {name: {"count",
    "total_s", "self_s"}}, "counters": {name: delta}}.  A no-op outside
    `recording()` and inside another row.  Yields the row (None when it
    is a no-op); its fields are filled when it closes."""
    reg = _REG
    if not _recording or reg.row_id is not None:
        yield None
        return
    r = {"iteration": reg.next_row}
    reg.next_row += 1
    before = dict(reg.counters)
    reg.row_id, reg.sink = r["iteration"], []
    start = time.time_ns()
    try:
        yield r
    finally:
        end = time.time_ns()
        closed, now = reg.sink, reg.counters
        reg.row_id, reg.sink = None, reg.records
        agg: Dict[str, list] = {}  # name: [count, total ns, self ns]
        for rec in closed:
            a = agg.get(rec[1])
            if a is None:
                a = agg[rec[1]] = [0, 0, 0]
            a[0] += 1
            a[1] += rec[3] - rec[2]
            a[2] += rec[6]
        r.update(
            start_ns=start, end_ns=end,
            spans={k: {"count": a[0], "total_s": a[1] * 1e-9,
                       "self_s": a[2] * 1e-9} for k, a in agg.items()},
            counters={k: v - before.get(k, 0) for k, v in now.items()
                      if v != before.get(k, 0)})
        reg.records.extend(closed)
        reg.rows.append(r)


def rows() -> List[dict]:
    """The closed rows kept, oldest first."""
    return list(_REG.rows)


def last_row() -> Optional[dict]:
    """The newest closed row, or None."""
    return _REG.rows[-1] if _REG.rows else None


def records() -> List[SpanRecord]:
    """The span records kept, in the order the spans closed (those of an
    open row join when it closes)."""
    return [SpanRecord._make(t) for t in _REG.records]
