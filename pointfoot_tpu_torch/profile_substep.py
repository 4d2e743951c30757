"""Profile the physics substep at 4096 envs and split it into its parts
(scripts/profile_substep.py of the JAX package).

    python -m pointfoot_tpu_torch.profile_substep [--trace DIR]
    PROFILE_NUM_ENVS=64 python -m pointfoot_tpu_torch.profile_substep \
        --device cpu

Times (`utils.profiling.timed`, 2 warm-up calls and 20 timed ones, the
device drained around them) five things at B = $PROFILE_NUM_ENVS envs
(default 4096), and prints a markdown table of time a call, ns an env,
GFLOP/s, GB/s and the share of the card's memory rate:

1. the full pointfoot_rough env step on procedural terrain, the
   configuration the flagship trained on (the JAX script's make_env
   builds the registered table terrain), through its eager body
   (`LeggedEnv._step_eager`; `step` replays it as a CUDA graph on a
   card, envs/step_graph.py);
2. `dynamics.step_batched` of PointFoot on a plane given as a height
   function without `is_flat` (at 4096 rows on the card: kernel 4, the
   surface query, kernel 3);
3. `dynamics.assemble_velocity_solve` (FK, CRBA, RNEA, contact terms);
4. the velocity solve: kernel 5 (`ops/cuda/cholesky`) on the card, where
   the JAX script takes its Pallas kernel on a TPU; `linalg.chol_solve`
   elsewhere;
5. `dynamics.finish_step` (contact sensor and integration);

then the substep minus its parts and the 4 substeps' share of `env.step`.
Bytes are counted, not estimated from a compiler: the sum of the tensor
inputs and outputs of the aten operations a call dispatches (views and
allocations move none), which is what eager execution moves.  The
dispatcher cannot see into a hand-written kernel: the solve row, which is
kernel 5 on the card, counts the kernel table's bytes
(`cholesky.chol_solve_bytes`), and on the card the env.step and
step_batched rows count the aten operations around kernels 1-4 only, a
lower bound.  FLOPs come from `utils.profiling.flops_estimate`, which
counts matrix products only.  The roofline share divides by the card's
own memory rate, 3.35 TB/s for the H100 SXM (NVIDIA H100 80GB HBM3); on
another device no share is printed.  The bench lock
(`utils.benchlock`) quiesces a trainer first; `--trace DIR` captures a
`torch.profiler` trace of 5 substeps there.  Runs on the GPU unless
--device names another.
"""

from __future__ import annotations

import argparse
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.ops import linalg as linalg_ops
from pointfoot_tpu_torch.ops.cuda import cholesky as chol_cuda
from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
from pointfoot_tpu_torch.terrain.analytic import FLAT
from pointfoot_tpu_torch.utils import benchlock, profiling
from pointfoot_tpu_torch.utils.policy_eval import FLAGSHIP_PATCH
from pointfoot_tpu_torch.utils.registry import make_env

B = int(os.environ.get("PROFILE_NUM_ENVS", "4096"))
DT = 0.005
# the card's memory rate by its exact device name (PERF.md's bound uses the
# same); an H100 PCIe or NVL has another
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
# allocations, and a view the schema does not mark as one: no bytes move
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "_unsafe_view"}


class ByteCount(TorchDispatchMode):
    """Sums the bytes of the tensor inputs and outputs of every aten
    operation dispatched inside it; views and allocations count none."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False) and \
                func.overloadpacket.__name__ not in _NO_BYTES:
            self.bytes += sum(
                t.numel() * t.element_size()
                for t in tree_leaves((args, kwargs or {}, out))
                if isinstance(t, torch.Tensor))
        return out


def count_bytes(fn, *args) -> int:
    """The bytes one call of fn(*args) moves (module docstring)."""
    with ByteCount() as counter:
        fn(*args)
    return counter.bytes


def peak_bytes_per_s(device: torch.device):
    """The card's memory rate by its name, else None."""
    if device.type != "cuda":
        return None
    return PEAK_BYTES_PER_S.get(torch.cuda.get_device_name(device))


def main(argv=None) -> dict:
    """Prints the table and summary lines; returns {"rows": [{"component",
    "s", "ns_per_env", "gflops", "gbps", "roofline", "bytes", "flops"}],
    "overhead_us", "substep_share", "trace", "condition"}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    cond = benchlock.quiesce(timeout_s=240)
    try:
        return _profile(args, cond)
    finally:
        benchlock.release()


def _profile(args, cond: str) -> dict:
    print(f"<!-- measurement condition: trainer={cond}, B={B} -->")
    dev = resolve_device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"<!-- device: {dev.type} {kind} -->")

    def cost(fn, *a):
        return (profiling.flops_estimate(fn, *a)["flops"],
                count_bytes(fn, *a))

    def timed(fn, *a):
        return profiling.timed(fn, *a, iters=20, warmup=2)

    with torch.no_grad():
        # ---- full env policy step (pointfoot_rough: 4 substeps + obs/rew)
        env = make_env("pointfoot_rough", num_envs=B, device=dev,
                       cfg_patch=FLAGSHIP_PATCH)
        st = env.init_state(0)
        act = torch.zeros(B, env.num_actions, device=dev)

        def env_step(s):
            # the eager body: the dispatch modes of `cost` see its
            # operations, which a CUDA graph's replay would hide
            return env._step_eager(s, act)[0]

        t_env = timed(env_step, st)
        f_env, by_env = cost(env_step, st)

        # ---- physics substep in isolation (plane; B, nv = 12)
        model = get_model("pointfoot").to(dev)
        pp = PhysicsParams.nominal(model, B, dev)
        phys = PhysicsState.default(model, torch.zeros(6), B, dev,
                                    base_height=0.62)
        tau = torch.zeros(B, model.nj, device=dev)

        def sub():
            return dynamics.step_batched(model, pp, phys, tau, FLAT, DT)

        t_sub = timed(sub)
        f_sub, by_sub = cost(sub)

        # ---- decomposition: assembly / solve / finish
        def assemble():
            return dynamics.assemble_velocity_solve(model, pp, phys, tau,
                                                    FLAT, DT)

        A, rhs, terms = assemble()
        t_ass = timed(assemble)
        f_ass, by_ass = cost(assemble)

        if dev.type == "cuda":
            nv = model.nv
            At = A.reshape(B, nv * nv).t().contiguous()
            rt = rhs.t().contiguous()

            def solve():
                return chol_cuda.chol_solve_lanes(At, rt)

            sol_name = "solve (CUDA lane-group Cholesky, kernel 5)"
        else:
            def solve():
                return linalg_ops.chol_solve(A, rhs)

            sol_name = "solve (plain Cholesky)"
        t_sol = timed(solve)
        f_sol, by_sol = cost(solve)
        if dev.type == "cuda":
            by_sol = chol_cuda.chol_solve_bytes(nv, B)

        u = torch.linalg.solve(A, rhs)

        def finish():
            return dynamics.finish_step(model, phys, u, terms, DT)

        t_fin = timed(finish)
        f_fin, by_fin = cost(finish)

        # ---- optional profiler trace
        trace_note = "not captured"
        if args.trace:
            try:
                with profiling.trace(args.trace):
                    for _ in range(5):
                        sub()
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                trace_note = f"captured to {args.trace}"
            except Exception as e:  # a sandboxed card may refuse tracing
                trace_note = f"FAILED: {type(e).__name__}: {e}"

    # ---- report
    peak = peak_bytes_per_s(dev)
    rows = []
    for name, t, f, by in (
            ("full env.step (4 substeps + obs/rew/terrain)", t_env, f_env,
             by_env),
            ("physics substep (assembly+solve+finish)", t_sub, f_sub, by_sub),
            ("assembly (FK/CRBA/RNEA/contact terms)", t_ass, f_ass, by_ass),
            (sol_name, t_sol, f_sol, by_sol),
            ("finish (contact sensor + integrate)", t_fin, f_fin, by_fin)):
        rows.append({"component": name, "s": t, "ns_per_env": 1e9 * t / B,
                     "gflops": f / t / 1e9, "gbps": by / t / 1e9,
                     "roofline": None if peak is None else by / t / peak,
                     "bytes": by, "flops": f})
    print("\n| component | time/call | us/env | GFLOP/s | HBM GB/s "
          "| HBM roofline |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        share = ("n/a" if r["roofline"] is None
                 else f"{100 * r['roofline']:.0f}%")
        print(f"| {r['component']} | {1e6 * r['s']:.0f} us "
              f"| {r['ns_per_env']:.1f} ns | {r['gflops']:.0f} "
              f"| {r['gbps']:.0f} | {share} |")
    overhead = t_sub - (t_ass + t_sol + t_fin)
    print(f"\nsubstep minus parts: {1e6 * overhead:.0f} us "
          f"(what one step_batched call saves or adds over its parts "
          f"called apart)")
    print(f"4 substeps = {4e6 * t_sub:.0f} us of the {1e6 * t_env:.0f} us "
          f"env.step ({400 * t_sub / t_env:.0f}%)")
    print("GFLOP/s counts matrix products only (torch.utils.flop_counter); "
          "GB/s counts each aten operation's tensor inputs and outputs"
          + ("" if dev.type != "cuda" else
             ", and kernel 5's table bytes (kernels 1-4 inside env.step and "
             "step_batched are not counted)")
          + ("" if peak is None else f"; roofline share of {peak / 1e12:.2f}"
             f" TB/s"))
    print(f"profiler trace: {trace_note}")
    return {"rows": rows, "overhead_us": 1e6 * overhead,
            "substep_share": 4 * t_sub / t_env, "trace": trace_note,
            "condition": cond}


if __name__ == "__main__":
    main()
