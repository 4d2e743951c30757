"""Times of the hand-written kernels alone, on synthetic inputs.

    python -m pointfoot_tpu_torch.kernel_times [--num_envs 4096]
        [--chol_systems 2048] [--check] [-k NAME]

For the substep kernel (ANYmal C), the rollout substep kernel (PointFoot),
the SRB-LQR kernel (m = 6 and 12, horizon 12), the sphere-xy FK kernel
(ANYmal C) and the sphere-xyz FK kernel (PointFoot, ANYmal C, A1) at
`--num_envs` items, and the Cholesky kernel (n = 18 and 12) at
`--chol_systems` systems, it prints one JSON line each with two times per
launch:

- `wrapper_ms`: CUDA events around a loop of calls of the Python wrapper,
  as chip_smoke.py times a kernel.  Below some 0.02 ms this is the host's
  time to enqueue a launch, not the kernel's;
- `device_ms`: the same calls captured once in a CUDA graph and replayed,
  so that the device runs the launches back to back.

A `launch floor` line times a one-element `zero_()` the same two ways: the
least that any launch costs, to read a kernel of a few microseconds against.

`--check` also holds each kernel to its plain version at B = num_envs (or
chol_systems), 1000, 1 and 4099 (and the SRB-LQR kernel at horizons 1 and
96) and two launches to each other bit for bit; the Cholesky and the two
sphere FK kernels must equal their plain versions.
`-k NAME` keeps the kernels whose name holds NAME (`-k cholesky`, `-k fk`,
`-k substep`, `-k srb_lqr`).  Inputs come from a seed: perturbed default
poses on a tilted random surface, the random dense LQR problems of the
tests, SPD systems A Aᵀ + n I.  Needs a CUDA device.  The script uses only
the wrappers' public functions, so it times whatever kernels the checkout
holds.
"""

from __future__ import annotations

import argparse
import json

import torch

from pointfoot_tpu_torch import bench
from pointfoot_tpu_torch.ops.cuda import build
from pointfoot_tpu_torch.ops.cuda import cholesky as ch
from pointfoot_tpu_torch.ops.cuda import riccati as rk
from pointfoot_tpu_torch.ops.cuda import substep as sp
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState

ANYMAL_QDEF = [0.0, 0.4, -0.8] * 4
A1_QDEF = (-0.1, 0.8, -1.5, 0.1, 0.8, -1.5, -0.1, 1.0, -1.5, 0.1, 1.0, -1.5)
DT, GRAVITY = 0.005, 9.81
HORIZON = 12
RAGGED = (1000, 1, 4099)


def events_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of fn by CUDA events around a loop of calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Mean ms per call of fn with `per_graph` calls captured in a CUDA
    graph and the graph replayed: the device's time, free of the host's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return events_ms(graph.replay, replays) / per_graph


def substep_inputs(model, qdef, height: float, num: int, seed: int, device):
    """(in_rows, surf_rows, state_rows, ctrl_rows) of `num` perturbed envs
    on a tilted surface that some spheres penetrate."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    nj, nc = model.nj, len(model.collision_body)
    params = PhysicsParams.nominal(model, num, device)
    st = PhysicsState.default(model, qdef, num, device, base_height=height)
    quat = st.base_quat + 0.1 * randn(num, 4)
    st = st.replace(
        base_quat=quat / quat.norm(dim=-1, keepdim=True),
        base_pos=st.base_pos + 0.05 * randn(num, 3),
        base_lin_vel=0.5 * randn(num, 3), base_ang_vel=0.5 * randn(num, 3),
        qpos=st.qpos + 0.3 * randn(num, nj), qvel=2.0 * randn(num, nj))
    push = 50.0 * randn(num, 3)
    heights = 0.05 * randn(num, nc) + 0.03
    normals = torch.cat([0.2 * randn(num, nc, 2),
                         torch.ones(num, nc, 1, device=device)], dim=-1)
    normals = normals / normals.norm(dim=-1, keepdim=True)
    return (sp.pack_substep_in(st, params, 5.0 * randn(num, nj), push),
            sp.pack_surface((heights, normals)),
            sp.pack_state(st, 1.5 * randn(num, nj)),
            sp.pack_ctrl(0.5 * randn(num, nj), params, push))


def dense_problem(m: int, num: int, seed: int, device):
    """The random dense LQR problems of tests/test_pallas.py:60-72 at `num`
    scenarios, staged (rows, B): F perturbed everywhere."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    n = rk.N_STATE
    F = torch.eye(n, device=device).repeat(num, 1, 1)
    eye3 = torch.eye(3, device=device)
    F[:, 0:3, 6:9] += 0.02 * eye3
    F[:, 3:6, 9:12] += 0.02 * eye3
    F += 0.01 * randn(num, n, n)
    Xd = randn(num, n).abs() + 0.5
    return rk.stage(F, 0.05 * randn(num, n), 0.1 * randn(num, n, m), Xd,
                    randn(num, m).abs() * 0.01 + 0.005, 2.0 * Xd,
                    randn(num, n), randn(num, m))


def spd_systems(n: int, num: int, seed: int, device):
    """`num` SPD systems A Aᵀ + n I and right-hand sides, staged (n·n, B)
    and (n, B)."""
    g = torch.Generator(device=device).manual_seed(seed)
    M = torch.randn(num, n, n, generator=g, device=device)
    A = M @ M.transpose(1, 2) + n * torch.eye(n, device=device)
    b = torch.randn(num, n, generator=g, device=device)
    return A.reshape(num, n * n).t().contiguous(), b.t().contiguous()


def hold(name: str, fn, plain, num: int, tol=None) -> dict:
    """Max |kernel - plain| over the outputs, and whether two launches
    agree bit for bit; with `tol`, the error must not exceed it."""
    got, again, want = fn(), fn(), plain()
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, again, want = (got,), (again,), (want,)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    rec = {"check": name, "B": num, "max_abs_err": err,
           "two_launches_identical": same}
    print(json.dumps(rec), flush=True)
    if not same:
        raise AssertionError(f"{name} B={num}: two launches differ")
    if tol is not None and not err <= tol:
        raise AssertionError(f"{name} B={num}: max |err| {err} > {tol}")
    return rec


def cols(tensors, num: int):
    return tuple(t[:, :num].contiguous() for t in tensors)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--chol_systems", type=int, default=2048)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("-k", dest="only", default="",
                    help="time only the kernels whose name holds this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device available")
    dev = torch.device("cuda")
    num, n_chol = args.num_envs, args.chol_systems
    print(f"card: {bench.card_line(dev)}", flush=True)
    any_model = get_model("anymal_c").to(dev)
    pf_model = get_model("pointfoot").to(dev)
    a1_model = get_model("a1").to(dev)
    mc_any, mc_pf = sp.model_consts(any_model), sp.model_consts(pf_model)
    mc_a1 = sp.model_consts(a1_model)
    libs = build.build_all([build.model_spec(mc_any), build.model_spec(mc_pf),
                            build.RICCATI_SPEC, build.CHOLESKY_SPEC,
                            build.model_spec(mc_a1)])
    for what, lib in zip(("ANYmal substep.cu", "PointFoot substep.cu",
                          "riccati.cu", "cholesky.cu", "A1 substep.cu"),
                         libs):
        print(f"[build] {what}: {lib.build_seconds:.2f} s", flush=True)
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build]   {line.strip()}", flush=True)
    print(f"[build] fk_contact_xy_kernel (ANYmal C): resident warps an SM "
          f"{libs[0].lib.pf_fk_xy_resident_warps()}", flush=True)
    for what, i in (("PointFoot", 1), ("ANYmal C", 0), ("A1", 4)):
        print(f"[build] fk_from_state_kernel ({what}): resident warps an SM "
              f"{libs[i].lib.pf_fk_xyz_resident_warps()}", flush=True)
    for n in ch.SIZES:
        lib = libs[3].lib
        print(f"[build] chol_solve_kernel n={n}: {lib.pf_chol_lanes(n)} lanes "
              f"a system, {lib.pf_chol_smem_bytes(n)} B of dynamic shared "
              f"memory a block, resident warps an SM "
              f"{lib.pf_chol_resident_warps(n)}", flush=True)

    big = max(num, n_chol, max(RAGGED))
    a_in, a_surf, a_state, _ = substep_inputs(any_model, ANYMAL_QDEF, 0.55,
                                              big, 1, dev)
    a1_state = substep_inputs(a1_model, A1_QDEF, 0.3, big, 3, dev)[2]
    # the FK input rows: base_pos, base_quat, qpos
    a_fk = torch.cat([a_in[:7], a_in[13:13 + mc_any.nj]]).contiguous()
    spd = {n: spd_systems(n, big, 20 + n, dev) for n in ch.SIZES}
    _, p_surf, p_state, p_ctrl = substep_inputs(pf_model, [0.0] * 6, 0.62,
                                                big, 2, dev)
    dense = {m: dense_problem(m, big, 9 + m, dev) for m in rk.SIZES}
    qdef = (0.0,) * 6

    def substep(n):
        rows, surf = cols((a_in, a_surf), n)
        return (lambda: sp.step_rows(mc_any, rows, surf, DT, GRAVITY),
                lambda: sp.step_rows_plain(mc_any, rows, surf, DT, GRAVITY))

    def rollout(n):
        state, ctrl, surf = cols((p_state, p_ctrl, p_surf), n)
        a = (mc_pf, state, ctrl, surf, True, qdef, 0.25, "P", DT, GRAVITY)
        return (lambda: sp.rollout_step(*a),
                lambda: sp.rollout_step_plain(*a))

    def lqr(m, n, horizon=HORIZON):
        st = cols(dense[m], n)
        return (lambda: rk.srb_lqr_lanes(*st, horizon),
                lambda: rk.srb_lqr_lanes_plain(*st, horizon))

    def fk_xy(n):
        rows = cols((a_fk,), n)[0]
        return (lambda: sp.fk_xy_rows(mc_any, rows),
                lambda: sp.fk_xy_rows_plain(mc_any, rows))

    def fk_xyz(mc, state, n):
        rows = cols((state,), n)[0]
        return (lambda: sp.fk_rows(mc, rows),
                lambda: sp.fk_rows_plain(mc, rows))

    def chol(size, n):
        A_t, b_t = cols(spd[size], n)
        return (lambda: ch.chol_solve_lanes(A_t, b_t),
                lambda: ch.chol_solve_lanes_plain(A_t, b_t))

    # name, items at full width, (kernel, plain) at a batch, tolerance
    cases = [("substep_kernel (ANYmal C)", num, substep, None),
             ("rollout_substep_kernel (PointFoot)", num, rollout, None)]
    cases += [(f"srb_lqr_kernel m={m} T={HORIZON}", num,
               lambda n, m=m: lqr(m, n), None) for m in rk.SIZES]
    cases += [("fk_contact_xy_kernel (ANYmal C)", num, fk_xy, 0.0)]
    cases += [(f"fk_from_state_kernel ({what})", num,
               lambda n, mc=mc, st=st: fk_xyz(mc, st, n), 0.0)
              for what, mc, st in (("PointFoot", mc_pf, p_state),
                                   ("ANYmal C", mc_any, a_state),
                                   ("A1", mc_a1, a1_state))]
    cases += [(f"chol_solve_kernel n={size} (cholesky.cu)", n_chol,
               lambda n, size=size: chol(size, n), 0.0)
              for size in sorted(ch.SIZES, reverse=True)]
    cases = [c for c in cases if args.only in c[0]]

    if args.check:
        for name, full, make, tol in cases:
            for n in (full,) + RAGGED:
                hold(name, *make(n), n, tol)
            if name.startswith("srb_lqr_kernel"):
                m = int(name.split("m=")[1].split()[0])
                for horizon in (1, 96):
                    hold(f"srb_lqr_kernel m={m} T={horizon}",
                         *lqr(m, 1000, horizon), 1000)

    one = torch.empty(1, device=dev)
    for name, full, fn in [(c[0], c[1], c[2](c[1])[0]) for c in cases] + [
            ("launch floor (one-element zero_)", 1, one.zero_)]:
        print(json.dumps({"kernel": name, "B": full,
                          "wrapper_ms": events_ms(fn, 200),
                          "device_ms": graph_ms(fn)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
