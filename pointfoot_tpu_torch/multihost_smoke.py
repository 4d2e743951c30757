"""Two-process collective smoke test on one machine
(scripts/multihost_smoke.py of the JAX package).

    python -m pointfoot_tpu_torch.multihost_smoke
    python -m pointfoot_tpu_torch.multihost_smoke --device cpu

Checks the multi-process code path without a cluster: two OS processes
join one `torch.distributed` group over a loopback rendezvous
(`parallel.mesh.init_distributed`, gloo: both ranks share one card, which
nccl refuses), each holds its shard of a global (8, 3) batch, rows
`arange(12).reshape(4, 3) + 100 * rank`, and an all-reduce sums the
shards' totals across the process boundary.  Rank 0 prints
`multihost_smoke OK: psum-total ... (expected ...)` with the JAX script's
expected total; the JAX script ran 2 virtual devices a process, the port
one rank a process.  The parent picks a free loopback port (SMOKE_PORT
overrides it), starts the workers, prints their output and "all workers
exited cleanly" when both exit 0.  Every wait has a time limit: a worker
that fails or hangs fails the run and the other is killed.  Runs on the
GPU unless --device names another.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

from pointfoot_tpu_torch.device import resolve_device

NPROC = 2
B = 8  # global batch rows
INIT_TIMEOUT_S = 120.0
WAIT_TIMEOUT_S = 300.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def expected_total() -> float:
    n = B // NPROC * 3
    return float(sum(range(n)) * NPROC + 100 * n * sum(range(NPROC)))


def worker(rank: int, port: int, device) -> int:
    import torch
    import torch.distributed as dist

    from pointfoot_tpu_torch.parallel.mesh import init_distributed

    dev = resolve_device(device)
    init_distributed("gloo", init_method=f"tcp://127.0.0.1:{port}",
                     world_size=NPROC, rank=rank, timeout_s=INIT_TIMEOUT_S)
    try:
        local = torch.arange(B // NPROC * 3, dtype=torch.float32,
                             device=dev).reshape(B // NPROC, 3) + 100 * rank
        total = local.sum()
        dist.all_reduce(total)
        got = float(total)
        expected = expected_total()
        ok = abs(got - expected) < 1e-3
        if rank == 0:
            print(f"multihost_smoke {'OK' if ok else 'MISMATCH'}: psum-total "
                  f"{got} (expected {expected}) across {NPROC} processes / "
                  f"{dist.get_world_size()} ranks, one rank a process on "
                  f"{dev}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> dict:
    """Starts the workers and waits for them; returns {"ok", "total",
    "expected", "rcs", "lines"} (rank 0's line parsed for the total).
    Raises when a worker fails or outlives WAIT_TIMEOUT_S."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        sys.exit(worker(args.worker, args.port, args.device))
    resolve_device(args.device)  # refuse here, not in the workers

    port = int(os.environ.get("SMOKE_PORT", 0)) or free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "pointfoot_tpu_torch.multihost_smoke",
           "--port", str(port)]
    if args.device is not None:
        cmd += ["--device", args.device]
    procs = [subprocess.Popen(cmd + ["--worker", str(r)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, text=True)
             for r in range(NPROC)]
    deadline = time.monotonic() + WAIT_TIMEOUT_S
    outs, rcs = [], []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
            rcs.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = [ln for out in outs for ln in out.splitlines()]
    for ln in lines:
        print(ln)
    if any(rc != 0 for rc in rcs):
        raise RuntimeError(f"multihost_smoke: worker exit codes {rcs}")
    print("all workers exited cleanly")
    line = next(ln for ln in lines if ln.startswith("multihost_smoke "))
    total = float(line.split("psum-total ")[1].split()[0])
    return {"ok": line.startswith("multihost_smoke OK"), "total": total,
            "expected": expected_total(), "rcs": rcs, "lines": lines}


if __name__ == "__main__":
    main()
