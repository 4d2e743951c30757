"""`batched_substep_roofline`: the share of its roofline that kernel 3,
`substep_kernel` (the substep of `step_batched`'s mega-kernel route, layer
`ops.cuda` kernels), reaches: the least time one launch for the cell's
envs needs, its bytes (benchmark/counts_scan.py: each input row read once,
each output row written once) over the card's HBM bandwidth, divided by
the mean device time of its launches in the profiler trace.  The fused
rollout's `rollout_substep_kernel` is another kernel and is not read.
Percent; nothing where no launch of kernel 3 ran."""

import re

from benchmark import counts, counts_scan

# the kernel's own name, not a longer name that ends in it
KERNEL = re.compile(r"(?<![A-Za-z0-9_])substep_kernel")


def read(obs):
    bw = counts.PEAKS.get(obs.get("device_name"), {}).get("hbm_bytes_per_s")
    if not bw:
        return None
    n, sec = 0, 0.0
    for p in obs.get("profiles") or []:
        for name, (k, s) in p["kernels"].items():
            if KERNEL.search(name):
                n, sec = n + k, sec + s
    if n == 0 or sec <= 0:
        return None
    flat = obs["config"]["env"]["terrain"]["mesh_type"] == "plane"
    need = counts_scan.batched_substep_bytes(
        obs["model"]["nj"], obs["model"]["nc"], obs["envs"],
        surface=not flat) / bw
    return 100.0 * need / (sec / n)
