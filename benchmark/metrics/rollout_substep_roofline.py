"""`rollout_substep_roofline`: the share of its roofline that one
decimation substep reaches (layer `ops.cuda` kernels): the least time the
substep of the cell's envs needs, its bytes (benchmark/counts.py: each
input row read once, each output row written once) over the card's HBM
bandwidth, divided by the mean device time of the launches named below in
the profiler trace.  Percent; nothing where no such launch ran."""

from benchmark import counts

KERNELS = ("rollout_substep_kernel",)


def read(obs):
    bw = counts.PEAKS.get(obs.get("device_name"), {}).get("hbm_bytes_per_s")
    if not bw:
        return None
    n, sec = 0, 0.0
    for p in obs.get("profiles") or []:
        for name, (k, s) in p["kernels"].items():
            if any(x in name for x in KERNELS):
                n, sec = n + k, sec + s
    if n == 0 or sec <= 0:
        return None
    flat = obs["config"]["env"]["terrain"]["mesh_type"] == "plane"
    need = counts.substep_bytes(obs["model"]["nj"], obs["model"]["nc"],
                                obs["envs"], surface=not flat) / bw
    return 100.0 * need / (sec / n)
