"""`device_idle`: the share of the profiled window (whole iterations, host
clock with the card drained at both ends) in which no operation but a
collective's kernel ran on the device: 1 - (union of the trace's device
activity intervals, NCCL's kernels left out) / window, the mean over the
ranks.  A collective's kernel runs from its launch until every rank has
joined, so it counts as idle: the result line's `device.busy_s` counts it
as busy.  One rank runs no collective, so there the two agree."""


def read(obs):
    profs = obs.get("profiles") or []
    shares = [1.0 - p["work_s"] / p["window_s"] for p in profs
              if p["window_s"] > 0 and p["work_s"] > 0]
    return sum(shares) / len(shares) if shares else None
