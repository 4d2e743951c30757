"""`collective_wait_ms`: milliseconds an iteration that a rank's NCCL
kernels spend waiting for the last rank to join (layer `parallel.mesh`
DP): for each collective, a rank's kernel time less the least over the
ranks (`collective_ms`), summed over the profiled iterations
(benchmark/trace.py), the mean over the ranks, over the iterations.  It
is the ranks' skew at the collectives: the host-bound ranks drift apart
between them.  Nothing where no collective ran, or the ranks' counts of
them differ."""

from benchmark.trace import collectives_matched


def read(obs):
    profs = obs.get("profiles") or []
    per_rank = collectives_matched(profs)
    if per_rank is None:
        return None
    least = [min(c) for c in zip(*per_rank)]
    wait = [sum(d - m for d, m in zip(c, least)) for c in per_rank]
    return 1e3 * sum(wait) / len(wait) / profs[0]["iterations"]
