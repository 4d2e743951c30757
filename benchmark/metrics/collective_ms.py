"""`collective_ms`: milliseconds an iteration that NCCL's collectives take
when no rank waits (layer `parallel.mesh` DP): for each collective, the
least over the ranks of its kernel's device time, summed over the
profiled iterations (benchmark/trace.py) and taken over their number.  A
collective's kernel runs from its launch on a rank until every rank has
joined, so the rank that launched it last reads the transfer alone; the
other ranks' excess is `collective_wait_ms`.  Nothing where no collective
ran, or the ranks' counts of them differ."""

from benchmark.trace import collectives_matched


def read(obs):
    profs = obs.get("profiles") or []
    per_rank = collectives_matched(profs)
    if per_rank is None:
        return None
    sec = sum(min(c) for c in zip(*per_rank))
    return 1e3 * sec / profs[0]["iterations"]
