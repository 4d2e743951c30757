"""`device_idle`: the share of the profiled window (whole iterations, host
clock with the card drained at both ends) in which no operation ran on the
device: 1 - (union of the trace's device activity intervals) / window, the
mean over the ranks."""


def read(obs):
    profs = obs.get("profiles") or []
    shares = [1.0 - p["busy_s"] / p["window_s"] for p in profs
              if p["window_s"] > 0 and p["busy_s"] > 0]
    return sum(shares) / len(shares) if shares else None
