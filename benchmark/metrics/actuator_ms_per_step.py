"""`actuator_ms_per_step`: milliseconds of the actuator network in one env
step (layer `physics.actuator`): the port's span `actuator.torque`, one an
actuator tick (decimation ticks a step), summed over the traced window's
rows (utils/profiling.py, host clock) and divided by the env steps those
rows hold (the span `env.step`'s count).  Nothing where the rows hold no
such span (a task without the network, or a program without the span)."""


def read(obs):
    rows = obs.get("program_rows") or []
    total = steps = 0.0
    for r in rows:
        spans = r.get("spans", {})
        total += spans.get("actuator.torque", {}).get("total_s", 0.0)
        steps += spans.get("env.step", {}).get("count", 0)
    if total <= 0 or steps <= 0:
        return None
    return total / steps * 1e3
