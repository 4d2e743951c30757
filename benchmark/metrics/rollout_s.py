"""`rollout_s`: seconds of the runner's rollout an iteration (layer
`rl.runner` rollout), the mean of the traced window's spans around the
runner instance's `rollout` / `rollout_recurrent` (host clock, the card
drained at both ends)."""


def read(obs):
    spans = obs.get("spans")
    v = spans.host.get("rollout") if spans else None
    return sum(v) / len(v) if v else None
