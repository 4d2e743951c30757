"""`update_s`: seconds of the PPO update an iteration (layer `rl.ppo`
update), the mean of the traced window's spans around the runner
instance's `update` / `update_recurrent` (host clock, the card drained at
both ends)."""


def read(obs):
    spans = obs.get("spans")
    v = spans.host.get("update") if spans else None
    return sum(v) / len(v) if v else None
