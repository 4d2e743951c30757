"""`env_step_ms`: milliseconds of one `LeggedEnv.step` (layer
`envs.legged_env`), the mean over the traced window's steps of CUDA events
recorded before and after each call."""


def read(obs):
    spans = obs.get("spans")
    v = spans.events.get("env_step") if spans else None
    return sum(v) / len(v) if v else None
