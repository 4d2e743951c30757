"""`terrain_ms_per_step`: milliseconds of terrain queries in one env step
(layer `terrain`): CUDA events around the surface queries the physics makes
through the env's `height_fn.surface_fn` and around the terrain's
`height_scan_at` calls, summed per env step, the mean over the traced
window's steps.  Where no query ran (plane terrain), nothing."""


def read(obs):
    spans = obs.get("spans")
    v = spans.events.get("terrain_per_step") if spans else None
    return sum(v) / len(v) if v else None
