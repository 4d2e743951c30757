"""Contact constants and the terrain surface query
(pointfoot_tpu/physics/contact.py).

The force law itself lives in physics/rowdyn.py, the body of the substep
kernel.
"""

from __future__ import annotations

# PhysX max_depenetration_velocity parity: only penetration in excess of
# the static-rest band fades as the contact point exits at this speed.
MAX_DEPENETRATION_VEL = 1.0  # m/s
# static-rest band: ordinary stance and touchdown loads live in this depth
# and always carry their full spring.
PEN_REST = 0.05  # m


def query_surface(height_fn, x, y):
    """(height, unit normal) of the terrain under (x, y), from the
    `surface_fn` the terrain attaches to its height function (the JAX
    package's finite-difference fallback for bare height functions has no
    caller in the port)."""
    return height_fn.surface_fn(x, y)
