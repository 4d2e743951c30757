"""The contact constants and the terrain surface query of the plain route:
a frozen copy from the port's physics/contact.py."""

from __future__ import annotations

import torch

# PhysX max_depenetration_velocity parity: only penetration in excess of
# the static-rest band fades as the contact point exits at this speed.
MAX_DEPENETRATION_VEL = 1.0  # m/s
# static-rest band: ordinary stance and touchdown loads live in this depth
# and always carry their full spring.
PEN_REST = 0.05  # m


def terrain_normal(height_fn, x, y, eps: float = 0.02):
    """Finite-difference unit surface normal of a height function."""
    dhdx = (height_fn(x + eps, y) - height_fn(x - eps, y)) / (2 * eps)
    dhdy = (height_fn(x, y + eps) - height_fn(x, y - eps)) / (2 * eps)
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def query_surface(height_fn, x, y):
    """(height, unit normal) of the terrain under (x, y): one gather through
    the `surface_fn` a terrain attaches to its height function, else finite
    differences of the bare height function."""
    surf = getattr(height_fn, "surface_fn", None)
    if surf is not None:
        return surf(x, y)
    return height_fn(x, y), terrain_normal(height_fn, x, y)
