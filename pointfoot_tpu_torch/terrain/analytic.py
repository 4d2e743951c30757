"""Analytic terrain height functions for closed-loop gait/MPC testing
(pointfoot_tpu/terrain/analytic.py).

Pure `height_fn(x, y) -> z` callables (the physics/contact.py contract:
finite-difference normals are derived, no grid is needed), chosen by a
compact `kind:amp` spec so diagnostics and tests share one vocabulary.
Every field is 0 at the origin, so the default spawn height works
unchanged.  Inputs are cast to float32, as the JAX functions cast them.

None of them carries `is_flat`, FLAT included, as in the JAX package:
`dynamics.step_batched` queries them like any other surface (on the card,
through the sphere-xy FK kernel and `contact.query_surface`).
"""

from __future__ import annotations

import math

import torch


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)


def FLAT(x, y):
    """The plane z = 0."""
    return torch.zeros_like(_f32(x))


def make_terrain(spec: str):
    """`kind:amp` with kind in {flat, slope, wave, bumps, step}.

    slope:g  — ramp of grade g starting 0.5 m ahead
    wave:a   — smooth rolling field, amplitude a [m]
    bumps:a  — two-octave uneven field, amplitude a [m]
    step:h   — single step of height h (down if negative) 1 m ahead
    """
    if not spec or spec == "flat":
        return FLAT
    kind, _, a = spec.partition(":")
    a = float(a or 0.05)
    if kind == "slope":
        return lambda x, y: a * torch.clamp_min(_f32(x) - 0.5, 0.0)
    if kind == "wave":
        return lambda x, y: a * torch.sin(
            2 * math.pi * _f32(x) / 1.2) * torch.sin(
            2 * math.pi * _f32(y) / 1.7)
    if kind == "bumps":
        def f(x, y):
            x, y = _f32(x), _f32(y)
            z = (0.6 * torch.sin(5.2 * x + 0.3) * torch.sin(4.1 * y + 1.1)
                 + 0.4 * torch.sin(9.7 * x + 2.0) * torch.sin(8.3 * y + 0.5))
            s = lambda v: torch.sin(_f32(v))  # noqa: E731
            z0 = 0.6 * s(0.3) * s(1.1) + 0.4 * s(2.0) * s(0.5)
            return a * (z - z0)
        return f
    if kind == "step":
        return lambda x, y: a * (_f32(x) > 1.0).to(torch.float32)
    raise ValueError(f"unknown terrain spec {spec!r}")


class AnalyticTerrain:
    """Adapter giving an analytic fn the TerrainGrid `.height_at` face."""

    def __init__(self, fn):
        self.height_at = fn
