"""Work of the scan path's substep counted from shapes, frozen here so that
the program cannot change what its roofline share is measured against.

`batched_substep_bytes`: the bytes one launch of `substep_kernel` (kernel 3,
the substep of `physics.dynamics.step_batched`'s mega-kernel route) needs
for B envs: each input row read once, each output row written once,
float32.  The card's peaks are benchmark/counts.py's.
"""

from __future__ import annotations

from typing import Dict


def batched_substep_rows(nj: int, nc: int) -> Dict[str, int]:
    """float32 rows of `substep_kernel` per env: the state and inputs in
    (pose, velocities, joints, torque, push, frictions, mass, CoM, contact
    constants), the surface rows (height and normal under each sphere) and
    the state out with the contact forces."""
    state = 3 + 4 + 3 + 3 + 2 * nj
    inputs = nj + 3 + nc + nj + 1 + 3 + 1 + 1
    return {"state_in": state, "inputs": inputs, "surface": 4 * nc,
            "state_out": state, "contact_out": 3 * nc}


def batched_substep_bytes(nj: int, nc: int, envs: int, surface: bool = True
                          ) -> int:
    r = batched_substep_rows(nj, nc)
    rows = sum(r.values()) - (0 if surface else r["surface"])
    return 4 * rows * envs
