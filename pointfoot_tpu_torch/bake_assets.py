"""Bake URDF robot descriptions into standalone JSON model assets
(scripts/bake_assets.py of the JAX package).

    python -m pointfoot_tpu_torch.bake_assets [--resources DIR] [--out DIR]

Runs the URDF compiler (physics/urdf.py) over the robot descriptions under
`--resources` (default `resources/robots`, the layout of the upstream
project's resources tree: `<robot>/urdf/<robot>.urdf`) and writes each
model's JSON into `--out` (default the package's `physics/_assets/`).  A
robot whose URDF is absent is skipped with a line that says so; the
repository commits no URDF.  Host code only.
"""

from __future__ import annotations

import argparse
import os
import xml.etree.ElementTree as ET

from pointfoot_tpu_torch.physics.assets import ASSET_DIR, save_model
from pointfoot_tpu_torch.physics.urdf import load_urdf

ROBOTS = {
    "pointfoot": "PF_P441A/urdf/PF_P441A.urdf",
    "a1": "a1/urdf/a1.urdf",
    "anymal_b": "anymal_b/urdf/anymal_b.urdf",
    "anymal_c": "anymal_c/urdf/anymal_c.urdf",
    "cassie": "cassie/urdf/cassie.urdf",
}


def main(argv=None) -> dict:
    """Returns {robot: path written} for the robots baked."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--resources", default=os.path.join("resources",
                                                        "robots"))
    ap.add_argument("--out", default=ASSET_DIR)
    args = ap.parse_args(argv)
    baked = {}
    for name, rel in ROBOTS.items():
        path = os.path.join(args.resources, rel)
        if not os.path.exists(path):
            print(f"skip {name}: {path} not found")
            continue
        try:
            model, _ = load_urdf(path)
        except (ValueError, NotImplementedError, KeyError, AttributeError,
                ET.ParseError) as e:  # keep baking the rest
            print(f"FAIL {name}: {e}")
            continue
        baked[name] = save_model(model, name, args.out)
        print(f"baked {name}: nb={model.nb} nj={model.nj} "
              f"nc={len(model.collision_body)} -> {baked[name]}")
        print(f"   joints: {model.joint_names}")
    return baked


if __name__ == "__main__":
    main()
