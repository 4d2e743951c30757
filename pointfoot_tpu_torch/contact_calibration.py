"""Contact-model calibration experiments
(scripts/contact_calibration.py of the JAX package).

    python -m pointfoot_tpu_torch.contact_calibration
    python -m pointfoot_tpu_torch.contact_calibration --device cpu \
        --experiments static,drop

Checks the compliant sphere-terrain contact against closed-form
expectations and the reference simulator's behavioural anchors (1 N
contact threshold, mm-scale static penetration, heavily damped impacts
that do not bounce), on the A1 quadruped standing under a stance PD at its
default pose (two point feet cannot hold pitch passively, so a biped rig
would measure its own toppling, not the contact):

1. `static`: settle 400 substeps from 0.30 m; the feet's normal forces,
   their sum against the weight and the steady penetration f / k;
2. `drop`: drop from 0.35 m; impact speed, lowest and resting height,
   residual rebound; and the normal damping ratio d / (2 sqrt(k m/2));
3. `stick_slip`: after 300 settling substeps a lateral base force ramped
   from 0 to 2 mu W over 800 substeps; breakaway where vx first exceeds
   0.2 m/s (below the cone the regularized Coulomb contact creeps);
4. `stiffness`: four critically damped stiffnesses 1.2e4-1.2e5 N/m at
   the 5 ms substep: stable, resting height, largest |vz| after settling.

Each substep is one `dynamics.step` of one robot, a loop on the host (the
plain route).  Prints the JAX script's lines; `main` returns the numbers.
--experiments picks a comma-separated subset (default: all four).  Runs
on the GPU unless --device names another.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from pointfoot_tpu_torch.device import resolve_device
from pointfoot_tpu_torch.physics import dynamics
from pointfoot_tpu_torch.physics.assets import get_model
from pointfoot_tpu_torch.physics.model import PhysicsParams, PhysicsState
from pointfoot_tpu_torch.terrain.analytic import FLAT

EXPERIMENTS = ("static", "drop", "stick_slip", "stiffness")
DT = 0.005
QDEF = np.asarray([-0.1, 0.8, -1.5, 0.1, 0.8, -1.5,
                   -0.1, 1.0, -1.5, 0.1, 1.0, -1.5], np.float32)
STIFFNESSES = (1.2e4, 3e4, 6e4, 1.2e5)


def pd_tau(model, p: PhysicsState, kp=40.0, kd=1.5) -> torch.Tensor:
    """Stance PD at the default pose, so the legs hold while the contact
    itself is measured (A1's joint defaults)."""
    qdef = torch.as_tensor(QDEF, device=p.qpos.device)
    eff = model.effort_limit
    return torch.minimum(torch.maximum(kp * (qdef - p.qpos) - kd * p.qvel,
                                       -eff), eff)


def run(model, params, phys, steps: int, dt: float = DT, ext=None):
    """`steps` substeps under the stance PD; returns (the last state,
    (base_pos (steps, B, 3), base_lin_vel (steps, B, 3), contact_force
    (steps, B, nc, 3))).  `ext` (B, 3) pushes the base."""
    pos, vel, cf = [], [], []
    with torch.no_grad():
        for _ in range(steps):
            phys = dynamics.step(model, params, phys, pd_tau(model, phys),
                                 FLAT, dt, external_force=ext)
            pos.append(phys.base_pos)
            vel.append(phys.base_lin_vel)
            cf.append(phys.contact_force)
    return phys, (torch.stack(pos), torch.stack(vel), torch.stack(cf))


def static(model, params, k: float, w: float) -> dict:
    phys = PhysicsState.default(model, QDEF, 1, params.kp.device,
                                base_height=0.30)
    _, (_, _, cf) = run(model, params, phys, 400)
    fz = cf[-1, 0, :, 2].cpu().numpy()
    fz_feet = fz[list(model.collision_indices("foot"))]
    pen_pred = fz_feet / k
    print(f"1. static: foot normal forces {fz_feet.round(1)} N "
          f"(sum {fz_feet.sum():.1f} vs weight {w:.1f}); "
          f"steady penetration {1e3 * pen_pred.round(5)} mm "
          f"(PhysX TGS anchor: mm-scale)")
    return {"foot_fz": fz_feet.tolist(), "fz_sum": float(fz_feet.sum()),
            "weight": w, "penetration_mm": (1e3 * pen_pred).tolist()}


def drop(model, params, k: float, d: float, m_tot: float) -> dict:
    phys = PhysicsState.default(model, QDEF, 1, params.kp.device,
                                base_height=0.35)
    _, (pos, vel, _) = run(model, params, phys, 400)
    z = pos[:, 0, 2].cpu().numpy()
    v_imp = float(vel[:, 0, 2].min())
    z_min, z_rest = float(z.min()), float(z[-1])
    rebound = max(0.0, float(z[120:].max() - z_rest))
    print(f"2. drop 5 cm: impact speed {v_imp:.3f} m/s, min z {z_min:.4f}, "
          f"rest z {z_rest:.4f}, residual rebound {1e3 * rebound:.1f} mm "
          f"(restitution ~ {rebound / 0.05:.3f}; PhysX restitution 0)")
    # damping ratio of the normal contact (per foot, effective mass ~ m/2)
    zeta = d / (2.0 * np.sqrt(k * m_tot / 2))
    print(f"   normal damping ratio zeta = d/(2 sqrt(k m/2)) = {zeta:.2f} "
          f"(>1: overdamped, matches TGS dead-impact behavior)")
    return {"impact_speed": v_imp, "min_z": z_min, "rest_z": z_rest,
            "rebound_mm": 1e3 * rebound, "restitution": rebound / 0.05,
            "zeta": float(zeta)}


def stick_slip(model, params, w: float) -> dict:
    """A ramped lateral push on the settled robot; breakaway near mu W."""
    mu = float(params.friction.reshape(-1)[0])
    dev = params.kp.device
    phys = PhysicsState.default(model, QDEF, 1, dev, base_height=0.30)
    phys, _ = run(model, params, phys, 300)  # settle
    forces = torch.linspace(0.0, 2.0 * mu * w, 800, device=dev)
    vx, x = [], []
    with torch.no_grad():
        for f in forces:
            ext = torch.stack([f, torch.zeros_like(f), torch.zeros_like(f)]
                              )[None]
            phys = dynamics.step(model, params, phys, pd_tau(model, phys),
                                 FLAT, DT, external_force=ext)
            vx.append(phys.base_lin_vel[0, 0])
            x.append(phys.base_pos[0, 0])
    vx = torch.stack(vx).cpu().numpy()
    forces = forces.cpu().numpy()
    # regularized Coulomb: below the cone the contact CREEPS at
    # v = F / (nc * c_t); true breakaway = acceleration past 0.2 m/s
    slid = np.where(vx > 0.2)[0]
    f_break = float(forces[slid[0]]) if len(slid) else float("nan")
    i_half = np.argmin(np.abs(forces - 0.5 * mu * w))
    print(f"3. stick-slip: mu={mu}, breakaway at {f_break:.1f} N vs "
          f"mu*W = {mu * w:.1f} N (ratio {f_break / (mu * w):.2f}); "
          f"creep speed at 0.5 mu W = {vx[i_half]:.4f} m/s "
          f"(regularized-Coulomb artifact, see PARITY.md)")
    return {"mu": mu, "breakaway_N": f_break, "mu_weight_N": mu * w,
            "ratio": f_break / (mu * w), "creep_speed": float(vx[i_half])}


def stiffness(model, params, w: float, m_tot: float) -> list:
    """Critically damped stiffness probes at the 5 ms substep."""
    out = []
    for k_try in STIFFNESSES:
        full = torch.full_like(params.contact_stiffness, 1.0)
        p_try = dataclasses.replace(
            params, contact_stiffness=full * k_try,
            contact_damping=full * float(2.0 * np.sqrt(k_try * m_tot / 2)))
        phys = PhysicsState.default(model, QDEF, 1, params.kp.device,
                                    base_height=0.33)
        _, (pos, vel, _) = run(model, p_try, phys, 400)
        z = pos[:, 0, 2].cpu().numpy()
        fin = bool(np.isfinite(z).all())
        vz_max = float(vel[200:, 0, 2].abs().max())
        print(f"4. k={k_try:.3g} (crit-damped): stable={fin}, "
              f"rest z={z[-1]:.4f}, max |vz| after settle "
              f"{vz_max:.4f} m/s, static pen {1e3 * w / 2 / k_try:.2f} mm")
        out.append({"k": k_try, "stable": fin, "rest_z": float(z[-1]),
                    "max_vz_after_settle": vz_max})
    return out


def main(argv=None) -> dict:
    """Prints the JAX script's lines; returns {"mass", "weight", "k", "d",
    and one entry per experiment run}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--experiments", default=",".join(EXPERIMENTS),
                    help="comma-separated subset of " + ",".join(EXPERIMENTS))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    todo = [e for e in args.experiments.split(",") if e]
    unknown = sorted(set(todo) - set(EXPERIMENTS))
    if unknown:
        ap.error(f"unknown experiments {unknown}; choose from {EXPERIMENTS}")
    dev = resolve_device(args.device)

    model = get_model("a1").to(dev)
    params = PhysicsParams.nominal(model, 1, dev)
    k = float(params.contact_stiffness[0])
    d = float(params.contact_damping[0])
    m_tot = float(model.mass.sum())
    w = m_tot * 9.81
    print(f"model mass {m_tot:.3f} kg (weight {w:.1f} N); "
          f"contact k={k:.3g} N/m, d={d:.3g} N·s/m")
    out = {"mass": m_tot, "weight": w, "k": k, "d": d}
    if "static" in todo:
        out["static"] = static(model, params, k, w)
    if "drop" in todo:
        out["drop"] = drop(model, params, k, d, m_tot)
    if "stick_slip" in todo:
        out["stick_slip"] = stick_slip(model, params, w)
    if "stiffness" in todo:
        out["stiffness"] = stiffness(model, params, w, m_tot)
    return out


if __name__ == "__main__":
    main()
