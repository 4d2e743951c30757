"""Value-loss-storm detector over a run's metrics.jsonl
(scripts/storm_guard.py of the JAX package).

    python -m pointfoot_tpu_torch.storm_guard LOG_DIR

Reads the tail of LOG_DIR/metrics.jsonl (the runner writes `it`,
`value_loss` and `noise_std` on every logged iteration,
rl/runner.py) and alarms on the storm signature of the JAX rounds: a
value_loss p95 over the last `STORM_WINDOW` rows (default 40) above
`STORM_VLOSS_P95` (1500), or a mean noise_std of the last 5 rows above
`STORM_NOISE_STD` (0.70).  The thresholds sit between the recorded
healthy regime (noise_std max 0.57, value_loss p95 < 400) and the storm
(value_loss p95 3,641, noise_std 0.82-1.0); the environment variables
override them.  A STORM line is also appended to the sticky
LOG_DIR/STORM_ALARM file.

Exit codes: 0 = calm, 1 = STORM (message on stdout), 2 = not enough data.
Reads files only: no device, no torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def check(metrics_path,
          window=int(os.environ.get("STORM_WINDOW", 40)),
          vloss_p95_max=float(os.environ.get("STORM_VLOSS_P95", 1500.0)),
          noise_max=float(os.environ.get("STORM_NOISE_STD", 0.70))):
    """(code, message) of the last `window` rows of `metrics_path`."""
    try:
        with open(metrics_path, "rb") as f:
            try:  # only the tail is needed; a row is < 2 KB
                f.seek(-4096 * window, os.SEEK_END)
            except OSError:
                f.seek(0)
            lines = f.read().decode(errors="replace").splitlines()
    except OSError:
        return 2, "no metrics file"
    rows = []
    for ln in lines[-window:]:
        try:
            rows.append(json.loads(ln))
        except ValueError:
            continue
    if len(rows) < max(5, window // 4):
        return 2, f"only {len(rows)} rows"
    vl = sorted(r.get("value_loss", 0.0) for r in rows)
    p95 = vl[min(len(vl) - 1, int(0.95 * len(vl)))]
    # mean of the last 5 noise_std readings (single-row spikes are noise)
    tail_noise = [r.get("noise_std", 0.0) for r in rows[-5:]]
    noise = sum(tail_noise) / len(tail_noise)
    it = rows[-1].get("it", -1)
    if p95 > vloss_p95_max:
        return 1, (f"STORM it={it}: value_loss p95 {p95:.0f} > "
                   f"{vloss_p95_max:.0f} over last {len(vl)} rows")
    if noise > noise_max:
        return 1, (f"STORM it={it}: noise_std {noise:.3f} > {noise_max} "
                   f"(mean of last 5 rows)")
    return 0, f"calm it={it}: vloss_p95 {p95:.0f}, noise {noise:.3f}"


def main(argv=None) -> dict:
    """Prints the verdict; returns {"code", "message"}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log_dir")
    args = ap.parse_args(argv)
    code, msg = check(os.path.join(args.log_dir, "metrics.jsonl"))
    print(msg)
    if code == 1:
        # sticky alarm artifact next to the run
        with open(os.path.join(args.log_dir, "STORM_ALARM"), "a") as f:
            f.write(msg + "\n")
    return {"code": code, "message": msg}


if __name__ == "__main__":
    sys.exit(main()["code"])
