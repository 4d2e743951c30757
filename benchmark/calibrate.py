"""The readings the limits of a cell are set from, in one process on the
card: the numbers of the comparison for sound runs of the port on many
seeds (the lower readings), for the control (the reference with TF32 matrix
products put in the port's place) and for the faults of benchmark/faults.py
planted in the port, on a few seeds (the upper readings).

    python3 -m benchmark.calibrate --workload <cell> --seeds 11,12,... \
        --control_seeds 3 --faults half_batch,answer_altered --out <json>

The port runs the cell's set-up and recorded iterations only (no window),
through the cell's driver (`port_records`; a multi-rank cell's driver
starts its ranks on cards 1..W-1 once for every seed and fault); every run
is at the cell's own size.  Writes one JSON object and prints one line a
reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control_seeds", type=int, default=3)
    ap.add_argument("--faults", default="half_batch,answer_altered")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import run as bench_run
    bench_run.cache_dirs()
    import torch
    from benchmark import spec

    cell = spec.load_cell(args.workload)
    driver = spec.load_module("drivers", cell.traffic["driver"])
    fault_names = [f for f in args.faults.split(",") if f]
    bench_run.check_devices(cell.chips)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = {"workload": cell.name, "card": bench_run.card(),
           "device": torch.cuda.get_device_name(device), "sound": {},
           "control": {}, "faults": {f: {} for f in fault_names},
           "seconds": {}}

    def show(kind, seed, nums):
        print(kind, seed, json.dumps(nums), flush=True)

    tasks = []
    for i, seed in enumerate(seeds):
        tasks.append((seed, []))
        if i < args.control_seeds:
            tasks += [(seed, [f]) for f in fault_names]
    refs = {}  # the control's seeds' and the latest seed's
    keep = set(seeds[:args.control_seeds])

    def reference(seed):
        if seed not in refs:
            for s in set(refs) - keep:
                del refs[s]
            t = time.perf_counter()
            refs[seed] = driver.reference_record(cell, seed, device)
            out["seconds"].setdefault("reference", []).append(
                time.perf_counter() - t)
        return refs[seed]

    t = time.perf_counter()
    for (seed, names), prog in zip(tasks, driver.port_records(cell, tasks,
                                                               device)):
        out["seconds"].setdefault("port", []).append(time.perf_counter() - t)
        nums = driver.numbers(prog, reference(seed))
        if names:
            out["faults"][names[0]][seed] = nums
        else:
            out["sound"][seed] = nums
        show(names[0] if names else "sound", seed, nums)
        t = time.perf_counter()
    for seed in seeds[:args.control_seeds]:
        ref = reference(seed)
        ctl = driver.reference_record(cell, seed, device, tf32=True)
        out["control"][seed] = driver.numbers(ctl, ref)
        show("control", seed, out["control"][seed])
    if out["sound"]:
        lower = {k: max(v[k] for v in out["sound"].values())
                 for k in driver.NUMBERS}
        out["lower"] = lower
        print("lower", json.dumps(lower), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
