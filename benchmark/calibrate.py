"""The readings the limits of a cell are set from, in one process on the
card: the numbers of the comparison for sound runs of the port on many
seeds (the lower readings), for the control (the reference with TF32 matrix
products put in the port's place) and for the faults of benchmark/faults.py
planted in the port, on a few seeds (the upper readings).

    python3 -m benchmark.calibrate --workload <cell> --seeds 11,12,... \
        --control_seeds 3 --faults half_batch,answer_altered --out <json>

The port runs the cell's set-up and recorded iterations only (no window);
every run is at the cell's own size.  Writes one JSON object and prints
one line a reading.
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
    from benchmark import compare, faults, record, spec
    from benchmark.drivers import ppo_train

    cell = spec.load_cell(args.workload)
    bench_run.check_devices(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    seeds = [int(s) for s in args.seeds.split(",")]
    fault_names = [f for f in args.faults.split(",") if f]
    out = {"workload": cell.name, "card": bench_run.card(),
           "device": torch.cuda.get_device_name(device), "sound": {},
           "control": {}, "faults": {f: {} for f in fault_names},
           "seconds": {}}

    def port(seed):
        t = time.perf_counter()
        env, runner = ppo_train.build_port(cell, device)
        _, rec = record.start(runner, env, seed, cell.traffic)
        torch.cuda.synchronize()
        out["seconds"].setdefault("port", []).append(time.perf_counter() - t)
        del env, runner
        return rec

    def show(kind, seed, nums):
        print(kind, seed, json.dumps(nums), flush=True)

    for i, seed in enumerate(seeds):
        prog = port(seed)
        t = time.perf_counter()
        ref = ppo_train.reference_record(cell, seed, device)
        out["seconds"].setdefault("reference", []).append(
            time.perf_counter() - t)
        out["sound"][seed] = compare.numbers(prog, ref)
        show("sound", seed, out["sound"][seed])
        if i >= args.control_seeds:
            continue
        ctl = ppo_train.reference_record(cell, seed, device, tf32=True)
        out["control"][seed] = compare.numbers(ctl, ref)
        show("control", seed, out["control"][seed])
        for f in fault_names:
            with faults.FAULTS[f]():
                bad = port(seed)
            out["faults"][f][seed] = compare.numbers(bad, ref)
            show(f, seed, out["faults"][f][seed])
    lower = {k: max(v[k] for v in out["sound"].values())
             for k in compare.NUMBERS}
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
