"""One run of one cell of BENCHMARK.json.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1`
`breakdown`, and last `compared`: each number of the correctness
comparison beside its limit, which the last lines of standard error repeat.
Exits non-zero, printing no result, without as many CUDA devices as the
cell asks for, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pointfoot_tpu")
CACHE = os.path.join(ROOT, ".bench_cache")


class NoDevice(RuntimeError):
    pass


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed directory of the checkout:
    only a cell's first run there builds."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card(device_index: int = 0) -> dict:
    """Name and power limit of the card, from nvidia-smi where there is
    one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device_index}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        name, limit = [s.strip() for s in out.strip().split(",")[:2]]
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, ValueError):
        return {}


def check_devices(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark measures the card "
                       "and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} present")


def result_line(cell, args, out: dict) -> dict:
    """The result object, `compared` last."""
    import torch
    from benchmark import compare, spec
    nums = out["numbers"]
    correct = compare.verdict(nums, cell.limits)
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            v = spec.load_module("metrics", m["name"]).read(out["observed"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {"train_env_steps_per_s": out["rate"],
                  "setup_s": out["setup_s"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    res = {"correct": bool(correct), "attempted": int(out["iterations"]),
           "failed": 0, "metrics": metrics, "device": device}
    if args.trace:
        profs = out["observed"]["profiles"]
        device["busy_s"] = sum(p["busy_s"] for p in profs) / len(profs)
        device["window_s"] = sum(p["window_s"] for p in profs) / len(profs)
        p0 = profs[0]
        res["breakdown"] = {"device_ops": p0["device_ops"],
                            "idle_gaps": p0["idle_gaps"]}
    res["card"] = card()
    res["setup_marks_s"] = out.get("marks", {})
    res["iteration_ends_s"] = out.get("ends", [])
    res["iterations"] = out["iterations"]
    res["window_s"] = out["window_s"]
    res["compared"] = {k: {"value": v, "limit": (cell.limits or {}).get(k)}
                       for k, v in nums.items()}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, ROOT)
    from benchmark import spec
    cell = spec.load_cell(args.workload)
    try:
        check_devices(cell.chips)
    except NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    driver = spec.load_module("drivers", cell.traffic["driver"])
    out = driver.run(cell, args, T0)
    res = result_line(cell, args, out)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}; no result",
              file=sys.stderr)
        return 3
    for k, v in res["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"correct {res['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
