"""What `BENCHMARK.json` names, found by name under `benchmark/`.

A cell of `workloads` names a configuration and a traffic mix; each is a
file of its own, found by its name:

- `configs/<config>.json`: the task and the env and training configuration
  as they run;
- `traffic/<traffic>.json`: terrain overlay, envs a rank, ranks, warm
  iterations, and the driver whose loop the window runs;
- `drivers/<driver>.py`: the loop (`run(cell, args, t0)`);
- `metrics/<metric>.py`: the reader of one per-layer metric (`read(obs)`);
- `limits/<workload>.json`: the limit of each number the correctness
  comparison prints for that cell.

A later cell, configuration, traffic mix, metric or driver is a new file and
a new entry; no file here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module `<kind>/<name>.py` under `benchmark/`, loaded from its
    file (a metric's name may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} '{name}': {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything it names."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Optional[Dict[str, float]]

    @property
    def ranks(self) -> int:
        return int(self.traffic.get("ranks", 1))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    config = load_json(os.path.join(BENCH_DIR, "configs",
                                    f"{w['config']}.json"))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     f"{w['traffic']}.json"))
    limits_path = os.path.join(BENCH_DIR, "limits", f"{name}.json")
    # a cell without limits is never correct (compare.verdict)
    limits = load_json(limits_path) if os.path.isfile(limits_path) else None
    if traffic.get("ranks", 1) != w["chips"]:
        raise ValueError(f"'{name}' asks for {w['chips']} chips, its "
                         f"traffic for {traffic.get('ranks', 1)} ranks")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        limits=limits)


def tuples(x):
    """JSON lists as the tuples the configuration dataclasses hold."""
    if isinstance(x, list):
        return tuple(tuples(v) for v in x)
    if isinstance(x, dict):
        return {k: tuples(v) for k, v in x.items()}
    return x


def lists(x):
    """The inverse of `tuples`, for comparing a dataclass with its file."""
    if isinstance(x, (list, tuple)):
        return [lists(v) for v in x]
    if isinstance(x, dict):
        return {k: lists(v) for k, v in x.items()}
    return x


def overlay(base, values: Dict[str, Any]):
    """`base`, a (nested) dataclass, with every field that `values` holds
    replaced, nested dataclasses field by field."""
    kw = {}
    for f in dataclasses.fields(base):
        if f.name not in values:
            continue
        cur, new = getattr(base, f.name), values[f.name]
        if dataclasses.is_dataclass(cur) and isinstance(new, dict):
            kw[f.name] = overlay(cur, new)
        else:
            kw[f.name] = tuples(new)
    return dataclasses.replace(base, **kw)


def env_values(cell: Cell) -> Dict[str, Any]:
    """The env configuration of the cell: the configuration file's, with
    the traffic's terrain overlay and envs a rank x ranks."""
    env = json.loads(json.dumps(cell.config["env"]))
    env["terrain"].update(cell.traffic.get("terrain", {}))
    env["env"]["num_envs"] = cell.traffic["envs_per_rank"] * cell.ranks
    return env


def check_same(cfg, values: Dict[str, Any], what: str) -> None:
    """Raise where the dataclass `cfg` built from `values` differs from
    them: a key the program lacks, or a value it does not take."""
    got = lists(dataclasses.asdict(cfg))
    want = lists(values)
    if got != want:
        diff = sorted(k for k in set(got) | set(want)
                      if got.get(k) != want.get(k))
        raise ValueError(f"{what}: the built configuration differs from "
                         f"the file in {diff}")
