"""Everything a cell is made of, found by name.

``BENCHMARK.json`` at the root of the repository lists the cells; a cell
names a configuration (``<data>/configs/<name>.json``), a traffic mix
(``<data>/traffic/<name>.json``) and has its comparison limits
(``<data>/limits/<cell>.json``).  Each per-layer metric is a reader
``<data>/metrics/<name>.py``.  ``<data>`` is the benchmark's folder; tests
point it at a folder of their own.
"""

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the benchmark's folder
REPO = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    metric_modules: Dict[str, object] = field(default_factory=dict)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_metric(data_dir: str, name: str):
    path = os.path.join(data_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench_json: str = None, data_dir: str = None, with_metrics: bool = True) -> Cell:
    bench_json = bench_json or os.path.join(REPO, "BENCHMARK.json")
    data_dir = data_dir or HERE
    bench = load_json(bench_json)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_json} (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(os.path.dirname(bench_json), configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(data_dir, "traffic", f"{w['traffic']}.json"))
    limits_path = os.path.join(data_dir, "limits", f"{name}.json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else {}
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    cell = Cell(name, w["chips"], config, traffic, limits, e2e, per_layer)
    if with_metrics:
        cell.metric_modules = {m["name"]: load_metric(data_dir, m["name"]) for m in per_layer}
    return cell
