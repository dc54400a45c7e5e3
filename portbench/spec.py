"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<name>.json``), its limits
(``limits/<workload>.json``), the driver its mix names
(``drivers/<kind>.py``) and the readers of its per-layer metrics
(``metrics/<name>.py``). Adding a cell, a mix or a metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int
    base: Path = HERE


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, workload: str, e2e_names: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return e2e_names is None or metric.get("moves") in e2e_names


def find_cell(name: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s benchmark (or of ``bench``), its
    files read from ``root``."""
    bench = bench if bench is not None else load_benchmark(root)
    base = root / HERE.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(base / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    limits_file = base / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, config, traffic, limits, e2e, per_layer, w["chips"], base)


def driver(kind: str):
    """The module that runs traffic of ``kind`` (``drivers/<kind>.py``)."""
    return importlib.import_module("portbench.drivers." + kind.replace("-", "_"))


def reader(metric: str, base: Path = HERE) -> Callable[[dict], Optional[float]]:
    """``read(ctx)`` of ``metrics/<metric>.py`` under ``base``."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_")
                                                  .replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metric_readers(cell: Cell) -> Dict[str, Callable[[dict], Optional[float]]]:
    return {m["name"]: reader(m["name"], cell.base) for m in cell.per_layer}
