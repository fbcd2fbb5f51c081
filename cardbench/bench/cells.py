"""Finding a cell's files by name: the cell's entry in ``BENCHMARK.json``,
its configuration ``cardbench/configs/<config>.json``, its traffic
``cardbench/traffic/<cell>.json``, and one reader per metric,
``cardbench/metrics/<metric>.py`` (a function ``read(run)`` returning the
number, or None where the run gave it nothing to read)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable, Dict, List

HERE = pathlib.Path(__file__).resolve().parents[1]      # cardbench/
ROOT = HERE.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    conf: dict              # the configuration file
    mix: dict               # the traffic file
    end_to_end: List[Metric]
    per_layer: List[Metric]


def reader(name: str) -> Callable:
    """The ``read`` function of metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metrics(entries: List[dict], cell: str) -> List[Metric]:
    return [Metric(m["name"], m["unit"], reader(m["name"]))
            for m in entries
            if cell in m.get("workloads", [cell])]


def load(name: str, bench: Dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``)."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    conf = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    if mix.get("traffic") != w["traffic"]:
        raise ValueError(f"{name}: traffic file is of mix "
                         f"{mix.get('traffic')!r}, not {w['traffic']!r}")
    return Cell(name, int(w["chips"]), conf, mix,
                _metrics(bench["end_to_end"], name),
                _metrics(bench["per_layer"], name))
