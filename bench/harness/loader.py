"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic; the files
are ``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json``
(whose ``generator`` names ``bench/generators/<generator>.py``) and
``bench/workloads/<cell>.json`` (the service's geometry, the run's
sampling and the comparison's limits), and each per-layer metric is read
by ``bench/metrics/<metric>.py``.  A new cell, traffic mix, generator or
metric is new files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list     # the BENCHMARK.json entries this cell reports
    per_layer: list
    metrics_dir: Path
    generators_dir: Path


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises KeyError for a
    cell it does not list and FileNotFoundError for a missing part."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in {root / 'BENCHMARK.json'}; "
                       f"known: {[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    data = root / "bench"
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=_json(root / conf["file"]),
        traffic=_json(data / "traffic" / f"{entry['traffic']}.json"),
        workload=_json(data / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        metrics_dir=data / "metrics", generators_dir=data / "generators")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(cell: Cell, metric: str):
    """``read(ctx)`` of ``bench/metrics/<metric>.py``."""
    return _module(cell.metrics_dir / f"{metric}.py",
                   f"bench_metric_{metric}").read


def make_generator(cell: Cell, seed: int):
    """The cell's traffic generator for ``seed``: ``make(spec, seed,
    service)`` of the module its traffic file names."""
    name = cell.traffic["generator"]
    mod = _module(cell.generators_dir / f"{name}.py",
                  f"bench_generator_{name}")
    return mod.make(cell.traffic, seed, cell.workload["service"])
