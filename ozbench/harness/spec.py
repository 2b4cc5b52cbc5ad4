"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root lists the cells, each naming a
configuration and a traffic mix, and the metrics.  Each piece is a file
of its own under ``ozbench/``, found by its name:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the
  deployment's sizes, mode, operands, the reference that judges it and
  the limit of each number compared (``"limits"``);
- ``traffic/<traffic>.json``: the driver that runs the mix and its
  parameters;
- ``drivers/<driver>.py``: the code that runs a kind of traffic;
- ``operands/<kind>.py``: how a kind of operand is made from the seed;
- ``end_to_end/<metric>.py`` and ``metrics/<metric>.py``: the reader of
  one end-to-end or per-layer metric;
- ``limits/<workload>.json``, where a cell's limits differ from its
  configuration's: those limits.

A reader's file may serve several metrics: ``<name>.py`` is looked for
first, then the file of the name's part before its first dot, so
``device_idle_share.hpl`` is read by ``metrics/device_idle_share.py``.
So a cell, a mix, a driver, a kind of operand or a metric is added by
adding files, and no file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _applies(entry: dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return "moves" not in entry or entry["moves"] in reported


def find_cell(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its pieces."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(_json(os.path.join(root, configs[w["config"]]["file"])), name=w["config"])
    traffic = dict(_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")),
                   name=w["traffic"])
    limits = dict(config.get("limits", {}))
    own = os.path.join(bench_dir, "limits", f"{name}.json")
    if os.path.exists(own):
        limits.update(_json(own))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer)


_LOADED: Dict[str, ModuleType] = {}


def path_of(kind: str, name: str, bench_dir: str = BENCH_DIR) -> str:
    """``<kind>/<name>.py`` under ``bench_dir``, or else the file of the
    name's part before its first dot."""
    for stem in (name, name.partition(".")[0]):
        path = os.path.join(bench_dir, kind, f"{stem}.py")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {kind}/{name}.py under {bench_dir}")


def load(kind: str, name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """The module of ``<kind>/<name>.py`` (see :func:`path_of`), loaded
    once a file."""
    path = os.path.realpath(path_of(kind, name, bench_dir))
    if path not in _LOADED:
        stem = os.path.splitext(os.path.basename(path))[0]
        mod_name = f"ozbench_{kind}_{stem}_{len(_LOADED)}".replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        _LOADED[path] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del _LOADED[path]
            raise
    return _LOADED[path]


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """The ``read(ctx)`` of the per-layer metric ``name``."""
    return load("metrics", name, bench_dir).read


def end_to_end_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """The ``read(ctx)`` of the end-to-end metric ``name``."""
    return load("end_to_end", name, bench_dir).read
