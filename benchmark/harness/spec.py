"""What ``BENCHMARK.json`` names, found by name as files under
``benchmark/``: a cell's configuration (``configs/<config>.json``), its
traffic mix (``traffic/<traffic>.json``, which names the driver that
runs it, ``drivers/<driver>.py``), its limits (``limits/<cell>.json``)
and every metric's reader (``metrics/<metric>.py``). Adding a cell, a
mix or a metric adds files and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]    # the cell's end-to-end metrics
    per_layer: List[dict]     # the cell's per-layer metrics

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _reported(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, bench_path: str = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read; a
    per-layer metric without ``workloads`` belongs to every cell that
    reports the end-to-end metric it moves."""
    bench_path = bench_path or os.path.join(ROOT, "BENCHMARK.json")
    bench = read_json(bench_path)
    # the repository's cells keep their files under benchmark/; another
    # BENCHMARK.json (the tests' tiny cells) keeps them beside itself
    files = BENCH_DIR if os.path.dirname(os.path.abspath(bench_path)) \
        == ROOT else os.path.dirname(os.path.abspath(bench_path))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _reported(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in moved and _reported(m, name)]
    path = lambda *p: os.path.join(files, *p)
    return Cell(name=name, chips=int(w["chips"]),
                config=read_json(path("configs", w["config"] + ".json")),
                traffic=read_json(path("traffic", w["traffic"] + ".json")),
                limits=read_json(path("limits", name + ".json")),
                end_to_end=e2e, per_layer=per_layer)


def driver_module(cell: Cell):
    return load_module(os.path.join(BENCH_DIR, "drivers",
                                    cell.driver + ".py"),
                       "benchmark_driver_" + cell.driver)


def read_metrics(metrics: List[dict], obs: dict) -> Dict[str, dict]:
    """Each metric's reader (``metrics/<name>.py``'s ``read(obs)``) on
    the run's observations; a reader that finds nothing returns None and
    its metric is left out."""
    out = {}
    for m in metrics:
        reader = load_module(os.path.join(BENCH_DIR, "metrics",
                                          m["name"] + ".py"),
                             "benchmark_metric_" + m["name"].replace(
                                 ".", "_").replace("-", "_"))
        value = reader.read(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
