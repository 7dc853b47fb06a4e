"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<mix>`` resolves to ``configs/<config>.json``,
``traffic/<mix>.json``, the driver the mix names (``drivers/<driver>.py``),
``limits/<cell>.json`` and the readers of the metrics the cell reports
(``metrics/<metric>.py``, else ``metrics/<metric before the first dot>.py``).
Nothing here branches on a cell: a new cell, configuration, mix or metric
is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

__all__ = ["BENCH_DIR", "ROOT", "Cell", "load_benchmark", "resolve", "load_module",
           "metric_reader"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with everything it names loaded."""

    name: str
    chips: int
    config: dict            # configs/<config>.json
    mix: dict               # traffic/<mix>.json
    limits: dict            # limits/<cell>.json
    end_to_end: list        # the end-to-end metrics this cell reports
    per_layer: list         # the per-layer metrics this cell reports


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists; an end-to-end metric without that key, every cell.  A per-layer
    metric has to list its cells."""
    if "workloads" not in metric and "moves" in metric:
        raise KeyError(f"per-layer metric {metric['name']!r} lists no workloads")
    return cell in metric.get("workloads", [cell])


def resolve(name: str, bench: dict | None = None, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    bench = load_benchmark(bench_dir.parent) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=_load_json(bench_dir.parent / conf["file"]),
                mix=_load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
                limits=_load_json(bench_dir / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def load_module(path: Path, name: str):
    """Import the file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod              # dataclasses look their module up here
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``read(run) -> float | None`` of metric ``name``: from
    ``metrics/<name>.py``, else from ``metrics/<name before the first
    dot>.py`` (one reader for ``mfu.prompt`` and ``mfu.batch``)."""
    for stem in (name, name.split(".", 1)[0]):
        path = bench_dir / "metrics" / f"{stem}.py"
        if path.is_file():
            return load_module(path, f"gpu_bench_metric_{stem.replace('.', '_')}").read
    raise FileNotFoundError(f"no reader for metric {name!r} under {bench_dir / 'metrics'}")
