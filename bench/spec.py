"""What ``BENCHMARK.json`` names, found by name under ``bench/``.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's file holds the model's sizes and family, the family names
its plain reference (``bench/reference/<family>.py``), the mix its
parameters (``bench/traffic/<traffic>.json``), and each per-layer metric its
reader (``bench/metrics/<name>.py``, or, for a name ``base.suffix`` with no
file of its own, the reader of ``base``).  A cell's correctness limits are
``bench/limits/<cell>.json``.  Adding a cell, a mix, a configuration or a
metric adds files; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict          # the configuration's file, whole
    traffic: dict         # the mix's file, whole
    chips: int
    limits: dict          # bench/limits/<cell>.json
    end_to_end: tuple     # the cell's end-to-end metric entries
    per_layer: tuple      # the cell's per-layer metric entries


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _read(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str, e2e: tuple = ()) -> bool:
    """An end-to-end metric applies where its ``workloads`` list the cell,
    or everywhere without one; a per-layer metric without the list applies
    where the end-to-end metric it moves (``e2e``: the cell's) does."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in {m["name"]
                                                       for m in e2e}


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = load_benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    (conf,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    e2e = tuple(m for m in bench["end_to_end"] if _applies(m, name))
    return Cell(
        name=name, config=_read(root / conf["file"]),
        traffic=_read(BENCH / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        limits=_read(BENCH / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=tuple(m for m in bench["per_layer"]
                        if _applies(m, name, e2e)))


def reference(family: str):
    """The plain reference module of a model family."""
    return importlib.import_module(f"bench.reference.{family}")


def metric_reader(name: str):
    """The ``read`` function of the per-layer metric ``name``: the file
    named after it, else the file of the part before its first dot."""
    for stem in (name, name.split(".", 1)[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"bench.metrics.{stem.replace('.', '_').replace('-', '_')}",
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise KeyError(f"no reader for per-layer metric {name!r} under "
                   f"{BENCH / 'metrics'}")
