"""The port's copy of ``repro.telemetry.store``.

RunStore — a durable, queryable record of every instrumented run.

Layout mirrors ``CalibrationStore`` (one directory per run, atomic
manifest writes), and a store rooted next to calibration artifacts keeps
telemetry and calibrations in one place::

    <root>/<run>/events.jsonl     append-only event log
    <root>/<run>/manifest.json    atomic (tmp + os.replace) run metadata

The JSONL log is append-only so a crash loses at most the unflushed
buffer; the manifest is written whole-file-atomically so a reader never
sees a torn run description.  Queries (:meth:`events`) filter by kind,
name (exact, or prefix with a trailing ``*``), tenant, epoch, and time
range; :meth:`aggregate` buckets matching events into fixed windows of
logical time — the primitive reports build p50/p99 tables and
retries-per-epoch breakdowns from.

Round-trip contract: a fresh :class:`RunStore` pointed at the same root
(a process restart) returns byte-identical query results — events are
re-hydrated from JSONL, and :meth:`canonical_lines` (wall fields
stripped) is the determinism surface the tests compare.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import time
from typing import Callable, Iterable, Sequence

from .events import TelemetryEvent

_REDUCERS: dict[str, Callable[[Sequence[float]], float]] = {
    "sum": sum,
    "count": len,
    "mean": lambda xs: statistics.fmean(xs),
    "max": max,
    "min": min,
}


class RunStore:
    """Filesystem-backed event store: one subdirectory per run."""

    def __init__(self, root: str | pathlib.Path):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # --------------------------------------------------------------- paths
    def run_dir(self, run: str) -> pathlib.Path:
        return self.root / run

    def events_path(self, run: str) -> pathlib.Path:
        return self.run_dir(run) / "events.jsonl"

    def manifest_path(self, run: str) -> pathlib.Path:
        return self.run_dir(run) / "manifest.json"

    # ---------------------------------------------------------------- runs
    def new_run(self, prefix: str = "run") -> str:
        """A fresh run id ``<prefix>-NNNN``, numbered after the highest
        existing one so re-runs never clobber earlier logs.  Counts every
        reserved run directory, including ones that have not recorded an
        event yet — two recorders created back-to-back must not collide."""
        n = 0
        if self.root.is_dir():
            for p in self.root.iterdir():
                if not p.is_dir():
                    continue
                head, _, tail = p.name.rpartition("-")
                if head == prefix and tail.isdigit():
                    n = max(n, int(tail))
        run = f"{prefix}-{n + 1:04d}"
        self.run_dir(run).mkdir(parents=True, exist_ok=True)
        return run

    def runs(self) -> list[str]:
        """Every run id under the root, sorted."""
        if not self.root.is_dir():
            return []
        return sorted(p.name for p in self.root.iterdir()
                      if p.is_dir() and (
                          (p / "events.jsonl").is_file()
                          or (p / "manifest.json").is_file()))

    def latest(self) -> str | None:
        """The most recently created run (manifest ``created_unix``,
        falling back to name order)."""
        runs = self.runs()
        if not runs:
            return None
        return max(runs, key=lambda r: (
            self.manifest(r).get("created_unix", 0.0), r))

    # --------------------------------------------------------------- write
    def append(self, run: str, events: Iterable[TelemetryEvent]) -> int:
        """Append events to the run's JSONL log.  Returns count."""
        d = self.run_dir(run)
        d.mkdir(parents=True, exist_ok=True)
        lines = [e.to_json() for e in events]
        if lines:
            with open(self.events_path(run), "a") as f:
                f.write("\n".join(lines) + "\n")
        return len(lines)

    def write_manifest(self, run: str, meta: dict) -> None:
        """Atomically (re)write the run's manifest; ``created_unix`` is
        preserved from an earlier manifest when present."""
        d = self.run_dir(run)
        d.mkdir(parents=True, exist_ok=True)
        old = self.manifest(run)
        payload = {"run": run,
                   "created_unix": old.get("created_unix", time.time()),
                   **meta}
        path = self.manifest_path(run)
        tmp = path.with_suffix(f".json.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(payload, sort_keys=True, indent=1))
        os.replace(tmp, path)

    def manifest(self, run: str) -> dict:
        path = self.manifest_path(run)
        if not path.is_file():
            return {}
        return json.loads(path.read_text())

    # --------------------------------------------------------------- query
    def events(self, run: str, *, kind: str | None = None,
               name: str | None = None, tenant: str | None = None,
               epoch: int | None = None,
               t_range: tuple[float, float] | None = None
               ) -> list[TelemetryEvent]:
        """The run's events in ``seq`` order, filtered.

        ``name`` matches exactly, or as a prefix when it ends with ``*``
        (``"plan_cache.*"``).  ``t_range=(lo, hi)`` keeps events with
        ``lo <= t < hi``.  Filters compose conjunctively.
        """
        path = self.events_path(run)
        if not path.is_file():
            return []
        prefix = name[:-1] if name is not None and name.endswith("*") \
            else None
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                e = TelemetryEvent.from_json(line)
                if kind is not None and e.kind != kind:
                    continue
                if prefix is not None:
                    if not e.name.startswith(prefix):
                        continue
                elif name is not None and e.name != name:
                    continue
                if tenant is not None and e.tenant != tenant:
                    continue
                if epoch is not None and e.epoch != epoch:
                    continue
                if t_range is not None \
                        and not (t_range[0] <= e.t < t_range[1]):
                    continue
                out.append(e)
        out.sort(key=lambda e: e.seq)
        return out

    def counter_total(self, run: str, name: str, *,
                      tenant: str | None = None) -> float:
        """Sum of a counter's increments across the run."""
        return sum(e.value for e in self.events(run, kind="counter",
                                                name=name, tenant=tenant))

    def by_tenant(self, run: str, name: str,
                  kind: str = "counter") -> dict[str, float]:
        """``{tenant: total value}`` for one event name — e.g. per-tenant
        cache hit counts from ``plan_cache.hit``."""
        out: dict[str, float] = {}
        for e in self.events(run, kind=kind, name=name):
            out[e.tenant] = out.get(e.tenant, 0.0) + e.value
        return out

    def by_epoch(self, run: str, name: str,
                 kind: str = "counter") -> dict[int, float]:
        """``{epoch: total value}`` — e.g. retries per membership epoch
        (events with no epoch land under -1)."""
        out: dict[int, float] = {}
        for e in self.events(run, kind=kind, name=name):
            ep = -1 if e.epoch is None else e.epoch
            out[ep] = out.get(ep, 0.0) + e.value
        return out

    def aggregate(self, run: str, name: str, *, kind: str | None = None,
                  window: float = 1.0, reduce: str = "sum",
                  tenant: str | None = None
                  ) -> list[tuple[float, float]]:
        """Windowed aggregation over logical time: events matching
        ``name`` (prefix-``*`` allowed) bucketed into ``[k·window,
        (k+1)·window)`` and reduced by ``sum`` | ``count`` | ``mean`` |
        ``max`` | ``min``.  Returns ``[(window_start, value)]`` for
        non-empty windows, ascending."""
        if window <= 0:
            raise ValueError("window must be positive")
        try:
            fn = _REDUCERS[reduce]
        except KeyError:
            raise ValueError(f"unknown reducer {reduce!r}; expected one "
                             f"of {sorted(_REDUCERS)}") from None
        buckets: dict[int, list[float]] = {}
        for e in self.events(run, kind=kind, name=name, tenant=tenant):
            buckets.setdefault(int(e.t // window), []).append(e.value)
        return [(k * window, float(fn(buckets[k])))
                for k in sorted(buckets)]

    # --------------------------------------------------------- determinism
    def canonical_lines(self, run: str) -> list[str]:
        """The run's event log with wall-clock fields stripped — the byte
        surface two seeded replays must agree on (see
        :mod:`repro_torch.telemetry.events`)."""
        return [e.canonical() for e in self.events(run)]
