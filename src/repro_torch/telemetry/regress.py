"""The port's copy of ``repro.telemetry.regress``.

Run-diffing perf-regression harness — snapshots, baselines, gates.

The missing half of a benchmark suite is *memory*: a number printed to a
terminal regresses silently.  This module distills a benchmark run (in
the JAX package, the ``benchmarks/common.emit`` surface; here, whatever
rows a caller collects) into a flat JSON **snapshot** and
diffs two snapshots with per-metric relative tolerances, exiting nonzero
on regression — the check CI runs against the committed baseline
(``BENCH_<n>.json`` at the repo root) so every later perf PR measures
itself against the trajectory.

Snapshot schema (version 1)::

    {"schema": 1, "suites": ["tab1", "fig8"],
     "metrics": {"fig8/4nodes/hidp": {"value": 523187.2, "unit":
                 "sim_us", "direction": "lower"}, ...}}

Units decide what is *gated* vs *informational*:

``us``
    Wall-clock microseconds — machine-dependent, so diffs report them
    but never fail on them (``--gate-wall`` opts in, e.g. for an A/A
    comparison on one box).
``sim_us`` / ``ratio`` / ``count`` / anything else
    Deterministic domain quantities (simulated latency, throughput
    ratios, event counts) — gated at the default relative tolerance
    (25 %) or a per-metric override.

``direction`` says which way is bad: ``lower`` (latency — regression =
value grew), ``higher`` (throughput ratio — regression = value fell).
A metric present in the baseline but missing from the current run is a
regression too (coverage loss), a brand-new metric is informational.

CLI (what CI runs)::

    python -m repro_torch.telemetry.regress BASELINE.json CURRENT.json \
        [--tolerance 0.25] [--gate-wall]

exit 0 = no gated metric regressed; exit 1 = regression (the diff table
names every offender); exit 2 = unusable snapshot files.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
from typing import Mapping, Sequence

SCHEMA = 1

#: default relative tolerance for gated metrics
DEFAULT_TOLERANCE = 0.25

#: units that are machine-dependent wall time — reported, not gated
WALL_UNITS = ("us",)

#: diff entry statuses (fixed vocabulary, rendered in this order)
STATUSES = ("regressed", "missing", "improved", "ok", "info", "new")


def snapshot(metrics: Mapping[str, Mapping],
             suites: Sequence[str] = ()) -> dict:
    """A snapshot dict from ``{name: {value, unit, direction}}`` rows
    (the JAX package's ``benchmarks/common.METRICS`` after a run).  This
    copy imports nothing of ``benchmarks``."""
    out = {}
    for name in sorted(metrics):
        m = metrics[name]
        out[name] = {"value": float(m["value"]),
                     "unit": str(m.get("unit", "us")),
                     "direction": str(m.get("direction", "lower"))}
    return {"schema": SCHEMA, "suites": list(suites), "metrics": out}


def write_snapshot(path: str | pathlib.Path,
                   metrics: Mapping[str, Mapping],
                   suites: Sequence[str] = ()) -> pathlib.Path:
    """Serialize :func:`snapshot` to ``path`` (parents created)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(snapshot(metrics, suites), indent=2,
                               sort_keys=True) + "\n")
    return path


def load_snapshot(path: str | pathlib.Path) -> dict:
    """Read and validate a snapshot file."""
    d = json.loads(pathlib.Path(path).read_text())
    if d.get("schema") != SCHEMA:
        raise ValueError(f"{path}: unsupported snapshot schema "
                         f"{d.get('schema')!r} (expected {SCHEMA})")
    if not isinstance(d.get("metrics"), dict):
        raise ValueError(f"{path}: snapshot has no metrics mapping")
    return d


@dataclasses.dataclass(frozen=True)
class DiffEntry:
    """One metric's verdict.  ``rel`` is the signed relative change in
    the *bad* direction (positive = worse), NaN when undefined."""

    name: str
    status: str          # one of STATUSES
    unit: str
    baseline: float | None
    current: float | None
    rel: float
    tolerance: float


@dataclasses.dataclass
class DiffResult:
    entries: list[DiffEntry]

    @property
    def regressions(self) -> list[DiffEntry]:
        return [e for e in self.entries
                if e.status in ("regressed", "missing")]

    @property
    def ok(self) -> bool:
        return not self.regressions


def _rel_worse(base: float, cur: float, direction: str) -> float:
    """Signed relative change in the bad direction: positive = worse.
    ``lower`` is better → growing is bad; ``higher`` → shrinking is."""
    if base == 0:
        return 0.0 if cur == base else float("inf")
    rel = (cur - base) / abs(base)
    return rel if direction == "lower" else -rel


def diff(baseline: Mapping, current: Mapping, *,
         tolerance: float = DEFAULT_TOLERANCE,
         tolerances: Mapping[str, float] | None = None,
         gate_wall: bool = False) -> DiffResult:
    """Compare two snapshots.  ``tolerances`` overrides the relative
    tolerance per metric name; wall-unit metrics are informational
    unless ``gate_wall``."""
    tolerances = tolerances or {}
    base_m, cur_m = baseline["metrics"], current["metrics"]
    entries: list[DiffEntry] = []
    for name in sorted(set(base_m) | set(cur_m)):
        b, c = base_m.get(name), cur_m.get(name)
        if b is None:
            entries.append(DiffEntry(name, "new", c["unit"], None,
                                     c["value"], float("nan"), 0.0))
            continue
        tol = float(tolerances.get(name, tolerance))
        gated = gate_wall or b.get("unit", "us") not in WALL_UNITS
        if c is None:
            entries.append(DiffEntry(
                name, "missing" if gated else "info", b.get("unit", "us"),
                b["value"], None, float("nan"), tol))
            continue
        rel = _rel_worse(b["value"], c["value"],
                         b.get("direction", "lower"))
        if not gated:
            status = "info"
        elif rel > tol:
            status = "regressed"
        elif rel < -tol:
            status = "improved"
        else:
            status = "ok"
        entries.append(DiffEntry(name, status, b.get("unit", "us"),
                                 b["value"], c["value"], rel, tol))
    order = {s: i for i, s in enumerate(STATUSES)}
    entries.sort(key=lambda e: (order[e.status], e.name))
    return DiffResult(entries)


def render_diff(result: DiffResult) -> str:
    """The diff as a fixed-order table plus a one-line verdict."""
    lines = []
    width = max((len(e.name) for e in result.entries), default=4)
    for e in result.entries:
        b = "-" if e.baseline is None else f"{e.baseline:.6g}"
        c = "-" if e.current is None else f"{e.current:.6g}"
        rel = "" if e.rel != e.rel else f"{e.rel * 100:+7.1f}%"
        lines.append(f"  {e.status:<9} {e.name:<{width}} "
                     f"{b:>12} -> {c:>12} {e.unit:<7} {rel}")
    n_reg = len(result.regressions)
    if n_reg:
        lines.append(f"REGRESSION: {n_reg} metric(s) worse than "
                     "tolerance (or missing) — see rows above")
    else:
        gated = sum(1 for e in result.entries
                    if e.status in ("ok", "improved"))
        lines.append(f"clean: {gated} gated metric(s) within tolerance, "
                     f"{len(result.entries) - gated} informational")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    tolerance = DEFAULT_TOLERANCE
    gate_wall = False
    pos: list[str] = []
    i = 0
    while i < len(argv):
        if argv[i] == "--tolerance":
            if i + 1 >= len(argv):
                print("--tolerance needs a value", file=sys.stderr)
                return 2
            tolerance = float(argv[i + 1])
            i += 2
        elif argv[i] == "--gate-wall":
            gate_wall = True
            i += 1
        else:
            pos.append(argv[i])
            i += 1
    if len(pos) != 2:
        print("usage: python -m repro_torch.telemetry.regress BASELINE "
              "CURRENT [--tolerance REL] [--gate-wall]", file=sys.stderr)
        return 2
    try:
        baseline = load_snapshot(pos[0])
        current = load_snapshot(pos[1])
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"regress: {e}", file=sys.stderr)
        return 2
    result = diff(baseline, current, tolerance=tolerance,
                  gate_wall=gate_wall)
    print(f"== regress: {pos[1]} vs baseline {pos[0]} "
          f"(tolerance {tolerance * 100:g}%) ==")
    print(render_diff(result))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
