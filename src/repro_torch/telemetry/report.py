"""The port's copy of ``repro.telemetry.report``.

Per-run summary reports over a :class:`~repro_torch.telemetry.RunStore`.

Three layers:

* :func:`sim_aggregates` — the *exact* reconstruction surface: the run
  totals a :class:`~repro_torch.core.simulator.SimReport` computes in
  memory (retries, migrations, SLO violations, per-tenant cache hits, total
  active joules), rebuilt purely from the durable event log.  The
  acceptance gate (fig7's telemetry section and
  ``tests/test_telemetry.py``) holds these equal to the in-memory report,
  so the log is a sufficient statistic for the run — not a lossy shadow.
* :func:`run_summary` / :func:`render` — the human table: request
  percentiles (p50/p99), energy, hit rates, retries per epoch, drift and
  membership history.
* :func:`render_trace` / :func:`render_timelines` — the causal layer
  (:mod:`repro_torch.telemetry.trace`): where each request's latency went
  (plan/queue/compute/comm/retry-waste), per-resource utilization,
  overlap headroom, and ASCII latency/energy timelines drawn from
  :meth:`RunStore.aggregate` windows — no plotting dependencies.

CLI (exit-code gated; CI smokes it)::

    python -m repro_torch.telemetry.report <store-dir> [run] \
        [--window SECONDS]

exits nonzero when the store has no runs, the chosen run recorded no
events, or the run has a manifest but zero *span* events — an
instrumented pipeline that produced nothing (a disabled recorder wired
where an enabled one was meant) is a failure, not an empty table.
"""

from __future__ import annotations

import sys

from .store import RunStore
from .trace import CATEGORIES, trace_summary


def percentile(xs: list[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 for empty input."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[i]


def sim_aggregates(store: RunStore, run: str) -> dict:
    """Reconstruct a simulated run's ``SimReport`` totals from its event
    log alone.  Keys mirror the in-memory aggregates they must equal:
    ``total_retries`` / ``total_migrations`` / ``slo_violations``
    (``SimReport`` methods of the same name), ``total_active_joules``
    (sum of per-request active energy incl. radio), and
    ``cache_hits_by_tenant`` / ``cache_misses_by_tenant`` (the
    ``PlanCache`` counters, split per tenant — finer than the in-memory
    cache ever tracked)."""
    requests = store.events(run, kind="span", name="sim.request")
    return {
        "requests": len(requests),
        "latencies": [e.value for e in requests],
        "total_retries": int(sum(e.attrs.get("retries", 0)
                                 for e in requests)),
        "total_migrations": int(sum(e.attrs.get("migrations", 0)
                                    for e in requests)),
        "slo_violations": int(sum(1 for e in requests
                                  if e.attrs.get("slo_violated"))),
        "total_active_joules": float(sum(e.attrs.get("active_energy_j",
                                                     0.0)
                                         for e in requests)),
        "cache_hits_by_tenant": {
            t: int(v) for t, v in store.by_tenant(run,
                                                  "plan_cache.hit").items()},
        "cache_misses_by_tenant": {
            t: int(v)
            for t, v in store.by_tenant(run, "plan_cache.miss").items()},
        "retries_by_epoch": {
            int(k): int(v)
            for k, v in store.by_epoch(run, "sim.retry").items()},
    }


def run_summary(store: RunStore, run: str) -> dict:
    """The full per-run summary the CLI renders: :func:`sim_aggregates`
    plus latency percentiles, cache hit rate, frontier passes, membership
    epochs, leader elections, and drift events."""
    agg = sim_aggregates(store, run)
    lats = agg.pop("latencies")
    hits = sum(agg["cache_hits_by_tenant"].values())
    misses = sum(agg["cache_misses_by_tenant"].values())
    drift = store.events(run, kind="gauge", name="feedback.drift")
    membership = store.events(run, kind="gauge", name="fleet.membership")
    summary = {
        "run": run,
        **agg,
        "p50_latency_s": percentile(lats, 50),
        "p99_latency_s": percentile(lats, 99),
        "mean_latency_s": sum(lats) / len(lats) if lats else 0.0,
        "cache_hits": hits,
        "cache_misses": misses,
        "cache_hit_rate": hits / (hits + misses) if hits + misses else 0.0,
        "frontier_passes": len(store.events(run, kind="span",
                                            name="plan.frontier_pass")),
        "epochs": len(membership),
        "leader_elections": int(store.counter_total(
            run, "fleet.leader_election")),
        "drift_events": len(drift),
        "max_drift": max((e.value for e in drift), default=0.0),
        "events": len(store.events(run)),
    }
    return summary


def render(summary: dict) -> str:
    """One run, one table — fixed row order so reports diff cleanly."""
    rows = [
        ("requests", f"{summary['requests']}"),
        ("p50 latency", f"{summary['p50_latency_s'] * 1e3:10.1f} ms"),
        ("p99 latency", f"{summary['p99_latency_s'] * 1e3:10.1f} ms"),
        ("mean latency", f"{summary['mean_latency_s'] * 1e3:10.1f} ms"),
        ("active energy", f"{summary['total_active_joules']:10.2f} J"),
        ("retries", f"{summary['total_retries']}"),
        ("migrations", f"{summary['total_migrations']}"),
        ("SLO violations", f"{summary['slo_violations']}"),
        ("cache hits/misses",
         f"{summary['cache_hits']}/{summary['cache_misses']} "
         f"(rate {summary['cache_hit_rate']:.3f})"),
        ("frontier passes", f"{summary['frontier_passes']}"),
        ("membership epochs", f"{summary['epochs']}"),
        ("leader elections", f"{summary['leader_elections']}"),
        ("drift events", f"{summary['drift_events']} "
                         f"(max {summary['max_drift']:.3f})"),
        ("events", f"{summary['events']}"),
    ]
    width = max(len(k) for k, _ in rows)
    lines = [f"== telemetry report: run {summary['run']} =="]
    lines += [f"  {k:<{width}}  {v}" for k, v in rows]
    for tenant in sorted(set(summary["cache_hits_by_tenant"])
                         | set(summary["cache_misses_by_tenant"])):
        h = summary["cache_hits_by_tenant"].get(tenant, 0)
        m = summary["cache_misses_by_tenant"].get(tenant, 0)
        lines.append(f"  tenant {tenant or '<none>':<{width - 7}}  "
                     f"hits={h} misses={m}")
    for ep in sorted(summary["retries_by_epoch"]):
        lines.append(f"  epoch {ep:<{width - 6}}  "
                     f"retries={summary['retries_by_epoch'][ep]}")
    return "\n".join(lines)


def render_trace(tsum: dict) -> str:
    """The causal section: critical-path category breakdown (mean
    seconds and share of mean latency), per-resource utilization, and
    overlap headroom.  Empty string when the run has no request roots
    (pure benchmark runs) — the caller then skips the section."""
    if not tsum["requests"]:
        return ""
    lines = [f"  -- critical path ({tsum['requests']} requests, mean "
             f"latency {tsum['mean_latency_s'] * 1e3:.1f} ms) --"]
    width = max(len(c) for c in CATEGORIES)
    for cat in CATEGORIES:
        mean = tsum["category_means_s"][cat]
        frac = tsum["category_fractions"][cat]
        bar = "#" * int(round(frac * 30))
        lines.append(f"  {cat:<{width}}  {mean * 1e3:9.2f} ms "
                     f"{frac * 100:5.1f}%  {bar}")
    lines.append(f"  residual (max)  {tsum['max_residual_s']:.2e} s")
    util = tsum["utilization"]
    if util:
        lines.append("  -- utilization --")
        w = max(len(k) for k in util)
        for key, u in util.items():
            bar = "#" * int(round(u["utilization"] * 30))
            lines.append(f"  {key:<{w}}  busy {u['busy_s']:8.3f} s  "
                         f"util {u['utilization'] * 100:5.1f}%  {bar}")
    head = tsum["headroom"]
    total = head.get("total", {})
    if total.get("idle_while_peer_busy_s", 0.0) > 0:
        lines.append(
            f"  overlap headroom: "
            f"{total['idle_while_peer_busy_s']:.3f} s idle-while-peer-busy"
            f" ({total['fraction'] * 100:.1f}% of node-time) — "
            "reclaimable by pipelined execution")
    return "\n".join(lines)


def timeline(store: RunStore, run: str, name: str, *,
             kind: str | None = None, window: float = 1.0,
             reduce: str = "mean", width: int = 40,
             unit: str = "") -> list[str]:
    """One metric's :meth:`RunStore.aggregate` windows as ASCII bars —
    one line per non-empty window, bar length proportional to the
    window's value over the run maximum.  Empty list when the run never
    logged the metric."""
    buckets = store.aggregate(run, name, kind=kind, window=window,
                              reduce=reduce)
    if not buckets:
        return []
    peak = max(v for _, v in buckets) or 1.0
    lines = [f"  -- {name} per {window:g} s ({reduce}{', ' + unit if unit else ''}) --"]
    for t0, v in buckets:
        bar = "#" * max(1, int(round(v / peak * width)))
        lines.append(f"  [{t0:8.2f} s] {v:12.6g} {bar}")
    return lines


def render_timelines(store: RunStore, run: str,
                     window: float = 1.0) -> str:
    """Latency and energy over the run's logical time: mean request
    latency per window (``sim.request``, or ``load.request`` for
    queueing runs) and joules per window (``sim.energy`` gauges).
    Whatever the run did not log is skipped."""
    lines: list[str] = []
    for name in ("sim.request", "load.request"):
        lines += timeline(store, run, name, kind="span", window=window,
                          reduce="mean", unit="s latency")
    lines += timeline(store, run, "sim.energy", kind="gauge",
                      window=window, reduce="sum", unit="J")
    return "\n".join(lines)


def generate(store: RunStore, run: str | None = None, *,
             window: float = 1.0) -> str:
    """Render the report for ``run`` (default: the latest).  Raises
    ``ValueError`` when the store has no runs, the run logged no events,
    or the run has a manifest but zero span events — the exit-code
    contract the CI smoke gates on."""
    if run is None:
        run = store.latest()
        if run is None:
            raise ValueError(f"no runs under {store.root}")
    if not store.events(run):
        raise ValueError(f"run {run!r} recorded no events")
    if not store.events(run, kind="span"):
        raise ValueError(
            f"run {run!r} has a manifest but zero span events — nothing "
            "to report on; was a disabled recorder wired where an "
            "enabled one was meant?")
    parts = [render(run_summary(store, run))]
    tsec = render_trace(trace_summary(store, run))
    if tsec:
        parts.append(tsec)
    tl = render_timelines(store, run, window)
    if tl:
        parts.append(tl)
    return "\n".join(parts)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 1
    window = 1.0
    pos: list[str] = []
    i = 0
    while i < len(argv):
        if argv[i] == "--window":
            if i + 1 >= len(argv):
                print("--window needs a value (seconds)", file=sys.stderr)
                return 1
            window = float(argv[i + 1])
            i += 2
        else:
            pos.append(argv[i])
            i += 1
    store = RunStore(pos[0])
    run = pos[1] if len(pos) > 1 else None
    try:
        print(generate(store, run, window=window))
    except ValueError as e:
        print(f"telemetry report failed: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
