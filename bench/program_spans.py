#!/usr/bin/env python3
"""A traced run of a cell, as ``bench/run.py --trace 1`` makes it, with the
program's spans laid against the device trace by launch time:

    python3 bench/program_spans.py --workload <cell> --seed <n> --seconds <s> [--out FILE]

prints the run's result line, then on standard error ``program spans:``
(for each span name its host seconds, the device seconds and kernels
launched innermost under it, and the device idle seconds put down to it;
``bench/spans.py``), the same split by model call (``by call:``), the
spans that launched the top kernels, the device time each way of finding
an op's launch covered (the CUDA API call, else the linked host op),
the share of device-busy time launched inside ``layer.moe`` spans, how far
each ``engine.step`` span lies from the ``bench.step`` profiler range
around it, and the same for an empty span in an empty range under the same
profiler (``clock_floor``: the two clocks' reads with nothing between them
but the recorder's and the profiler's own work), with what one span costs
the host.  ``--out`` keeps all of it, and the per-step offsets, as JSON.
The benchmark's own runs never run it: its readers see no launch times."""

import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run as bench_run  # noqa: E402


def _quantiles(values) -> dict:
    if not values:
        return {}
    s = sorted(values)

    def q(p):
        return s[min(len(s) - 1, int(p * len(s)))]
    return {"n": len(s), "min": s[0], "p50": q(0.5), "p99": q(0.99),
            "max": s[-1], "mean": statistics.fmean(s)}


def _offsets(offsets) -> dict:
    within = sum(1 for a, b in offsets if abs(a) <= 50_000
                 and abs(b) <= 50_000)
    return {"matched": len(offsets),
            "within_50us_share": (100.0 * within / len(offsets)
                                  if offsets else None),
            "start": _quantiles([a / 1e3 for a, _ in offsets]),
            "end": _quantiles([b / 1e3 for _, b in offsets])}


def kernels_by_span(pairs, top: int = 12) -> dict:
    """For the ``top`` kernel names by device time: their device seconds
    by the span (under its model call) that launched them."""
    out: dict[str, dict] = {}
    total: dict[str, float] = {}
    from bench import spans
    for op, s in pairs:
        name = op.name[:80]
        where = spans.NO_SPAN if s is None else spans.by_call(s)
        row = out.setdefault(name, {})
        row[where] = row.get(where, 0.0) + (op.end - op.start) / 1e9
        total[name] = total.get(name, 0.0) + (op.end - op.start) / 1e9
    keep = sorted(total, key=total.get, reverse=True)[:top]
    return {k: out[k] for k in keep}


def clock_floor(n: int = 500) -> dict:
    """An empty wall-clocked span inside an empty ``record_function``
    range, ``n`` times under a CPU and CUDA profiler: the offsets of the
    span's ends from the range's, as ``step_offsets`` reads them."""
    import torch
    from bench import devtrace, spans
    from repro_torch.telemetry import TelemetryRecorder
    rec = TelemetryRecorder("clock_floor")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        for _ in range(n):
            with torch.profiler.record_function(devtrace.STEP):
                with rec.trace("engine.step", wall=True):
                    pass
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == devtrace.STEP
                    and devtrace._kind(e) == "user_annotation")
    tr = devtrace.Trace((0, 0), [], {devtrace.STEP: ranges})
    out = _offsets(spans.step_offsets(tr, spans.program_spans(rec.events)))
    # what one span costs the host, the profiler off
    t0 = time.perf_counter()
    for _ in range(n):
        with rec.trace("layer.norm", wall=True, layer=0):
            pass
    out["span_cost_us"] = 1e6 * (time.perf_counter() - t0) / n
    return out


def analyse(trace, events, launches: dict) -> dict:
    """The program-span table and the checks of one traced window."""
    from bench import devtrace, spans
    sp = spans.program_spans(events)
    pairs = spans.owners(trace, sp)
    device_s = sum(o.end - o.start for o in trace.ops) / 1e9
    by_way: dict[str, float] = {}
    for o in trace.ops:
        way = str(getattr(o, "launch_by", None))
        by_way[way] = by_way.get(way, 0.0) + (o.end - o.start) / 1e9
    in_span = sum(o.end - o.start for o, s in pairs if s is not None) / 1e9
    offsets = spans.step_offsets(trace, sp)
    return {
        "table": spans.table(trace, sp),
        "by_call": spans.table(trace, sp, key=spans.by_call),
        "kernels_by_span": kernels_by_span(pairs),
        "launches": launches,
        "device_s": device_s,
        "device_s_by_launch": by_way,
        "device_share_in_a_span": 100.0 * in_span / device_s,
        "moe_busy_share": spans.moe_busy_share(trace, sp),
        "busy_s": devtrace.busy_s(trace),
        "window_s": trace.window_s,
        "step_offsets_us": {
            "steps": len(trace.ranges.get(devtrace.STEP, [])),
            **_offsets(offsets)},
        "offsets_ns": offsets,
    }


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch
    from bench import devtrace, spans, spec
    if not torch.cuda.is_available():
        bench_run.log("the traced run needs a GPU")
        return 2
    kept: dict = {}
    read, reader = devtrace.read, spec.metric_reader

    def read_with_launches(prof):
        tr = read(prof)
        if tr is not None:
            kept["launches"] = spans.attach_launches(prof, tr)
        return tr

    def keeping(name):
        fn = reader(name)

        def read_metric(ctx):
            kept.setdefault("ctx", ctx)
            return fn(ctx)
        return read_metric

    devtrace.read, spec.metric_reader = read_with_launches, keeping
    try:
        result = bench_run.run(spec.cell(args.workload), args.seed,
                               args.seconds, True)
    finally:
        devtrace.read, spec.metric_reader = read, reader
    bench_run.report(result)
    ctx = kept.get("ctx")
    if ctx is None or ctx.trace is None:
        bench_run.log("program spans: no trace")
        return 1
    out = analyse(ctx.trace, ctx.events, kept["launches"])
    out["clock_floor_us"] = clock_floor()
    for label, k in (("program spans", "table"), ("by call", "by_call")):
        bench_run.log(f"{label}: " + json.dumps(
            {name: {f: round(v, 6) for f, v in row.items()}
             for name, row in sorted(out[k].items(),
                                     key=lambda kv: -kv[1]["device_s"])}))
    for k in ("kernels_by_span", "launches", "device_s",
              "device_s_by_launch", "device_share_in_a_span",
              "moe_busy_share", "busy_s", "window_s", "step_offsets_us",
              "clock_floor_us"):
        bench_run.log(f"{k} {json.dumps(out[k])}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"result": result, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
