"""The port's copies of ``repro.telemetry``'s run store, trace trees,
report and regress modules, held equal to the JAX package's.

The seeded runs are the JAX package's own helpers (``_recorded_churn_run``
of ``tests/test_telemetry.py``, ``_churn_run``/``_load_run`` of
``tests/test_trace.py``, ``_telemetry_run`` of ``tests/test_load.py``)
called once as they are and once on the port (``on_port``): the canonical
event lines, span-tree lines, critical paths, summaries and reports of the
two are compared byte for byte.  Each package reads a store the other
wrote, and both CLIs give the same exit codes.  The cases of
``tests/test_trace.py``, ``tests/test_regress.py`` and the store, report
and simulator cases of ``tests/test_telemetry.py`` run on the port too.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import test_load as load_cases
import test_regress as regress_cases
import test_telemetry as telemetry_cases
import test_trace as trace_cases
from _port_alias import call_case, on_port
from repro.telemetry import regress as jregress
from repro.telemetry import report as jreport
from repro.telemetry import store as jstore
from repro.telemetry import trace as jtrace
from repro_torch.telemetry import regress, report, store, trace

ROOT = Path(__file__).resolve().parents[1]
PORT = dict(store=store, trace=trace, report=report, regress=regress)
JAX = dict(store=jstore, trace=jtrace, report=jreport, regress=jregress)


def _runs(kind, root):
    """One seeded run of ``kind`` recorded under ``root/port`` by the port
    and under ``root/jax`` by the JAX package: ``[(store, run, report),
    ...]`` in the order port, JAX."""
    cases = {"churn": telemetry_cases, "trace": trace_cases,
             "load": trace_cases, "saturation": load_cases}[kind]
    out = []
    for tag in ("port", "jax"):
        m = cases if tag == "jax" else on_port(cases)
        if kind == "churn":
            s, rec, rep, *_ = m._recorded_churn_run(root / tag,
                                                    planning_time=0.0)
            out.append((s, rec.run, rep))
        elif kind == "trace":
            out.append(m._churn_run(root / tag))
        elif kind == "load":
            out.append(m._load_run(root / tag))
        else:
            out.append(m._telemetry_run(root, tag))
    assert type(out[0][0]) is store.RunStore
    assert type(out[1][0]) is jstore.RunStore
    return out


KINDS = ("churn", "trace", "load", "saturation")


def _paths(paths):
    return [dataclasses.asdict(p) for p in paths]


@pytest.mark.parametrize("kind", KINDS)
def test_canonical_event_lines_equal_the_reference(kind, tmp_path):
    (s, run, _), (js, jrun, _) = _runs(kind, tmp_path)
    assert run == jrun
    lines = s.canonical_lines(run)
    assert len(lines) > 20
    assert lines == js.canonical_lines(jrun)
    man, jman = s.manifest(run), js.manifest(jrun)
    man.pop("created_unix"), jman.pop("created_unix")
    assert man == jman


@pytest.mark.parametrize("kind", KINDS)
def test_trees_paths_and_summaries_equal_the_reference(kind, tmp_path):
    runs = _runs(kind, tmp_path)
    got = []
    for pkg, (s, run, _) in zip((PORT, JAX), runs):
        tr, rp = pkg["trace"], pkg["report"]
        roots = tr.span_trees(s.events(run))
        got.append((tr.tree_lines(roots),
                    _paths(tr.request_critical_paths(s, run)),
                    tr.node_utilization(s, run),
                    tr.overlap_headroom(s, run),
                    tr.trace_summary(s, run), rp.run_summary(s, run),
                    rp.sim_aggregates(s, run),
                    rp.generate(s, run, window=2.0)))
    assert got[0][1] and got[0][0]
    assert got[0] == got[1]


@pytest.mark.parametrize("kind", ["churn", "trace"])
def test_sim_aggregates_equal_the_sim_report(kind, tmp_path):
    (s, run, rep), _ = _runs(kind, tmp_path)
    agg = report.sim_aggregates(s, run)
    assert agg["requests"] == len(rep.records)
    assert agg["latencies"] == [r.latency for r in rep.records]
    assert agg["total_retries"] == rep.total_retries() >= 1
    assert agg["total_migrations"] == rep.total_migrations()
    assert agg["slo_violations"] == rep.slo_violations()
    assert agg["total_active_joules"] == \
        sum(r.active_energy for r in rep.records)
    cats = [p.categories for p in trace.request_critical_paths(s, run)]
    assert len(cats) == len(rep.records)
    assert all(set(c) == set(trace.CATEGORIES) for c in cats)


def _events_on_disk(s, run):
    return ([e.to_json() for e in s.events(run)], s.manifest(run),
            s.canonical_lines(run))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_store_the_other_wrote(writer, tmp_path):
    (s, run, _), (js, jrun, _) = _runs("trace", tmp_path)
    root = tmp_path / writer
    ours, theirs = store.RunStore(root), jstore.RunStore(root)
    assert ours.runs() == theirs.runs() == [run]
    assert ours.latest() == theirs.latest() == run
    assert _events_on_disk(ours, run) == _events_on_disk(theirs, run)
    for q in (dict(kind="span"), dict(name="sim.*"), dict(epoch=1),
              dict(tenant="vgg19"), dict(t_range=(1.0, 4.0))):
        assert [e.to_json() for e in ours.events(run, **q)] == \
            [e.to_json() for e in theirs.events(run, **q)]
    for name in ("sim.request", "sim.energy", "sim.retry"):
        assert ours.counter_total(run, name) == \
            theirs.counter_total(run, name)
        assert ours.by_tenant(run, name) == theirs.by_tenant(run, name)
        assert ours.by_epoch(run, name) == theirs.by_epoch(run, name)
        for red in ("sum", "count", "mean", "max", "min"):
            assert ours.aggregate(run, name, window=1.5, reduce=red) == \
                theirs.aggregate(run, name, window=1.5, reduce=red)
    # the reader's report over the other package's store is the writer's
    assert report.generate(ours, run) == jreport.generate(theirs, run)
    # and a run the reader appends lands where the writer numbers it
    assert ours.new_run("trace") == "trace-0002"
    assert theirs.new_run("trace") == "trace-0003"


# --------------------------------------------------------------------------
# regress
# --------------------------------------------------------------------------

BASE = {
    "kern/flash/launches": {"value": 36.0, "unit": "count",
                            "direction": "lower"},
    "kern/decode/launches": {"value": 18.0, "unit": "count",
                             "direction": "lower"},
    "engine/decode_step": {"value": 4210.5, "unit": "us",
                           "direction": "lower"},
    "sim/hidp/tput": {"value": 0.8, "unit": "ratio", "direction": "higher"},
}
CHANGES = {
    "missing": {"sim/hidp/tput": None},
    "doubled": {"kern/flash/launches": 72.0},
    "wall_only": {"engine/decode_step": 99999.0},
    "improved": {"kern/decode/launches": 9.0, "sim/hidp/tput": 0.95},
    "tput_drop": {"sim/hidp/tput": 0.5},
    "zero_base": {"kern/decode/launches": 0.0},
}


def _snapshots(pkg, change):
    base = pkg["regress"].snapshot(BASE, suites=["smoke"])
    cur = {k: dict(v) for k, v in BASE.items()}
    for k, v in CHANGES[change].items():
        if v is None:
            del cur[k]
        else:
            cur[k]["value"] = v
    cur["new/metric"] = {"value": 1.0, "unit": "count", "direction": "lower"}
    return base, pkg["regress"].snapshot(cur, suites=["smoke"])


@pytest.mark.parametrize("gate_wall", [False, True])
@pytest.mark.parametrize("change", sorted(CHANGES))
def test_diff_results_equal_the_reference(change, gate_wall):
    got = []
    for pkg in (PORT, JAX):
        base, cur = _snapshots(pkg, change)
        for a, b in ((base, cur), (cur, base), (base, base)):
            for tol in (0.25, 0.01):
                r = pkg["regress"].diff(a, b, tolerance=tol,
                                        gate_wall=gate_wall,
                                        tolerances={"sim/hidp/tput": 0.1})
                # repr: a new metric's ``rel`` is NaN
                got.append((repr([dataclasses.asdict(e) for e in r.entries]),
                            r.ok, pkg["regress"].render_diff(r)))
    half = len(got) // 2
    assert got[:half] == got[half:]


def _cli(module, *args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120).returncode


def test_regress_cli_exit_codes_equal_the_reference(tmp_path):
    base = regress.write_snapshot(tmp_path / "base.json", BASE, ["smoke"])
    doubled = dict(BASE, **{"kern/flash/launches": dict(
        BASE["kern/flash/launches"], value=72.0)})
    cur = regress.write_snapshot(tmp_path / "cur.json", doubled, ["smoke"])
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": 99, "metrics": {}}))
    cases = [((base, base), 0), ((base, cur), 1),
             ((base, cur, "--tolerance", "2.0"), 0), ((base,), 2),
             ((base, tmp_path / "nope.json"), 2), ((base, bad), 2)]
    for args, rc in cases:
        assert regress.main(list(map(str, args))) == rc, args
        assert jregress.main(list(map(str, args))) == rc, args
    for args, rc in cases[:2] + cases[3:4]:
        for module in ("repro_torch.telemetry.regress",
                       "repro.telemetry.regress"):
            assert _cli(module, *args, cwd=tmp_path) == rc, (module, args)


def test_report_cli_exit_codes_equal_the_reference(tmp_path):
    (s, run, _), (js, jrun, _) = _runs("trace", tmp_path)
    empty = store.RunStore(tmp_path / "spanless")
    rec = on_port(trace_cases).TelemetryRecorder(
        empty.new_run("empty"), store=empty)
    rec.counter("something.happened")
    rec.close()
    cases = [((tmp_path / "port",), 0), ((tmp_path / "jax", jrun), 0),
             ((tmp_path / "port", "--window", "2.0"), 0),
             ((tmp_path / "nothing",), 1), ((tmp_path / "spanless",), 1),
             ((tmp_path / "port", "--window"), 1), ((), 1), (("-h",), 0)]
    for args, rc in cases:
        for module in ("repro_torch.telemetry.report",
                       "repro.telemetry.report"):
            assert _cli(module, *args, cwd=tmp_path) == rc, (module, args)


# --------------------------------------------------------------------------
# the JAX package's own cases, run on the port
# --------------------------------------------------------------------------

TELEMETRY_CASES = (
    "test_disabled_recorder_normalizes_away_and_emits_nothing",
    "test_run_store_new_run_numbering_and_latest",
    "test_run_store_restart_round_trip", "test_run_store_query_filters",
    "test_run_store_windowed_aggregation",
    "test_two_seeded_runs_are_byte_identical_modulo_wall",
    "test_poisson_churn_run_deterministic_under_seed",
    "test_log_reconstructs_sim_report_aggregates_exactly",
    "test_run_summary_and_report_render", "test_feedback_drift_emits_gauge",
    "test_sim_report_empty_guards")
TRACE_CASES = (
    "test_span_trees_synthetic_parentage_and_orphans",
    "test_churn_run_tree_shape",
    "test_tree_lines_byte_identical_across_seeded_replays",
    "test_critical_path_sums_to_latency_under_churn",
    "test_critical_path_rejects_non_request_roots",
    "test_mixed_tenant_interleaving_keeps_trees_disjoint",
    "test_load_request_trees_and_critical_paths",
    "test_load_trees_byte_identical_across_replays",
    "test_node_utilization_and_overlap_headroom",
    "test_report_includes_trace_section_and_timelines",
    "test_report_fails_readably_on_zero_span_runs",
    "test_disabled_recorder_allocates_nothing")
REGRESS_CASES = (
    "test_snapshot_round_trip", "test_load_snapshot_rejects_bad_schema",
    "test_self_diff_is_clean", "test_lower_is_better_regression_gates",
    "test_lower_is_better_improvement_passes",
    "test_higher_is_better_direction_flips",
    "test_wall_metrics_report_but_never_gate_unless_asked",
    "test_missing_gated_metric_is_a_regression",
    "test_new_metric_is_informational",
    "test_per_metric_tolerance_override", "test_zero_baseline_edge",
    "test_cli_exit_codes", "test_bench_emit_feeds_snapshots")


@pytest.mark.parametrize("case", TELEMETRY_CASES)
def test_telemetry_cases_on_the_port(case, tmp_path):
    call_case(getattr(on_port(telemetry_cases), case), tmp_path=tmp_path)


@pytest.mark.parametrize("case", TRACE_CASES)
def test_trace_cases_on_the_port(case, tmp_path):
    call_case(getattr(on_port(trace_cases), case), tmp_path=tmp_path)


@pytest.mark.parametrize("case", REGRESS_CASES)
def test_regress_cases_on_the_port(case, tmp_path, capsys):
    call_case(getattr(on_port(regress_cases), case), tmp_path=tmp_path,
              capsys=capsys)
