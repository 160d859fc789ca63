"""The port's copy of ``repro.load`` — arrival traces, service models, the
open-loop queueing harness and saturation sweeps — held equal to the JAX
package's on the same seeds, by exact equality.

Traces draw from ``np.random.Generator`` in both packages, so a seed gives
the same arrays (``np.array_equal``); reports are compared array for
array, and the telemetry the harness emits event for event in canonical
projection.  The cases of ``tests/test_load.py`` run on the port as well
(``on_port``), except the hypothesis properties (their seeded fall-backs
run) and the 10⁵-request scale test.
"""

import dataclasses

import numpy as np
import pytest

import test_load as load_cases
from _port_alias import call_case, on_port
from repro import fleet as jfleet
from repro import load as jload
from repro import serving as jserving
from repro import telemetry as jtelemetry
from repro.core import edge_models as jedge
from repro.core import hidp as jhidp
from repro.load import harness as jharness
from repro_torch import fleet, load, serving, telemetry
from repro_torch.core import edge_models, hidp
from repro_torch.load import harness

PORT = dict(load=load, harness=harness, fleet=fleet, serving=serving,
            telemetry=telemetry, edge=edge_models, hidp=hidp)
JAX = dict(load=jload, harness=jharness, fleet=jfleet, serving=jserving,
           telemetry=jtelemetry, edge=jedge, hidp=jhidp)
PACKAGES = (PORT, JAX)

RATES = {"chat": 20.0, "batch": 10.0, "embed": 35.0}

TRACES = {
    "poisson": lambda A: A.poisson(RATES, horizon=20.0, seed=3),
    "diurnal": lambda A: A.diurnal(RATES, horizon=40.0, seed=4,
                                   peak_factor=4.0, period=13.0,
                                   phase=2.0),
    "mmpp": lambda A: A.mmpp(RATES, horizon=30.0, seed=5,
                             state_factors=(0.3, 1.0, 5.0),
                             mean_dwell=(4.0, 2.0, 1.0)),
    "burst": lambda A: A.burst(RATES, horizon=30.0, seed=6),
    "merge": lambda A: A.poisson({"chat": 5.0}, 10.0, seed=1).merge(
        A.burst({"chat": 2.0, "bulk": 3.0}, 10.0, seed=2),
        A.diurnal({"bulk": 4.0}, 10.0, seed=3)),
    "scaled": lambda A: A.poisson(RATES, 10.0, seed=7).scaled(3.5),
    "window": lambda A: A.mmpp(RATES, 30.0, seed=8).window(4.0, 17.5),
}


def _trace(t) -> tuple:
    return (t.times, t.tenant_ids, t.tenants, t.horizon, t.counts(),
            t.offered_rates(), t.offered_rate(), len(t), repr(t))


def _same(a, b) -> bool:
    """Equal, with numpy arrays compared by ``np.array_equal`` (NaN equal
    to NaN) and dtype."""
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    return a == b


# --------------------------------------------------------------------------
# arrival traces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TRACES))
def test_arrival_traces_equal_the_reference(name):
    ours = TRACES[name](load.ArrivalTrace)
    theirs = TRACES[name](jload.ArrivalTrace)
    assert len(ours) > 0
    assert _same(_trace(ours), _trace(theirs))


def test_trace_validation_equals_the_reference():
    for A in (load.ArrivalTrace, jload.ArrivalTrace):
        with pytest.raises(ValueError, match="peak_factor"):
            A.diurnal(RATES, 5.0, peak_factor=0.5)
        with pytest.raises(ValueError, match="2 rate states"):
            A.mmpp(RATES, 5.0, state_factors=(1.0,))
        with pytest.raises(ValueError, match="mean_dwell"):
            A.mmpp(RATES, 5.0, mean_dwell=(1.0, 2.0, 3.0))


# --------------------------------------------------------------------------
# the harness
# --------------------------------------------------------------------------

def _report(rep) -> tuple:
    """Every field and aggregate of a ``LoadReport``."""
    return (rep.status, rep.start, rep.finish, rep.clock_end,
            [dataclasses.asdict(s) for s in rep.specs],
            dataclasses.asdict(rep.config), rep.arrived, rep.completed,
            rep.rejected, rep.shed, rep.in_flight, rep.queued,
            rep.admitted, rep.conservation_ok(), rep.latencies(),
            rep.waits(), rep.percentile(50), rep.percentile(99),
            rep.slo_violations(), rep.slo_violation_rate(),
            rep.utilization(), rep.throughput(), rep.per_tenant(),
            repr(rep))


CONFIGS = {
    "admission": dict(servers=1, queue_capacity=16, max_wait=0.5),
    "unbounded": dict(servers=2, shed_doomed=False),
    "quantum": dict(servers=1, queue_capacity=64, quantum=0.02),
    "no_drain": dict(servers=1, queue_capacity=32, drain=False),
}


def _fixed_run(pkg, cfg):
    L = pkg["load"]
    tr = L.ArrivalTrace.mmpp(RATES, horizon=20.0, seed=9).scaled(1.5)
    svc = L.FixedServiceModel({"chat": 0.012, "batch": 0.04,
                               "embed": 0.006})
    specs = [L.TenantSpec("chat", slo=0.25, weight=2.0),
             L.TenantSpec("batch", slo=1.0),
             L.TenantSpec("embed", weight=0.5)]
    rec = pkg["telemetry"].TelemetryRecorder("load")
    h = L.OpenLoopHarness(tr, specs, svc, L.LoadConfig(**CONFIGS[cfg]),
                          telemetry=rec)
    rep = h.run()
    return (_report(rep), [e.canonical() for e in rec.events],
            pkg["harness"].derive_priorities(specs), repr(svc))


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_load_reports_equal_the_reference(cfg):
    ours, theirs = (_fixed_run(pkg, cfg) for pkg in PACKAGES)
    assert ours[0][7] > 0 and ours[1]
    assert _same(ours, theirs)


def _plan_priced(pkg):
    """``PlanServiceModel`` over a membership-keyed ``PlanCache`` under a
    crash and a return, recorded."""
    L, edge = pkg["load"], pkg["edge"]
    rec = pkg["telemetry"].TelemetryRecorder("priced")
    cluster = edge.paper_cluster()
    ctl = pkg["fleet"].FleetController(cluster, pkg["fleet"].ChurnTrace
                                       .scripted([(2.0, "tx2", "crash"),
                                                  (5.0, "tx2", "join")]),
                                       telemetry=rec)
    cache = pkg["serving"].PlanCache(pkg["hidp"].HiDPPlanner(), cluster,
                                     membership_source=ctl, telemetry=rec)
    specs = {
        "resnet": L.TenantSpec("resnet", slo=60.0, weight=2.0,
                               dag=edge.EDGE_MODELS["resnet152"](),
                               delta=edge.MODEL_DELTA["resnet152"]),
        "vgg": L.TenantSpec("vgg", slo=90.0, dag=edge.EDGE_MODELS["vgg19"](),
                            delta=edge.MODEL_DELTA["vgg19"],
                            objective="energy"),
    }
    model = L.PlanServiceModel(cache, specs)
    tr = L.ArrivalTrace.poisson({"resnet": 2.0, "vgg": 1.0}, horizon=8.0,
                                seed=5)
    h = L.OpenLoopHarness(tr, specs, model,
                          L.LoadConfig(queue_capacity=32, max_wait=200.0,
                                       shed_doomed=False),
                          fleet=ctl, telemetry=rec)
    rep = h.run()
    stats = cache.stats()
    stats.pop("nbytes")          # the JSON of plans with planning_seconds
    return (_report(rep), [e.canonical() for e in rec.events],
            model.resolutions, h.epochs_seen, stats, repr(model))


def test_plan_priced_churn_run_equals_the_reference():
    ours, theirs = (_plan_priced(pkg) for pkg in PACKAGES)
    assert ours[3] == 2 and ours[2] == 6
    assert _same(ours, theirs)


def test_mix_capacity_equals_the_reference():
    svc = {"chat": 0.010, "batch": 0.030, "embed": 0.004}
    for servers in (1, 3):
        assert load.mix_capacity(svc, RATES, servers=servers) == \
            jload.mix_capacity(svc, RATES, servers=servers)
    assert load.mix_capacity(svc, {"chat": 0.0}) == \
        jload.mix_capacity(svc, {"chat": 0.0})


def _sweep(pkg, churn):
    L = pkg["load"]
    tr = L.ArrivalTrace.poisson({"chat": 20.0, "batch": 10.0},
                                horizon=15.0, seed=7)
    specs = [L.TenantSpec("chat", slo=0.15, weight=2.0),
             L.TenantSpec("batch", slo=0.5)]
    factory = None
    if churn:
        def factory():
            return pkg["fleet"].FleetController(
                pkg["edge"].paper_cluster(), pkg["fleet"].ChurnTrace.poisson(
                    ["tx2", "nano", "rpi5"], rate=0.5, horizon=15.0,
                    seed=3))
    rec = pkg["telemetry"].TelemetryRecorder("sweep")
    pts = L.saturation_sweep(tr, specs,
                             L.FixedServiceModel({"chat": 0.010,
                                                  "batch": 0.030}),
                             [0.5, 1.0, 2.0, 4.0],
                             L.LoadConfig(queue_capacity=64, max_wait=1.0),
                             fleet_factory=factory, telemetry=rec)
    return ([(p.factor, p.offered, p.throughput, p.p50, p.p99, p.goodput,
              p.loss_rate, p.row(), _report(p.report)) for p in pts],
            [e.canonical() for e in rec.events])


@pytest.mark.parametrize("churn", [False, True], ids=["static", "churn"])
def test_saturation_points_equal_the_reference(churn):
    ours, theirs = (_sweep(pkg, churn) for pkg in PACKAGES)
    assert len(ours[0]) == 4 and ours[0][-1][6] > 0   # loss at 4x
    assert _same(ours, theirs)


# --------------------------------------------------------------------------
# the JAX package's own cases, run on the port
# --------------------------------------------------------------------------

LOAD_CASES = (
    "test_poisson_trace_is_seeded_and_replayable",
    "test_poisson_offered_rates_match_requested",
    "test_per_tenant_streams_are_independent",
    "test_diurnal_trace_swings_between_trough_and_peak",
    "test_burst_trace_is_overdispersed",
    "test_merge_pools_same_named_tenants_and_stays_sorted",
    "test_scaled_compresses_time_and_multiplies_offered_load",
    "test_window_reanchors_at_zero", "test_trace_validation",
    "test_underload_completes_everything_within_slo",
    "test_admission_control_rejects_when_queue_full",
    "test_free_lane_is_never_rejected_even_with_zero_waiting_room",
    "test_max_wait_bounds_every_admitted_requests_queue_age",
    "test_doomed_shedding_makes_served_traffic_meet_slo",
    "test_drain_false_leaves_backlog_accounted",
    "test_per_tenant_fifo_no_reordering",
    "test_strict_priority_across_classes",
    "test_slo_derived_priorities_and_explicit_override",
    "test_wdrr_shares_service_by_weight_under_backlog",
    "test_wdrr_weights_do_not_starve_light_tenants",
    "test_mix_capacity_and_saturation_sweep_shape",
    "test_spec_and_config_validation",
    "test_multi_server_utilization_and_speedup",
    "test_queueing_invariants_seeded_fallback",
    "test_trace_identity_seeded_fallback",
    "test_wdrr_fairness_seeded_fallback",
    "test_two_seeded_replays_emit_byte_identical_canonical_logs",
    "test_run_store_reconstructs_the_saturation_story",
    "test_churn_composition_one_frontier_pass_per_tenant_per_epoch",
    "test_backpressure_engages_instead_of_deadlocking_under_capacity_drop",
    "test_churn_composed_replays_are_byte_identical")


@pytest.mark.parametrize("case", LOAD_CASES)
def test_load_cases_on_the_port(case, tmp_path):
    call_case(getattr(on_port(load_cases), case), tmp_path=tmp_path)
