"""The port's copies of the fleet layer — ``core.cluster``,
``core.edge_models``, ``fleet.traces``, ``fleet.controller`` and the
telemetry ``events``/``recorder`` — held equal to the JAX package's on the
same stdlib inputs, by exact equality.

The behavioural cases of ``tests/test_cluster.py``, ``tests/test_fleet.py``
and ``tests/test_telemetry.py`` run here on the port's classes: each test
module is re-executed with ``repro`` resolved to ``repro_torch``
(``_port_alias.on_port``), so the cases are the same code, not copies of
it.
"""

import dataclasses
import sys

import pytest

import test_cluster as cluster_cases
import test_fleet as fleet_cases
import test_telemetry as telemetry_cases
from _port_alias import call_case, on_port
from repro import fleet as jfleet
from repro import telemetry as jtelemetry
from repro.core import cluster as jcluster
from repro.core import edge_models as jedge
from repro.core.fingerprint import (cluster_fingerprint as jcluster_fp,
                                    dag_fingerprint as jdag_fp,
                                    membership_fingerprint as jmember_fp)
from repro_torch import fleet, telemetry
from repro_torch.core import cluster, edge_models
from repro_torch.core.fingerprint import (cluster_fingerprint, dag_fingerprint,
                                          membership_fingerprint)


def _on(fn, package: str):
    """``fn`` itself for ``"repro"``; for ``"repro_torch"`` the same case
    of its module re-executed with ``repro`` resolved to the port
    (``on_port``)."""
    if package == "repro":
        return fn
    return getattr(on_port(sys.modules[fn.__module__]), fn.__name__)


def _cases(module, names):
    return [pytest.param(getattr(module, n), id=n) for n in names]


# --------------------------------------------------------------------------
# core.cluster: tests/test_cluster.py on both packages
# --------------------------------------------------------------------------

CLUSTER_CASES = _cases(cluster_cases, (
    "test_expiry_at_exactly_the_timeout_boundary",
    "test_never_seen_node_is_dead_and_beat_revives",
    "test_elect_leader_requires_availability",
    "test_reelection_when_the_leader_dies",
    "test_first_available_none_when_fleet_empty",
    "test_refresh_availability_round_trip",
    "test_set_available_round_trip_and_counts"))


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_cluster_manager_cases(case, package):
    _on(case, package)()


def test_cluster_manager_leader_policy_equals_the_reference():
    """``ensure_leader`` over the same sequence of availability changes
    seats the same leaders in both packages."""
    ops = [("ensure", None), ("down", "orin_nx"), ("ensure", None),
           ("ensure", "nano"), ("down", "nano"), ("ensure", "rpi5"),
           ("up", "orin_nx"), ("ensure", "orin_nx"), ("down", "tx2"),
           ("refresh", 3.0), ("ensure", None)]

    def run(mgr):
        seen = []
        for n in mgr.nodes():
            mgr.monitor.beat(n.name, 1.0)
        for op, arg in ops:
            if op == "ensure":
                seen.append(mgr.ensure_leader(arg))
            elif op == "refresh":
                seen.append(mgr.refresh_availability(arg).availability())
            else:
                mgr.set_available(arg, op == "up")
            seen.append((mgr.leader, mgr.available_count(),
                         getattr(mgr.first_available(), "name", None)))
        return seen

    assert run(cluster.ClusterManager(edge_models.paper_cluster())) == \
        run(jcluster.ClusterManager(jedge.paper_cluster()))


# --------------------------------------------------------------------------
# core.edge_models: the zoo and the boards
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jedge.EDGE_MODELS))
def test_edge_model_dags_equal_the_jax_digests(name):
    ours, theirs = edge_models.EDGE_MODELS[name](), jedge.EDGE_MODELS[name]()
    assert dag_fingerprint(ours) == jdag_fp(theirs)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert edge_models.MODEL_DELTA[name] == jedge.MODEL_DELTA[name]


@pytest.mark.parametrize("kind", ["paper_cluster", "battery_cluster"])
def test_edge_clusters_equal_the_jax_digests(kind):
    for n in range(1, 6):
        ours = getattr(edge_models, kind)(n)
        theirs = getattr(jedge, kind)(n)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert cluster_fingerprint(ours) == jcluster_fp(theirs)
        assert membership_fingerprint(ours) == jmember_fp(theirs)
    assert cluster_fingerprint(edge_models.battery_cluster(idle_scale=0.2)) \
        == jcluster_fp(jedge.battery_cluster(idle_scale=0.2))


# --------------------------------------------------------------------------
# fleet.traces
# --------------------------------------------------------------------------

NAMES = ("orin_nx", "tx2", "nano", "rpi5", "rpi4")

TRACES = {
    "scripted": lambda m: m.ChurnTrace.scripted(
        [(2.0, "nano", "join"), (1.0, "tx2", "crash"),
         (1.0, "rpi4", "leave"), m.ChurnEvent(3.5, "tx2", "join")]),
    "poisson": lambda m: m.ChurnTrace.poisson(NAMES, rate=0.5,
                                              horizon=200.0, seed=7),
    "poisson_protected": lambda m: m.ChurnTrace.poisson(
        NAMES, rate=2.0, horizon=40.0, seed=3, crash_fraction=0.2,
        protect=["orin_nx"]),
    "battery": lambda m: m.ChurnTrace.battery(
        NAMES[1:], drain_after=10.0, recharge_after=5.0, horizon=60.0,
        stagger=1.5),
    "thermal": lambda m: m.ChurnTrace.thermal(
        ["tx2", "nano"], throttle_after=3.0, cool_after=2.0, horizon=30.0),
    "merged": lambda m: m.ChurnTrace.poisson(
        NAMES, rate=0.3, horizon=50.0, seed=11).merge(
            m.ChurnTrace.battery(["rpi5"], 7.0, 3.0, 50.0),
            m.ChurnTrace.thermal(["nano"], 4.0, 4.0, 50.0)),
}


def _events(trace):
    return [(e.time, e.node, e.kind, e.goes_down, e.is_failure)
            for e in trace]


@pytest.mark.parametrize("name", sorted(TRACES))
def test_churn_traces_equal_the_reference_event_for_event(name):
    ours, theirs = TRACES[name](fleet), TRACES[name](jfleet)
    assert len(ours) > 0
    assert _events(ours) == _events(theirs)
    assert repr(ours) == repr(theirs)
    assert _events(ours.window(1.0, 20.0)) == \
        _events(theirs.window(1.0, 20.0))


def test_churn_kind_sets_equal_the_reference():
    for k in ("DOWN_KINDS", "UP_KINDS", "FAILURE_KINDS", "KINDS"):
        assert getattr(fleet, k) == getattr(jfleet, k)
    with pytest.raises(ValueError, match="unknown churn kind"):
        fleet.ChurnEvent(0.0, "a", "explode")


FLEET_CASES = _cases(fleet_cases, (
    "test_event_kinds_validated", "test_scripted_trace_sorts_and_windows",
    "test_poisson_trace_is_seeded_and_plausible",
    "test_battery_and_thermal_duty_cycles_alternate",
    "test_merge_keeps_time_order",
    "test_controller_epochs_coalesce_and_fingerprint_returns",
    "test_controller_reelects_fallen_leader_and_forgets_feedback",
    "test_controller_noop_epoch_when_events_cancel",
    "test_next_failure_peeks_without_consuming"))


@pytest.mark.parametrize("case", FLEET_CASES)
def test_fleet_cases_on_the_port(case):
    _on(case, "repro_torch")()


# --------------------------------------------------------------------------
# fleet.controller against the reference
# --------------------------------------------------------------------------

class _Forget:
    """A FeedbackLoop stand-in that records which nodes it forgot."""

    def __init__(self):
        self.forgotten = []

    def forget_resource(self, node):
        self.forgotten.append(node)
        return 0


def _replay(pkg, edge, tel, trace_name, leader):
    """Advance a controller over ``TRACES[trace_name]`` on a half-second
    grid; return everything it exposes, in order."""
    rec = tel.TelemetryRecorder("fleet")
    spy = _Forget()
    seen = []
    ctl = pkg.FleetController(edge.battery_cluster(), TRACES[trace_name](pkg),
                              leader=leader, feedback=spy, telemetry=rec,
                              on_epoch=lambda ep: seen.append(("cb",
                                                               ep.epoch)))
    ctl.add_epoch_hook(lambda ep: seen.append(("hook", ep.available())))
    out = []
    for i in range(1, 121):
        now = 0.5 * i
        peek = ctl.next_failure(now, now + 5.0, NAMES)
        applied = ctl.advance(now)
        out.append((now, _events(applied), ctl.epoch, ctl.leader,
                    ctl.membership_mask(), ctl.membership_fingerprint(),
                    ctl.available_names(), ctl.leader_elections,
                    None if peek is None else _events([peek]), repr(ctl)))
    epochs = [(ep.epoch, ep.time, ep.mask, ep.fingerprint, ep.leader,
               _events(ep.events)) for ep in ctl.epochs]
    return (out, epochs, seen, spy.forgotten,
            [e.canonical() for e in rec.events],
            membership_fingerprint(ctl.cluster) if pkg is fleet
            else jmember_fp(ctl.cluster))


@pytest.mark.parametrize("trace_name,leader", [
    ("poisson", None), ("poisson_protected", "orin_nx"),
    ("merged", "nano"), ("scripted", "tx2")])
def test_fleet_controller_equals_the_reference(trace_name, leader):
    ours = _replay(fleet, edge_models, telemetry, trace_name, leader)
    theirs = _replay(jfleet, jedge, jtelemetry, trace_name, leader)
    assert len(ours[1]) > 1                       # the trace made epochs
    for a, b in zip(ours, theirs):
        assert a == b


# --------------------------------------------------------------------------
# telemetry.events / telemetry.recorder
# --------------------------------------------------------------------------

TELEMETRY_CASES = _cases(telemetry_cases, (
    "test_event_schema_and_canonical_projection",
    "test_recorder_seq_clock_and_counts",
    "test_recorder_flush_every_and_close"))


@pytest.mark.parametrize("case", TELEMETRY_CASES)
def test_telemetry_cases_on_the_port(case, tmp_path):
    """The recorder flushes into the port's ``RunStore``."""
    call_case(_on(case, "repro_torch"), tmp_path=tmp_path)


class _ListStore:
    """The two methods a recorder calls on its store."""

    def __init__(self):
        self.appended, self.manifests = [], []

    def append(self, run, events):
        self.appended.append((run, [e.canonical() for e in events]))
        return len(events)

    def write_manifest(self, run, manifest):
        self.manifests.append((run, manifest))


def _record(tel):
    """Every emission path of a recorder, in one deterministic script."""
    store = _ListStore()
    rec = tel.TelemetryRecorder("script", store=store, flush_every=4)
    rec.counter("plan_cache.hit", tenant="toy", key="a")
    rec.advance(2.5)
    with rec.trace("engine.resolve", tenant="toy", request=0) as h:
        rec.counter("engine.submit", resolved="miss")
        with rec.trace("dp.pass", t=1.0, wall=True):
            rec.gauge("fleet.membership", 4.0, epoch=1, leader="orin_nx")
        cid = rec.child_span("stage", 0.25, node="tx2")
        rec.span("leaf", 0.5, parent_id=cid, epoch=2)
        h.set(0.75, epoch=1, ok=True)
    sid = rec.allocate_span()
    rec.span("sim.request", 1.5, span_id=sid, parent_id=None)
    with rec.timed("kernel.profile", kind="attn"):
        rec.gauge("drift", 0.1, parent_id=None)
    rec.advance(1.0)                              # the clock never rewinds
    rec.counter("elastic.replan", 2.0, t=9.0, reason="drift")
    n = rec.flush()
    rec.close(cluster="battery")
    rec.close()                                   # idempotent
    off = tel.TelemetryRecorder("off", enabled=False)
    with off.trace("x") as oh:
        off.counter("y")
    return ([e.canonical() for e in rec.events], store.appended,
            store.manifests, n, rec.clock, rec.current_span(), repr(rec),
            off.events, oh.span_id, off.child_span("z", 1.0),
            tel.active(off), tel.active(None) is None,
            tel.active(rec) is rec, tel.KINDS, tel.WALL_FIELDS)


def test_recorder_events_equal_the_reference_in_canonical_projection():
    ours, theirs = _record(telemetry), _record(jtelemetry)
    assert len(ours[0]) == 11 and ours[2]
    assert ours == theirs
    ev = telemetry.TelemetryEvent.from_json(
        jtelemetry.TelemetryEvent(seq=1, kind="gauge", name="g", value=2.0,
                                  attrs={"a": 1}, wall=3.0,
                                  wall_s=0.5).to_json())
    assert ev.canonical() == jtelemetry.TelemetryEvent.from_dict(
        ev.to_dict()).canonical()
