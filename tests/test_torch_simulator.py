"""The port's copies of the paper's evaluation layer in ``core`` — the
§IV-A baselines (``baselines``), the event-driven edge simulator
(``simulator``) and the leader/follower scheduler FSMs (``scheduler``) —
held equal to the JAX package's on the same inputs.

Plans, fronts, FSM traces, records and spans are compared by exact
equality (the copies keep every float operation in the original's order;
``planning_seconds`` is wall clock and left out).  The cases of
``tests/test_simulator.py`` and the simulator cases of
``tests/test_energy.py`` run on the port as well (``on_port``).
"""

import dataclasses

import pytest

import test_energy as energy_cases
import test_simulator as simulator_cases
from _port_alias import call_case, on_port
from repro import fleet as jfleet
from repro import profiling as jprofiling
from repro import serving as jserving
from repro.core import baselines as jbaselines
from repro.core import edge_models as jedge
from repro.core import hidp as jhidp
from repro.core import scheduler as jscheduler
from repro.core import simulator as jsimulator
from repro.core.cluster import ClusterManager as JClusterManager
from repro_torch import fleet, profiling, serving
from repro_torch.core import (baselines, edge_models, hidp, scheduler,
                              simulator)
from repro_torch.core.cluster import ClusterManager

PORT = dict(baselines=baselines, edge=edge_models, hidp=hidp,
            scheduler=scheduler, simulator=simulator, fleet=fleet,
            profiling=profiling, serving=serving, manager=ClusterManager)
JAX = dict(baselines=jbaselines, edge=jedge, hidp=jhidp,
           scheduler=jscheduler, simulator=jsimulator, fleet=jfleet,
           profiling=jprofiling, serving=jserving, manager=JClusterManager)
PACKAGES = (PORT, JAX)

MODELS = sorted(jedge.EDGE_MODELS)
STRATS = ("hidp", "modnn", "omniboost", "disnet")
CHURN = [(0.4, "tx2", "crash"), (3.0, "tx2", "join"),
         (4.0, "nano", "leave"), (6.0, "nano", "join")]


def _plan(p) -> dict:
    """Its own package's ``plan_to_dict`` without the wall-clock
    ``planning_seconds``."""
    own = hidp if type(p).__module__.startswith("repro_torch.") else jhidp
    d = own.plan_to_dict(p)
    d.pop("planning_seconds")
    return d


# --------------------------------------------------------------------------
# baselines
# --------------------------------------------------------------------------

def test_strategy_tables_name_the_same_strategies():
    assert list(baselines.STRATEGIES) == list(jbaselines.STRATEGIES)
    assert list(baselines.STRATEGY_FRONTS) == \
        list(jbaselines.STRATEGY_FRONTS)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("strategy", STRATS)
def test_strategy_plans_equal_the_reference(strategy, model):
    ours, theirs = (
        pkg["baselines"].STRATEGIES[strategy](
            pkg["edge"].EDGE_MODELS[model](), pkg["edge"].paper_cluster(),
            pkg["edge"].MODEL_DELTA[model])
        for pkg in PACKAGES)
    assert _plan(ours) == _plan(theirs)
    assert ours.predicted_latency > 0


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("strategy", STRATS)
def test_strategy_fronts_equal_the_reference(strategy, model):
    ours, theirs = (
        [(p.latency, p.energy, _plan(p.plan)) for p in
         pkg["baselines"].STRATEGY_FRONTS[strategy](
             pkg["edge"].EDGE_MODELS[model](), pkg["edge"].paper_cluster(),
             pkg["edge"].MODEL_DELTA[model]).points]
        for pkg in PACKAGES)
    assert ours and ours == theirs


def test_mcts_pipeline_equals_the_reference_under_its_seed():
    """OmniBoost's search draws from ``random.Random(seed)``: the same
    seed walks the same tree in both packages."""
    from repro.core.cost_model import node_as_resource as jres
    from repro_torch.core.cost_model import node_as_resource as res
    for seed in (0, 1, 7):
        for stages in (2, 3):
            ours, theirs = (
                dataclasses.asdict(pkg["baselines"]._mcts_pipeline(
                    pkg["edge"].vgg19(),
                    [r(n, 1.0) for n in pkg["edge"].paper_cluster().nodes],
                    budget=64, seed=seed, max_stages=stages))
                for pkg, r in ((PORT, res), (JAX, jres)))
            assert ours == theirs


# --------------------------------------------------------------------------
# simulator
# --------------------------------------------------------------------------

def _workload(pkg, n=6):
    names = ["resnet152", "vgg19", "efficientnet_b0"]
    edge = pkg["edge"]
    return [pkg["simulator"].SimRequest(
        i, edge.EDGE_MODELS[names[i % 3]](), 0.7 * i,
        edge.MODEL_DELTA[names[i % 3]], slo=2.0) for i in range(n)]


def _report(rep) -> tuple:
    return ([dataclasses.asdict(r) for r in rep.records],
            [dataclasses.asdict(s) for s in rep.spans],
            rep.latencies(), rep.energies(), rep.predicted_energies(),
            rep.prediction_error(), rep.total_retries(),
            rep.total_migrations(), rep.slo_violations(), rep.makespan(),
            rep.gflops_timeline(0.25), rep.completed_by(3.0))


def _churn_sim(pkg, strategy):
    edge = pkg["edge"]
    ctl = pkg["fleet"].FleetController(
        edge.paper_cluster(), pkg["fleet"].ChurnTrace.scripted(CHURN))
    sim = pkg["simulator"].EdgeSimulator(edge.paper_cluster(), strategy,
                                         fleet=ctl, planning_time=0.0)
    return _report(sim.run(_workload(pkg))), sim.leader_elections, \
        sim.medium_spans, sim.radio_energy


@pytest.mark.parametrize("strategy", STRATS)
def test_simulated_churn_run_equals_the_reference(strategy):
    ours, theirs = (_churn_sim(pkg, strategy) for pkg in PACKAGES)
    assert ours[0][6] > 0                          # the crash forced a retry
    assert ours == theirs


@pytest.mark.parametrize("strategy", STRATS)
def test_simulate_single_requests_equal_the_reference(strategy):
    """The paper's Fig. 5 cell: every model alone on ``paper_cluster()``."""
    for model in MODELS:
        ours, theirs = (_report(pkg["simulator"].simulate(
            pkg["edge"].paper_cluster(), strategy,
            [(0.0, pkg["edge"].EDGE_MODELS[model](),
              pkg["edge"].MODEL_DELTA[model])], planning_time=0.0))
            for pkg in PACKAGES)
        assert ours == theirs


def _cached_sim(pkg):
    """hidp through a membership-keyed ``PlanCache`` under churn, with a
    ground truth that diverges from the datasheet and a feedback loop."""
    edge = pkg["edge"]
    cluster = edge.paper_cluster()
    ctl = pkg["fleet"].FleetController(
        cluster, pkg["fleet"].ChurnTrace.scripted(CHURN))
    cache = pkg["serving"].PlanCache(pkg["hidp"].HiDPPlanner(), cluster,
                                     membership_source=ctl)
    gt = pkg["profiling"].SyntheticGroundTruth(
        cluster, rate_scale={"tx2": 0.7}, power_scale={"orin_nx": 1.5})
    sim = pkg["simulator"].EdgeSimulator(cluster, "hidp", plan_cache=cache,
                                         fleet=ctl, ground_truth=gt,
                                         planning_time=0.0)
    rep = sim.run(_workload(pkg, n=8))
    stats = cache.stats()
    stats.pop("nbytes")          # the JSON of plans with planning_seconds
    return _report(rep), stats


def test_simulated_plan_cache_run_equals_the_reference():
    ours, theirs = (_cached_sim(pkg) for pkg in PACKAGES)
    assert ours[1]["misses"] > 0 and ours[1]["hits"] > 0
    assert ours == theirs


def test_simulator_rejects_what_the_reference_rejects():
    for pkg in PACKAGES:
        cluster = pkg["edge"].paper_cluster()
        cache = pkg["serving"].PlanCache(pkg["hidp"].HiDPPlanner(), cluster)
        with pytest.raises(ValueError, match="cannot simulate strategy"):
            pkg["simulator"].EdgeSimulator(cluster, "modnn",
                                           plan_cache=cache)
        with pytest.raises(ValueError, match="planning_time"):
            pkg["simulator"].EdgeSimulator(cluster, planning_time=-1.0)


# --------------------------------------------------------------------------
# leader / follower FSMs
# --------------------------------------------------------------------------

class _Link:
    """A transport over an 80 MB/s link that logs every send."""

    def __init__(self):
        self.sent = []

    def send(self, src, dst, nbytes, payload, now):
        self.sent.append((src, dst, nbytes, payload, now))
        return now if src == dst else now + nbytes / 80e6


def _fsm_cycle(pkg):
    """Two requests through the leader FSM (the leader dies between them)
    and every follower's shard through a follower FSM."""
    edge, sch = pkg["edge"], pkg["scheduler"]
    mgr = pkg["manager"](edge.paper_cluster())
    mgr.elect_leader("orin_nx")
    link = _Link()
    fsm = sch.LeaderFSM(manager=mgr, transport=link)
    out = []
    for i, (now, model, down) in enumerate(
            ((0.0, "resnet152", None), (5.0, "vgg19", "orin_nx"))):
        for n in mgr.nodes():
            if n.name != down:
                mgr.monitor.beat(n.name, now)
        if down is not None:
            mgr.set_available(down, False)
        req = sch.InferenceRequest(i, edge.EDGE_MODELS[model](), now,
                                   edge.MODEL_DELTA[model])
        p = fsm.on_request(req, now)
        sent = fsm.offload(now)
        lp = fsm.local_map(now)
        follow = []
        for dst, arrive, stage in sent:
            a = p.global_plan.assignments[stage]
            f = sch.FollowerFSM(node=a.node, transport=link)
            flp = f.on_shard(pkg["hidp"].sub_dag_for(req.dag, a),
                             req.delta, arrive)
            back = f.report(mgr.leader, 1024.0, ("done", i, stage),
                            arrive + flp.predicted_latency)
            follow.append((dataclasses.asdict(flp), back, f.state.value))
        done = [fsm.on_shard_result(sch.ShardResult(
            i, a.node.name, a.stage_index, None, now + 1.0), now + 1.0)
            for a in p.global_plan.assignments]
        out.append((_plan(p), sent, dataclasses.asdict(lp), follow, done,
                    mgr.leader, fsm.state.value))
    return (out, [(t, s.value) for t, s in fsm.trace], link.sent,
            [(r.request_id, r.node_name, r.stage_index) for r in fsm.results])


def test_fsm_cycle_equals_the_reference():
    ours, theirs = (_fsm_cycle(pkg) for pkg in PACKAGES)
    assert ours[0][1][5] != "orin_nx"              # the leader failed over
    assert len(ours[1]) == 12 and ours[2]          # six states a request
    assert ours == theirs
    assert [s.value for s in scheduler.State] == \
        [s.value for s in jscheduler.State]


def test_fsm_refuses_a_fleet_with_no_node_alive():
    for pkg in PACKAGES:
        mgr = pkg["manager"](pkg["edge"].paper_cluster())
        for n in mgr.nodes():
            mgr.set_available(n.name, False)
        fsm = pkg["scheduler"].LeaderFSM(manager=mgr, transport=_Link())
        req = pkg["scheduler"].InferenceRequest(
            0, pkg["edge"].resnet152(), 0.0)
        with pytest.raises(RuntimeError, match="no available node"):
            fsm.on_request(req, 100.0)


# --------------------------------------------------------------------------
# the JAX package's own cases, run on the port
# --------------------------------------------------------------------------

SIMULATOR_CASES = (
    "test_hidp_lowest_latency_all_models",
    "test_hidp_lowest_energy_all_models",
    "test_queueing_increases_latency_under_load",
    "test_node_scaling_monotone_for_hidp",
    "test_gflops_timeline_integrates_to_total_work",
    "test_leader_fsm_full_cycle", "test_heartbeat_availability",
    "test_manager_failure_masks_node")
ENERGY_CASES = (
    "test_simulator_meters_ground_truth_energy",
    "test_simulator_feeds_energy_observations")


@pytest.mark.parametrize("case", SIMULATOR_CASES)
def test_simulator_cases_on_the_port(case):
    call_case(getattr(on_port(simulator_cases), case))


@pytest.mark.parametrize("case", ENERGY_CASES)
def test_energy_cases_on_the_port(case):
    call_case(getattr(on_port(energy_cases), case))
