"""The port's serving engine: the tests of test_serving.py on the port's
engine (CPU), greedy-token parity with the JAX engine on the same weights,
and the serving CLI.

The engine takes its PlanCache, FeedbackLoop, FleetController and
telemetry recorder as objects and never imports their classes: most tests
hand it the JAX package's (pure Python); three hand it the port's own
PlanCache, with its FeedbackLoop or with its FleetController and
TelemetryRecorder on the churn path.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.serving.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.scheduler import State  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_lm():
    jmodel = jbuild_model(jget_config("gemma-2b").reduced())
    return jmodel, jmodel.init(jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def small_lm(jax_lm):
    """The reduced gemma-2b of test_serving.py, its JAX weights converted."""
    cfg = get_config("gemma-2b").reduced()
    params = from_jax(jax.tree.map(np.asarray, jax_lm[1]), device="cpu")
    return cfg, build_model(cfg), params


def _engine(model, params, **kw):
    return ServingEngine(model, params, device="cpu", **kw)


def _reference_greedy(model, params, prompt, n_new):
    """Full-forward greedy decoding (no cache) — the exactness oracle."""
    toks = list(map(int, prompt))
    for _ in range(n_new):
        logits = model.apply_train(
            params, {"tokens": torch.tensor([toks], dtype=torch.int32)})
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def test_engine_single_request_matches_reference(small_lm):
    cfg, model, params = small_lm
    prompt = np.asarray([5, 9, 2, 7], np.int32)
    want = _reference_greedy(model, params, prompt, 6)

    eng = _engine(model, params, max_batch=2, max_len=32)
    rid = eng.submit(prompt, max_new_tokens=6)
    done = eng.run_until_done()
    got = done[rid].generated[:6]
    assert got == want, (got, want)


def test_engine_batches_multiple_requests(small_lm):
    cfg, model, params = small_lm
    eng = _engine(model, params, max_batch=2, max_len=32)
    prompts = [np.asarray(p, np.int32) for p in
               ([1, 2, 3], [9, 8, 7, 6], [4, 4], [11, 3, 5, 2, 1])]
    wants = [_reference_greedy(model, params, p, 4) for p in prompts]
    rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
    done = eng.run_until_done()
    assert len(done) == 4                      # queue drained via slot reuse
    for rid, want in zip(rids, wants):
        assert done[rid].generated[:4] == want


def test_engine_respects_max_len(small_lm):
    cfg, model, params = small_lm
    eng = _engine(model, params, max_batch=1, max_len=12)
    rid = eng.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=100)
    done = eng.run_until_done()
    assert done[rid].done
    assert 3 + len(done[rid].generated) <= 12 + 1


def test_engine_feedback_reenters_explore_on_drift(small_lm):
    """A cost model that wildly underestimates decode latency drifts
    immediately; the engine re-enters EXPLORE and fires the re-plan hook,
    and the refitted model then tracks the measured step times."""
    from repro.profiling import FeedbackLoop, LearnedCostModel

    cfg, model, params = small_lm
    beliefs = LearnedCostModel()
    beliefs.fit_entry("engine/decode", "decode",
                      [(1.0, 0.0, 1e-9), (2.0, 0.0, 2e-9)])
    replans = []
    fb = FeedbackLoop(beliefs, threshold=0.75,
                      on_drift=lambda: replans.append(fb.observations))
    eng = _engine(model, params, max_batch=1, max_len=64, feedback=fb,
                  on_replan=lambda: None)
    rid = eng.submit(np.asarray([5, 9, 2], np.int32), max_new_tokens=40)
    done = eng.run_until_done()
    assert done[rid].done
    assert eng.replans >= 1 and replans
    assert State.EXPLORE in eng.trace
    pred = beliefs.predict("engine/decode", "decode", 1.0, 0.0)
    assert pred is not None and pred > 1e-7
    # every decode step was timed; step 1 never reached the loop
    assert len(eng.decode_seconds) == eng._decode_steps
    assert fb.observations == eng._decode_steps - 1


def test_dominant_objective_tie_break_is_deterministic(small_lm):
    """Ties resolve by the fixed METRICS order (latency > energy > edp)."""
    cfg, model, params = small_lm
    eng = _engine(model, params, max_batch=2, max_len=32)
    eng.submit(np.asarray([1], np.int32), max_new_tokens=2, objective="edp")
    eng.submit(np.asarray([2], np.int32), max_new_tokens=2,
               objective="energy")
    assert eng.dominant_objective() == "energy"
    eng.submit(np.asarray([3], np.int32), max_new_tokens=2,
               objective="latency")
    assert eng.dominant_objective() == "latency"
    eng.submit(np.asarray([4], np.int32), max_new_tokens=2, objective="edp")
    eng.submit(np.asarray([5], np.int32), max_new_tokens=2, objective="edp")
    assert eng.dominant_objective() == "edp"


def _toy_cache():
    """A PlanCache over the paper cluster for a small synthetic workload."""
    from repro.core import (Block, HiDPPlanner, ModelDAG, Objective,
                            PlannerConfig)
    from repro.core.edge_models import battery_cluster
    from repro.serving import PlanCache

    blocks = tuple(Block(name=f"b{i}", flops=2e9, param_bytes=1e6,
                         bytes_in=4e5, bytes_out=4e5, kind="conv")
                   for i in range(6))
    dag = ModelDAG(name="toy", blocks=blocks, input_bytes=4e5,
                   output_bytes=4e5)
    planner = HiDPPlanner(PlannerConfig(
        objective=Objective("energy", radio_power=4.0)))
    return PlanCache(planner, battery_cluster()), dag


def test_engine_submit_resolves_objectives_from_plan_cache(small_lm):
    """Mixed-objective traffic is served from one cached frontier: the
    first submit pays the DP pass, every later submit is a hit."""
    from repro.core import Objective

    cfg, model, params = small_lm
    cache, dag = _toy_cache()
    eng = _engine(model, params, max_batch=2, max_len=32, plan_cache=cache,
                  default_dag=dag)
    objectives = ("latency", "energy", "edp", "energy")
    for i, obj in enumerate(objectives):
        eng.submit(np.asarray([i + 1, 2], np.int32), max_new_tokens=2,
                   objective=obj)
    assert cache.misses == 1 and cache.hits == len(objectives) - 1
    want = cache.front(dag).select(Objective("energy"))
    assert eng.plan.global_plan.partition == want.global_plan.partition
    done = eng.run_until_done()
    assert len(done) == len(objectives)
    assert cache.misses == 1                    # execution never re-plans


def test_engine_drift_triggers_exactly_one_cache_replan(small_lm):
    from repro.profiling import FeedbackLoop, LearnedCostModel

    cfg, model, params = small_lm
    cache, dag = _toy_cache()
    beliefs = LearnedCostModel()
    beliefs.fit_entry("engine/decode", "decode",
                      [(1.0, 0.0, 1e-9), (2.0, 0.0, 2e-9)])
    fb = FeedbackLoop(beliefs, threshold=0.75)
    eng = _engine(model, params, max_batch=1, max_len=64, feedback=fb,
                  plan_cache=cache, default_dag=dag)
    rid = eng.submit(np.asarray([5, 9, 2], np.int32), max_new_tokens=40,
                     objective="energy")
    done = eng.run_until_done()
    assert done[rid].done
    assert eng.replans >= 1 and State.EXPLORE in eng.trace
    assert cache.misses == 1 + eng.replans
    assert cache.invalidations == eng.replans
    assert cache.version == eng.replans



def _port_toy_cache():
    """``_toy_cache`` built from the port's own planner and plan cache, over
    ``battery_cluster()`` rebuilt in the port; returns the port's cache and
    tenant beside the JAX package's."""
    from repro_torch.core import HiDPPlanner, Objective, PlannerConfig
    from repro_torch.core.dag import Block, ModelDAG
    from repro_torch.serving.plan_cache import PlanCache
    from test_torch_planner import port_cluster, toy_dag

    jcache, jdag = _toy_cache()
    planner = HiDPPlanner(PlannerConfig(
        objective=Objective("energy", radio_power=4.0)))
    cache = PlanCache(planner, port_cluster(jcache.cluster))
    return cache, toy_dag(Block, ModelDAG), jcache, jdag


def test_engine_resolves_objectives_from_the_ports_plan_cache(small_lm):
    """The port's engine with the port's PlanCache: one frontier pass on the
    first submit, hits for every later objective, and the same plan the JAX
    package's cache selects for the same tenant."""
    from repro.core import plan_to_dict as jplan_to_dict
    from repro_torch.core import Objective, plan_to_dict

    cfg, model, params = small_lm
    cache, dag, jcache, jdag = _port_toy_cache()
    eng = _engine(model, params, max_batch=2, max_len=32, plan_cache=cache,
                  default_dag=dag)
    objectives = ("latency", "energy", "edp", "energy")
    for i, obj in enumerate(objectives):
        eng.submit(np.asarray([i + 1, 2], np.int32), max_new_tokens=2,
                   objective=obj)
    assert cache.misses == 1 and cache.hits == len(objectives) - 1
    want = cache.front(dag).select(Objective("energy"))
    assert eng.plan.global_plan.partition == want.global_plan.partition
    got = plan_to_dict(eng.plan)
    jwant = jplan_to_dict(jcache.get(jdag, objective="energy"))
    for d in (got, jwant):
        d.pop("planning_seconds")
    assert got == jwant
    done = eng.run_until_done()
    assert len(done) == len(objectives)
    assert cache.misses == 1                    # execution never re-plans


def test_engine_drift_replans_once_through_the_ports_loop(small_lm):
    """The port's FeedbackLoop wired to the port's PlanCache: every decode
    step after the first is observed; each drift event bumps the
    calibration version and costs exactly one frontier re-plan."""
    from repro_torch.profiling import FeedbackLoop, LearnedCostModel

    cfg, model, params = small_lm
    cache, dag, _, _ = _port_toy_cache()
    beliefs = LearnedCostModel()
    beliefs.fit_entry("engine/decode", "decode",
                      [(1.0, 0.0, 1e-9), (2.0, 0.0, 2e-9)])
    fb = FeedbackLoop(beliefs, threshold=0.75)
    eng = _engine(model, params, max_batch=1, max_len=64, feedback=fb,
                  plan_cache=cache, default_dag=dag)
    rid = eng.submit(np.asarray([5, 9, 2], np.int32), max_new_tokens=40,
                     objective="energy")
    done = eng.run_until_done()
    assert done[rid].done
    assert fb.observations == len(eng.decode_seconds) - 1 > 0
    assert eng.replans == fb.replans >= 1 and State.EXPLORE in eng.trace
    assert cache.misses == 1 + eng.replans
    assert cache.invalidations == eng.replans
    assert cache.version == eng.replans

def test_engine_drift_replans_each_tenant_exactly_once(small_lm):
    import dataclasses

    from repro.profiling import FeedbackLoop, LearnedCostModel
    from repro_torch.core.fingerprint import dag_fingerprint

    cfg, model, params = small_lm
    cache, dag_a = _toy_cache()
    dag_b = dataclasses.replace(dag_a, name="toy_b",
                                blocks=dag_a.blocks[:-1])
    beliefs = LearnedCostModel()
    beliefs.fit_entry("engine/decode", "decode",
                      [(1.0, 0.0, 1e-9), (2.0, 0.0, 2e-9)])
    fb = FeedbackLoop(beliefs, threshold=0.75)
    eng = _engine(model, params, max_batch=2, max_len=64, feedback=fb,
                  plan_cache=cache)
    ra = eng.submit(np.asarray([5, 9, 2], np.int32), max_new_tokens=40,
                    objective="energy", dag=dag_a)
    rb = eng.submit(np.asarray([1, 4], np.int32), max_new_tokens=40,
                    objective="latency", dag=dag_b)
    done = eng.run_until_done()
    assert done[ra].done and done[rb].done
    assert eng.replans >= 1 and State.EXPLORE in eng.trace
    assert cache.misses == 2 + 2 * eng.replans
    assert cache.invalidations == eng.replans
    assert set(eng.tenant_plans) == {dag_fingerprint(dag_a),
                                     dag_fingerprint(dag_b)}
    assert eng.tenant_plans[dag_fingerprint(dag_a)].dag_name == "toy"
    assert eng.tenant_plans[dag_fingerprint(dag_b)].dag_name == "toy_b"


def test_engine_membership_epoch_replans_each_tenant_once(small_lm):
    from repro.fleet import ChurnTrace, FleetController

    cfg, model, params = small_lm
    cache, dag = _toy_cache()
    fleet = FleetController(cache.cluster, ChurnTrace.scripted(
        [(1.0, "tx2", "leave"), (2.0, "tx2", "join")]))
    cache.membership_source = fleet
    eng = _engine(model, params, max_batch=2, max_len=32, plan_cache=cache,
                  default_dag=dag)
    fleet.on_epoch = lambda ep: eng.on_membership_change(ep)
    eng.submit(np.asarray([1, 2], np.int32), max_new_tokens=4)
    assert cache.misses == 1                 # cold pass, full membership
    fleet.advance(1.5)                       # tx2 leaves → epoch 1
    assert eng.replans == 1 and State.EXPLORE in eng.trace
    assert cache.misses == 2                 # one pass for the new mask
    assert all(a.node.name != "tx2"
               for a in eng.plan.global_plan.assignments)
    fleet.advance(2.5)                       # tx2 returns → epoch 2
    assert eng.replans == 2
    assert cache.misses == 2                 # warm return: zero DP work
    assert cache.hits >= 1
    done = eng.run_until_done()
    assert len(done) == 1


def test_engine_submit_requires_tenant_when_cache_wired(small_lm):
    cfg, model, params = small_lm
    cache, dag = _toy_cache()
    eng = _engine(model, params, max_batch=1, max_len=32, plan_cache=cache)
    with pytest.raises(ValueError, match="tenant"):
        eng.submit(np.asarray([1], np.int32), max_new_tokens=2)
    eng.submit(np.asarray([1], np.int32), max_new_tokens=2, dag=dag)
    assert cache.misses == 1
    plain = _engine(model, params, max_batch=1, max_len=32)
    with pytest.raises(ValueError, match="plan_cache"):
        plain.submit(np.asarray([1], np.int32), max_new_tokens=2, dag=dag)
    with pytest.raises(ValueError, match="plan_cache"):
        _engine(model, params, default_dag=dag)


def test_engine_submit_delta_is_part_of_the_cache_key(small_lm):
    cfg, model, params = small_lm
    cache, dag = _toy_cache()
    cache.front(dag, 70.0)                         # warmed at δ=70
    eng = _engine(model, params, max_batch=2, max_len=32, plan_cache=cache,
                  default_dag=dag)
    eng.submit(np.asarray([1, 2], np.int32), max_new_tokens=2, delta=70.0)
    assert (cache.misses, cache.hits) == (1, 1)    # warm front reused
    eng.submit(np.asarray([3], np.int32), max_new_tokens=2, delta=55.0)
    assert cache.misses == 2                       # new δ → new key
    eng.run_until_done()


def test_engine_per_request_objective(small_lm):
    cfg, model, params = small_lm
    eng = _engine(model, params, max_batch=2, max_len=32)
    assert eng.dominant_objective() == "latency"      # empty engine default
    eng.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=2)
    eng.submit(np.asarray([4, 5], np.int32), max_new_tokens=2,
               objective="energy")
    eng.submit(np.asarray([6], np.int32), max_new_tokens=2,
               objective="energy")
    assert eng.dominant_objective() == "energy"
    with pytest.raises(ValueError):
        eng.submit(np.asarray([7], np.int32), objective="throughput")
    done = eng.run_until_done()
    assert len(done) == 3
    assert eng.dominant_objective() == "latency"      # drained → default


def test_engine_emits_the_jax_engines_greedy_tokens(small_lm, jax_lm):
    """The port's engine and the JAX engine, on the same weights and
    prompts, emit the same greedy tokens.  bf16 rounding differs between
    the two (XLA fuses elementwise ops), so where the tokens first part the
    JAX logits at that step must have a top-1/top-2 margin under 5e-2 —
    a near tie either side may break — and the comparison stops there."""
    cfg, model, params = small_lm
    jmodel, jparams = jax_lm
    prompts = [np.random.default_rng(i).integers(
        0, cfg.vocab, size=n).astype(np.int32)
        for i, n in enumerate((3, 9, 5, 14, 7))]
    n_new = 12
    kw = dict(max_batch=2, max_len=48)
    jeng = JServingEngine(jmodel, jparams, **kw)
    eng = _engine(model, params, **kw)
    jids = [jeng.submit(p, max_new_tokens=n_new) for p in prompts]
    ids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    jdone, done = jeng.run_until_done(), eng.run_until_done()
    compared = _greedy_parity(jax_lm, prompts, [jdone[i] for i in jids],
                              [done[i] for i in ids], n_new)
    # the rule above may stop a sequence early, but most steps compare
    assert compared >= len(prompts) * n_new // 2


def _greedy_parity(jax_lm, prompts, jreqs, reqs, n_new) -> int:
    """Hold each port request's greedy tokens to the JAX request's, up to
    the first step where they part at a JAX top-1/top-2 margin under 5e-2;
    returns the number of tokens compared."""
    jmodel, jparams = jax_lm
    compared = 0
    for p, jreq, req in zip(prompts, jreqs, reqs):
        want, got = jreq.generated, req.generated
        assert len(got) == len(want) == n_new
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                toks = jnp.asarray([list(p) + want[:i]], jnp.int32)
                top = jnp.sort(jmodel.apply_train(
                    jparams, {"tokens": toks}, remat=False)[0, -1])[-2:]
                margin = float(top[1] - top[0])
                assert margin < 5e-2, (i, g, w, margin)
                break
            compared += 1
    return compared


def _churn_run(pkg, engine, prompts, n_new):
    """The membership-epoch test's churn path on one package's objects:
    a ``PlanCache`` over ``battery_cluster()`` keyed on the membership of a
    ``FleetController`` replaying tx2's leave and return, the epochs wired
    to ``on_membership_change``, one recorder for all three.  The fleet
    advances only between engine steps."""
    rec = pkg.TelemetryRecorder("churn")
    cluster = pkg.battery_cluster()
    fleet = pkg.FleetController(cluster, pkg.ChurnTrace.scripted(
        [(1.0, "tx2", "leave"), (2.0, "tx2", "join")]), telemetry=rec)
    cache = pkg.PlanCache(pkg.HiDPPlanner(pkg.PlannerConfig(
        objective=pkg.Objective("energy", radio_power=4.0))), cluster,
        membership_source=fleet, telemetry=rec)
    eng = engine(max_batch=2, max_len=32, plan_cache=cache,
                 default_dag=pkg.dag, telemetry=rec)
    fleet.on_epoch = eng.on_membership_change
    rids = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    seen = [(cache.misses, cache.hits)]
    for now in (None, 1.5, None, 2.5):
        if now is not None:
            fleet.advance(now)
            nodes = {a.node.name for a in eng.plan.global_plan.assignments}
            seen.append((now, eng.replans, cache.misses, cache.hits,
                         "tx2" in nodes))
        eng.step()
    done = eng.run_until_done()
    return dict(reqs=[done[r] for r in rids], seen=seen, replans=eng.replans,
                misses=cache.misses, hits=cache.hits,
                events=[e.canonical() for e in rec.events],
                counters=[(e.name, e.epoch, e.attrs.get("resolved"))
                          for e in rec.events if e.kind == "counter"])


def test_churn_path_on_the_ports_objects_equals_the_jax_engine(small_lm,
                                                               jax_lm):
    """The membership-epoch test on the port's ``FleetController``,
    ``PlanCache``, ``battery_cluster`` and ``TelemetryRecorder`` against the
    JAX package's objects under the same trace: the same re-plans, misses
    and hits at every epoch (tx2 absent from the plan while away, the warm
    return free), the same greedy tokens, and the same recorder events in
    canonical projection."""
    import types

    import repro.core as jcore
    import repro.fleet as jfleet
    import repro.serving as jserving
    import repro.telemetry as jtelemetry
    import repro_torch.core as core
    import repro_torch.fleet as fleet
    import repro_torch.telemetry as telemetry
    from repro_torch.core.dag import Block, ModelDAG
    from repro_torch.serving.plan_cache import PlanCache
    from test_torch_planner import toy_dag

    def pkg(core, fleet, telemetry, cache_cls, dag):
        return types.SimpleNamespace(
            TelemetryRecorder=telemetry.TelemetryRecorder,
            battery_cluster=core.battery_cluster,
            FleetController=fleet.FleetController,
            ChurnTrace=fleet.ChurnTrace, PlanCache=cache_cls,
            HiDPPlanner=core.HiDPPlanner, PlannerConfig=core.PlannerConfig,
            Objective=core.Objective, dag=dag)

    cfg, model, params = small_lm
    jmodel, jparams = jax_lm
    prompts = [np.asarray([1, 2], np.int32), np.asarray([7, 3, 9], np.int32)]
    n_new = 6
    ours = _churn_run(pkg(core, fleet, telemetry, PlanCache,
                          toy_dag(Block, ModelDAG)),
                      lambda **kw: _engine(model, params, **kw), prompts,
                      n_new)
    theirs = _churn_run(pkg(jcore, jfleet, jtelemetry, jserving.PlanCache,
                            toy_dag()),
                        lambda **kw: JServingEngine(jmodel, jparams, **kw),
                        prompts, n_new)
    # two submits: one cold pass and a hit; tx2 leaves: one pass for the
    # new membership, a plan without tx2; tx2 returns: a warm hit
    assert ours["seen"] == [(1, 1), (1.5, 1, 2, 1, False),
                            (2.5, 2, 2, 2, True)]
    for k in ("seen", "replans", "misses", "hits", "counters", "events"):
        assert ours[k] == theirs[k], k
    assert [c for c in ours["counters"] if c[0] == "engine.replan"] == [
        ("engine.replan", 1, None), ("engine.replan", 2, None)]
    assert _greedy_parity(jax_lm, prompts, theirs["reqs"], ours["reqs"],
                          n_new) >= n_new


def test_chip_smokes_churn_phase_runs_on_the_cpu(small_lm, monkeypatch):
    """``chip_smoke.serve_churn``'s wiring and checks, on the CPU at the
    reduced size (the engine on ``cpu``, syncs as no-ops, a 64-position
    cache): it raises on any failed check."""
    import functools

    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    cfg, model, params = small_lm
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "ServingEngine", functools.partial(
        ServingEngine, device="cpu"))
    monkeypatch.setattr(chip_smoke, "MAX_LEN", 64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(4, 20, size=8)]
    run = chip_smoke.drive_main_path(model, params, prompts)
    out = chip_smoke.serve_churn(model, params, prompts, run, "cpu")
    assert len(out["epoch_s"]) == 2 and len(out["submit_s"]) == 8


def test_chip_smokes_evaluation_phase_runs_on_the_cpu(small_lm, monkeypatch,
                                                      capsys):
    """``chip_smoke.evaluation_phase`` on the CPU at the reduced size: the
    churn run's telemetry through the port's store, report and regress
    (their CLIs as subprocesses), the simulated strategy comparison, and
    open-loop load priced by a plan cache calibrated on the CPU's plain
    kernels; it raises on any failed check."""
    import functools

    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    from repro_torch.core import (Cluster, HiDPPlanner, PlannerConfig,
                                  gpu_node, processors_as_resources)
    from repro_torch.models import ShapeConfig
    from repro_torch.profiling import (CalibratedCostProvider,
                                       LearnedCostModel, Profiler)
    from repro_torch.serving.plan_cache import PlanCache

    cfg, model, params = small_lm
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "ServingEngine", functools.partial(
        ServingEngine, device="cpu"))
    monkeypatch.setattr(chip_smoke, "MAX_LEN", 64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(4, 20, size=8)]
    run = chip_smoke.drive_main_path(model, params, prompts)
    churn = chip_smoke.serve_churn(model, params, prompts, run, "cpu")
    node = gpu_node("h100")
    gpu = processors_as_resources(node)[0]
    samples = Profiler(warmup=0, repeats=1, trim=0).profile_kernels(
        device="cpu", key=gpu.profile_key or gpu.name,
        shapes={"attn": ((1, 32, 2, 16), (1, 64, 2, 16)),
                "decode": ((1, 32, 2, 16), (2, 64, 2, 16)),
                "ssd": ((1, 32, 2, 16, 8), (1, 64, 2, 16, 8))})
    loaded = LearnedCostModel.fit(samples)
    plan = dict(loaded=loaded, dag=model.block_costs(
        ShapeConfig("serve", 64, 4, "decode")), cache=PlanCache(
            HiDPPlanner(PlannerConfig(
                provider=CalibratedCostProvider(loaded))),
            Cluster((node,))))
    # the plain versions count no launch on the CPU: stand in the card's
    # counts, which the regress check doubles
    run = dict(run, launches={"flash_attention": 36, "decode_attention": 18,
                              "ssd_intra_chunk": 0})
    capsys.readouterr()
    chip_smoke.evaluation_phase(model, run, churn, plan, "cpu")
    out = capsys.readouterr().out
    for what in ("telemetry: churn run", "regress: snapshot",
                 "simulated (cost model, one H100", "open-loop load",
                 "saturation sweep priced", "evaluation phase:"):
        assert what in out, what
    assert out.count("simulated (cost model, paper_cluster)") == 4


def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "4"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "arch=gemma-2b: served 4/4 requests" in out.stdout
