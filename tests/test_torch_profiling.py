"""The port's analyzer (``repro_torch.profiling``) against the JAX
package's: the same samples fit to the same JSON, the synthetic profiler
and the feedback loop give the same rows and drift events, each package
reads the other's calibration store, and the kernel sweep gives the JAX
sweep's rows and telemetry (latencies are measurements, not compared).
The sweep on the CPU runs the plain versions; on a GPU it launches the
hand-written kernels (``chip_smoke.py`` checks that)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.edge_models import (EDGE_MODELS, MODEL_DELTA,  # noqa: E402
                                    paper_cluster)
from repro.profiling import (  # noqa: E402
    CalibrationStore as JStore, FeedbackLoop as JFeedback,
    LearnedCostModel as JLearned, Profiler as JProfiler, Sample as JSample,
    SyntheticGroundTruth as JTruth, calibrate as jcalibrate,
    calibrate_kernels as jcalibrate_kernels)
from repro.telemetry import TelemetryRecorder  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.models import ShapeConfig, build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.profiling import (  # noqa: E402
    CalibratedCostProvider, CalibrationStore, DEFAULT_KERNEL_SHAPES,
    FeedbackLoop, LearnedCostModel, Profiler, Sample, SyntheticGroundTruth,
    calibrate, calibrate_kernels)
from repro_torch.profiling.profiler import kernel_call  # noqa: E402
from test_torch_planner import port_cluster, port_dag  # noqa: E402

# one shape per kind, smaller than DEFAULT_KERNEL_SHAPES
TINY = {"attn": ((1, 32, 2, 16),), "decode": ((1, 32, 2, 16),),
        "ssd": ((1, 32, 2, 16, 8),)}


def _rows(samples):
    return [(s.key, s.kind, s.work, s.traffic) for s in samples]


def _paper_samples(seed: int):
    """``profile_cluster`` over the paper cluster and its CNN zoo in both
    packages, under one seed and a ground truth that diverges from the
    datasheet (a throttled GPU, a hungrier CPU, noise)."""
    jcl = paper_cluster()
    cl = port_cluster(jcl)
    jdags = {k: f() for k, f in EDGE_MODELS.items()}
    dags = {k: port_dag(d) for k, d in jdags.items()}
    kw = dict(rate_scale={("tx2", "gpu"): 0.5, "rpi4": 0.8},
              power_scale={("orin_nx", "cpu"): 1.5}, noise=0.05)
    jsamples = JProfiler(seed=seed).profile_cluster(
        jcl, jdags, MODEL_DELTA, ground_truth=JTruth(jcl, **kw))
    samples = Profiler(seed=seed).profile_cluster(
        cl, dags, MODEL_DELTA, ground_truth=SyntheticGroundTruth(cl, **kw))
    return jsamples, samples


# --------------------------------------------------------------------------
# synthetic profiler, fit, provider
# --------------------------------------------------------------------------

def test_profile_cluster_samples_equal_under_one_seed():
    jsamples, samples = _paper_samples(seed=11)
    assert len(samples) == len(jsamples) > 0
    assert [dataclasses.asdict(s) for s in samples] == \
        [dataclasses.asdict(s) for s in jsamples]
    assert _paper_samples(seed=12)[1] != samples


@pytest.mark.parametrize("mode", ["linear", "isotonic"])
def test_learned_fit_json_equals_the_jax_fit(mode):
    jsamples, samples = _paper_samples(seed=5)
    model = LearnedCostModel.fit(samples, mode=mode)
    jmodel = JLearned.fit(jsamples, mode=mode)
    assert model.to_json() == jmodel.to_json()
    assert model.revision == jmodel.revision
    assert model.mape_against(samples) == jmodel.mape_against(jsamples)
    # the JSON round trip of each package loads in the other
    assert JLearned.from_json(model.to_json()).to_json() == jmodel.to_json()
    assert LearnedCostModel.from_json(jmodel.to_json()).to_json() == \
        model.to_json()


def test_calibrate_gives_the_jax_providers_prices():
    jcl = paper_cluster()
    cl = port_cluster(jcl)
    jdags = {k: f() for k, f in EDGE_MODELS.items()}
    dags = {k: port_dag(d) for k, d in jdags.items()}
    truth = dict(rate_scale={("tx2", "gpu"): 0.5}, noise=0.02)
    jprov = jcalibrate(jcl, jdags, MODEL_DELTA,
                       ground_truth=JTruth(jcl, **truth))
    prov = calibrate(cl, dags, MODEL_DELTA,
                     ground_truth=SyntheticGroundTruth(cl, **truth))
    assert prov.model.to_json() == jprov.model.to_json()
    from repro.core.cost_model import (node_as_resource as jnode_res,
                                       processors_as_resources as jproc_res)
    for jn, n in zip(jcl.nodes, cl.nodes):
        pairs = [(jnode_res(jn), cm.node_as_resource(n))] + list(
            zip(jproc_res(jn), cm.processors_as_resources(n)))
        for jr, r in pairs:
            for name in jdags:
                jd, d = jdags[name], dags[name]
                for i in range(len(d.blocks)):
                    assert prov.block_time(r, d.blocks[i]) == \
                        jprov.block_time(jr, jd.blocks[i])
                    assert prov.block_energy(r, d.blocks[i]) == \
                        jprov.block_energy(jr, jd.blocks[i])
                assert prov.data_coeffs(d, r) == jprov.data_coeffs(jd, jr)


# --------------------------------------------------------------------------
# feedback loop
# --------------------------------------------------------------------------

def _scripted_observations():
    """A healthy stretch, a 3× latency throttle on one GPU, then a power
    shift with latency intact on another, with seeded noise: each kind of
    drift trips once."""
    rng = np.random.default_rng(4)
    obs = []
    for i in range(90):
        work = 1e8 * (1 + i % 5)
        jitter = 1.0 + 0.02 * rng.standard_normal()
        lat = work / 1e9 * jitter * (3.0 if 30 <= i < 60 else 1.0)
        obs.append(("n/gpu", "conv", work, 1e5, lat, 5.0 * work / 1e9))
        watts = 12.0 if i >= 60 else 4.0
        obs.append(("m/gpu", "conv", work, 1e5, work / 2e9 * jitter,
                    watts * work / 2e9 * jitter))
    return obs


def test_feedback_drift_sequence_equals_the_jax_loop():
    seed_rows = [(k, w, w / r, p * w / r) for k, r, p in
                 (("n/gpu", 1e9, 5.0), ("m/gpu", 2e9, 4.0))
                 for w in (1e8, 2e8, 4e8, 8e8)]

    def loop(learned, sample, feedback):
        model = learned.fit([sample(k, "conv", w, 1e5, lat, en)
                             for k, w, lat, en in seed_rows])
        trips = []
        fb = feedback(model, threshold=0.3, calibration_version=7,
                      on_drift=lambda: trips.append(fb.observations))
        flags = [fb.observe(*o[:5], energy_j=o[5])
                 for o in _scripted_observations()]
        return fb, model, flags, trips

    fb, model, flags, trips = loop(LearnedCostModel, Sample, FeedbackLoop)
    jfb, jmodel, jflags, jtrips = loop(JLearned, JSample, JFeedback)
    assert [dataclasses.asdict(e) for e in fb.events] == \
        [dataclasses.asdict(e) for e in jfb.events]
    assert {e.metric for e in fb.events} == {"latency", "energy"}
    assert flags == jflags and trips == jtrips
    assert (fb.calibration_version, fb.replans, fb.observations) == \
        (jfb.calibration_version, jfb.replans, jfb.observations)
    assert fb.calibration_version == 7 + fb.replans
    assert (fb.drift(), fb.energy_drift()) == (jfb.drift(), jfb.energy_drift())
    assert model.to_json() == jmodel.to_json()
    assert fb.forget_resource("n") == jfb.forget_resource("n") > 0


# --------------------------------------------------------------------------
# calibration store
# --------------------------------------------------------------------------

def test_calibration_store_reads_the_other_packages_saves(tmp_path):
    jsamples, samples = _paper_samples(seed=2)
    jcl = paper_cluster()
    cl = port_cluster(jcl)
    model, jmodel = LearnedCostModel.fit(samples), JLearned.fit(jsamples)
    store, jstore = CalibrationStore(tmp_path), JStore(tmp_path)
    assert store.fingerprint(cl) == jstore.fingerprint(jcl)
    assert jstore.save(jcl, jmodel, note="jax") == 1
    assert store.save(cl, model, note="port") == 2
    assert store.versions(cl) == jstore.versions(jcl) == [1, 2]
    assert store.load(cl, version=1).to_json() == jmodel.to_json()
    assert jstore.load(jcl, version=2).to_json() == model.to_json()
    assert store.load(cl).to_json() == jstore.load(jcl).to_json()
    assert store.fronts_path(cl) == jstore.fronts_path(jcl)
    # a fleet the other package declared differently is another fingerprint
    other = cm.Cluster((cm.gpu_node("h100"),))
    assert store.versions(other) == []


# --------------------------------------------------------------------------
# the kernel sweep
# --------------------------------------------------------------------------

def test_profile_kernels_rows_equal_the_jax_sweep():
    prof = Profiler(warmup=1, repeats=2, trim=0)
    samples = prof.profile_kernels(device="cpu")
    jsamples = JProfiler(warmup=1, repeats=2, trim=0).profile_kernels(
        device=jax.devices("cpu")[0])
    assert _rows(samples) == _rows(jsamples)
    assert len(samples) == sum(len(v) for v in DEFAULT_KERNEL_SHAPES.values())
    assert all(s.key == "cpu:0" and s.latency_s > 0 for s in samples)
    assert LearnedCostModel.fit(samples).rate("cpu:0", "attn") > 0
    # kinds and shapes restrict the sweep; a key overrides the default
    sub = prof.profile_kernels(device="cpu", kinds=("ssd",), shapes=TINY,
                               key="h100/gpu0")
    jsub = JProfiler().profile_kernels(kinds=("ssd",), shapes=TINY,
                                       key="h100/gpu0")
    assert _rows(sub) == _rows(jsub) == [("h100/gpu0", "ssd", 6.0 * 32 * 2
                                          * 16 * 8, 4.0 * (2 * 32 * 2 * 16
                                                           + 2 * 32 * 8))]
    with pytest.raises(KeyError, match="unknown kernel kinds"):
        prof.profile_kernels(device="cpu", kinds=("conv",))


@pytest.mark.parametrize("kind", sorted(TINY))
def test_kernel_call_builds_what_the_sweep_times(kind):
    """``kernel_call`` is the sweep's own recipe: the same work and traffic
    as the sample, and under one seed the same inputs, so two builds give
    equal outputs and another seed does not."""
    (shape,) = TINY[kind]
    (s,) = Profiler(warmup=0, repeats=1, trim=0).profile_kernels(
        device="cpu", kinds=(kind,), shapes=TINY)
    cpu = torch.device("cpu")
    fn, flops, traffic = kernel_call(kind, shape, device=cpu)
    assert (s.work, s.traffic) == (flops, traffic)
    again, _, _ = kernel_call(kind, shape, device=cpu)
    other, _, _ = kernel_call(kind, shape, device=cpu, seed=1)
    def out(call):                       # ops.ssd also returns its state
        y = call()
        return y[0] if isinstance(y, tuple) else y
    assert torch.equal(out(fn), out(again))
    assert not torch.equal(out(fn), out(other))
    with pytest.raises(KeyError, match="unknown kernel kind"):
        kernel_call("conv", shape, device=cpu)


def _events(rec):
    return [(e.name, e.kind, e.value, e.attrs) for e in rec.events]


def test_calibrate_kernels_emits_the_jax_telemetry(tmp_path):
    """``tests/test_telemetry.py``'s sweep through both packages, each
    handed a JAX-package ``TelemetryRecorder``: the same ``profile.kernel``
    spans and ``profile.calibration`` counter, attribute for attribute."""
    jcl = paper_cluster()
    prof = dict(warmup=0, repeats=1, trim=0)
    jrec, rec = TelemetryRecorder("jax"), TelemetryRecorder("port")
    jmodel, jversion = jcalibrate_kernels(
        JStore(tmp_path / "jax"), jcl, profiler=JProfiler(**prof),
        telemetry=jrec, devices=jax.devices("cpu")[:1], shapes=TINY)
    store = CalibrationStore(tmp_path / "port")
    model, version = calibrate_kernels(
        store, port_cluster(jcl), profiler=Profiler(**prof), telemetry=rec,
        devices=["cpu"], shapes=TINY)
    assert version == jversion == 1
    assert set(model.entries) == set(jmodel.entries) == {
        ("cpu:0", k) for k in TINY}
    assert set(store.load(port_cluster(jcl)).entries) == set(model.entries)
    assert _events(rec) == _events(jrec)
    spans = [e for e in rec.events if e.name == "profile.kernel"]
    assert {e.attrs["kind"] for e in spans} == set(TINY)
    assert all(e.wall_s is not None and e.wall_s > 0 for e in spans)
    (done,) = [e for e in rec.events if e.name == "profile.calibration"]
    assert done.attrs["version"] == 1 and done.attrs["samples"] == 3


def test_kernel_sweep_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the sweep runs on it")
    with pytest.raises(RuntimeError, match="cuda"):
        Profiler().profile_kernels()
    with pytest.raises(RuntimeError, match="GPU"):
        calibrate_kernels(CalibrationStore(tmp_path), port_cluster(
            paper_cluster()))
    assert not any(tmp_path.iterdir())           # nothing was saved


def test_sweep_keyed_to_a_gpu_node_prices_both_tiers_from_its_entry():
    """Keyed to the local tier's resource (``h100/gpu0``), the sweep's
    ``attn`` entry prices the served model's attention layers on both
    tiers: the processor directly, the node through Λ = Σλ."""
    node = cm.gpu_node("h100")
    samples = Profiler(warmup=0, repeats=1, trim=0).profile_kernels(
        device="cpu", kinds=("attn",), key="h100/gpu0")
    prov = CalibratedCostProvider(LearnedCostModel.fit(samples))
    dag = build_model(get_config("gemma-2b")).block_costs(
        ShapeConfig("serve", 1024, 4, "decode"))
    layer = dag.blocks[1]
    assert layer.kind == "attn"
    rate = prov.model.rate("h100/gpu0", "attn")
    for r in (cm.node_as_resource(node), *cm.processors_as_resources(node)):
        assert prov.effective_rate(r, "attn") == rate
        assert prov.block_time(r, layer) != cm.ANALYTIC.compute_time(
            layer.flops, r, "attn")
    # a kind the sweep never measured falls back to the datasheet
    r = cm.processors_as_resources(node)[0]
    assert prov.block_time(r, dag.blocks[-1]) == cm.ANALYTIC.compute_time(
        dag.blocks[-1].flops, r, "dense")
