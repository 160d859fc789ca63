"""The serving engine's and the model's spans on the port's telemetry
recorder (CPU, reduced configs): the span tree of one ``step``, the layer
spans under each model call, served tokens unchanged by the recorder, the
disabled path, and a wall-clocked span on ``torch.profiler``'s clock."""

import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.telemetry import TelemetryRecorder  # noqa: E402

ARCHS = ("mixtral-8x7b", "hymba-1.5b", "mamba2-780m")
# the spans of one layer, by family: (name, spans a layer)
LAYER_SPANS = {"moe": {"layer.norm": 2, "layer.attention": 1,
                       "layer.moe": 1},
               "hybrid": {"layer.norm": 2, "layer.attention": 1,
                          "layer.ssm": 1, "layer.mlp": 1},
               "ssm": {"layer.norm": 1, "layer.ssm": 1}}
PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9])


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    cfg = get_config(request.param).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return cfg, model, params


def _engine(lm, **kw):
    _, model, params = lm
    return ServingEngine(model, params, max_batch=2, max_len=32,
                         device="cpu", **kw)


def _spans(rec):
    return [e for e in rec.events if e.kind == "span"]


def _children(spans, parent, prefix=""):
    return [e for e in spans if e.parent_id == parent.span_id
            and e.name.startswith(prefix)]


class _Feedback:
    """A feedback loop that reports drift on the observations named."""

    def __init__(self, drift_at=()):
        self.n, self.drift_at = 0, set(drift_at)

    def observe(self, *args):
        self.n += 1
        return self.n in self.drift_at


def test_the_span_tree_of_one_step(lm):
    rec = TelemetryRecorder("spans")
    eng = _engine(lm, telemetry=rec, feedback=_Feedback(drift_at={1}))
    rids = [eng.submit(np.asarray(p, np.int32), max_new_tokens=4)
            for p in PROMPTS[:2]]
    eng.step()
    eng.step()                  # the first step observes no feedback
    spans = _spans(rec)
    steps = [e for e in spans if e.name == "engine.step"]
    assert len(steps) == 2 and all(e.parent_id is None for e in steps)
    assert steps[0].attrs == {"admitted": 2, "rows": 2}
    assert steps[1].attrs == {"admitted": 0, "rows": 2}

    first = _children(spans, steps[0], "engine.")
    assert [e.name for e in first] == ["engine.admit", "engine.decode",
                                       "engine.emit"]
    second = _children(spans, steps[1], "engine.")
    assert [e.name for e in second] == ["engine.admit", "engine.decode",
                                        "engine.feedback", "engine.emit"]
    # the drift's re-plan pass nests under the feedback span
    (replan,) = _children(spans, second[2])
    assert replan.name == "engine.replan_pass"
    assert replan.attrs["reason"] == "drift"

    admit, decode = first[0], first[1]
    prefills = _children(spans, admit)
    assert [e.name for e in prefills] == ["engine.prefill"] * 2
    submits = [e for e in rec.events if e.name == "engine.submit"]
    assert [e.attrs["request"] for e in prefills] == rids == [
        e.attrs["request"] for e in submits]
    for e, p in zip(prefills, PROMPTS):
        assert e.attrs["tokens"] == len(p)
        assert 0 <= e.attrs["queued_s"] <= e.wall - (e.wall_s or 0)
        assert [c.name for c in _children(spans, e, "engine.")] == [
            "engine.slot_write", "engine.first_token"]
    assert decode.attrs == {"rows": 2,
                            "kv_tokens": sum(len(p) + 1
                                             for p in PROMPTS[:2])}
    # every span is wall-clocked and lies inside its parent
    by_id = {e.span_id: e for e in spans}
    for e in spans:
        assert e.wall_s is not None and e.wall_s >= 0
        if e.parent_id is not None:
            p = by_id[e.parent_id]
            assert p.wall - p.wall_s - 1e-6 <= e.wall - e.wall_s
            assert e.wall <= p.wall + 1e-6


def test_layer_spans_under_each_model_call(lm):
    cfg = lm[0]
    rec = TelemetryRecorder("layers")
    eng = _engine(lm, telemetry=rec)
    eng.submit(np.asarray(PROMPTS[2], np.int32), max_new_tokens=3)
    eng.run_until_done()
    spans = _spans(rec)
    calls = [e for e in spans if e.name in ("engine.prefill",
                                            "engine.decode")]
    assert [e.name for e in calls] == ["engine.prefill"] + [
        "engine.decode"] * 2
    per_layer = LAYER_SPANS[cfg.family]
    for call in calls:
        mine = _children(spans, call)
        names = Counter(e.name for e in mine)
        want = {k: v * cfg.n_layers for k, v in per_layer.items()}
        want.update({"model.embed": 1, "model.head": 1})
        if call.name == "engine.prefill":
            want.update({"engine.slot_write": 1, "engine.first_token": 1})
        assert dict(names) == want
        for name, n in per_layer.items():
            layers = sorted(e.attrs["layer"] for e in mine
                            if e.name == name)
            assert layers == sorted(list(range(cfg.n_layers)) * n)
        order = [e.name for e in mine if not e.name.startswith("engine.")]
        assert order[0] == "model.embed" and order[-1] == "model.head"


def test_served_tokens_do_not_depend_on_the_recorder(lm):
    out = []
    for rec in (None, TelemetryRecorder("tokens")):
        eng = _engine(lm, telemetry=rec)
        for p in PROMPTS:
            eng.submit(np.asarray(p, np.int32), max_new_tokens=5)
        done = eng.run_until_done()
        out.append([done[r].generated for r in sorted(done)])
    assert out[0] == out[1]


class _Spy:
    """The model, recording the keywords of every call."""

    def __init__(self, model):
        self._model, self.cfg, self.kw = model, model.cfg, []

    def init_cache(self, *args, **kw):
        return self._model.init_cache(*args, **kw)

    def apply_prefill(self, params, batch, **kw):
        self.kw.append(kw)
        return self._model.apply_prefill(params, batch, **kw)

    def apply_decode(self, params, cache, batch, **kw):
        self.kw.append(kw)
        return self._model.apply_decode(params, cache, batch, **kw)


@pytest.mark.parametrize("recorder", ["none", "disabled", "enabled"])
def test_only_a_wired_recorder_reaches_the_model(lm, recorder):
    _, model, params = lm
    rec = {"none": None,
           "disabled": TelemetryRecorder("off", enabled=False),
           "enabled": TelemetryRecorder("on")}[recorder]
    spy = _Spy(model)
    eng = ServingEngine(spy, params, max_batch=2, max_len=32, device="cpu",
                        telemetry=rec, feedback=_Feedback())
    eng.submit(np.asarray(PROMPTS[0], np.int32), max_new_tokens=3)
    eng.run_until_done()
    assert len(spy.kw) == 3
    if recorder == "enabled":
        assert all(kw == {"telemetry": rec} for kw in spy.kw)
        assert rec.events
    else:
        assert all(kw == {} for kw in spy.kw)
        assert rec is None or rec.events == []
    assert eng.trace.maxlen == engine_mod.TRACE_STATES


def test_a_wall_clocked_span_is_on_the_profilers_clock():
    """``[wall - wall_s, wall]`` of a span lies inside a ``record_function``
    range opened just around it (to the profiler's clock conversion, 0.1
    ms), and within 1 ms of its ends: of five tries, the closest, since a
    busy host may deschedule the process between the range and the span.
    ``wall_s`` is the closing read minus the opening one."""
    from torch.profiler import ProfilerActivity, profile, record_function
    rec = TelemetryRecorder("clock")
    reads = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):    # a first range sets up ~1 ms
            pass
        for _ in range(5):
            before = time.time()
            with record_function("outer"):
                with rec.trace("inner", wall=True):
                    torch.ones(64).cumsum(0)
                    time.sleep(0.002)
            reads.append((before, time.time()))
    outer = sorted((e.start_ns() / 1e9,
                    (e.start_ns() + e.duration_ns()) / 1e9)
                   for e in prof.profiler.kineto_results.events()
                   if e.name() == "outer")
    assert len(rec.events) == len(outer) == 5
    gaps = []
    for ev, (before, after), (o_start, o_end) in zip(rec.events, reads,
                                                     outer):
        start, end = ev.wall - ev.wall_s, ev.wall
        assert before <= start < end <= after and ev.wall_s >= 0.002
        assert o_start <= start + 1e-4 and end <= o_end + 1e-4
        gaps.append(max(abs(start - o_start), abs(end - o_end)))
    assert min(gaps) < 1e-3


def test_counters_keep_their_emission_time():
    rec = TelemetryRecorder("wall")
    before = time.time()
    rec.counter("c")
    with rec.trace("untimed"):
        pass
    after = time.time()
    assert all(before <= e.wall <= after for e in rec.events)
    assert [e.wall_s for e in rec.events] == [None, None]
