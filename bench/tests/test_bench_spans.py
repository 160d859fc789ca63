"""The program's spans against a device trace (``bench/spans.py``) and the
readers that use them, on synthetic traces and events: the join by launch
time, idle put down to the innermost span, None where the program has no
such span, and the existing readers unchanged by the launch times."""

import types

import pytest
from torch.autograd import DeviceType

from bench import devtrace, spans, spec
from bench import run as bench_run
from bench.tests import _tiny
from repro_torch.telemetry.events import TelemetryEvent

T0 = 1_792_000_000_000_000_000          # a unix time in ns
US = 1000
EXISTING = ("decode_step_ms", "prefill_ms_per_ktok", "ttft_p95_ms",
            "planner_ms_per_s", "kernels_per_decode_step", "mfu",
            "flash_roofline", "decode_attn_roofline", "device_idle")
NEW = ("admit_wait_p95_ms", "decode_idle_ms")


def _span(sid, parent, name, start_us, end_us, **attrs):
    """A wall-clocked span as the recorder emits it: ``wall`` its end in
    unix seconds, ``wall_s`` its length."""
    start, end = T0 + start_us * US, T0 + end_us * US
    return TelemetryEvent(seq=sid, kind="span", name=name, value=0.0,
                          attrs=attrs, span_id=sid, parent_id=parent,
                          wall=end / 1e9, wall_s=(end - start) / 1e9)


def _events():
    """One step: a prefill with a MoE layer, a decode with one, the emit;
    and an event that is no span."""
    return [
        _span(0, None, "engine.step", 0, 1000, admitted=1, rows=1),
        _span(1, 0, "engine.admit", 10, 300),
        _span(2, 1, "engine.prefill", 20, 290, request=7, tokens=16,
              queued_s=0.005),
        _span(3, 2, "model.embed", 30, 40),
        _span(4, 2, "layer.attention", 40, 100, layer=0),
        _span(5, 2, "layer.moe", 100, 200, layer=0),
        _span(6, 2, "model.head", 200, 220),
        _span(7, 2, "engine.first_token", 230, 290),
        _span(8, 0, "engine.decode", 300, 800, rows=1, kv_tokens=17),
        _span(9, 8, "layer.moe", 400, 600, layer=0),
        _span(10, 0, "engine.emit", 800, 990),
        TelemetryEvent(seq=11, kind="counter", name="engine.submit",
                       value=1.0, attrs={"request": 8}, wall=T0 / 1e9),
    ]


def _op(name, start_us, end_us, launch_us, kind="kernel"):
    op = devtrace.Op(name, kind, T0 + start_us * US, T0 + end_us * US)
    op.launch_ns = None if launch_us is None else T0 + launch_us * US
    return op


def _trace():
    """Ops that run after their launch (the device lags the host): A in
    the prefill's attention, B in its MoE layer running past the span, C
    in the decode's MoE layer (three spans deep), D a copy at the emit, E
    outside every span."""
    ops = [_op("A", 50, 150, 45), _op("B", 150, 400, 110),
           _op("C", 450, 500, 450), _op("D", 805, 820, 805, "gpu_memcpy"),
           _op("E", 1500, 1600, 1500)]
    return devtrace.Trace((T0, T0 + 2000 * US), ops,
                          {devtrace.WINDOW: [(T0, T0 + 2000 * US)]})


def test_ops_join_the_innermost_span_open_at_their_launch():
    sp = spans.program_spans(_events())
    got = {o.name: None if s is None else s.name
           for o, s in spans.owners(_trace(), sp)}
    assert got == {"A": "layer.attention", "B": "layer.moe",
                   "C": "layer.moe", "D": "engine.emit", "E": None}
    (c_span,) = [s for o, s in spans.owners(_trace(), sp) if o.name == "C"]
    assert c_span.depth == 2 and c_span.attrs == {"layer": 0}


def test_idle_goes_to_the_innermost_span_at_each_gaps_middle():
    rows = spans.table(_trace(), spans.program_spans(_events()))
    idle = {k: round(v["idle_s"] * 1e6, 3) for k, v in rows.items()
            if v["idle_s"]}
    # gaps: [0, 50] (middle in the prefill, before the embed), [400, 450]
    # (the decode's MoE layer), [500, 805] (the decode), [820, 1500] and
    # [1600, 2000] (no span)
    assert idle == {"engine.prefill": 50.0, "layer.moe": 50.0,
                    "engine.decode": 305.0, spans.NO_SPAN: 1080.0}
    assert rows["layer.moe"]["kernels"] == 2
    assert rows["layer.moe"]["device_s"] == pytest.approx(300e-6)
    assert rows["engine.emit"]["kernels"] == 0          # a copy
    # the spans' ends are unix seconds in a double, 0.24 us apart
    assert rows["layer.moe"]["host_s"] == pytest.approx(300e-6, abs=1e-6)
    assert rows["engine.step"]["host_s"] == pytest.approx(1000e-6,
                                                          abs=1e-6)


def test_the_moe_share_the_decode_idle_and_the_admit_wait():
    tr, sp = _trace(), spans.program_spans(_events())
    # busy: [50, 400], [450, 500], [805, 820], [1500, 1600] = 515 us;
    # launched in layer.moe: B and C, 300 us
    assert spans.moe_busy_share(tr, sp) == pytest.approx(100 * 300 / 515)
    # decode [300, 800]: busy [300, 400] and [450, 500]
    assert spans.decode_idle(tr, sp) == [pytest.approx(350e-6)]
    assert spans.admit_waits(_events()) == [0.005]
    ctx = types.SimpleNamespace(events=_events(), trace=tr)
    assert spec.metric_reader("decode_idle_ms")(ctx) == pytest.approx(0.35)
    assert spec.metric_reader("admit_wait_p95_ms")(ctx) == \
        pytest.approx(5.0)


@pytest.mark.parametrize("what", ["no spans", "no moe", "no launches",
                                  "no trace"])
def test_none_where_the_program_has_no_such_span(what):
    events, tr = _events(), _trace()
    if what == "no spans":            # a program without them
        events = [e for e in events if e.kind != "span"
                  or not e.name.startswith(spans.PREFIXES)]
    if what == "no moe":
        events = [e for e in events if e.name != "layer.moe"]
    if what == "no launches":
        for o in tr.ops:
            del o.launch_ns
    if what == "no trace":
        tr = None
    sp = spans.program_spans(events)
    ctx = types.SimpleNamespace(events=events, trace=tr)
    if tr is not None:
        assert spans.moe_busy_share(tr, sp) is None
    if what in ("no spans", "no trace"):
        assert spec.metric_reader("decode_idle_ms")(ctx) is None
    if what == "no spans":
        assert spec.metric_reader("admit_wait_p95_ms")(ctx) is None


def test_a_child_rounded_past_its_parent_is_clamped_into_it():
    events = [_span(0, None, "engine.decode", 100, 200),
              _span(1, 0, "layer.moe", 99.9, 200.2)]
    parent, child = spans.program_spans(events)
    assert (parent.name, child.name) == ("engine.decode", "layer.moe")
    assert parent.start <= child.start <= child.end <= parent.end
    assert spans.innermost([parent, child], [T0 + 150 * US]) == [child]


def test_step_offsets_against_the_bench_step_ranges():
    events = [_span(0, None, "engine.step", 10, 90),
              _span(1, None, "engine.step", 110, 180)]
    tr = devtrace.Trace((T0, T0 + 300 * US), [], {
        devtrace.STEP: [(T0 + 5 * US, T0 + 95 * US),
                        (T0 + 100 * US, T0 + 200 * US),
                        (T0 + 210 * US, T0 + 290 * US)]})
    got = spans.step_offsets(tr, spans.program_spans(events))
    want = [(5 * US, 5 * US), (10 * US, 20 * US)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == pytest.approx(w, abs=500)    # ns: the ends' rounding


class _Ev:
    """A raw profiler event as ``devtrace.read`` reads it."""

    def __init__(self, name, kind, start_us, dur_us, corr=0, linked=0):
        self._name, self.kind = name, kind
        self.start, self.dur = T0 + int(start_us * US), int(dur_us * US)
        self.corr, self.linked = corr, linked

    def name(self):
        return self._name

    def activity_type(self):
        return self.kind

    def device_type(self):
        return (DeviceType.CUDA if self.kind in devtrace.DEVICE_KINDS
                else DeviceType.CPU)

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked


def _prof():
    """A window with one prefill (flash and a GEMM launched through aten,
    a ctypes kernel whose runtime call is missing) and one decode (the
    two decode attention launches), one launch before the window."""
    ua, cpu, rt = "user_annotation", "cpu_op", "cuda_runtime"
    evs = [
        _Ev(devtrace.WINDOW, ua, 0, 1000, corr=1),
        _Ev(devtrace.STEP, ua, 10, 900, corr=2),
        _Ev(devtrace.PREFILL, ua, 20, 300, corr=3),
        _Ev("aten::mm", cpu, 30, 20, corr=4),
        _Ev("cudaLaunchKernel", rt, 35, 5, corr=101),
        _Ev("ext::flash", cpu, 60, 10, corr=5),
        _Ev("cudaLaunchKernel", rt, 62, 5, corr=102),
        _Ev(devtrace.DECODE, ua, 400, 300, corr=6),
        _Ev("cudaLaunchKernel", rt, 420, 5, corr=104),
        _Ev("cudaLaunchKernel", rt, 430, 5, corr=105),
        _Ev("cudaLaunchKernel", rt, -50, 5, corr=100),
        _Ev("nvjet_tst_gemm", "kernel", 40, 50, corr=101, linked=4),
        _Ev("flash_bf16_kernel", "kernel", 90, 100, corr=102, linked=5),
        _Ev("ssd_like_ctypes", "kernel", 200, 30, corr=103, linked=3),
        _Ev("decode_split_kernel", "kernel", 440, 40, corr=104, linked=6),
        _Ev("decode_combine_kernel", "kernel", 480, 10, corr=105,
            linked=6),
        _Ev("before_window", "kernel", -40, 20, corr=100),
    ]
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))


def _ctx(tr):
    conf = spec.cell("mixtral-8x7b-l8.azconv_c256").config
    events = [TelemetryEvent(seq=0, kind="span", name="engine.resolve",
                             value=0.0, wall=T0 / 1e9, wall_s=0.0002)]
    return bench_run.Context(
        config=conf, window_s=tr.window_s, e2e={"ttft_p95_ms": 12.5},
        prefill_seconds=[0.0003], decode_seconds=[0.0003],
        prompt_tokens_admitted=64, events=events, trace=tr,
        calls=[{"kind": "prefill", "tokens": 64},
               {"kind": "decode", "lengths": [65, 0, 30]}])


def test_launch_times_from_the_runtime_call_else_the_linked_op():
    prof = _prof()
    tr = devtrace.read(prof)
    counts = spans.attach_launches(prof, tr)
    assert counts == {"runtime": 4, "linked": 1}
    got = {o.name: ((o.launch_ns - T0) // US, o.launch_by) for o in tr.ops}
    assert got == {"nvjet_tst_gemm": (35, "runtime"),
                   "flash_bf16_kernel": (62, "runtime"),
                   "ssd_like_ctypes": (20, "linked"),
                   "decode_split_kernel": (420, "runtime"),
                   "decode_combine_kernel": (430, "runtime")}


def test_the_existing_readers_ignore_the_launch_times():
    prof = _prof()
    tr = devtrace.read(prof)
    before = {m: spec.metric_reader(m)(_ctx(tr)) for m in EXISTING}
    parts = devtrace.breakdown(tr)
    spans.attach_launches(prof, tr)
    assert {m: spec.metric_reader(m)(_ctx(tr)) for m in EXISTING} == before
    assert devtrace.breakdown(tr) == parts
    # each reads a value here, so the comparison compares something
    assert all(v is not None for v in before.values()), before


def test_every_new_metric_is_in_the_benchmark_with_a_reader():
    per_layer = {m["name"]: m
                 for m in spec.load_benchmark()["per_layer"]}
    for name in NEW:
        assert per_layer[name]["workloads"] == [
            "mixtral-8x7b-l8.azconv_c256"]
        assert callable(spec.metric_reader(name))


def test_a_traced_cpu_run_reads_the_admission_wait():
    """On the CPU a traced run has the program's spans and no device
    trace: the wait reads, the decode idle does not."""
    r = _tiny.run("mixtral-8x7b-l8.azconv_c256", trace=True,
                  seconds=1.0)
    c = _tiny.cell("mixtral-8x7b-l8.azconv_c256")
    assert {m["name"] for m in c.per_layer} >= set(NEW)
    assert r["metrics"]["admit_wait_p95_ms"]["value"] >= 0
    assert "decode_idle_ms" not in r["metrics"]


def test_the_analysis_of_a_traced_window():
    from bench import program_spans
    tr = _trace()
    for o in tr.ops:
        o.launch_by = "runtime"
    tr.ranges[devtrace.STEP] = [(T0 - 2 * US, T0 + 1003 * US)]
    out = program_spans.analyse(tr, _events(), {"runtime": 5})
    # device time 515 us, of it 415 launched inside a span (E is not)
    assert out["device_share_in_a_span"] == pytest.approx(100 * 415 / 515)
    assert out["device_s_by_launch"] == {"runtime": pytest.approx(515e-6)}
    assert out["moe_busy_share"] == pytest.approx(100 * 300 / 515)
    steps = out["step_offsets_us"]
    assert (steps["steps"], steps["matched"]) == (1, 1)
    assert steps["within_50us_share"] == 100.0
    assert steps["start"]["p50"] == pytest.approx(2.0, abs=0.5)
    assert steps["end"]["p50"] == pytest.approx(3.0, abs=0.5)
