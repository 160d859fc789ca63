"""The ``hybrid_moe`` cell's benchmark files at their own tiny size on the
CPU: the plain reference against the tests' reference
(``tests/_plain_hybrid_moe.py``) and the program in fp32, a tiny run that
is correct where its fp8 control is not, the yardstick's arithmetic, and
the cell's readers in ``BENCHMARK.json`` scoped to it, and each fault a
serving cell can have planted under a tiny run, which then reads not
correct."""

import dataclasses
import importlib.util
import time

import pytest
import torch

from bench import devtrace, roofline, roofline_hybrid_moe as rh, spec
from bench.run import Context, arch_config
from bench.tests import _tiny
from bench.tests.test_bench_faults import FAULTS

CELL = "granite-4-h-small-l20.azconv_c256"
METRICS = ("hybrid_moe_mfu", "hybrid_ssd_roofline",
           "hybrid_decode_hbm_roofline")
# the engine's and the device's yardsticks, read in this cell under a name
# of its own by the reader of the name before the dot
ENGINE = ("decode_step_ms", "prefill_ms_per_ktok", "ttft_p95_ms",
          "planner_ms_per_s", "kernels_per_decode_step", "device_idle",
          "admit_wait_p95_ms", "decode_idle_ms")
# the cell's configuration cut to a size the CPU runs in seconds: both
# kinds of layer, the shared expert, every mechanism of the full one
TINY = dict(n_layers=3, mixers="MAM", d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, vocab=256,
            moe={"num_experts": 8, "top_k": 3, "d_ff_expert": 32,
                 "d_ff_shared": 48},
            ssm={"d_state": 8, "head_dim": 16, "expand": 2, "chunk": 8,
                 "conv_width": 4, "conv_bias": True, "norm_eps": 1e-5})
# the mean served-token gap a tiny run is held to, set between the readings
# of seeds 1-12 on the CPU, every finished request compared: the program's
# largest (3.0e-6) against the fp8 control's smallest (2.5e-5); the logits,
# divided by 16 and drawn small (``make_params``), and their gaps are small
LIMIT = {"mean_logit_gap": 1e-5}


def _plain():
    path = spec.ROOT / "tests" / "_plain_hybrid_moe.py"
    s = importlib.util.spec_from_file_location("_plain_hybrid_moe", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def _conf() -> dict:
    return dict(spec.cell(CELL).config, **TINY)


def _cell():
    c = spec.cell(CELL)
    mix = dict(c.traffic, clients=4, max_len=48, pool=16,
               check_tokens=10 ** 6, check_requests=10 ** 6,
               prompt_tokens={"dist": "loguniform", "min": 8, "max": 32},
               output_tokens={"dist": "uniform", "min": 4, "max": 12})
    return dataclasses.replace(c, traffic=mix, config=_conf(), limits=LIMIT)


def _run(seed: int, **kw) -> dict:
    from bench import run as bench_run
    return bench_run.run(_cell(), seed, 1.5, False, device="cpu",
                         t_start=time.perf_counter(),
                         calibration_shapes=_tiny.SHAPES, **kw)


@pytest.fixture
def fp32_compute():
    from repro_torch.models import layers
    old = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        layers.COMPUTE_DTYPE = old


@pytest.mark.parametrize("seed", [3, 4])
def test_reference_equals_the_tests_reference_and_the_program(
        seed, fp32_compute):
    from repro_torch.models import transformer
    conf = _conf()
    ref = spec.reference("hybrid_moe")
    params = ref.make_params(conf, torch.Generator().manual_seed(seed),
                             "cpu", dtype=torch.float32)
    toks = torch.randint(0, conf["vocab"], (40,),
                         generator=torch.Generator().manual_seed(seed + 1))
    want = ref.logits(conf, params, toks, 0)
    cfg = arch_config(conf)
    other = _plain().forward(cfg, params, toks)
    with torch.no_grad():
        got, _ = transformer.forward(cfg, params, toks[None],
                                     mode="prefill", moe_impl="routed")
    for x in (other, got[0]):
        assert x.shape == want.shape
        assert ((x - want).norm() / want.norm()).item() < 1e-5
    tail = ref.logits(conf, params, toks, 25)
    assert torch.allclose(tail, want[25:], atol=1e-6)
    low = ref.logits(conf, params, toks, 0, precision="fp8")
    assert 1e-3 < ((low - want).norm() / want.norm()).item() < 0.5


def test_make_params_is_the_program_layout():
    from repro_torch.models import build_model
    conf = _conf()
    params = spec.reference("hybrid_moe").make_params(
        conf, torch.Generator().manual_seed(0), "cpu")
    want = build_model(arch_config(conf)).param_specs(torch.bfloat16)

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert (a[k].shape, a[k].dtype) == (b[k].shape,
                                                    b[k].dtype), path + k
    walk(params, want)


def test_a_tiny_run_is_correct_and_its_control_is_not():
    r = _run(11)
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] > 0
    c = _run(11, control=True)
    assert not c["correct"], c["compared"]
    assert c["compared"]["mean_logit_gap"]["value"] > LIMIT["mean_logit_gap"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_tiny_run_with_a_fault_is_not_correct(fault, monkeypatch):
    """The faults of ``test_bench_faults`` under this cell's per-kind
    cache: a decode step that leaves the K/V and the SSM state unchanged,
    half of the batch without logits, a token altered in every row or in
    one slot alone."""
    from repro_torch.models.model import Model
    monkeypatch.setattr(Model, "apply_decode",
                        FAULTS[fault](Model.apply_decode))
    r = _run(11)
    assert not r["correct"], r["compared"]
    assert list(r)[-1] == "compared"


def test_the_readers_are_the_cells_own():
    bench = spec.load_benchmark()
    by_name = {m["name"]: m for m in bench["per_layer"]}
    granite = tuple(f"{name}.granite" for name in ENGINE)
    for name in METRICS + granite:
        assert by_name[name]["workloads"] == [CELL]
        assert callable(spec.metric_reader(name))
    for name in ENGINE:
        base, mine = by_name[name], by_name[f"{name}.granite"]
        assert spec.metric_reader(f"{name}.granite").__module__ == \
            spec.metric_reader(name).__module__
        assert ({k: v for k, v in mine.items()
                 if k not in ("name", "workloads")}
                == {k: v for k, v in base.items()
                    if k not in ("name", "workloads")})
    cell = spec.cell(CELL)
    assert {m["name"] for m in cell.per_layer} == set(METRICS + granite)
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "output_tok_per_s", "itl_p95_ms", "peak_mem_gib"}
    # another family's cell reads nothing of them, an untraced run neither
    ctx = Context(config=spec.cell("mixtral-8x7b-l8.azconv_c256").config,
                  trace=None, calls=[])
    for name in METRICS:
        assert spec.metric_reader(name)(ctx) is None


def _trace(durations_ns: list[int]) -> devtrace.Trace:
    """Decode ranges one after another, each with one kernel of the given
    length."""
    ops, ranges, t = [], [], 0
    for i, dur in enumerate(durations_ns):
        ranges.append((t, t + dur + 10))
        ops.append(devtrace.Op("k", "kernel", t + 5, t + 5 + dur,
                               (devtrace.DECODE, i)))
        t += dur + 20
    return devtrace.Trace((0, t), ops, {devtrace.DECODE: ranges,
                                        devtrace.WINDOW: [(0, t)]})


def test_the_decode_share_is_least_bytes_over_device_time():
    conf = spec.cell(CELL).config
    lengths = [[300, 0, 1200], [301, 5, 1201]]
    least = [rh.decode_bytes(conf, n) / roofline.PEAK_BYTES for n in lengths]
    spent = [2 * x for x in least]            # the card at half its bound
    ctx = Context(config=conf, calls=[{"kind": "decode", "lengths": n}
                                      for n in lengths],
                  trace=_trace([int(s * 1e9) for s in spent]), window_s=1.0)
    got = spec.metric_reader("hybrid_decode_hbm_roofline")(ctx)
    assert got == pytest.approx(50.0, rel=1e-6)


def test_the_decode_bytes_count_each_part_once():
    conf = dict(_conf(), vocab=100)
    d, m = conf["d_model"], conf["moe"]
    one, two = rh.decode_bytes(conf, [9]), rh.decode_bytes(conf, [9, 0, 9])
    # a second row adds its state and K/V, and 3 more experts a layer
    s = conf["ssm"]
    di, n = s["expand"] * d, s["d_state"]
    row = (2 * (4 * (di // s["head_dim"]) * s["head_dim"] * n
                + 2 * (s["conv_width"] - 1) * (di + 2 * n)) * 2
           + 2 * 2 * conf["n_kv_heads"] * conf["head_dim"] * 9)
    experts = 2 * 3 * 3 * d * m["d_ff_expert"] * 3
    assert two - one == row + experts
    assert rh.decode_bytes(conf, [0, 0]) == 0.0
    # every expert at most once, however many rows
    many = [rh.decode_bytes(conf, [9] * k) for k in (3, 4)]
    assert many[1] - many[0] == row


def test_the_flops_count_the_mixers_apart():
    conf = _conf()
    t = 40
    f = rh.prefill_flops(conf, t)
    attn_ctx = 4.0 * conf["n_heads"] * conf["head_dim"] * t * (t + 1) / 2
    assert f == pytest.approx(t * rh.per_token_flops(conf) + attn_ctx
                              + 2.0 * conf["d_model"] * conf["vocab"])
    no_attn = dict(conf, mixers="MMM")
    assert rh.per_token_flops(no_attn) != rh.per_token_flops(conf)
    assert rh.decode_flops(conf, [0, 0]) == 0.0
