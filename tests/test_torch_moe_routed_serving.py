"""The inference steps' MoE lowering, "routed" (``moe_ep.moe_routed``), on
reduced mixtral-8x7b and qwen3-moe-30b-a3b (CPU): ``apply_prefill`` and
``apply_decode`` with no ``moe_impl`` run the width-1 grouped step and
never ``moe_dense``; every one of the t·k assignments is kept whatever the
capacity factor, and the logits are the dense oracle's by the routing
near-tie rule (``test_torch_moe._close_routed``); the serving engine emits
the dense engine's greedy tokens, its ``layer.moe`` spans name the
lowering; a train step and the sharded steps leave the step's counter
where it was."""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe_ep  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.sharding import ctx as shard_ctx  # noqa: E402
from repro_torch.sharding.plan import SINGLE_POD, ShardingPlan  # noqa: E402
from repro_torch.telemetry import TelemetryRecorder  # noqa: E402
from repro_torch.training import optimizer as optim  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402
from test_torch_distributed import spawn  # noqa: E402
from test_torch_moe import _close_routed, _routed  # noqa: E402

ARCHS = ("mixtral-8x7b", "qwen3-moe-30b-a3b")
S = 320                                  # the decode cache's rows


def _cfg(aid: str, capacity_factor: float | None = None):
    cfg = get_config(aid).reduced()
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    cfg = _cfg(request.param)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.bfloat16)
    return cfg, model, params


class _Grouped:
    """``torch._grouped_mm`` recording each call's rows and group ends."""

    def __init__(self):
        self.real, self.calls = torch._grouped_mm, []

    def __call__(self, a, b, *, offs):
        self.calls.append((a.shape[0], offs.tolist()))
        return self.real(a, b, offs=offs)


def _spy_grouped():
    spy = _Grouped()
    return spy, mock.patch.object(torch, "_grouped_mm", spy)


def _no_last_expert(monkeypatch, cfg):
    """Routing over the first E - 1 experts alone: the last expert gets no
    token, in the routed and the dense lowering alike."""
    real = L.moe_router

    def router(spec, router_w, x2d):
        return real(spec, router_w[:, :-1], x2d)
    monkeypatch.setattr(L, "moe_router", router)


def _prompt(cfg, t: int, seed: int = 0) -> dict:
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (1, t))
    return {"tokens": torch.from_numpy(toks.astype(np.int32)),
            "lengths": torch.tensor([t], dtype=torch.int32)}


def _decode_batch(cfg, b: int, seed: int = 1) -> tuple[dict, dict]:
    """A (b, S) cache of random keys and values and one token per row at
    lengths from 1 to S."""
    rng = np.random.default_rng(seed)
    cache = build_model(cfg).init_cache(b, S, device="cpu")
    for k in ("k", "v"):
        cache[k].copy_(torch.from_numpy(rng.standard_normal(
            cache[k].shape).astype(np.float32)))
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab, (b, 1)).astype(np.int32)),
             "lengths": torch.from_numpy(rng.integers(
                 1, S + 1, b).astype(np.int32))}
    return cache, batch


# --------------------------------------------------------------------------
# (a) the inference steps' default
# --------------------------------------------------------------------------

def test_inference_steps_run_the_routed_step_and_never_the_dense(
        lm, monkeypatch):
    """No ``moe_impl``: each MoE layer of a prefill and of a decode step
    is one call of the width-1 step, ``moe_dense`` is never reached.  On
    qwen3 the last expert gets no token, so its group is empty."""
    cfg, model, params = lm
    empty = cfg.name.startswith("qwen3")
    if empty:
        _no_last_expert(monkeypatch, cfg)

    def refuse(*args, **kw):
        raise AssertionError("moe_dense reached at inference")
    monkeypatch.setattr(L, "moe_dense", refuse)
    spy, patch = _spy_grouped()
    cache, step = _decode_batch(cfg, 3)
    with torch.no_grad(), patch:
        c0 = moe_ep.calls
        logits, _ = model.apply_prefill(params, _prompt(cfg, 5))
        assert moe_ep.calls - c0 == cfg.n_layers
        dec, _ = model.apply_decode(params, cache, step)
        assert moe_ep.calls - c0 == 2 * cfg.n_layers
    assert logits.shape == (1, 1, cfg.vocab) and dec.shape == (3, 1,
                                                               cfg.vocab)
    assert torch.isfinite(logits).all() and torch.isfinite(dec).all()
    # gate, up and down per layer, over E groups
    assert len(spy.calls) == 3 * 2 * cfg.n_layers
    for rows, offs in spy.calls:
        assert len(offs) == cfg.moe.num_experts and offs[-1] == rows
        if empty:
            assert offs[-1] == offs[-2]


# --------------------------------------------------------------------------
# (b) every assignment kept, the dense oracle's logits
# --------------------------------------------------------------------------

KEPT_CASES = {"prefill_1": 1, "prefill_5": 5, "prefill_256": 256,
              "decode_256": None}


@pytest.mark.parametrize("aid", ARCHS)
@pytest.mark.parametrize("case", list(KEPT_CASES))
def test_every_assignment_is_kept_and_the_logits_are_the_dense_oracles(
        aid, case, monkeypatch):
    """At a capacity factor of 0.5, under which the grouped training step
    keeps fewer than the t·k assignments at these sizes, the inference
    step's grouped products take all t·k rows; its logits are
    ``moe_impl="dense"``'s by the near-tie rule."""
    cfg = _cfg(aid, capacity_factor=0.5)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu",
                        dtype=torch.bfloat16)
    k = cfg.moe.top_k
    t = KEPT_CASES[case]
    if t is None:
        t = 256
        cache, batch = _decode_batch(cfg, t)

        def run(impl):
            return model.apply_decode(
                params, {n: v.clone() for n, v in cache.items()}, batch,
                **impl)[0]
    else:
        batch = _prompt(cfg, t, seed=t)

        def run(impl):
            return model.apply_prefill(params, batch, **impl)[0]
    assert moe_ep.capacity(t, k, 0.5) < t * k or t * k <= 8
    spy, patch = _spy_grouped()
    with torch.no_grad():
        with patch:
            got, gaps = _routed(monkeypatch, lambda: run({}))
        want = run({"moe_impl": "dense"})
    assert len(spy.calls) == 3 * cfg.n_layers
    for rows, offs in spy.calls:
        assert rows == offs[-1] == t * k
    _close_routed(got, want.numpy(), gaps)


# --------------------------------------------------------------------------
# (c) the engine; training and the sharded steps
# --------------------------------------------------------------------------

PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8])


def _serve(model, params, rec=None) -> tuple[list, ServingEngine]:
    eng = ServingEngine(model, params, max_batch=2, max_len=32,
                        device="cpu", telemetry=rec)
    ids = [eng.submit(np.asarray(p, np.int32), max_new_tokens=8)
           for p in PROMPTS]
    done = eng.run_until_done()
    return [done[i].generated for i in ids], eng


def _dense_steps(monkeypatch) -> None:
    """``apply_prefill`` and ``apply_decode`` pinned to the dense oracle."""
    for name in ("apply_prefill", "apply_decode"):
        monkeypatch.setattr(Model, name, functools.partialmethod(
            getattr(Model, name), moe_impl="dense"))


def test_engine_serves_the_dense_engines_tokens_through_the_routed_step(
        lm, monkeypatch):
    """The engine, which passes no ``moe_impl``, serves routed: the
    counter moves once per MoE layer of every model call and every
    ``layer.moe`` span names "routed".  Its greedy tokens are the engine's
    pinned to "dense"; where they first part, the dense logits' top-1/top-2
    margin there is under 5e-2 and the comparison stops."""
    cfg, model, params = lm
    rec = TelemetryRecorder("routed")
    with torch.no_grad():
        c0 = moe_ep.calls
        got, eng = _serve(model, params, rec)
        calls = len(eng.prefill_seconds) + len(eng.decode_seconds)
        assert moe_ep.calls - c0 == cfg.n_layers * calls
        moe = [e for e in rec.events
               if e.kind == "span" and e.name == "layer.moe"]
        assert len(moe) == cfg.n_layers * calls
        assert {e.attrs["impl"] for e in moe} == {"routed"}
        _dense_steps(monkeypatch)
        c1 = moe_ep.calls
        want, _ = _serve(model, params)
        assert moe_ep.calls == c1
        compared = 0
        for p, g, w in zip(PROMPTS, got, want):
            assert len(g) == len(w) == 8
            for i, (a, b) in enumerate(zip(g, w)):
                if a != b:
                    toks = torch.tensor([list(p) + w[:i]], dtype=torch.int32)
                    top = torch.sort(model.apply_train(
                        params, {"tokens": toks})[0, -1]).values[-2:]
                    assert float(top[1] - top[0]) < 5e-2, (i, a, b)
                    break
                compared += 1
    assert compared >= len(PROMPTS) * 8 // 2


def test_a_train_step_leaves_the_counter(lm):
    """``make_train_step`` under a plan's default lowering ("dense")."""
    cfg, model, params = lm
    step = train_loop.make_train_step(
        model, optim.OptConfig(warmup_steps=1),
        ShardingPlan(arch=cfg.name, shape="s", mesh=SINGLE_POD,
                     global_mode="data", local_layout="dp", batch_axes=()))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    c0 = moe_ep.calls
    _, _, metrics = step(params, optim.init(params),
                         {"tokens": toks, "targets": toks})
    assert np.isfinite(float(metrics["loss"]))
    assert moe_ep.calls == c0


def sharded_worker(rank: int, payload: dict) -> dict:
    """Reduced mixtral's sharded prefill and decode step at world 1 under
    the plan's lowering (``payload["impl"]``): the width-1 step's calls
    over both."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.sharding import MeshDesc, specs, spmd
    cfg = _cfg("mixtral-8x7b")
    model = build_model(cfg)
    mesh = make_smoke_mesh((1, 1), ("data", "model"), device_type="cpu")
    impl = payload["impl"]
    plan = ShardingPlan(arch=cfg.name, shape="t",
                        mesh=MeshDesc(("data", "model"), (1, 1)),
                        global_mode="data", local_layout="dp_tp_ep",
                        batch_axes=("data",), tp_axes=("model",),
                        moe_impl=impl)
    params = model.init(torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.bfloat16)
    batch = _prompt(cfg, 8)
    with torch.no_grad():
        sp = specs.param_shardings(mesh, params, plan)
        c0 = moe_ep.calls
        _, cache = spmd.make_sharded_prefill(model, plan, mesh)(sp, batch)
        local = {k: v.to_local() for k, v in cache.items()}
        pad = {k: torch.cat([v, torch.zeros_like(v)], 2)
               for k, v in local.items()}
        dc = specs.cache_shardings(mesh, pad, plan)
        spmd.make_sharded_decode(model, plan, mesh)(
            sp, dc, {"tokens": batch["tokens"][:, :1],
                     "lengths": batch["lengths"] + 1})
        calls = moe_ep.calls - c0
    return {"calls": calls}


@pytest.mark.parametrize("impl", ["ep_a2a", "dense"])
def test_the_sharded_steps_leave_the_counter(impl):
    """The sharded steps run their plan's lowering, the expert step across
    the EP axis (``_ep_step``) or the dense oracle, never the width-1
    step."""
    assert spawn(sharded_worker, 1, {"impl": impl}) == {"calls": 0}


def test_moe_apply_routed_is_moe_routed(lm):
    """``moe_apply(impl="routed")`` is ``moe_routed``, which is the grouped
    training step's arithmetic with every assignment kept.  It refuses a
    published mesh or tensor-parallel state, whose expert stacks may be
    shards."""
    cfg, _, params = lm
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)).bfloat16()
    got = L.moe_apply(cfg, p, x, impl="routed")
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(got, moe_ep.moe_routed(cfg, p, x))
    assert torch.equal(got, moe_ep.moe_ep_a2a(cfg, p, x,
                                              capacity_factor=8.0))
    with shard_ctx.plan_specs(None, None, mesh=object(), ep_axis="model"):
        with pytest.raises(ValueError, match="routed"):
            L.moe_apply(cfg, p, x, impl="routed")
    with shard_ctx.tensor_parallel(object()):
        with pytest.raises(ValueError, match="routed"):
            L.moe_apply(cfg, p, x, impl="routed")


def test_the_chip_smokes_copy_check_passes_the_grouped_gemm():
    """``chip_smoke``'s decode-step check fails on a long copy kernel; the
    grouped products' CUTLASS kernel, which the served decode step now
    runs, names copy atoms in its template arguments and is no copy."""
    import chip_smoke
    gemm = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_"
            "for_sm9xINS_4gemm6kernel13GemmUniversalIN4cute5tupleIJiiiiEEE"
            "NS4_10collective13CollectiveMmaINS4_9Copy_AtomEEE")
    assert not chip_smoke._is_copy(gemm)
    assert chip_smoke._is_copy(
        "void at::native::elementwise_kernel<128, 4, at::native::"
        "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda"
        "(at::TensorIteratorBase&)>(int)")
