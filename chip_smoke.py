#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port starts and is right on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit.  Imports nothing of jax and nothing of the JAX package.  Phases,
each of which exits non-zero when it fails:

1. the card (``nvidia-smi`` name and power limit); the kernels are built from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
2. each CUDA kernel against its plain PyTorch version on the card: the shape
   lists of ``tests/test_kernels.py`` in fp32 and bf16 at its ``TOL``, then
   the main path's gemma-2b shapes (head_dim 256, MQA, ragged, windowed);
3. the main path at full width: gemma-2b, all 18 layers, seeded random bf16
   weights, a ``ServingEngine(max_batch=4, max_len=1024)`` answering 8
   requests, with both kernels' launch counters read around the run; then
   prefill-then-decode logits against the full forward;
4. a profiler window over full decode steps (device-busy share), then
   times at the main path's shapes: kernel, plain version, one PyTorch
   library call (``scaled_dot_product_attention``, a yardstick the port never
   calls) and the card's bound; engine tokens/s, prefill and decode-step ms.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

# tests/test_kernels.py's lists (that module imports jax); a CPU test holds
# these copies equal to it.
SHAPES = [
    # (b, tq, tk, hq, hkv, d, window, causal, bq, bk)
    (1, 128, 128, 4, 4, 64, None, True, 64, 64),
    (2, 64, 64, 8, 2, 32, None, True, 16, 32),
    (2, 37, 53, 6, 3, 16, 12, True, 16, 16),
    (1, 32, 32, 4, 1, 128, None, False, 32, 16),
    (3, 1, 96, 8, 4, 64, None, True, 16, 32),
    (2, 80, 80, 5, 5, 48, 24, True, 32, 32),
]
DECODE_SHAPES = [
    # (b, s, hq, hkv, d, window, bk)
    (2, 128, 8, 2, 64, None, 32),
    (3, 96, 4, 4, 32, 24, 32),
    (1, 64, 8, 1, 128, None, 64),
    (4, 256, 12, 3, 64, 100, 128),
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# gemma-2b attention: 8 query heads over one kv head, head_dim 256
HQ, HKV, HD = 8, 1, 256
# prefill (B, T, window): the engine prefills one prompt of 32..512 tokens
# (the first entry, recorded in the kernels line); the windowed case is
# gemma3's 512-token local layer
PREFILL = [(1, 512, None), (1, 128, None), (4, 512, None), (2, 1024, 512)]
# decode (lengths, window) over a (4, 1024) cache; 0 is an empty slot.  The
# first entry holds the engine's lengths (prompts of up to 512 tokens plus
# 32 new ones) and is recorded in the kernels line.
DECODE_LENS = [([544, 400, 256, 96], None), ([1024, 700, 33, 1], None),
               ([1024, 517, 2, 0], 512)]
MAX_BATCH, MAX_LEN, N_REQUESTS, MAX_NEW = 4, 1024, 8, 32
# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def _randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _check(name, got, want, tol) -> float:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bound = tol + tol * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()) or bool((err > bound).any()):
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} over "
                             f"tolerance {tol}")
    return err.max().item()


def flash_case(b, tq, tk, hq, hkv, d, window, causal, dtype, lens, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn((b, tq, hq, d), dtype, gen)
    k = _randn((b, tk, hkv, d), dtype, gen)
    v = _randn((b, tk, hkv, d), dtype, gen)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, window=window, q_offset=tk - tq, lengths=lens)
    return (q, k, v), kw


def decode_case(b, s, hq, hkv, d, dtype, lens, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn((b, 1, hq, d), dtype, gen)
    kc = _randn((b, s, hkv, d), dtype, gen)
    vc = _randn((b, s, hkv, d), dtype, gen)
    return (q, kc, vc), torch.tensor(lens, dtype=torch.int32, device="cuda")


def check_kernels() -> dict:
    """Every kernel against its plain version; returns the largest error at
    the main path's shapes per kernel."""
    n = 0
    for i, (b, tq, tk, hq, hkv, d, win, caus, _, _) in enumerate(SHAPES):
        for dtype in TOL:
            lens = [tk] + [max(tk * 2 // 3, 1)] * (b - 1)
            args, kw = flash_case(b, tq, tk, hq, hkv, d, win, caus, dtype,
                                  lens, i)
            _check(f"flash {SHAPES[i]} {dtype}", fa.flash_attention(*args, **kw),
                   ref.attention_naive(*args, **kw), TOL[dtype])
            n += 1
    for i, (b, s, hq, hkv, d, win, _) in enumerate(DECODE_SHAPES):
        for dtype in TOL:
            lens = [s] + [max(s // 3, 1)] * (b - 1)
            args, lens = decode_case(b, s, hq, hkv, d, dtype, lens, 100 + i)
            _check(f"decode {DECODE_SHAPES[i]} {dtype}",
                   da.decode_attention(*args, lens, window=win),
                   ref.decode_attention_naive(*args, lens, window=win),
                   TOL[dtype])
            n += 1
    log(f"kernels vs plain, reference shape lists: {n} cases within TOL")
    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    cases = [(b, t, w, torch.bfloat16) for b, t, w in PREFILL]
    cases.append((1, 128, None, torch.float32))
    for i, (b, t, win, dtype) in enumerate(cases):
        lens = [t, t * 3 // 4, t // 2, t // 4][:b]
        args, kw = flash_case(b, t, t, HQ, HKV, HD, win, True, dtype, lens,
                              200 + i)
        err = _check(f"flash gemma-2b B={b} T={t} window={win} {dtype}",
                     fa.flash_attention(*args, **kw),
                     ref.attention_naive(*args, **kw), TOL[dtype])
        log(f"  flash   B={b} T={t:4d} window={win} {dtype}: "
            f"max|err| {err:.3e}")
        if dtype == torch.bfloat16:
            worst["flash_attention"] = max(worst["flash_attention"], err)
    for i, (lens, win) in enumerate(DECODE_LENS):
        for dtype in TOL:
            args, lt = decode_case(MAX_BATCH, MAX_LEN, HQ, HKV, HD, dtype,
                                   lens, 300 + i)
            err = _check(f"decode gemma-2b lens={lens} window={win} {dtype}",
                         da.decode_attention(*args, lt, window=win),
                         ref.decode_attention_naive(*args, lt, window=win),
                         TOL[dtype])
            log(f"  decode  B=4 S=1024 lens={lens} window={win} {dtype}: "
                f"max|err| {err:.3e}")
            if dtype == torch.bfloat16:
                worst["decode_attention"] = max(worst["decode_attention"],
                                                err)
    torch.cuda.synchronize()
    return worst


def drive_main_path(model, params, prompts) -> dict:
    """One engine run over ``prompts``; every count is reset just before and
    read just after."""
    eng = ServingEngine(model, params, max_batch=MAX_BATCH, max_len=MAX_LEN)
    rids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    fa.launches = da.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches}
    return dict(eng=eng, rids=rids, done=done, wall=wall, launches=launches)


def check_engine(run, cfg, n: int) -> int:
    done, rids = run["done"], run["rids"]
    if len(done) != n or sorted(done) != sorted(rids):
        raise AssertionError(f"served {len(done)} of {n} requests")
    tokens = 0
    for rid in rids:
        gen = done[rid].generated
        if not done[rid].done or len(gen) != MAX_NEW:
            raise AssertionError(f"request {rid} ended with {len(gen)} tokens")
        if not all(0 <= t < cfg.vocab for t in gen):
            raise AssertionError(f"request {rid}: token out of [0, vocab)")
        tokens += len(gen)
    for name, count in run["launches"].items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    return tokens


def check_prefill_then_decode(model, params, cfg) -> float:
    """Prefill P tokens, decode one, compare with the full forward at P."""
    b, s = 2, 256
    p = s - 1
    gen = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")
    _, pcache = model.apply_prefill(params, {
        "tokens": toks[:, :p],
        "lengths": torch.full((b,), p, dtype=torch.int32, device="cuda")})
    cache = model.init_cache(b, s)
    for k in cache:
        cache[k][:, :, :p] = pcache[k]
    got, _ = model.apply_decode(params, cache, {
        "tokens": toks[:, p:],
        "lengths": torch.full((b,), p + 1, dtype=torch.int32,
                              device="cuda")})
    want = model.apply_train(params, {"tokens": toks})[:, p]
    rel = ((got[:, 0] - want).norm() / want.norm()).item()
    log(f"prefill-then-decode vs full forward: relative error {rel:.3e}")
    if rel > 5e-2:
        raise AssertionError(f"prefill-then-decode: relative error {rel}")
    # Element-wise, 1e-1 and not the 5e-2 of tests/test_arch_smoke.py (which
    # the reduced 2-layer configs hold in tests/test_torch_model.py): at full
    # width cuBLAS picks different GEMM kernels for the 255-row prefill and
    # the 256-row forward, their bf16 outputs differ by an ulp here and
    # there, and that compounds over 18 layers (6.4e-2 seen on an H100).
    return _check("prefill-then-decode vs full forward", got[:, 0], want,
                  1e-1)


def decode_breakdown(model, params, prompts, steps: int = 8) -> str:
    """Where a decode step's time goes: ``steps`` steps of an engine whose
    four slots are full, under torch.profiler; the kernels' device time
    against the host clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = ServingEngine(model, params, max_batch=MAX_BATCH, max_len=MAX_LEN)
    for p in prompts[:MAX_BATCH]:
        eng.submit(p, max_new_tokens=MAX_NEW)
    eng.step()                                   # admit all four, warm up
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dur = (e.time_range.end - e.time_range.start) / 1e3 / steps
            by_name[e.name] = by_name.get(e.name, 0.0) + dur
    if not by_name:
        return (f"decode step {wall_ms:.3f} ms on the host clock; device "
                "time not measured (the profiler saw no kernels)")
    device_ms = sum(by_name.values())
    attn_ms = sum(v for k, v in by_name.items()
                  if "decode_kernel" in k or "flash_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return (f"decode step {wall_ms:.3f} ms on the host clock, kernels "
            f"{device_ms:.3f} ms on the device (busy {device_ms / wall_ms:.1%}"
            f", idle {1 - device_ms / wall_ms:.1%}), decode-attention kernel "
            f"{attn_ms:.3f} ms; top kernels: "
            + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))


def time_ms(fn, flush: torch.Tensor | None, reps: int = 20) -> float:
    """Median over ``reps`` of CUDA-event time around one call, after a
    warm-up call; ``flush`` (a buffer larger than L2) is rewritten before
    each call where the real caller finds its inputs cold."""
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _sdpa(q, k, v, mask):
    """One library call for the same function (GQA through enable_gqa)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def time_flash(b, t, win, flush) -> dict:
    lens = [t, t * 3 // 4, t // 2, t // 4][:b]
    args, kw = flash_case(b, t, t, HQ, HKV, HD, win, True, torch.bfloat16,
                          lens, 400)
    q, k, v = args
    pos = torch.arange(t, device="cuda")
    mask = (pos[None, :] <= pos[:, None])[None] & \
        (pos[None, None, :] < kw["lengths"][:, None, None].long())
    if win is not None:
        mask &= (pos[None, :] > pos[:, None] - win)[None]
    pairs = float(mask.sum())
    flops = 4.0 * HQ * HD * pairs
    nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b
    bound, by = _bound(flops, nbytes)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in args)
    m4 = mask[:, None]
    return dict(
        ms=time_ms(lambda: fa.flash_attention(*args, **kw), flush),
        plain_ms=time_ms(lambda: ref.attention_naive(*args, **kw), flush),
        library_ms=time_ms(lambda: _sdpa(qt, kt, vt, m4), flush),
        bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)


def time_decode(lens, win, flush) -> dict:
    args, lt = decode_case(MAX_BATCH, MAX_LEN, HQ, HKV, HD, torch.bfloat16,
                           lens, 500)
    q, kc, vc = args
    w = 2 ** 30 if win is None else win
    valid = [max(0, min(n, MAX_LEN) - max(0, n - w)) for n in lens]
    per_pos = 2 * HKV * HD * 2                         # k and v, bf16
    nbytes = float(sum(valid) * per_pos + 2 * 2 * q.numel() + 4 * len(lens))
    flops = 4.0 * HQ * HD * sum(valid)
    bound, by = _bound(flops, nbytes)
    pos = torch.arange(MAX_LEN, device="cuda")
    mask = (pos[None] < lt[:, None].long()) & (pos[None] >= lt[:, None] - w)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in args)
    m4 = mask[:, None, None]
    return dict(
        ms=time_ms(lambda: da.decode_attention(*args, lt, window=win), flush),
        plain_ms=time_ms(
            lambda: ref.decode_attention_naive(*args, lt, window=win), flush),
        library_ms=time_ms(lambda: _sdpa(qt, kt, vt, m4), flush),
        bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # 1. build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(_build.KERNELS)} "
        f"kernels into {_build.BUILD_DIR}")
    for kname in _build.KERNELS:
        report = _build.build_log(kname)
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", report)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                             report)]
        log(f"  ptxas {kname}: {len(regs)} instantiations, at most "
            f"{max(regs, default=0)} registers and "
            f"{max(spills, default=0)} bytes of spill stores")

    # 2. kernels against their plain versions
    worst = check_kernels()

    # 3. the main path at full width
    cfg = get_config("gemma-2b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"gemma-2b full width: {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
        f"parameters, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(32, 513, size=N_REQUESTS)]
    drive_main_path(model, params, prompts[:2])          # warm-up run
    torch.cuda.reset_peak_memory_stats()
    run = drive_main_path(model, params, prompts)
    tokens = check_engine(run, cfg, N_REQUESTS)
    eng = run["eng"]
    log(f"engine: {N_REQUESTS}/{N_REQUESTS} requests, prompt lengths "
        f"{[len(p) for p in prompts]}, {tokens} tokens in "
        f"{run['wall']:.3f} s = {tokens / run['wall']:.1f} tok/s; "
        f"median prefill {1e3 * statistics.median(eng.prefill_seconds):.3f} "
        f"ms, median decode step "
        f"{1e3 * statistics.median(eng.decode_seconds):.3f} ms over "
        f"{len(eng.decode_seconds)} steps; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    log(f"launches per engine run: {run['launches']}")
    err = check_prefill_then_decode(model, params, cfg)
    log(f"prefill-then-decode vs full forward (B=2, P=255): max|err| "
        f"{err:.3e} within 1e-1")
    log(f"where the time goes: {decode_breakdown(model, params, prompts)} "
        f"[{smi}]")
    launches = run["launches"]
    del params, eng, run
    torch.cuda.empty_cache()

    # 4. times at the main path's shapes
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    records = {}
    for b, t, win in PREFILL:
        r = time_flash(b, t, win, None)       # q/k/v were just produced: warm
        log(f"time flash  B={b} T={t:4d} window={win}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}) [{smi}]")
        records.setdefault("flash_attention", r)
    for lens, win in DECODE_LENS[:2]:
        r = time_decode(lens, win, flush)     # the cache is cold, as in serving
        log(f"time decode B=4 S=1024 lens={lens} window={win}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}) [{smi}]")
        records.setdefault("decode_attention", r)
    log(f"kernels: {list(_build.KERNELS)}")

    source = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:134"),
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:104")}
    kernels = []
    for kname in _build.KERNELS:
        r = records[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source[kname][0],
            "replaces": source[kname][1],
            "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
