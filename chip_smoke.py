#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port starts and is right on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100 and the CUDA
toolkit.  Imports nothing of jax and nothing of the JAX package.  Phases,
each of which exits non-zero when it fails:

1. the card (``nvidia-smi`` name and power limit); the three kernels are
   built from ``src/repro_torch/kernels/csrc`` (one nvcc per source, in
   parallel), and ptxas's registers and spill bytes are logged per
   instantiation (a tensor-core instantiation that spills fails: bf16
   attention, the TF32 SSD pass);
2. each CUDA kernel against its plain PyTorch version on the card: the shape
   lists of ``tests/test_kernels.py`` (attention in fp32 and bf16 at its
   ``TOL``, the SSD pass and the whole scan at its atol 1e-4), then the
   serving paths' shapes (gemma-2b attention: head_dim 256, MQA, ragged,
   windowed, prompts of 441 and 39 tokens, decode lengths 0/1/32/1024;
   hymba-1.5b attention: 25 heads over 5, head_dim 64, window 1024, in bf16
   and fp32; mamba2-780m's and hymba-1.5b's SSD at chunk 128 and 39, and a
   strong-decay case whose log-decay cumsum falls below -100 in a chunk);
3. calibrate and plan, the paper's analyzer loop: ``Profiler.profile_kernels``
   on ``cuda:0`` sweeps the three kernels through ``ops`` in fp32 at the JAX
   package's ``DEFAULT_KERNEL_SHAPES`` and the serving shapes timed in 5,
   keyed to the planner's H100 resource (``gpu_node("h100")``), and each
   kernel's counter must rise by exactly (warmup + repeats) x shapes; the
   fitted ``LearnedCostModel`` goes through a ``CalibrationStore`` and back
   unchanged; the ``CalibratedCostProvider`` must price gemma-2b's
   attention layers from the card's entry, not the datasheet, and backs a
   ``PlanCache`` over ``HiDPPlanner``.  One line per sample (key, kind,
   shape, ms, fitted rate) and, for the serving shapes, the sweep's time
   beside the queued device time of the same call;
4. three serving paths at full width, each a ``ServingEngine(max_batch=4,
   max_len=1024)`` on seeded random bf16 weights, every kernel's launch
   counter set to 0 just before the run and read just after:
   - gemma-2b, all 18 layers, 8 requests: flash and decode attention; the
     same requests again through the plan cache (its tenant
     ``block_costs`` of a 4 x 1024 decode step) and a ``FeedbackLoop``
     (1 miss and 7 hits, plus a re-plan per drift event; every decode step
     after the first observed; the same greedy tokens), then
     prefill-then-decode logits against the full forward and a profiler
     window over decode steps (device-busy share);
   - mamba2-780m, all 48 layers, 8 requests: the SSD kernel and no
     attention kernel, then prefill-then-decode against the full forward
     and profiler windows over decode steps and over one prefill;
   - hymba-1.5b, all 32 layers, 4 requests: all three kernels, and the
     two profiler windows;
5. times at the serving shapes: kernel, plain version, one PyTorch library
   call where one computes the same function (``scaled_dot_product_attention``
   for attention, a yardstick the port never calls; none for the SSD pass),
   their ratio and the card's bound (for the SSD pass at every
   ``SSD_PREFILL`` shape); engine tokens/s, prefill and
   decode-step ms.  Kernel times are device times: the timed call waits in
   the stream behind a sleep kernel, so the host's enqueue is not in them
   (the attention lines also give the time with it).

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ANALYTIC, Cluster, HiDPPlanner,  # noqa: E402
                              PlannerConfig, gpu_node, node_as_resource,
                              plan_to_dict, processors_as_resources)
from repro_torch.kernels import _build, ops, ref, ssd_scan  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import ShapeConfig, build_model  # noqa: E402
from repro_torch.profiling import (DEFAULT_KERNEL_SHAPES,  # noqa: E402
                                   CalibratedCostProvider, CalibrationStore,
                                   FeedbackLoop, LearnedCostModel, Profiler)
from repro_torch.profiling.profiler import kernel_call  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.plan_cache import PlanCache  # noqa: E402

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
SSD_SHAPES = [(1, 64, 4, 8, 16, 16), (2, 48, 2, 16, 8, 8),
              (1, 33, 3, 8, 4, 16), (2, 128, 8, 16, 32, 32)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_ATOL = 1e-4

# gemma-2b attention: 8 query heads over one kv head, head_dim 256
HQ, HKV, HD = 8, 1, 256
# hymba-1.5b attention: 25 query heads over 5 kv heads, head_dim 64, every
# layer windowed at 1024
HYMBA_ATTN = (25, 5, 64, 1024)
# the engine's longest and shortest prompts: ragged q and kv tiles
RAGGED_PREFILL = (441, 39)
# prefill (B, T, window): the engine prefills one prompt of 32..512 tokens
# (the first entry, recorded in the kernels line); the windowed case is
# gemma3's 512-token local layer
PREFILL = [(1, 512, None), (1, 128, None), (4, 512, None), (2, 1024, 512)]
# decode (lengths, window) over a (4, 1024) cache; 0 is an empty slot.  The
# first entry holds the engine's lengths (prompts of up to 512 tokens plus
# 32 new ones) and is recorded in the kernels line.
DECODE_LENS = [([544, 400, 256, 96], None), ([1024, 700, 33, 1], None),
               ([1024, 517, 2, 0], 512), ([0, 1, 32, 1024], None)]
# the SSD pass at the serving widths, (b, t, nh, hd, n, chunk): a 512-token
# prompt (four chunks of 128, the first entry is recorded in the kernels
# line) and a 39-token one (one short chunk), for mamba2-780m (48 heads,
# d_state 128) and hymba-1.5b (50 heads, d_state 16)
SSD_PREFILL = [(1, 512, 48, 64, 128, 128), (1, 39, 48, 64, 128, 128),
               (1, 512, 50, 64, 16, 128), (1, 39, 50, 64, 16, 128)]
# strong decay: mamba2 widths with A scaled by 20, so that the log-decay
# cumsum falls below -100 inside a chunk and exp(dacs_i - dacs_j) overflows
# for j > i (the kernel selects before the exp)
STRONG_DECAY, STRONG_DECAY_A = (1, 256, 48, 64, 128, 128), 20.0
MAX_BATCH, MAX_LEN, N_REQUESTS, MAX_NEW = 4, 1024, 8, 32
HYBRID_REQUESTS = 4
# published dense peaks of one H100 SXM (NVIDIA data sheet): bf16 and TF32
# tensor cores, memory
PEAK_BF16_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES = 989e12, 495e12, 3.35e12
# each kernel's wrapper module, whose ``launches`` counts its calls that
# launched the kernel (a decode-attention call is two launches: split and
# combine)
COUNTERS = {"flash_attention": fa, "decode_attention": da,
            "ssd_intra_chunk": ssd_scan}
# the kernel kind each counter's calls are swept under by
# ``Profiler.profile_kernels``
SWEEP_KINDS = {"attn": "flash_attention", "decode": "decode_attention",
               "ssd": "ssd_intra_chunk"}
# the calibration sweep: the JAX package's DEFAULT_KERNEL_SHAPES plus the
# serving shapes timed below, in the sweep's layouts ((B, T, H, D) with one
# head count for attention, so gemma-2b's 8 query heads at head_dim 256;
# (B, T, NH, HD, N) for the SSD scan, mamba2-780m's widths over a 512-token
# prompt)
SWEEP_SERVING = {"attn": ((1, 512, HQ, HD),),
                 "decode": ((MAX_BATCH, MAX_LEN, HQ, HD),),
                 "ssd": ((1, 512, 48, 64, 128),)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def _randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _check(name, got, want, tol, rtol=None) -> float:
    """|got - want| <= tol + rtol * |want| element-wise (rtol defaults to
    tol), and got finite; returns the largest |got - want|."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bound = tol + (tol if rtol is None else rtol) * want.float().abs()
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


def ssd_case(b, t, nh, hd, n, seed, a_scale=1.0):
    """(x, dt, A, B, C, D) drawn like tests/test_kernels.py::_mk_ssd, A
    multiplied by ``a_scale``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return (rn(b, t, nh, hd) * 0.5,
            torch.nn.functional.softplus(rn(b, t, nh)) * 0.1,
            -torch.exp(rn(nh)) * a_scale, rn(b, t, n) * 0.3,
            rn(b, t, n) * 0.3, torch.full((nh,), 0.1, device="cuda"))


def check_ssd(shape, seed, a_scale=1.0) -> float:
    """The SSD kernel against its plain version, and the whole scan around
    it against ``ref.ssd_chunked`` with and without an incoming state, at
    atol 1e-4; returns the kernel's largest error."""
    b, t, nh, hd, n, chunk = shape
    x, dt, A, B, C, D = ssd_case(b, t, nh, hd, n, seed, a_scale)
    ops_ = ssd_scan.chunk_operands(x, dt, A, B, C, chunk)
    got = ssd_scan.ssd_intra_chunk(*ops_, nh=nh, hd=hd)
    want = ref.ssd_intra_chunk(*ops_, nh=nh, hd=hd)
    err = max(_check(f"ssd_intra_chunk {shape} {part}", g, w, SSD_ATOL, 0.0)
              for part, g, w in zip(("y_diag", "states"), got, want))
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    h0 = torch.randn((b, nh, hd, n), generator=gen, device="cuda") * 0.1
    for h in (None, h0):
        got = ssd_scan.ssd(x, dt, A, B, C, D, chunk=chunk, h0=h)
        want = ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk, h0=h)
        for part, g, w in zip(("y", "state"), got, want):
            _check(f"ssd {shape} h0={h is not None} {part}", g, w, SSD_ATOL,
                   0.0)
    return err


def check_serving_attention(hq, hkv, hd, window, prefill, decode_lens,
                            seed, tag) -> tuple[float, float]:
    """Flash and decode attention at one model's serving heads against their
    plain versions, in bf16 and fp32; prefill (b, t) over t tokens with
    lengths t, 3t/4, ..., decode over a (4, 1024) cache.  Returns the
    largest bf16 errors (flash, decode)."""
    worst = [0.0, 0.0]
    for i, ((b, t), dtype) in enumerate(
            (c, dt) for c in prefill for dt in TOL):
        lens = [t, t * 3 // 4, t // 2, t // 4][:b]
        args, kw = flash_case(b, t, t, hq, hkv, hd, window, True, dtype, lens,
                              seed + i)
        err = _check(f"flash {tag} B={b} T={t} window={window} {dtype}",
                     fa.flash_attention(*args, **kw),
                     ref.attention_naive(*args, **kw), TOL[dtype])
        log(f"  flash   {tag} B={b} T={t:4d} window={window} {dtype}: "
            f"max|err| {err:.3e}")
        if dtype == torch.bfloat16:
            worst[0] = max(worst[0], err)
    for i, (lens, dtype) in enumerate(
            (c, dt) for c in decode_lens for dt in TOL):
        args, lt = decode_case(MAX_BATCH, MAX_LEN, hq, hkv, hd, dtype, lens,
                               seed + 50 + i)
        err = _check(f"decode {tag} lens={lens} window={window} {dtype}",
                     da.decode_attention(*args, lt, window=window),
                     ref.decode_attention_naive(*args, lt, window=window),
                     TOL[dtype])
        log(f"  decode  {tag} B=4 S=1024 lens={lens} window={window} "
            f"{dtype}: max|err| {err:.3e}")
        if dtype == torch.bfloat16:
            worst[1] = max(worst[1], err)
    return worst[0], worst[1]


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
    for i, shape in enumerate(SSD_SHAPES):
        check_ssd(shape, 600 + i)
        n += 1
    log(f"kernels vs plain, reference shape lists: {n} cases within TOL "
        f"(attention) and atol {SSD_ATOL} (SSD)")
    worst = {"flash_attention": 0.0, "decode_attention": 0.0,
             "ssd_intra_chunk": 0.0}
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
    gemma_flash, _ = check_serving_attention(
        HQ, HKV, HD, None, [(1, t) for t in RAGGED_PREFILL], [], 850,
        "gemma-2b")
    worst["flash_attention"] = max(worst["flash_attention"], gemma_flash)
    hymba_flash, hymba_decode = check_serving_attention(
        *HYMBA_ATTN, [(1, t) for t in RAGGED_PREFILL],
        [DECODE_LENS[0][0], DECODE_LENS[3][0]], 900, "hymba-1.5b")
    worst["flash_attention"] = max(worst["flash_attention"], hymba_flash)
    worst["decode_attention"] = max(worst["decode_attention"], hymba_decode)
    for i, shape in enumerate(SSD_PREFILL):
        err = check_ssd(shape, 700 + i)
        log(f"  ssd     {shape}: max|err| {err:.3e}")
        worst["ssd_intra_chunk"] = max(worst["ssd_intra_chunk"], err)
    b, t, nh, hd, n, chunk = STRONG_DECAY
    x, dt, A = ssd_case(b, t, nh, hd, n, 750, STRONG_DECAY_A)[:3]
    low = float(torch.cumsum(dt.reshape(b, -1, chunk, nh) * A, 2).min())
    if low >= -100:
        raise AssertionError(f"strong-decay case reaches only {low:.1f}")
    err = check_ssd(STRONG_DECAY, 750, STRONG_DECAY_A)
    log(f"  ssd     {STRONG_DECAY} strong decay (A x {STRONG_DECAY_A}, "
        f"log-decay down to {low:.1f}): max|err| {err:.3e}")
    torch.cuda.synchronize()
    return worst


def drive_main_path(model, params, prompts, **engine_kw) -> dict:
    """One engine run over ``prompts`` (``engine_kw`` reaches the engine:
    a plan cache, a feedback loop); every count is reset just before and
    read just after."""
    eng = ServingEngine(model, params, max_batch=MAX_BATCH, max_len=MAX_LEN,
                        **engine_kw)
    rids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    for mod in COUNTERS.values():
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: mod.launches for k, mod in COUNTERS.items()}
    return dict(eng=eng, rids=rids, done=done, wall=wall, launches=launches)


def check_engine(run, cfg, n: int, kernels) -> int:
    """All ``n`` requests answered with MAX_NEW in-vocab tokens each; the
    kernels named in ``kernels`` launched in the run and no other."""
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
        if name in kernels and count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        if name not in kernels and count != 0:
            raise AssertionError(f"{name} launched {count} times on a path "
                                 "that does not run it")
    return tokens


def check_prefill_then_decode(model, params, cfg, limit: float) -> float:
    """Prefill P tokens, decode one, compare with the full forward at P:
    5e-2 in relative norm, ``limit`` element-wise.  Logs beside it how far
    the forward over P tokens and over P + 1 tokens part at position P - 1:
    0 means the prompt's positions are computed exactly alike, and the
    error is the decode step's own arithmetic."""
    b, s = 2, 256
    p = s - 1
    gen = torch.Generator(device="cuda").manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")
    _, pcache = model.apply_prefill(params, {
        "tokens": toks[:, :p],
        "lengths": torch.full((b,), p, dtype=torch.int32, device="cuda")})
    cache = model.init_cache(b, s)
    for k, v in pcache.items():
        if k in ("k", "v"):                 # positions: the prompt's prefix
            cache[k][:, :, :p] = v
        else:                               # SSM state, conv context: whole
            cache[k].copy_(v)
    got, _ = model.apply_decode(params, cache, {
        "tokens": toks[:, p:],
        "lengths": torch.full((b,), p + 1, dtype=torch.int32,
                              device="cuda")})
    full = model.apply_train(params, {"tokens": toks})
    want = full[:, p]
    floor = (model.apply_train(params, {"tokens": toks[:, :p]})[:, p - 1]
             - full[:, p - 1]).abs().max().item()
    rel = ((got[:, 0] - want).norm() / want.norm()).item()
    top = (got[:, 0] - want).abs().max().item()
    log(f"prefill-then-decode vs full forward: relative error {rel:.3e}, "
        f"largest element {top:.3e}; forward over P vs P + 1 tokens at "
        f"P - 1: {floor:.3e}")
    if rel > 5e-2:
        raise AssertionError(f"prefill-then-decode: relative error {rel}")
    return _check("prefill-then-decode vs full forward", got[:, 0], want,
                  limit)


# Element-wise limits of the prefill-then-decode check, and why they are not
# the 5e-2 of tests/test_arch_smoke.py (which the reduced 2-layer configs
# hold in tests/test_torch_model.py and tests/test_torch_ssm.py).  On an
# H100 the forward over 255 and over 256 tokens agree exactly at position
# 254, so the prompt's cache is exact; the error is the decode step's.  Its
# GEMMs run on B = 2 rows where the full forward's run on 512, cuBLAS runs
# other kernels for them (skinny ``nvjet_tst_*x8_*`` ones in the decode
# profile), their bf16 outputs round differently here and there, and that
# compounds over the layers: 6.25e-2 seen over gemma-2b's 18 layers,
# 1.31e-1 over mamba2-780m's 48 (relative error 3.35e-2), where the SSD
# state also enters the decode step from the kernel's chunked sums.
PTD_LIMIT = {"gemma-2b": 1e-1, "mamba2-780m": 2e-1}


OUR_KERNELS = ("flash_bf16", "flash_f32", "decode_split", "decode_combine",
               "ssd_intra_chunk_kernel")


def _profiled(fn, reps: int, what: str) -> str:
    """``fn`` run ``reps`` times under torch.profiler: the kernels' device
    time per run against the host clock, the hand-written kernels' share
    and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dur = (e.time_range.end - e.time_range.start) / 1e3 / reps
            by_name[e.name] = by_name.get(e.name, 0.0) + dur
    if not by_name:
        return (f"{what} {wall_ms:.3f} ms on the host clock; device time not "
                "measured (the profiler saw no kernels)")
    device_ms = sum(by_name.values())
    ours_ms = sum(v for k, v in by_name.items()
                  if any(o in k for o in OUR_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return (f"{what} {wall_ms:.3f} ms on the host clock, kernels "
            f"{device_ms:.3f} ms on the device (busy {device_ms / wall_ms:.1%}"
            f", idle {1 - device_ms / wall_ms:.1%}), {len(by_name)} kernel "
            f"names, hand-written kernels {ours_ms:.3f} ms; top kernels: "
            + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))


def decode_breakdown(model, params, prompts, steps: int = 8) -> str:
    """Where a decode step's time goes: ``steps`` steps of an engine whose
    four slots are full."""
    eng = ServingEngine(model, params, max_batch=MAX_BATCH, max_len=MAX_LEN)
    for p in prompts[:MAX_BATCH]:
        eng.submit(p, max_new_tokens=MAX_NEW)
    eng.step()                                   # admit all four, warm up
    eng.step()
    return _profiled(eng.step, steps, "decode step")


def prefill_breakdown(model, params, prompt, reps: int = 2) -> str:
    """Where a prefill's time goes: ``model.apply_prefill`` of one prompt,
    as the engine's admit calls it, after a warm-up call."""
    batch = {"tokens": torch.as_tensor(prompt[None, :], device="cuda"),
             "lengths": torch.tensor([len(prompt)], dtype=torch.int32,
                                     device="cuda")}
    model.apply_prefill(params, batch)
    return _profiled(lambda: model.apply_prefill(params, batch), reps,
                     f"prefill of {len(prompt)} tokens")


# a sleep kernel this long (about a millisecond) keeps the device busy while
# the host enqueues the timed call, so that the events time the device alone
SLEEP_CYCLES = 2_000_000


def time_ms(fn, flush: torch.Tensor | None, reps: int = 20,
            queued: bool = True) -> float:
    """Median over ``reps`` of CUDA-event time around one call, after a
    warm-up call; ``flush`` (a buffer larger than L2) is rewritten before
    each call where the real caller finds its inputs cold.  ``queued``: the
    call is enqueued behind a sleep kernel, so the time is the device's
    (its kernels and the gaps between them); otherwise the device also
    waits for the host to enqueue the call, as a lone call in an idle
    stream does."""
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _times(kernel, plain, library, flush) -> dict:
    """Device times of the kernel, its plain version and the library call,
    and the kernel's and the library call's times with the host's enqueue
    (``*_call_ms``)."""
    return dict(
        ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush),
        library_ms=time_ms(library, flush),
        call_ms=time_ms(kernel, flush, queued=False),
        library_call_ms=time_ms(library, flush, queued=False))


def _bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS
           ) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _sdpa(q, k, v, mask):
    """One library call for the same function (GQA through enable_gqa)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def time_flash(b, t, win, flush, heads=(HQ, HKV, HD)) -> dict:
    hq, hkv, hd = heads
    lens = [t, t * 3 // 4, t // 2, t // 4][:b]
    args, kw = flash_case(b, t, t, hq, hkv, hd, win, True, torch.bfloat16,
                          lens, 400)
    q, k, v = args
    pos = torch.arange(t, device="cuda")
    mask = (pos[None, :] <= pos[:, None])[None] & \
        (pos[None, None, :] < kw["lengths"][:, None, None].long())
    if win is not None:
        mask &= (pos[None, :] > pos[:, None] - win)[None]
    pairs = float(mask.sum())
    flops = 4.0 * hq * hd * pairs
    nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b
    bound, by = _bound(flops, nbytes)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in args)
    m4 = mask[:, None]
    return dict(
        **_times(lambda: fa.flash_attention(*args, **kw),
                 lambda: ref.attention_naive(*args, **kw),
                 lambda: _sdpa(qt, kt, vt, m4), flush),
        bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)


def time_decode(lens, win, flush, heads=(HQ, HKV, HD)) -> dict:
    hq, hkv, hd = heads
    args, lt = decode_case(MAX_BATCH, MAX_LEN, hq, hkv, hd, torch.bfloat16,
                           lens, 500)
    q, kc, vc = args
    w = 2 ** 30 if win is None else win
    valid = [max(0, min(n, MAX_LEN) - max(0, n - w)) for n in lens]
    per_pos = 2 * hkv * hd * 2                         # k and v, bf16
    nbytes = float(sum(valid) * per_pos + 2 * 2 * q.numel() + 4 * len(lens))
    flops = 4.0 * hq * hd * sum(valid)
    bound, by = _bound(flops, nbytes)
    pos = torch.arange(MAX_LEN, device="cuda")
    mask = (pos[None] < lt[:, None].long()) & (pos[None] >= lt[:, None] - w)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in args)
    m4 = mask[:, None, None]
    return dict(
        **_times(lambda: da.decode_attention(*args, lt, window=win),
                 lambda: ref.decode_attention_naive(*args, lt, window=win),
                 lambda: _sdpa(qt, kt, vt, m4), flush),
        bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)


def time_ssd(shape) -> dict:
    """The SSD pass at a serving shape.  Its least work: scores C.B^T once
    per chunk (2 c^2 n), y_diag over the causal pairs only
    (2 nh hd c(c+1)/2) and the states (2 nh c n hd).  The kernel runs these
    fp32 products on the TF32 tensor cores as three TF32 products each
    (3xTF32, which keeps fp32 accuracy), so the operations' bound is 3x the
    FLOPs at the TF32 peak; bytes are each fp32 input read once and each
    output written once."""
    b, t, nh, hd, n, chunk = shape
    ops_ = ssd_scan.chunk_operands(*ssd_case(b, t, nh, hd, n, 800)[:5],
                                   chunk)
    _, nc, c, _ = ops_[0].shape
    pairs = c * (c + 1) / 2
    flops = float(b * nc * (2 * c * c * n + 2 * nh * hd * pairs
                            + 2 * nh * c * n * hd))
    out = b * nc * (c * nh * hd + nh * n * hd)
    nbytes = 4.0 * (sum(o.numel() for o in ops_) + out)
    bound, by = _bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    return dict(
        ms=time_ms(lambda: ssd_scan.ssd_intra_chunk(*ops_, nh=nh, hd=hd),
                   None),
        plain_ms=time_ms(lambda: ref.ssd_intra_chunk(*ops_, nh=nh, hd=hd),
                         None),
        library_ms=None, bound_ms=bound, bound_by=by, flops=flops,
        bytes=nbytes)


def calibrate_and_plan(smi: str) -> dict:
    """The paper's analyzer loop on the card, feeding the planner: the
    kernel sweep (``Profiler.profile_kernels`` on ``cuda:0``, keyed to the
    H100 node's GPU resource) launches each hand-written kernel exactly
    (warmup + repeats) x shapes times; the fitted ``LearnedCostModel``
    goes through a ``CalibrationStore`` and back unchanged; the calibrated
    provider prices gemma-2b's attention layers from the card's entry on
    both planner tiers.  Returns what the planned serving run needs."""
    shapes = {k: DEFAULT_KERNEL_SHAPES[k] + SWEEP_SERVING[k]
              for k in DEFAULT_KERNEL_SHAPES}
    node = gpu_node("h100")                    # the card as a node of one GPU
    cluster = Cluster((node,))
    gpu = processors_as_resources(node)[0]
    key = gpu.profile_key or gpu.name          # what the provider looks up
    prof = Profiler(warmup=2, repeats=5, trim=1)
    for mod in COUNTERS.values():
        mod.launches = 0
    t0 = time.perf_counter()
    samples = prof.profile_kernels(device="cuda:0", shapes=shapes, key=key)
    sweep_s = time.perf_counter() - t0
    launches = {kind: COUNTERS[k].launches for kind, k in SWEEP_KINDS.items()}
    for kind, count in launches.items():
        want = (prof.warmup + prof.repeats) * len(shapes[kind])
        if count != want:
            raise AssertionError(f"the {kind} sweep launched "
                                 f"{SWEEP_KINDS[kind]} {count} times, "
                                 f"expected {want}")
    log(f"calibration sweep on cuda:0 keyed {key!r}: {len(samples)} samples "
        f"in {sweep_s:.3f} s; kernel calls {launches} = (warmup "
        f"{prof.warmup} + repeats {prof.repeats}) x shapes per kind")

    fitted = LearnedCostModel.fit(samples)
    with tempfile.TemporaryDirectory() as tmp:
        store = CalibrationStore(tmp)
        version = store.save(cluster, fitted, note=f"chip_smoke [{smi}]")
        loaded = store.load(cluster, version)
    if loaded.to_json() != fitted.to_json():
        raise AssertionError("the calibration read back from the store "
                             "differs from the one saved")
    log(f"calibration store: saved and reloaded version {version} under "
        f"fingerprint {store.fingerprint(cluster)}, equal JSON")
    order = [(kind, shape) for kind in shapes for shape in shapes[kind]]
    for (kind, shape), s in zip(order, samples):
        if s.kind != kind:
            raise AssertionError(f"sample {s} out of the sweep's order")
        log(f"  sample {s.key} {kind:6s} {'x'.join(map(str, shape)):17s}: "
            f"{1e3 * s.latency_s:.4f} ms, {s.work / s.latency_s / 1e9:.4g} "
            f"GFLOP/s; fitted rate {loaded.rate(key, kind) / 1e9:.4g} "
            f"GFLOP/s [{smi}]")
    for kind, e in sorted(loaded.entries.items()):
        log(f"  fit {kind}: a {e.a:.4e} s/FLOP, b {e.b:.4e} s/byte, c "
            f"{e.c:.4e} s, mape {e.mape:.3f} over {e.n} samples")
    for kind, (shape,) in SWEEP_SERVING.items():
        fn, _, _ = kernel_call(kind, shape, device=torch.device("cuda", 0),
                               seed=prof.seed)
        lat = samples[order.index((kind, shape))].latency_s
        log(f"  {kind:6s} {'x'.join(map(str, shape))} fp32: sweep "
            f"{1e3 * lat:.4f} ms (one call as its caller sees it); queued "
            f"device time {time_ms(fn, None):.4f} ms; lone call "
            f"{time_ms(fn, None, queued=False):.4f} ms [{smi}]")

    provider = CalibratedCostProvider(loaded)
    dag = build_model(get_config("gemma-2b")).block_costs(
        ShapeConfig("serve", MAX_LEN, MAX_BATCH, "decode"))
    attn = [b for b in dag.blocks if b.kind == "attn"]
    if not attn or loaded.entry(key, "attn") is None:
        raise AssertionError("no attention blocks, or no attn entry")
    for r in (node_as_resource(node), gpu):
        if provider.effective_rate(r, "attn") != loaded.rate(key, "attn"):
            raise AssertionError(f"{r.name} is not priced at the card's rate")
        for b in attn:
            if provider.block_time(r, b) == ANALYTIC.compute_time(
                    b.flops, r, b.kind):
                raise AssertionError(f"{r.name} prices {b.name} from the "
                                     "datasheet, not the card's entry")
    per_layer = provider.block_time(gpu, attn[0])
    log(f"calibrated provider: {len(attn)} attention layers of {dag.name} "
        f"priced from ({key!r}, 'attn') on the node and GPU tiers, "
        f"{1e3 * per_layer:.4g} ms a layer (datasheet "
        f"{1e3 * ANALYTIC.compute_time(attn[0].flops, gpu):.4g} ms)")
    datasheet = HiDPPlanner().plan(dag, cluster).predicted_latency
    cache = PlanCache(HiDPPlanner(PlannerConfig(provider=provider)), cluster,
                      version=version)
    return dict(loaded=loaded, version=version, cache=cache, dag=dag,
                datasheet=datasheet)


def serve_planned(model, params, prompts, run, plan, smi: str) -> None:
    """The counted run again, now with submits resolved through the
    calibrated ``PlanCache`` and decode steps fed to a ``FeedbackLoop``: one
    frontier pass on the first submit and a hit for every other (plus one
    re-plan per drift event, if the loop reports one), every decode step
    after the first observed, and the same greedy tokens as the run
    without a cache (on one card the plan does not change the
    computation)."""
    cache = plan["cache"]
    n = len(run["rids"])
    fb = FeedbackLoop(plan["loaded"], calibration_version=plan["version"])
    planned = drive_main_path(model, params, prompts[:n], plan_cache=cache,
                              default_dag=plan["dag"], feedback=fb)
    check_engine(planned, model.cfg, n, ("flash_attention",
                                         "decode_attention"))
    eng = planned["eng"]
    if cache.hits != n - 1 or cache.misses != 1 + eng.replans:
        raise AssertionError(f"plan cache: {cache.misses} misses and "
                             f"{cache.hits} hits for {n} submits and "
                             f"{eng.replans} re-plans")
    if eng.replans != fb.replans:
        raise AssertionError(f"{eng.replans} re-plans for {fb.replans} "
                             "drift events")
    if fb.observations != len(eng.decode_seconds) - 1:
        raise AssertionError(f"the feedback loop observed {fb.observations} "
                             f"of {len(eng.decode_seconds)} decode steps")
    for a, b in zip(run["rids"], planned["rids"]):
        if run["done"][a].generated != planned["done"][b].generated:
            raise AssertionError(f"request {b} emitted other tokens with "
                                 "the plan cache than without")
    p = eng.plan
    tokens = n * MAX_NEW
    log(f"{model.cfg.name} planned run: {n} submits, plan cache "
        f"{cache.misses} miss(es) and {cache.hits} hits, {eng.replans} "
        f"re-plan(s) on drift, feedback observed {fb.observations} of "
        f"{len(eng.decode_seconds)} decode steps, greedy tokens equal to "
        f"the run without a cache; {tokens / planned['wall']:.1f} tok/s "
        f"(without: {tokens / run['wall']:.1f}); plan {p.mode}-mode, "
        f"local plan {plan_to_dict(p)['local_plans'][0]['mode']}-mode, "
        f"predicted {1e3 * p.predicted_latency:.4f} ms a decode step "
        f"(datasheet plan {1e3 * plan['datasheet']:.4f} ms), measured "
        f"median {1e3 * statistics.median(eng.decode_seconds):.4f} ms "
        f"[{smi}]")
    stats = cache.stats()
    log("plan cache stats: " + json.dumps(
        {k: stats[k] for k in ("hits", "misses", "invalidations", "entries",
                               "nbytes", "version", "hit_rate",
                               "fingerprint")}))
    log(f"launches in the planned run: {planned['launches']}")


def serve(aid: str, n_requests: int, kernels, smi: str):
    """Seeded full-width bf16 weights for ``aid``, a warm-up engine run,
    then the counted run over ``n_requests`` prompts (numpy seed 0, 32..512
    tokens); returns (cfg, model, params, prompts, run)."""
    cfg = get_config(aid)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"{aid} full width: {cfg.n_layers} layers, {n_params / 1e9:.3f} B "
        f"parameters, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(32, 513, size=N_REQUESTS)]
    drive_main_path(model, params, prompts[:2])          # warm-up run
    torch.cuda.reset_peak_memory_stats()
    run = drive_main_path(model, params, prompts[:n_requests])
    tokens = check_engine(run, cfg, n_requests, kernels)
    eng = run["eng"]
    log(f"{aid} engine: {n_requests}/{n_requests} requests, prompt lengths "
        f"{[len(p) for p in prompts[:n_requests]]}, {tokens} tokens in "
        f"{run['wall']:.3f} s = {tokens / run['wall']:.1f} tok/s; "
        f"median prefill {1e3 * statistics.median(eng.prefill_seconds):.3f} "
        f"ms, median decode step "
        f"{1e3 * statistics.median(eng.decode_seconds):.3f} ms over "
        f"{len(eng.decode_seconds)} steps; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    log(f"{aid} launches per engine run: {run['launches']}")
    return cfg, model, params, prompts, run


# the tensor-core instantiations, which must not spill (their accumulators
# live in registers): bf16 attention, and every instantiation of the SSD
# pass (3xTF32)
TENSOR_CORE_KERNELS = ("flash_bf16", "decode_split_bf16",
                       "ssd_intra_chunk_kernel")


def log_ptxas(kname: str, report: str) -> None:
    """Registers and spill bytes per kernel instantiation from ptxas's
    report; raises if a tensor-core instantiation spills."""
    entries = re.findall(r"Compiling entry function '(\w+)'.*?"
                         r"(\d+) bytes spill stores.*?Used (\d+) registers",
                         report, flags=re.S)
    names = [n for n, _, _ in entries]
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.split("\n")
    except (OSError, subprocess.SubprocessError):
        pass                                 # keep the mangled names
    log(f"  ptxas {kname}: {len(entries)} instantiations")
    for name, (_, spill, regs) in zip(names, entries):
        short = re.sub(r"\(.*", "", name.replace("(anonymous namespace)::",
                                                  ""))
        log(f"    {short}: {regs} registers, {spill} bytes spill stores")
        if int(spill) and any(k in name for k in TENSOR_CORE_KERNELS):
            raise AssertionError(f"{short} spills {spill} bytes")
    for line in report.splitlines():
        if "warning" in line.lower():
            log(f"    {line.strip()}")


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
        log_ptxas(kname, _build.build_log(kname))

    # 2. kernels against their plain versions
    worst = check_kernels()

    # 3. calibrate and plan: the kernel sweep calibrates the planner
    plan = calibrate_and_plan(smi)

    # 4. the serving paths at full width; gemma-2b also through the plan
    cfg, model, params, prompts, run = serve(
        "gemma-2b", N_REQUESTS, ("flash_attention", "decode_attention"), smi)
    serve_planned(model, params, prompts, run, plan, smi)
    err = check_prefill_then_decode(model, params, cfg, PTD_LIMIT[cfg.name])
    log(f"prefill-then-decode vs full forward (B=2, P=255): max|err| "
        f"{err:.3e} within {PTD_LIMIT[cfg.name]}")
    log(f"where the time goes: {decode_breakdown(model, params, prompts)} "
        f"[{smi}]")
    launches = dict(run["launches"])
    del params, model, run
    torch.cuda.empty_cache()

    cfg, model, params, prompts, run = serve(
        "mamba2-780m", N_REQUESTS, ("ssd_intra_chunk",), smi)
    err = check_prefill_then_decode(model, params, cfg, PTD_LIMIT[cfg.name])
    log(f"mamba2-780m prefill-then-decode vs full forward (B=2, P=255: a "
        f"full chunk and a padded one): max|err| {err:.3e} within "
        f"{PTD_LIMIT[cfg.name]}")
    log(f"mamba2-780m where the time goes: "
        f"{decode_breakdown(model, params, prompts)} [{smi}]")
    log(f"mamba2-780m prefill: "
        f"{prefill_breakdown(model, params, prompts[0])} [{smi}]")
    launches["ssd_intra_chunk"] = run["launches"]["ssd_intra_chunk"]
    del params, model, run
    torch.cuda.empty_cache()

    cfg, model, params, prompts, run = serve(
        "hymba-1.5b", HYBRID_REQUESTS, tuple(COUNTERS), smi)
    log(f"hymba-1.5b where the time goes: "
        f"{decode_breakdown(model, params, prompts)} [{smi}]")
    log(f"hymba-1.5b prefill: "
        f"{prefill_breakdown(model, params, prompts[0])} [{smi}]")
    del params, model, run
    torch.cuda.empty_cache()

    # 5. times at the main path's shapes
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    records = {}
    hymba_heads = HYMBA_ATTN[:3]
    for b, t, win, heads in ([(*c, (HQ, HKV, HD)) for c in PREFILL]
                             + [(1, RAGGED_PREFILL[0], HYMBA_ATTN[3],
                                 hymba_heads)]):
        r = time_flash(b, t, win, None, heads)  # q/k/v just produced: warm
        log(f"time flash  heads={heads} B={b} T={t:4d} window={win}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
            f"{r['library_ms']:.4f} ms, kernel/sdpa "
            f"{r['ms'] / r['library_ms']:.2f}, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}); with the host's enqueue: kernel "
            f"{r['call_ms']:.4f} ms, sdpa {r['library_call_ms']:.4f} ms "
            f"[{smi}]")
        records.setdefault("flash_attention", r)
    for lens, win, heads in ([(*c, (HQ, HKV, HD)) for c in DECODE_LENS[:2]]
                             + [(DECODE_LENS[0][0], HYMBA_ATTN[3],
                                 hymba_heads)]):
        r = time_decode(lens, win, flush, heads)  # cold cache, as in serving
        log(f"time decode heads={heads} B=4 S=1024 lens={lens} window={win}: "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
            f"{r['library_ms']:.4f} ms, kernel/sdpa "
            f"{r['ms'] / r['library_ms']:.2f}, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}); with the host's enqueue: kernel "
            f"{r['call_ms']:.4f} ms, sdpa {r['library_call_ms']:.4f} ms "
            f"[{smi}]")
        records.setdefault("decode_attention", r)
    for shape in SSD_PREFILL:
        r = time_ssd(shape)
        log(f"time ssd    {shape}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library none, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}: "
            f"{r['flops'] / 1e9:.3f} GFLOP fp32 as 3xTF32, "
            f"{r['bytes'] / 1e6:.2f} MB) [{smi}]")
        records.setdefault("ssd_intra_chunk", r)
    log(f"kernels: {list(_build.KERNELS)}")

    source = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:134"),
        "decode_attention": (
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:104"),
        "ssd_intra_chunk": ("src/repro_torch/kernels/csrc/ssd_intra_chunk.cu",
                            "src/repro/kernels/ssd_scan.py:69")}
    # launches: the attention kernels' from the gemma-2b run, the SSD
    # kernel's from the mamba2-780m run (hymba-1.5b's are logged above)
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
