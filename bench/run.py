#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port, ``repro_torch``:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many NVIDIA GPUs as the
cell asks for.  The cell (``BENCHMARK.json``) names a configuration and a
closed-loop traffic mix (``bench/spec.py`` finds their files).  A run:

1. set-up: imports, CUDA, the program's kernels (built into the checkout at
   first use, loaded after), seeded weights made on the device, the
   planner's calibration sweep (``Profiler.profile_kernels`` → a
   ``LearnedCostModel`` → ``CalibratedCostProvider`` → ``PlanCache`` over
   ``HiDPPlanner`` for the model's ``block_costs`` on one H100 node), the
   ``ServingEngine`` with that cache and a ``FeedbackLoop``, one prefill at
   the mix's longest and shortest prompt (the engine's cache allocated, so
   the memory peak is the mix's worst case), then the first wave: one
   request per client, the first submit planning (the cache's miss), and
   one ``step`` that admits them all;
2. the window: ``step`` after ``step`` for ``--seconds``, each client
   submitting its next request as soon as its last one is finished, every
   output token stamped with the end of the step that made it;
3. after it: the memory peak; with ``--trace 1`` the profiler's trace of the
   window, reduced to the cell's per-layer metrics (``bench/metrics``); the
   served tokens of a sample of the finished requests against the plain
   reference (``bench/check.py``);
4. the result, one JSON object, as the last line of standard output; the
   numbers compared with their limits as the last lines of standard error.

Set-up's parts are printed on standard output before it.  With ``--trace
0`` the metrics are the cell's end-to-end ones, with ``--trace 1`` its
per-layer ones.  Exits 2, printing no result, without enough GPUs; 3 if
JAX, Flax or the JAX package ``repro`` was imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# any library that would load JAX by itself is kept from it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a traced run traces the first seconds of its window, at most these
TRACE_SECONDS = 20.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Phases:
    """Set-up's parts, timed one after another from the process start."""

    def __init__(self, t0: float):
        self.last = t0
        self.parts: dict[str, float] = {}

    def mark(self, name: str, sync=None) -> None:
        if sync is not None:
            sync()
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now


class RangedModel:
    """The model handed to the engine in a traced run: every call opens a
    profiler range (``model.prefill``/``model.decode``) and is logged with
    its sizes (the prompt's length; each row's length with its new token,
    0 for an empty row).  Computes nothing of its own."""

    def __init__(self, model, record_function):
        self._model, self._rf = model, record_function
        self.cfg = model.cfg
        self.engine = None
        self.calls: list[dict] = []
        self.logging = False

    def init_cache(self, *args, **kw):
        return self._model.init_cache(*args, **kw)

    def apply_prefill(self, params, batch, **kw):
        if self.logging:
            self.calls.append({"kind": "prefill",
                               "tokens": int(batch["tokens"].shape[1])})
        with self._rf("model.prefill"):
            return self._model.apply_prefill(params, batch, **kw)

    def apply_decode(self, params, cache, batch, **kw):
        if self.logging:
            self.calls.append({"kind": "decode",
                               "lengths": self.engine.lengths.tolist()})
        with self._rf("model.decode"):
            return self._model.apply_decode(params, cache, batch, **kw)


class Context:
    """What a per-layer metric's reader reads: the window's records."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def arch_config(conf: dict):
    """The program's ``ArchConfig`` from a configuration file."""
    from repro_torch.models.config import ArchConfig, MoESpec, SSMSpec
    fields = {k: conf[k] for k in ArchConfig.__dataclass_fields__
              if k in conf and k not in ("moe", "ssm")}
    if conf.get("moe"):
        fields["moe"] = MoESpec(**conf["moe"])
    if conf.get("ssm"):
        fields["ssm"] = SSMSpec(**conf["ssm"])
    return ArchConfig(**fields)


def planner(device, shapes=None) -> tuple:
    """The calibrated plan cache and feedback loop, as the paper's
    analyzer loop builds them on one H100 node."""
    from repro_torch.core import (Cluster, HiDPPlanner, PlannerConfig,
                                  gpu_node, processors_as_resources)
    from repro_torch.profiling import (CalibratedCostProvider, FeedbackLoop,
                                       LearnedCostModel, Profiler)
    from repro_torch.serving.plan_cache import PlanCache
    node = gpu_node("h100")
    cluster = Cluster((node,))
    gpu = processors_as_resources(node)[0]
    samples = Profiler(warmup=2, repeats=5, trim=1).profile_kernels(
        device=device, shapes=shapes, key=gpu.profile_key or gpu.name)
    fitted = LearnedCostModel.fit(samples)
    cache = PlanCache(HiDPPlanner(PlannerConfig(
        provider=CalibratedCostProvider(fitted))), cluster, version=1)
    return cache, FeedbackLoop(fitted, calibration_version=1)


class ClosedLoop:
    """C clients, each submitting its next request from the pool as soon
    as its last one is finished."""

    def __init__(self, eng, pool, rf):
        self.eng, self.pool, self.rf = eng, pool, rf
        self.tracks: dict[int, object] = {}
        self.inflight: list[int] = []
        self.finished: list[int] = []

    def submit(self, client: int) -> None:
        from bench.window import Track
        spec = self.pool.take()
        prompt = self.pool.tokens(spec.index)
        with self.rf("bench.submit"):
            t = time.perf_counter()
            rid = self.eng.submit(prompt, max_new_tokens=spec.max_new)
        req = self.eng.queue[-1]
        if req.request_id != rid:
            raise RuntimeError("the engine queued another request than the "
                               "one submitted")
        self.tracks[rid] = Track(client, spec, t, req)
        self.inflight.append(rid)

    def after_step(self, t: float) -> None:
        """Stamp the step's tokens; clients whose request finished submit
        their next one."""
        still = []
        free = []
        for rid in self.inflight:
            tr = self.tracks[rid]
            tr.stamp(t)
            if tr.req.done:
                self.finished.append(rid)
                free.append(tr.client)
            else:
                still.append(rid)
        self.inflight = still
        for client in free:
            self.submit(client)


def run(cell, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_start: float | None = None,
        control: bool = False, calibration_shapes=None) -> dict:
    """One run of ``cell``; returns the result object.  ``device`` and
    ``calibration_shapes`` (the sweep's own by default) serve the CPU
    tests; ``control`` judges the lower precision control's tokens in the
    program's place (``bench/control.py``)."""
    import numpy as np
    import torch

    from bench import check, devtrace, spec as spec_mod
    from bench import window as win
    from bench.traffic import Pool

    phases = Phases(T_START if t_start is None else t_start)
    torch.set_num_threads(1)       # one process, few threads: steadier
    dev = torch.device(device)
    on_gpu = dev.type == "cuda"

    def sync():
        if on_gpu:
            torch.cuda.synchronize(dev)

    from repro_torch.kernels import _build
    from repro_torch.models import ShapeConfig, build_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.telemetry import TelemetryRecorder
    phases.mark("imports")
    if on_gpu:
        torch.cuda.init()
        torch.zeros(1, device=dev)
    phases.mark("cuda_init", sync)
    if on_gpu:
        _build.build_all()
    phases.mark("kernels")

    conf = cell.config
    arch = arch_config(conf)
    ref = spec_mod.reference(conf["family"])
    mix = cell.traffic
    clients, max_len = int(mix["clients"]), int(mix["max_len"])
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    with torch.no_grad():
        params = ref.make_params(conf, gen, dev)
    phases.mark("weights", sync)

    cache, feedback = planner(dev, calibration_shapes)
    phases.mark("calibration", sync)

    model = build_model(arch)
    served = model
    rf = contextlib.nullcontext
    if trace:
        from torch.profiler import record_function
        served = RangedModel(model, record_function)
        rf = record_function
    dag = model.block_costs(ShapeConfig("serve", max_len, clients, "decode"))
    rec = TelemetryRecorder(run=cell.name) if trace else None
    eng = ServingEngine(served, params, max_batch=clients, max_len=max_len,
                        device=dev, plan_cache=cache, default_dag=dag,
                        feedback=feedback, telemetry=rec)
    if trace:
        served.engine = eng
    pool = Pool(mix, seed, arch.vocab)
    with torch.no_grad():
        for t in sorted({pool.max_prompt(), pool.min_prompt()},
                        reverse=True):
            warm = torch.as_tensor(np.random.default_rng(
                [seed, 5]).integers(0, arch.vocab, (1, t), dtype=np.int32),
                device=dev)
            model.apply_prefill(params, {
                "tokens": warm,
                "lengths": torch.tensor([t], dtype=torch.int32,
                                        device=dev)})
            del warm
    phases.mark("warmup", sync)

    loop = ClosedLoop(eng, pool, rf)
    with torch.no_grad():
        loop.submit(0)
        phases.mark("plan_miss")
        for c in range(1, clients):
            loop.submit(c)
        eng.step()
        loop.after_step(time.perf_counter())
    phases.mark("fill", sync)
    setup_s = sum(phases.parts.values())
    for k, v in phases.parts.items():
        print(f"setup {k} {v:.4f} s")
    print(f"setup total {setup_s:.4f} s")
    sys.stdout.flush()

    gc.collect()                   # set-up's garbage, not the window's
    prof = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if trace and on_gpu
        else None)
    n_pre0, n_dec0 = len(eng.prefill_seconds), len(eng.decode_seconds)
    n_ev0 = 0 if rec is None else len(rec.events)
    admitted0 = {rid for rid, t in loop.tracks.items()
                 if t.req.slot is not None}
    if trace:
        served.logging = True
    cut = None                     # the records at the traced part's end
    with torch.no_grad():
        if prof is not None:
            prof.start()
        span = rf("bench.window")
        span.__enter__()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        trace_end = t0 + min(seconds, TRACE_SECONDS)
        while True:
            with rf("bench.step"):
                eng.step()
            t1 = time.perf_counter()
            loop.after_step(t1)
            if span is not None and t1 >= trace_end:
                # the traced part of the window ends here; its reading
                # (profiler stop, raw events) would outgrow a run's time
                span.__exit__(None, None, None)
                span = None
                if trace:
                    served.logging = False
                    cut = Context(
                        t=t1, decode=len(eng.decode_seconds),
                        prefill=len(eng.prefill_seconds),
                        events=len(rec.events),
                        admitted={rid for rid, t in loop.tracks.items()
                                  if t.req.slot is not None})
                if prof is not None:
                    t_stop = time.perf_counter()
                    prof.stop()
                    log(f"profiler stopped after {trace_end - t0:.1f} s of "
                        f"the window in {time.perf_counter() - t_stop:.3f} s")
            if t1 >= deadline:
                break
    peak = torch.cuda.max_memory_allocated(dev) if on_gpu else 0

    e2e = win.end_to_end(loop.tracks.values(), t0, t1)
    done = [loop.tracks[r] for r in loop.finished
            if win.in_window(loop.tracks[r].stamps[-1], t0, t1)]
    failed = sum(check.malformed(tr, arch.vocab) for tr in done)
    metrics: dict[str, dict] = {}
    device_info = {"platform": "gpu" if on_gpu else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_gpu
                            else "cpu"),
                   "count": cell.chips if on_gpu else 1,
                   "memory_peak_bytes": int(peak)}
    extra: dict = {}
    values = {"setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30, **e2e}
    if not trace:
        for m in cell.end_to_end:
            # a name ``base.suffix`` (the same quantity in other cells,
            # bounded apart) is read as ``base``
            v = values.get(m["name"], values.get(m["name"].split(".")[0]))
            if v is None:
                raise RuntimeError(f"{m['name']}: no sample in the window")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        # per-layer metrics read the traced part of the window alone: after
        # it the profiler's stop holds the host for seconds
        tr = devtrace.read(prof) if on_gpu else None
        ctx = Context(
            config=conf, window_s=cut.t - t0,
            e2e=win.end_to_end(loop.tracks.values(), t0, cut.t),
            prefill_seconds=eng.prefill_seconds[n_pre0:cut.prefill],
            decode_seconds=eng.decode_seconds[n_dec0:cut.decode],
            prompt_tokens_admitted=sum(
                loop.tracks[rid].spec.prompt_len
                for rid in cut.admitted - admitted0),
            calls=served.calls, events=rec.events[n_ev0:cut.events],
            trace=tr)
        for m in cell.per_layer:
            v = spec_mod.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr is not None:
            device_info["busy_s"] = devtrace.busy_s(tr)
            device_info["window_s"] = tr.window_s
            extra["breakdown"] = devtrace.breakdown(tr)
        del prof, tr, ctx
    if not trace:
        # the host-clock yardsticks the traced run reports, read here
        # without the profiler, for comparison
        whole = Context(decode_seconds=eng.decode_seconds[n_dec0:],
                        prefill_seconds=eng.prefill_seconds[n_pre0:],
                        prompt_tokens_admitted=sum(
                            tr.spec.prompt_len
                            for rid, tr in loop.tracks.items()
                            if tr.req.slot is not None
                            and rid not in admitted0))
        log("untraced " + ", ".join(
            f"{name} {spec_mod.metric_reader(name)(whole)!r}"
            for name in ("decode_step_ms", "prefill_ms_per_ktok")))
    log(f"window {t1 - t0:.3f} s: {e2e['tokens']} tokens, "
        f"{e2e['first_tokens']} first tokens, {e2e['gaps']} gaps, "
        f"{len(done)} requests finished, {len(loop.inflight)} in flight at "
        f"the close; decode steps {len(eng.decode_seconds) - n_dec0}, "
        f"prefills {len(eng.prefill_seconds) - n_pre0}, re-plans "
        f"{eng.replans}, plan cache {cache.misses} miss(es) "
        f"{cache.hits} hits; peak {peak / 2 ** 30:.3f} GiB")

    # the program's state goes before the reference runs; the weights are
    # the benchmark's own, handed to both
    picked = check.sample(done, seed, int(mix["check_tokens"]),
                          int(mix["check_requests"]))
    del eng, loop, served, model, cache, feedback, rec
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    got = check.compare(ref, conf, params, picked, pool.tokens, dev,
                        control=control)
    # the control's tokens are judged in the program's place, by the same
    # limits: it has to come out not correct
    judged = got["control" if control else "program"]
    compared = {name: {"value": judged[name], "limit": float(limit)}
                for name, limit in sorted(cell.limits.items())}
    compared["malformed_requests"] = {"value": failed, "limit": 0}
    correct = (got["requests_compared"] > 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in compared.values()))
    for side in ("program", "control") if control else ("program",):
        log(f"compared {got['tokens_compared']} served tokens of "
            f"{got['requests_compared']} requests against the reference, "
            f"{side}{' (fp8)' if side == 'control' else ''}: {got[side]}")
    log(f"per request (served tokens, mean gap): {got['per_request']}"
        + (f"; control's mean gaps {got['control_per_request']}"
           if control else ""))
    result = {"correct": bool(correct), "attempted": len(done),
              "failed": int(failed), "metrics": metrics,
              "device": device_info, **extra}
    result["compared"] = compared
    sync()
    return result


def report(result: dict) -> None:
    print(json.dumps(result), flush=True)
    for k, v in result["compared"].items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import spec as spec_mod
    cell = spec_mod.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA GPU(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the port's benchmark runs without JAX "
            "and without the JAX package")
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
