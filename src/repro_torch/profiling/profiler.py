"""The port's copy of ``repro.profiling.profiler``: the measurement half of
the paper's DNN Model Analyzer.

Two measurement paths:

* ``profile_cluster`` micro-benchmarks analytic block DAGs against a ground
  truth — by default the datasheet itself, or a ``SyntheticGroundTruth``
  whose per-processor rates diverge from it (thermal throttling,
  contention, a mis-declared board).  This is the deterministic testbed
  path: seeded jitter, warmup discards, trimmed means.  A copy of the JAX
  package's, sample for sample.

* ``profile_kernels`` times the port's kernels through
  ``repro_torch.kernels.ops`` — prefill flash attention, decode attention
  and the Mamba-2 SSD scan — on one device, with the JAX package's per-kind
  shape sweeps (``DEFAULT_KERNEL_SHAPES``), FLOP and traffic formulas and
  ``Sample`` rows.  On a CUDA device the calls launch the hand-written
  kernels; on the CPU they run the plain versions.
  ``repro_torch.profiling.calibrate_kernels`` loops it over the visible
  GPUs, fits a ``LearnedCostModel`` and persists it through the
  ``CalibrationStore``.

Both produce ``learned.Sample`` rows that ``LearnedCostModel.fit`` consumes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.cost_model import Cluster, Node, Processor
from repro_torch.core.dag import Block, ModelDAG

from .learned import Sample


def block_traffic(block: Block) -> float:
    """Bytes a block touches: weights plus in/out activations."""
    return block.param_bytes + block.bytes_in + block.bytes_out


# --------------------------------------------------------------------------
# Ground truth — what the hardware actually does
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SyntheticGroundTruth:
    """True per-processor performance, possibly diverging from the datasheet.

    ``rate_scale`` maps ``(node_name, proc_name)`` (or ``node_name`` for the
    whole node) to a multiplier on the analytic rate: 0.4 means the processor
    sustains 40% of what the cost model believes.  ``power_scale`` does the
    same for active power draw: 1.5 means the processor really burns 1.5× its
    datasheet active watts (DVFS residency, rail losses, a mis-declared TDP)
    — the divergence the energy predictors exist to learn.  ``mem_bw`` and
    ``overhead_s`` add the memory-traffic and fixed-launch terms real
    measurements contain; ``noise`` is the relative jitter σ applied by
    ``sample_seconds`` (deterministic under a caller-provided rng).
    """

    cluster: Cluster
    rate_scale: Mapping[str, float] | Mapping[tuple[str, str], float] = \
        dataclasses.field(default_factory=dict)
    power_scale: Mapping[str, float] | Mapping[tuple[str, str], float] = \
        dataclasses.field(default_factory=dict)
    mem_bw: float = 12e9
    overhead_s: float = 2e-4
    noise: float = 0.0

    def _proc(self, node_name: str, proc_name: str) -> tuple[Node, Processor]:
        for n in self.cluster.nodes:
            if n.name == node_name:
                for p in n.processors:
                    if p.name == proc_name:
                        return n, p
        raise KeyError(f"{node_name}/{proc_name}")

    @staticmethod
    def _scale_from(table: Mapping, node_name: str, proc_name: str) -> float:
        rs = dict(table)
        return rs.get((node_name, proc_name),
                      rs.get(f"{node_name}/{proc_name}",
                             rs.get(node_name, 1.0)))

    def scale(self, node_name: str, proc_name: str) -> float:
        return self._scale_from(self.rate_scale, node_name, proc_name)

    def active_watts(self, node_name: str, proc_name: str) -> float:
        """The active power the hardware actually draws (W)."""
        _, p = self._proc(node_name, proc_name)
        return p.active_power * self._scale_from(self.power_scale,
                                                 node_name, proc_name)

    def rate(self, node_name: str, proc_name: str, kind: str,
             delta: float) -> float:
        """The rate the hardware actually sustains (flops/s at this δ)."""
        _, p = self._proc(node_name, proc_name)
        return p.rate(delta, kind) * self.scale(node_name, proc_name)

    def compute_seconds(self, node_name: str, proc_name: str, flops: float,
                        kind: str, delta: float) -> float:
        """Pure compute time of a shard — what the simulator's EXECUTE
        state charges when this ground truth replaces the datasheet."""
        return flops / max(self.rate(node_name, proc_name, kind, delta),
                           1e-12)

    def block_seconds(self, node_name: str, proc_name: str, block: Block,
                      delta: float) -> float:
        """Noise-free micro-benchmark latency of one block."""
        return (self.compute_seconds(node_name, proc_name, block.flops,
                                     block.kind, delta)
                + block_traffic(block) / self.mem_bw
                + self.overhead_s)

    def sample_seconds(self, node_name: str, proc_name: str, block: Block,
                       delta: float, rng: np.random.Generator) -> float:
        base = self.block_seconds(node_name, proc_name, block, delta)
        if self.noise <= 0:
            return base
        return base * float(np.clip(1.0 + self.noise * rng.standard_normal(),
                                    0.5, 2.0))


# --------------------------------------------------------------------------
# Profiler
# --------------------------------------------------------------------------

# Default shape sweep for the real-kernel path, per kernel kind.  Small by
# design (CI runs these under Pallas-interpret on CPU); a hardware
# deployment passes its own per-device shapes to ``profile_kernels``.
DEFAULT_KERNEL_SHAPES: dict[str, tuple[tuple[int, ...], ...]] = {
    # (B, T, H, D) — prefill flash attention
    "attn": ((1, 64, 4, 32), (1, 128, 4, 32), (2, 128, 4, 32)),
    # (B, S, H, D) — one decode token against an S-long KV cache
    "decode": ((1, 128, 4, 32), (2, 128, 4, 32), (2, 256, 4, 32)),
    # (B, T, NH, HD, N) — Mamba-2 chunked SSD scan
    "ssd": ((1, 64, 4, 32, 16), (1, 128, 4, 32, 16), (2, 128, 4, 32, 16)),
}


def kernel_call(kind: str, shape: tuple[int, ...], *, device, seed: int = 0,
                block_q: int = 32, block_k: int = 32):
    """One call of the kernel sweep's ``kind`` at ``shape`` (the layouts of
    ``DEFAULT_KERNEL_SHAPES``) through the port's ``ops``, on fp32 inputs
    from a generator seeded with ``seed`` on ``device``.

    Returns ``(fn, flops, traffic)``: the call and the FLOPs and bytes the
    JAX package's sweep counts for it.  ``Profiler.profile_kernels`` times
    these calls; a caller that times the same calls another way builds them
    here too, so both time the same inputs.
    """
    import torch

    from repro_torch.kernels import ops

    f32 = torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*size):
        return torch.randn(size, generator=gen, device=device, dtype=f32)
    if kind == "attn":
        b, t, h, d = shape
        q, k, v = (normal(b, t, h, d) for _ in range(3))
        flops = 4.0 * b * t * t * h * d                   # QK^T + AV
        traffic = 4.0 * (q.numel() + k.numel() + v.numel() + q.numel())
        return (lambda: ops.flash_attention(q, k, v, block_q=block_q,
                                            block_k=block_k)), flops, traffic
    if kind == "decode":
        b, s, h, d = shape
        q = normal(b, 1, h, d)
        kc, vc = normal(b, s, h, d), normal(b, s, h, d)
        lengths = torch.full((b,), s, dtype=torch.int32, device=device)
        flops = 4.0 * b * s * h * d                       # qK^T + aV
        traffic = 4.0 * (q.numel() + kc.numel() + vc.numel() + q.numel())
        return (lambda: ops.decode_attention(q, kc, vc, lengths)), flops, \
            traffic
    if kind != "ssd":
        raise KeyError(f"unknown kernel kind {kind!r}")
    b, t, nh, hd, n = shape
    x = normal(b, t, nh, hd)
    dt = torch.empty((b, t, nh), device=device, dtype=f32).uniform_(
        0.001, 0.1, generator=gen)
    A = -torch.ones((nh,), device=device, dtype=f32)
    B, C = normal(b, t, n), normal(b, t, n)
    D = torch.ones((nh,), device=device, dtype=f32)
    flops = 6.0 * b * t * nh * hd * n                     # in/out proj + scan
    traffic = 4.0 * (x.numel() + B.numel() + C.numel() + x.numel())
    return (lambda: ops.ssd(x, dt, A, B, C, D, chunk=min(64, t))), flops, \
        traffic


@dataclasses.dataclass
class Profiler:
    """Micro-benchmark runner: warmup, repeats, trimmed mean, fixed seed."""

    warmup: int = 2
    repeats: int = 5
    trim: int = 1                # drop the k fastest and k slowest repeats
    seed: int = 0

    def _trimmed_mean(self, xs: Sequence[float]) -> float:
        xs = sorted(xs)
        if len(xs) > 2 * self.trim:
            xs = xs[self.trim:len(xs) - self.trim]
        return float(np.mean(xs))

    def profile_cluster(self, cluster: Cluster,
                        dags: Mapping[str, ModelDAG],
                        deltas: Mapping[str, float],
                        ground_truth: SyntheticGroundTruth | None = None,
                        ) -> list[Sample]:
        """Per-(block × processor) timing/energy samples over every node.

        Deterministic: one seeded generator drives all jitter, and the
        iteration order is fixed (nodes → processors → dags → blocks).
        """
        gt = ground_truth or SyntheticGroundTruth(cluster)
        rng = np.random.default_rng(self.seed)
        samples: list[Sample] = []
        for node in cluster.nodes:
            for proc in node.processors:
                for name, dag in dags.items():
                    delta = deltas[name]
                    for block in dag.blocks:
                        for _ in range(self.warmup):   # cache/DVFS settle
                            gt.sample_seconds(node.name, proc.name, block,
                                              delta, rng)
                        reps = [gt.sample_seconds(node.name, proc.name,
                                                  block, delta, rng)
                                for _ in range(self.repeats)]
                        lat = self._trimmed_mean(reps)
                        samples.append(Sample(
                            key=f"{node.name}/{proc.name}",
                            kind=block.kind,
                            work=block.flops * delta,
                            traffic=block_traffic(block),
                            latency_s=lat,
                            energy_j=lat * gt.active_watts(node.name,
                                                           proc.name)))
        return samples

    # ------------------------------------------------------- real kernels
    def profile_kernels(self, *, kinds: Sequence[str] | None = None,
                        shapes: Mapping[str, Sequence[tuple[int, ...]]]
                        | None = None,
                        block_q: int = 32, block_k: int = 32,
                        device="cuda", key: str | None = None,
                        telemetry=None) -> list[Sample]:
        """Time the port's kernels on one device: prefill flash attention,
        single-token decode attention against a KV cache, and the Mamba-2
        chunked SSD scan, all in fp32 as the JAX package's sweep.

        ``shapes`` maps kernel kind → shape tuples (see
        ``DEFAULT_KERNEL_SHAPES`` for the per-kind layout); ``kinds``
        restricts the sweep.  ``device`` is where every input is made
        (``cuda`` unless the caller asks for ``"cpu"``; without a GPU a
        CUDA device raises).  ``key`` overrides the Sample key (default
        ``cuda:<index>`` on a GPU, ``cpu:0`` on the CPU, as the JAX
        package keys an explicit device ``<platform>:<id>``).  ``block_q`` and
        ``block_k`` reach the CPU's blocked attention only: the CUDA
        kernels choose their own tiles.  With ``telemetry`` each measured
        point also lands as a ``profile.kernel`` span whose wall_s is the
        trimmed-mean latency.

        Latency is one call as its caller sees it, as in the JAX package
        (wall clock around the call and ``block_until_ready``): on a GPU,
        CUDA events around each call in an otherwise idle stream, the end
        event synchronized, so the host's enqueue of the call is in the
        time; on the CPU, ``perf_counter``.  Warmup → repeats → trimmed
        mean, inputs from a generator seeded with ``seed`` on the device.
        """
        import torch

        from repro_torch import device as _device
        from repro_torch.telemetry import active as _tel_active

        dev = _device.resolve(device)
        on_gpu = dev.type == "cuda"
        if on_gpu and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        tel = _tel_active(telemetry)
        if key is None:
            key = f"{dev.type}:{dev.index or 0}"
        table = dict(DEFAULT_KERNEL_SHAPES)
        if shapes:
            table.update(shapes)
        sweep = tuple(kinds) if kinds is not None else tuple(table)
        unknown = [k for k in sweep if k not in table]
        if unknown:
            raise KeyError(f"unknown kernel kinds {unknown}; "
                           f"known: {sorted(table)}")
        samples: list[Sample] = []

        def one_call_s(fn) -> float:
            if not on_gpu:
                t0 = time.perf_counter()
                fn()
                return time.perf_counter() - t0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3

        def bench(fn) -> float:
            with torch.cuda.device(dev) if on_gpu else contextlib.nullcontext():
                for _ in range(self.warmup):
                    fn()
                if on_gpu:
                    torch.cuda.synchronize(dev)
                reps = [one_call_s(fn) for _ in range(self.repeats)]
            return self._trimmed_mean(reps)

        def record(kind: str, shape: tuple[int, ...], flops: float,
                   traffic: float, lat: float) -> None:
            samples.append(Sample(key=key, kind=kind, work=flops,
                                  traffic=traffic, latency_s=lat))
            if tel is not None:
                tel.span("profile.kernel", 0.0, wall_s=lat, kind=kind,
                         key=key, shape="x".join(map(str, shape)),
                         flops=flops)

        for kind in sweep:
            for shape in table[kind]:
                fn, flops, traffic = kernel_call(
                    kind, shape, device=dev, seed=self.seed,
                    block_q=block_q, block_k=block_k)
                lat = bench(fn)
                record(kind, shape, flops, traffic, lat)
        return samples
