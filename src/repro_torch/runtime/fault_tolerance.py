"""Fault tolerance for long training runs, a copy of
``repro.runtime.fault_tolerance``: heartbeat-tracked availability (the
paper's A(N_φ), Eq. 4), periodic atomic checkpoints with resume, and
straggler mitigation.

The signals are injected (simulated clocks / per-step timings) so the policy
layer is testable without hardware; the launcher wires the same interfaces
to real step timings.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import numpy as np

from repro_torch.core.cluster import ClusterManager
from repro_torch.training import checkpoint as ckpt


@dataclasses.dataclass
class CheckpointPolicy:
    directory: str
    every_steps: int = 50
    keep: int = 3

    def maybe_save(self, step: int, state: Any) -> str | None:
        if step % self.every_steps:
            return None
        path = ckpt.step_path(self.directory, step)
        ckpt.save(path, state, step)
        self._gc()
        return path

    def _gc(self) -> None:
        files = sorted(f for f in os.listdir(self.directory)
                       if f.startswith("ckpt_"))
        for f in files[:-self.keep]:
            os.remove(os.path.join(self.directory, f))

    def resume(self, like: Any) -> tuple[Any, int] | None:
        path = ckpt.latest(self.directory)
        if path is None:
            return None
        return ckpt.restore(path, like)


@dataclasses.dataclass
class StragglerPolicy:
    """Flag pods whose step time exceeds slack × the fleet's median.

    The mitigation (paper-faithful): the leader re-plans with the straggler's
    α_j = 0 — its share is redistributed by the same DP that placed it
    (runtime/elastic.py) — and restores it when it recovers."""

    slack: float = 1.5
    window: int = 20
    history: dict[str, list[float]] = dataclasses.field(default_factory=dict)

    def record(self, pod: str, step_seconds: float) -> None:
        h = self.history.setdefault(pod, [])
        h.append(step_seconds)
        del h[:-self.window]

    def stragglers(self) -> list[str]:
        if len(self.history) < 2:
            return []
        med = {p: float(np.median(h)) for p, h in self.history.items()
               if h}
        # fleet reference = median-of-medians (robust to the straggler
        # itself inflating a percentile reference)
        fleet = float(np.median(list(med.values())))
        return [p for p, m in med.items() if m > self.slack * fleet]


@dataclasses.dataclass
class FaultTolerantRunner:
    """Drives a train loop with checkpoint/restart + availability tracking.

    ``step_fn(state, batch) -> (state, metrics)`` is opaque; failures are
    signalled by exceptions from step_fn, after which the runner restores
    the last checkpoint and continues (optionally on a re-planned, smaller
    cluster — see elastic.py).  With the port's optimizer a failed step may
    have advanced the state's moments in place; the restore replaces the
    whole state."""

    step_fn: Callable
    ckpt_policy: CheckpointPolicy
    manager: ClusterManager | None = None
    straggler: StragglerPolicy = dataclasses.field(
        default_factory=StragglerPolicy)
    restarts: int = 0

    def run(self, state: Any, batches, *, start_step: int = 0,
            max_failures: int = 3) -> tuple[Any, int, list[dict]]:
        metrics_log: list[dict] = []
        step = start_step
        resumed = self.ckpt_policy.resume(state)
        if resumed is not None:
            state, step = resumed
        failures = 0
        it = iter(batches)
        while True:
            try:
                batch = next(it)
            except StopIteration:
                break
            try:
                state, metrics = self.step_fn(state, batch)
            except Exception:
                failures += 1
                self.restarts += 1
                if failures > max_failures:
                    raise
                restored = self.ckpt_policy.resume(state)
                if restored is not None:
                    state, step = restored
                continue
            step += 1
            metrics["step"] = step
            metrics_log.append(metrics)
            self.ckpt_policy.maybe_save(step, state)
        return state, step, metrics_log
