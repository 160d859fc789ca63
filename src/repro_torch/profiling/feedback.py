"""The port's copy of ``repro.profiling.feedback``.

FeedbackLoop — closing the Analyzer ↔ Scheduler cycle (paper Fig. 4).

The run-time scheduler measures every shard it executes.  The loop EWMA-
blends each observation into the *live* ``LearnedCostModel`` (so planning
keeps improving smoothly) but detects drift against a frozen **reference**
snapshot of each predictor, taken at fit/refit time.  Detection must not use
the live model: the EWMA adapts within a few observations, which would mask
exactly the sustained regime changes (thermal throttling, contention) the
loop exists to catch.

Per resource, the drift statistic is the mean relative error of the last
``min_observations`` measurements against the reference — recent
observations only, so a long healthy history cannot dilute a real shift.
Latency and energy drift are watched **independently**: an observation may
carry a measured ``energy_j`` alongside its seconds, and a processor whose
timing still tracks the model but whose power draw has shifted (DVFS
residency change, a rail browning out) trips the energy window on its own.
When a resource crosses ``threshold`` on either statistic, the loop

  1. hard-refits that resource's predictors from its most recent
     observations (the post-change regime, not the stale buffer),
  2. replaces their reference snapshots with the new fits,
  3. bumps ``calibration_version`` — the counter plan caches key on
     (``repro_torch.serving.plan_cache.PlanCache`` wired as ``version_source``
     sees every cached frontier invalidate atomically at this instant),
  4. fires ``on_drift`` exactly once — the hook that re-enters EXPLORE:
     ``runtime.elastic.ElasticController.on_drift`` for the TPU runtime,
     or any re-planning callback for the edge simulator,
  5. resets the drift windows so the refitted model gets a clean slate.

A drift event therefore costs one re-plan, not one per observation.
With a ``telemetry=`` recorder wired, every trip also lands as a
``feedback.drift`` gauge (value = the drift magnitude, attrs = metric,
resource, new calibration version) — see docs/observability.md.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

from .learned import LearnedCostModel


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    at_observation: int
    mean_error: float
    metric: str = "latency"          # "latency" | "energy"


class FeedbackLoop:
    def __init__(self, model: LearnedCostModel, *,
                 threshold: float = 0.3,
                 alpha: float = 0.3,
                 window: int = 6,
                 min_observations: int = 3,
                 buffer_size: int = 64,
                 on_drift: Callable[[], object] | None = None,
                 calibration_version: int = 0,
                 telemetry=None):
        self.model = model
        from repro_torch.telemetry import active as _tel_active
        self.telemetry = _tel_active(telemetry)
        self.threshold = threshold
        self.alpha = alpha
        self.min_observations = min_observations
        self.on_drift = on_drift
        self.observations = 0
        self.replans = 0
        # monotone counter a PlanCache keys cached frontiers on: seed it
        # with the CalibrationStore version the model was loaded at, and
        # every drift event advances it (invalidating those fronts)
        self.calibration_version = calibration_version
        self.events: list[DriftEvent] = []
        self._window = window
        self._errors: dict[str, deque[float]] = {}
        self._energy_errors: dict[str, deque[float]] = {}
        # rows are (work, traffic, measured_s, energy_j-or-0)
        self._buffers: dict[tuple[str, str],
                            deque[tuple[float, float, float, float]]] = {}
        self._buffer_size = buffer_size
        # frozen per-(key, kind) predictor snapshots drift is measured against
        self._reference: dict[tuple[str, str], object] = {}
        self._energy_reference: dict[tuple[str, str], object] = {}

    # ------------------------------------------------------------- ingest
    def _reference_for(self, key: str, kind: str):
        ek = (key, kind)
        if ek not in self._reference:
            live = (self.model.entries.get(ek)
                    or self.model.entries.get((key, "generic")))
            if live is None:
                return None
            self._reference[ek] = dataclasses.replace(live)
        return self._reference[ek]

    def _energy_reference_for(self, key: str, kind: str):
        ek = (key, kind)
        if ek not in self._energy_reference:
            live = (self.model.energy_entries.get(ek)
                    or self.model.energy_entries.get((key, "generic")))
            if live is None:
                return None
            self._energy_reference[ek] = dataclasses.replace(live)
        return self._energy_reference[ek]

    def observe(self, key: str, kind: str, work: float, traffic: float,
                measured_s: float, energy_j: float | None = None) -> bool:
        """One measured shard execution — seconds and, when the platform
        meters it, joules.  Returns True iff this observation tripped a
        drift threshold (latency or energy) and a re-plan was triggered."""
        if work <= 0 or measured_s <= 0:
            return False
        self.observations += 1
        joules = float(energy_j) if energy_j is not None and energy_j > 0 \
            else 0.0
        buf = self._buffers.setdefault(
            (key, kind), deque(maxlen=self._buffer_size))
        buf.append((work, traffic, measured_s, joules))

        ref = self._reference_for(key, kind)
        if ref is None:
            # first sight of this resource: seed predictors + references
            self.model.observe(key, kind, work, traffic, measured_s,
                               alpha=1.0)
            self._reference_for(key, kind)
            if joules > 0:
                self.model.observe_energy(key, kind, work, traffic, joules,
                                          alpha=1.0)
                self._energy_reference_for(key, kind)
            return False
        predicted = ref.linear(work, traffic)
        err = abs(predicted - measured_s) / max(measured_s, 1e-12)
        errs = self._errors.setdefault(key, deque(maxlen=self._window))
        errs.append(err)
        self.model.observe(key, kind, work, traffic, measured_s, self.alpha)

        if joules > 0:
            eref = self._energy_reference_for(key, kind)
            if eref is None:
                self.model.observe_energy(key, kind, work, traffic, joules,
                                          alpha=1.0)
                self._energy_reference_for(key, kind)
            else:
                epred = eref.linear(work, traffic)
                eerr = abs(epred - joules) / max(joules, 1e-12)
                eerrs = self._energy_errors.setdefault(
                    key, deque(maxlen=self._window))
                eerrs.append(eerr)
                self.model.observe_energy(key, kind, work, traffic, joules,
                                          self.alpha)

        # trigger only when the last min_observations errors *all* exceed
        # the threshold: a regime change sustains high error, noise does
        # not — and waiting for a full bad tail means the refit below sees
        # only post-change samples, so one change costs one re-plan
        if self._sustained(self._errors.get(key)):
            return self._trip(key, self.drift(key), "latency")
        if self._sustained(self._energy_errors.get(key)):
            return self._trip(key, self.energy_drift(key), "energy")
        return False

    def _sustained(self, errs: deque[float] | None) -> bool:
        if not errs:
            return False
        tail = list(errs)[-self.min_observations:]
        return (len(tail) >= self.min_observations
                and min(tail) > self.threshold)

    def _trip(self, key: str, drift_now: float, metric: str) -> bool:
        self._refit_key(key)
        self.replans += 1
        self.calibration_version += 1      # stale plan fronts die here
        self.events.append(DriftEvent(self.observations, drift_now, metric))
        if self.telemetry is not None:
            self.telemetry.gauge(
                "feedback.drift", float(drift_now), metric=metric,
                resource=key, calibration_version=self.calibration_version,
                at_observation=self.observations)
        self._errors.clear()          # fresh slate for the refitted model
        self._energy_errors.clear()
        if self.on_drift is not None:
            self.on_drift()
        return True

    def drift(self, key: str | None = None) -> float:
        """Mean relative latency error of the last ``min_observations``
        measurements against the reference — for one resource, or the worst
        when None."""
        return self._recent(self._errors, key)

    def energy_drift(self, key: str | None = None) -> float:
        """The energy twin of :meth:`drift`."""
        return self._recent(self._energy_errors, key)

    def _recent(self, table: dict[str, deque[float]],
                key: str | None) -> float:
        def recent_mean(errs: deque[float]) -> float:
            tail = list(errs)[-self.min_observations:]
            return sum(tail) / len(tail) if tail else 0.0
        if key is not None:
            errs = table.get(key)
            return recent_mean(errs) if errs else 0.0
        return max((recent_mean(e) for e in table.values() if e),
                   default=0.0)

    def _refit_key(self, key: str) -> None:
        """Hard-refit the drifted resource from its *recent* observations —
        the post-change regime — and re-snapshot its references.  Latency
        and energy predictors refit together: a drift event invalidates the
        whole picture of the resource, not one response variable."""
        for (k, kind), buf in self._buffers.items():
            if k != key or not buf:
                continue
            recent = list(buf)[-max(self.min_observations, 2):]
            self.model.fit_entry(k, kind, [r[:3] for r in recent])
            self._reference[(k, kind)] = dataclasses.replace(
                self.model.entries[(k, kind)])
            energy_rows = [(w, t, e) for w, t, _, e in recent if e > 0]
            if energy_rows:
                self.model.fit_energy_entry(k, kind, energy_rows)
                self._energy_reference[(k, kind)] = dataclasses.replace(
                    self.model.energy_entries[(k, kind)])

    # ------------------------------------------------------------- churn
    def forget_resource(self, node: str) -> int:
        """Drop every drift window, observation buffer, and reference
        snapshot for ``node`` (its node-level key and any ``node/proc``
        processor keys).  A ``repro.fleet.FleetController`` calls this when
        the node leaves the fleet: measurements from before an outage must
        not sit in the window that judges the node's first post-return
        shards — thermal state, DVFS residency, even the battery that
        caused the outage all reset across it.  The fitted predictors in
        the live model are *kept* (they are the best prior available);
        references re-snapshot from them on the next observation.  Returns
        the number of per-(key, kind) entries dropped."""
        def ours(key: str) -> bool:
            return key == node or key.startswith(f"{node}/")

        dropped = 0
        for table in (self._buffers, self._reference,
                      self._energy_reference):
            for k in [k for k in table if ours(k[0])]:
                del table[k]
                dropped += 1
        for table in (self._errors, self._energy_errors):
            for k in [k for k in table if ours(k)]:
                del table[k]
        return dropped

    # ---------------------------------------------------------- convenience
    def ingest_plan_execution(self, spans, plans: dict | None = None) -> int:
        """Feed a batch of simulator ExecutionSpans (duck-typed: .node,
        .processor, .flops, .start, .end, optional .watts).  Returns the
        number of drift triggers.  The span's flops are already δ-weighted by
        the caller's convention when delta==1; prefer the simulator's
        built-in feedback hook for per-shard accuracy."""
        triggers = 0
        for s in spans:
            dur = s.end - s.start
            if dur > 0 and s.flops > 0:
                watts = getattr(s, "watts", 0.0)
                if self.observe(f"{s.node}/{s.processor}", "generic",
                                s.flops, 0.0, dur,
                                energy_j=watts * dur if watts > 0 else None):
                    triggers += 1
        return triggers
