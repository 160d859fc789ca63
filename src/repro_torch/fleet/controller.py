"""The port's copy of ``repro.fleet.controller``.

FleetController — membership epochs over a live cluster.

The controller owns the availability machinery the seed already had but
nothing consumed end-to-end: a ``ClusterManager`` (availability vector +
leader election, Alg. 1 lines 2–3) and its ``HeartbeatMonitor``.  It
replays a :class:`~repro_torch.fleet.traces.ChurnTrace` against them and turns
raw events into **membership epochs** — the unit every churn-aware
consumer keys on:

* :meth:`advance` applies every unconsumed event up to ``now``.
  Simultaneously-applied events coalesce into at most **one** new epoch,
  so a consumer that re-plans per epoch re-plans once per membership
  change, not once per event.  Each epoch records its time, availability
  mask, :func:`~repro_torch.core.fingerprint.membership_fingerprint`, leader and
  triggering events (``epochs`` is the full history).
* leadership is maintained across churn: when the sitting leader goes
  unavailable the controller immediately fails over to the first available
  node (``ClusterManager.elect_leader``) — ``leader_elections`` counts
  hand-offs.
* ``on_epoch`` (a callback taking the new :class:`MembershipEpoch`) fires
  exactly once per epoch — wire
  ``ServingEngine.on_membership_change`` to re-enter EXPLORE with one
  frontier re-plan per in-flight tenant; with a membership-keyed
  ``PlanCache`` each of those re-plans is a single miss for a brand-new
  membership and a pure warm hit for a returning one.
* ``feedback`` (a ``repro_torch.profiling.FeedbackLoop``) is told to
  :meth:`~repro_torch.profiling.FeedbackLoop.forget_resource` a node's drift
  windows when it goes down, so a returning node's first measurements are
  judged on their own — not against a window straddling the outage.

The controller also exposes the *peek* the simulator's fault-injection
path needs: :meth:`next_failure` finds the earliest unconsumed ``crash``
inside an execution window that hits a node the plan actually uses,
without consuming it — the consume happens via :meth:`advance` once the
failure is handled.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

from repro_torch.core.cluster import ClusterManager
from repro_torch.core.cost_model import Cluster
from repro_torch.core.fingerprint import membership_fingerprint

from .traces import ChurnEvent, ChurnTrace


@dataclasses.dataclass(frozen=True)
class MembershipEpoch:
    """One membership generation: who is in the fleet, since when, led by
    whom, and which events created it."""

    epoch: int
    time: float
    mask: tuple[bool, ...]
    fingerprint: str
    leader: str | None
    events: tuple[ChurnEvent, ...] = ()

    def available(self) -> int:
        return sum(self.mask)


class FleetController:
    """Replays a :class:`ChurnTrace` into membership epochs.

    Attributes:
        manager: the owned ``ClusterManager`` (availability + leadership).
        trace: the replayable event schedule (never mutated; the
            controller's cursor tracks consumption).
        epoch: the current epoch number (0 = the initial membership).
        epochs: full epoch history, ``epochs[-1]`` current.
        leader_elections: leader hand-offs forced by churn.
        telemetry: optional ``repro_torch.telemetry.TelemetryRecorder`` — every
            closed epoch lands as a ``fleet.membership`` gauge (value =
            available-node count) and every forced hand-off as a
            ``fleet.leader_election`` counter.
    """

    def __init__(self, cluster: Cluster | ClusterManager,
                 trace: ChurnTrace | None = None, *,
                 leader: str | None = None,
                 on_epoch: Callable[[MembershipEpoch], object] | None = None,
                 feedback=None, telemetry=None):
        self.manager = (cluster if isinstance(cluster, ClusterManager)
                        else ClusterManager(cluster))
        self.trace = trace if trace is not None else ChurnTrace()
        self.on_epoch = on_epoch
        self.feedback = feedback
        from repro_torch.telemetry import active as _tel_active
        self.telemetry = _tel_active(telemetry)
        self.leader_elections = 0
        self._cursor = 0
        self._epoch_hooks: list[Callable[[MembershipEpoch], object]] = []
        self.now = 0.0
        if leader is not None:
            self.manager.elect_leader(leader)
        elif not self.manager.leader_available():
            self._elect_fallback(count=False)
        self.epochs: list[MembershipEpoch] = [MembershipEpoch(
            epoch=0, time=0.0, mask=self.membership_mask(),
            fingerprint=self.membership_fingerprint(),
            leader=self.manager.leader)]

    # ------------------------------------------------------------- accessors
    @property
    def cluster(self) -> Cluster:
        """The live cluster — current availability over the declared
        topology.  A ``PlanCache`` wired with this controller as its
        ``membership_source`` reads this on every lookup."""
        return self.manager.cluster

    @property
    def epoch(self) -> int:
        return self.epochs[-1].epoch

    @property
    def leader(self) -> str | None:
        return self.manager.leader

    def membership_mask(self) -> tuple[bool, ...]:
        return tuple(bool(n.available) for n in self.manager.cluster.nodes)

    def membership_fingerprint(self) -> str:
        return membership_fingerprint(self.manager.cluster)

    def available_names(self) -> tuple[str, ...]:
        return tuple(n.name for n in self.manager.cluster.nodes
                     if n.available)

    def add_epoch_hook(self, hook: Callable[[MembershipEpoch], object]
                       ) -> Callable[[MembershipEpoch], object]:
        """Register an additional per-epoch callback (fired after
        ``on_epoch``, in registration order).  Unlike the single
        constructor callback this composes: the serving engine's EXPLORE
        re-entry and a ``SpeculativePrewarmer``'s next-departure
        speculation can both observe the same epoch.  Returns the hook so
        it can be used as a decorator."""
        self._epoch_hooks.append(hook)
        return hook

    # --------------------------------------------------------------- driving
    def advance(self, now: float) -> tuple[ChurnEvent, ...]:
        """Apply every unconsumed event with ``time <= now``.  All events
        applied by one call coalesce into at most one new epoch; the
        heartbeat monitor is beaten for every available node at ``now`` so
        ``refresh_availability`` agrees with the trace.  Returns the
        applied events (empty when nothing fired)."""
        applied: list[ChurnEvent] = []
        events = self.trace.events
        while self._cursor < len(events) and events[self._cursor].time <= now:
            e = events[self._cursor]
            self._cursor += 1
            self._apply(e)
            applied.append(e)
        self.now = max(self.now, now)
        if applied:
            self._close_epoch(applied)
        for name in self.available_names():
            self.manager.monitor.beat(name, self.now)
        return tuple(applied)

    def _apply(self, e: ChurnEvent) -> None:
        up = not e.goes_down
        self.manager.set_available(e.node, up)
        if not up and self.feedback is not None:
            # a departed node's half-filled drift windows must not judge
            # its post-return measurements
            self.feedback.forget_resource(e.node)

    def _close_epoch(self, applied: Iterable[ChurnEvent]) -> None:
        if not self.manager.leader_available():
            self._elect_fallback()
        mask = self.membership_mask()
        last = self.epochs[-1]
        if mask == last.mask:
            return                      # e.g. a leave+join that cancelled out
        ep = MembershipEpoch(epoch=last.epoch + 1, time=self.now, mask=mask,
                             fingerprint=self.membership_fingerprint(),
                             leader=self.manager.leader,
                             events=tuple(applied))
        self.epochs.append(ep)
        if self.telemetry is not None:
            self.telemetry.gauge(
                "fleet.membership", float(ep.available()), t=ep.time,
                epoch=ep.epoch, fingerprint=ep.fingerprint[:12],
                leader=ep.leader or "",
                events=",".join(e.kind for e in ep.events))
        if self.on_epoch is not None:
            self.on_epoch(ep)
        for hook in self._epoch_hooks:
            hook(ep)

    def _elect_fallback(self, count: bool = True) -> str | None:
        """Hand the seat over via the shared ``ensure_leader`` policy,
        counting the hand-off when it really changed hands."""
        before = self.manager.leader
        name = self.manager.ensure_leader()
        if count and name != before:
            self.leader_elections += 1
            if self.telemetry is not None:
                self.telemetry.counter(
                    "fleet.leader_election", t=self.now,
                    epoch=self.epochs[-1].epoch if self.epochs else 0,
                    previous=before or "", leader=name or "")
        return name

    def elect_leader(self, preferred: str | None = None) -> str:
        """Alg. 1 line 2 under churn: the preferred (receiving) node leads
        when available, otherwise the sitting leader or the first
        available node (``ClusterManager.ensure_leader`` — the one
        fail-over policy).  Raises when the fleet is empty."""
        name = self.manager.ensure_leader(preferred)
        if name is None:
            raise RuntimeError("no available node to lead")
        return name

    # --------------------------------------------------- fault-injection peek
    def next_failure(self, start: float, end: float,
                     nodes: Iterable[str]) -> ChurnEvent | None:
        """The earliest *unconsumed* failure event (``crash``) with
        ``start < time <= end`` on one of ``nodes`` — peeked, not applied.
        The simulator uses this to decide whether an execution window
        survives; handling the failure then goes through :meth:`advance`
        (which consumes everything up to the crash instant, coalescing it
        with any earlier graceful events into one epoch)."""
        targets = set(nodes)
        for e in self.trace.events[self._cursor:]:
            if e.time > end:
                break
            if e.time > start and e.is_failure and e.node in targets:
                return e
        return None

    def __repr__(self) -> str:
        return (f"FleetController(epoch={self.epoch}, "
                f"available={len(self.available_names())}/"
                f"{len(self.manager.cluster.nodes)}, "
                f"leader={self.manager.leader!r}, "
                f"events {self._cursor}/{len(self.trace)})")
