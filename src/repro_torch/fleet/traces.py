"""The port's copy of ``repro.fleet.traces``.

Availability-event traces — the cluster dynamics a churn-aware fleet
replays.

HiDP's leader probes availability before every plan (Alg. 1 line 3,
Eq. 4); CoEdge and DEFER both treat device churn — nodes joining, leaving,
crashing, browning out, throttling — as the defining edge condition.  This
module turns those conditions into data: a :class:`ChurnTrace` is an
immutable, time-sorted sequence of :class:`ChurnEvent` s that a
:class:`~repro_torch.fleet.controller.FleetController` applies to a live
``ClusterManager``.  Traces are *replayable*: the trace itself never
mutates (the controller keeps the cursor), so the same trace drives a
simulation, a benchmark gate, and a unit test to identical membership
histories.

Event kinds and their availability semantics (the controller's mapping):

========================  ======================================================
kind                      meaning
========================  ======================================================
``leave``                 graceful departure — α_j → 0 at the next planning
                          boundary; in-flight shards complete
``crash``                 hard failure — α_j → 0 *immediately*; shards running
                          on the node at that instant fail and their request
                          must re-plan on the survivors (the simulator's
                          mid-request fault-injection path)
``battery_drain``         the node's battery ran out — availability-wise a
                          graceful leave (duty-cycled fleets announce it)
``thermal_throttle``      the node capped itself below usable capacity —
                          treated as a graceful leave until it cools
``join``                  a (new or returning) node becomes available
``battery_ok``            recharged — the ``battery_drain`` twin of ``join``
``recover``               cooled down — the ``thermal_throttle`` twin
========================  ======================================================

Generators: :meth:`ChurnTrace.scripted` (exact schedules — the unit-test
workhorse), :meth:`ChurnTrace.poisson` (seeded memoryless churn with
plausibility tracking: only present nodes leave, only absent nodes join),
:meth:`ChurnTrace.battery` and :meth:`ChurnTrace.thermal` (deterministic
duty cycles).  Compose with :meth:`ChurnTrace.merge`.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterable, Iterator, Sequence

#: kinds that flip a node's availability to 0
DOWN_KINDS = frozenset({"leave", "crash", "battery_drain",
                        "thermal_throttle"})
#: kinds that flip a node's availability to 1
UP_KINDS = frozenset({"join", "battery_ok", "recover"})
#: kinds that fail in-flight shards (vs taking effect at a plan boundary)
FAILURE_KINDS = frozenset({"crash"})

KINDS = DOWN_KINDS | UP_KINDS


@dataclasses.dataclass(frozen=True, order=True)
class ChurnEvent:
    """One availability change: at ``time``, ``node`` undergoes ``kind``."""

    time: float
    node: str
    kind: str

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown churn kind {self.kind!r}; "
                             f"expected one of {sorted(KINDS)}")

    @property
    def goes_down(self) -> bool:
        return self.kind in DOWN_KINDS

    @property
    def is_failure(self) -> bool:
        """True for kinds that kill in-flight shards (``crash``)."""
        return self.kind in FAILURE_KINDS


@dataclasses.dataclass(frozen=True)
class ChurnTrace:
    """An immutable, time-sorted availability-event schedule."""

    events: tuple[ChurnEvent, ...] = ()

    def __post_init__(self) -> None:
        times = [e.time for e in self.events]
        if times != sorted(times):
            object.__setattr__(self, "events",
                               tuple(sorted(self.events)))

    # -------------------------------------------------------------- builders
    @classmethod
    def scripted(cls, events: Iterable[ChurnEvent | tuple[float, str, str]]
                 ) -> "ChurnTrace":
        """An exact schedule: ``(time, node, kind)`` tuples or events."""
        return cls(tuple(e if isinstance(e, ChurnEvent) else ChurnEvent(*e)
                         for e in events))

    @classmethod
    def poisson(cls, node_names: Sequence[str], rate: float, horizon: float,
                seed: int = 0, crash_fraction: float = 0.5,
                protect: Sequence[str] = ()) -> "ChurnTrace":
        """Memoryless churn: events arrive as a Poisson process at ``rate``
        events/second over ``[0, horizon)``.  Each event picks a node
        uniformly and stays *plausible* — a present node leaves (a crash
        with probability ``crash_fraction``, else gracefully) and an absent
        node rejoins.  ``protect`` names nodes the trace never touches
        (keep the leader's seat stable).  Seeded: the same
        ``(node_names, rate, horizon, seed)`` always replays the same
        trace."""
        if rate <= 0:
            return cls(())
        rng = random.Random(seed)
        pool = [n for n in node_names if n not in set(protect)]
        if not pool:
            return cls(())
        present = dict.fromkeys(pool, True)
        events: list[ChurnEvent] = []
        t = rng.expovariate(rate)
        while t < horizon:
            node = rng.choice(pool)
            if present[node]:
                kind = "crash" if rng.random() < crash_fraction else "leave"
                present[node] = False
            else:
                kind = "join"
                present[node] = True
            events.append(ChurnEvent(t, node, kind))
            t += rng.expovariate(rate)
        return cls(tuple(events))

    @classmethod
    def battery(cls, node_names: Sequence[str], drain_after: float,
                recharge_after: float, horizon: float,
                stagger: float = 0.0) -> "ChurnTrace":
        """Duty-cycled batteries: each node drains after ``drain_after``
        seconds up, recharges ``recharge_after`` seconds later, repeating
        until ``horizon``.  ``stagger`` offsets successive nodes' cycles so
        the whole fleet never browns out at once."""
        return cls._duty_cycle(node_names, drain_after, recharge_after,
                               horizon, stagger, "battery_drain",
                               "battery_ok")

    @classmethod
    def thermal(cls, node_names: Sequence[str], throttle_after: float,
                cool_after: float, horizon: float,
                stagger: float = 0.0) -> "ChurnTrace":
        """Thermal duty cycle: sustained load trips the governor after
        ``throttle_after`` seconds; the node recovers ``cool_after``
        seconds later."""
        return cls._duty_cycle(node_names, throttle_after, cool_after,
                               horizon, stagger, "thermal_throttle",
                               "recover")

    @classmethod
    def _duty_cycle(cls, node_names: Sequence[str], up_s: float,
                    down_s: float, horizon: float, stagger: float,
                    down_kind: str, up_kind: str) -> "ChurnTrace":
        if up_s <= 0 or down_s <= 0:
            raise ValueError("duty-cycle phases must be positive")
        events: list[ChurnEvent] = []
        for i, name in enumerate(node_names):
            t = i * stagger + up_s
            while t < horizon:
                events.append(ChurnEvent(t, name, down_kind))
                if t + down_s >= horizon:
                    break
                events.append(ChurnEvent(t + down_s, name, up_kind))
                t += down_s + up_s
        return cls(tuple(sorted(events)))

    # ------------------------------------------------------------- operators
    def merge(self, *others: "ChurnTrace") -> "ChurnTrace":
        """The union schedule, time-sorted (ties keep left-operand order)."""
        merged = list(self.events)
        for o in others:
            merged.extend(o.events)
        return ChurnTrace(tuple(sorted(merged, key=lambda e: e.time)))

    def window(self, t0: float, t1: float) -> tuple[ChurnEvent, ...]:
        """Events with ``t0 < time <= t1`` (the half-open advance window)."""
        return tuple(e for e in self.events if t0 < e.time <= t1)

    def __iter__(self) -> Iterator[ChurnEvent]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        if not self.events:
            return "ChurnTrace(empty)"
        return (f"ChurnTrace({len(self.events)} events, "
                f"t [{self.events[0].time:.3g}, "
                f"{self.events[-1].time:.3g}] s)")
