"""The port's copy of ``repro.telemetry.events``.

Typed, timestamped telemetry events — the fleet's structured record.

Every observable fact in the stack becomes one :class:`TelemetryEvent` of
exactly three kinds:

``span``
    Something with an extent: a request, a retry attempt, a DP frontier
    pass, a kernel micro-benchmark.  ``value`` is the span's duration in
    the *deterministic* time domain (simulated seconds); wall-clock-
    measured extents (planning passes, kernel timings) carry their
    measured seconds in ``wall_s`` instead, because wall time is not
    replayable.
``counter``
    Something that happened N times: a cache hit, a retry, an eviction,
    an SLO violation.  ``value`` is the increment (usually 1).
``gauge``
    A level sampled at an instant: fleet membership size, drift
    magnitude, elastic world size, joules.

Spans form **trace trees**: every span may carry a recorder-assigned
``span_id`` and any event a ``parent_id`` naming the span it happened
*inside* — a retry attempt under its request, a frontier pass under the
submit that triggered it, a per-stage compute shard under its attempt.
Ids come from the recorder's deterministic allocation counter (program
order, not wall clocks), so parentage is part of the replayable surface:
:meth:`TelemetryEvent.canonical` **keeps** both fields, and two seeded
replays must agree on the whole tree byte-for-byte.
:mod:`repro_torch.telemetry.trace` reconstructs the trees and computes
critical paths from them.

Determinism is a schema contract, not an aspiration: every field except
the :data:`WALL_FIELDS` (``wall`` — the unix timestamp, ``wall_s`` — a
wall-clock-measured duration) must be reproducible under the repo's
seeded-replay idiom.  Two seeded runs of the same churn trace therefore
produce byte-identical logs once those fields are stripped —
:meth:`TelemetryEvent.canonical` is that projection, and the test suite
holds the whole pipeline to it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping

#: event kinds, fixed — queries and reports switch on these
KINDS = ("span", "counter", "gauge")

#: the only fields allowed to differ between two seeded replays of the
#: same run (wall-clock timestamp / wall-clock-measured duration)
WALL_FIELDS = ("wall", "wall_s")


@dataclasses.dataclass(frozen=True)
class TelemetryEvent:
    """One structured observation.

    Attributes:
        seq: recorder-assigned monotone sequence number — the total order
            events are replayed and compared in (deterministic, unlike
            wall time).
        kind: ``"span"`` | ``"counter"`` | ``"gauge"``.
        name: dotted event name, e.g. ``"sim.request"``,
            ``"plan_cache.hit"``, ``"fleet.membership"``.
        value: the deterministic payload — span duration (domain time),
            counter increment, or gauge level.
        t: logical time (simulated seconds for simulator-driven runs,
            the recorder's clock otherwise).
        tenant: the tenant (dag name) this event belongs to, ``""`` when
            not tenant-scoped.
        epoch: the fleet membership epoch in effect, None outside churn.
        attrs: free-form deterministic attributes (request id, node,
            metric, shape, ...).
        span_id: this span's identity in the trace tree (recorder-
            allocated, deterministic program order); None for events that
            are not themselves spans-with-children.
        parent_id: the ``span_id`` of the enclosing span — what makes
            flat logs reconstructable as causal trees; None for roots
            and for events emitted outside any span context.
        wall: unix timestamp at emission (nondeterministic, stripped by
            :meth:`canonical`).
        wall_s: wall-clock-measured duration for spans timed against
            real hardware (nondeterministic, stripped likewise).
    """

    seq: int
    kind: str
    name: str
    value: float
    t: float = 0.0
    tenant: str = ""
    epoch: int | None = None
    attrs: Mapping = dataclasses.field(default_factory=dict)
    span_id: int | None = None
    parent_id: int | None = None
    wall: float = 0.0
    wall_s: float | None = None

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}; "
                             f"expected one of {KINDS}")

    # ------------------------------------------------------------- codecs
    def to_dict(self) -> dict:
        d = {"seq": self.seq, "kind": self.kind, "name": self.name,
             "value": self.value, "t": self.t}
        if self.tenant:
            d["tenant"] = self.tenant
        if self.epoch is not None:
            d["epoch"] = self.epoch
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.span_id is not None:
            d["span_id"] = self.span_id
        if self.parent_id is not None:
            d["parent_id"] = self.parent_id
        d["wall"] = self.wall
        if self.wall_s is not None:
            d["wall_s"] = self.wall_s
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: Mapping) -> "TelemetryEvent":
        return cls(seq=int(d["seq"]), kind=d["kind"], name=d["name"],
                   value=float(d["value"]), t=float(d.get("t", 0.0)),
                   tenant=d.get("tenant", ""), epoch=d.get("epoch"),
                   attrs=dict(d.get("attrs", {})),
                   span_id=d.get("span_id"), parent_id=d.get("parent_id"),
                   wall=float(d.get("wall", 0.0)), wall_s=d.get("wall_s"))

    @classmethod
    def from_json(cls, line: str) -> "TelemetryEvent":
        return cls.from_dict(json.loads(line))

    # -------------------------------------------------------- determinism
    def canonical(self) -> str:
        """The event as JSON with the :data:`WALL_FIELDS` stripped — the
        byte string two seeded replays of the same run must agree on.
        ``span_id``/``parent_id`` are deliberately *kept*: trace-tree
        shape is deterministic and part of the replay contract."""
        d = self.to_dict()
        for f in WALL_FIELDS:
            d.pop(f, None)
        return json.dumps(d, sort_keys=True, separators=(",", ":"))
