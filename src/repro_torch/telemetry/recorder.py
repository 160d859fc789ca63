"""The port's copy of ``repro.telemetry.recorder``.

TelemetryRecorder — the one emission point every subsystem shares.

A recorder is cheap enough to thread through hot paths: emission is a
dataclass construction and a list append; a *disabled* recorder
(``enabled=False``) is indistinguishable from no recorder at all, because
instrumented classes normalize it to ``None`` via :func:`active` at
construction time — the hot path then pays exactly one ``is not None``
check, which is why the fig7 overhead gate holds the disabled path to a
≤2 % regression.

Ordering is deterministic: every event gets the recorder's next ``seq``,
and logical time comes from the recorder's :attr:`clock`, which the
simulator advances as simulated time passes (subsystems with no time of
their own — the plan cache, the feedback loop — stamp events with the
clock as-is).  Wall-clock facts are confined to the schema's designated
``wall``/``wall_s`` fields, so seeded replays stay byte-identical modulo
those fields (see :mod:`repro_torch.telemetry.events`).  A span
wall-clocked by :meth:`trace` (``wall=True``) is read on the unix clock at
both ends, so ``[wall - wall_s, wall]`` is the block itself, on the clock of
``torch.profiler``'s host and device events; counters and gauges keep
``wall`` as their emission time.

Causal context rides the same determinism: :meth:`trace` opens a span
context (ids from a deterministic allocation counter, **not** the event
``seq`` — a parent span is emitted *after* its children, so its eventual
seq is unknowable at child-emission time), and every event emitted while
a context is open is auto-parented under it.  Subsystems that cannot
nest their control flow (the open-loop harness's event loop) allocate
ids explicitly with :meth:`allocate_span` and pass ``span_id=`` /
``parent_id=`` themselves.  :mod:`repro_torch.telemetry.trace` rebuilds
the trees.

Lifecycle::

    store = RunStore("artifacts/telemetry")
    tel = TelemetryRecorder(store.new_run("churn"), store=store)
    ... thread tel through EdgeSimulator / PlanCache / FleetController ...
    tel.close(cluster_fingerprint=...)     # flush events + write manifest

``store`` is any object with ``append(run, events)`` and
``write_manifest(run, manifest)``: the port's
:class:`~repro_torch.telemetry.store.RunStore` or the JAX package's.

``flush_every=N`` bounds the in-memory buffer for long runs; ``close``
always flushes the tail and stamps the manifest with per-kind counts.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

from .events import TelemetryEvent

#: sentinel for "parent under the innermost open trace() context"
_AUTO = object()


class SpanHandle:
    """The mutable face of an open :meth:`TelemetryRecorder.trace`
    context: callers fill in what is only known at exit (duration, final
    epoch, outcome attrs) via :meth:`set` before the context closes and
    the span event is emitted."""

    __slots__ = ("span_id", "name", "duration", "t", "tenant", "epoch",
                 "wall_s", "attrs")

    def __init__(self, span_id: int | None, name: str, t: float | None,
                 tenant: str, epoch: int | None, attrs: dict):
        self.span_id = span_id
        self.name = name
        self.duration = 0.0
        self.t = t
        self.tenant = tenant
        self.epoch = epoch
        self.wall_s: float | None = None
        self.attrs = attrs

    def set(self, duration: float | None = None, *,
            t: float | None = None, tenant: str | None = None,
            epoch: int | None = None, **attrs) -> "SpanHandle":
        """Update the span's fields before the context closes; extra
        keywords merge into its attrs.  Returns self for chaining."""
        if duration is not None:
            self.duration = float(duration)
        if t is not None:
            self.t = t
        if tenant is not None:
            self.tenant = tenant
        if epoch is not None:
            self.epoch = epoch
        self.attrs.update(attrs)
        return self


def active(telemetry: "TelemetryRecorder | None"
           ) -> "TelemetryRecorder | None":
    """Normalize a ``telemetry=`` constructor argument: a disabled
    recorder becomes ``None`` so instrumented hot paths pay only a single
    ``is not None`` check per event site.  Consequence: ``enabled`` is a
    construction-time decision — flipping it after wiring has no effect
    on classes that already normalized."""
    if telemetry is None or not telemetry.enabled:
        return None
    return telemetry


_NO_SPAN = contextlib.nullcontext()


def wall_span(telemetry: "TelemetryRecorder | None", name: str, **attrs):
    """A wall-clocked :meth:`TelemetryRecorder.trace` context on
    ``telemetry``, or, where it is None (normalized by :func:`active`), one
    shared null context that yields None: a hot path's span site costs one
    ``is None`` check when nothing records."""
    if telemetry is None:
        return _NO_SPAN
    return telemetry.trace(name, wall=True, **attrs)


class TelemetryRecorder:
    """Buffers typed events for one run.

    Attributes:
        run: the run id events are filed under in the :class:`RunStore`.
        enabled: construction-time switch; a disabled recorder emits
            nothing and is normalized away by :func:`active`.
        clock: the logical clock (simulated seconds); events emitted
            without an explicit ``t`` are stamped with it.
        events: the in-memory buffer (flushed events are dropped from it
            only on ``flush`` when a store is wired).
    """

    def __init__(self, run: str = "run", *, enabled: bool = True,
                 store=None, flush_every: int | None = None):
        self.run = run
        self.enabled = enabled
        self.clock = 0.0
        self.events: list[TelemetryEvent] = []
        self._store = store
        if flush_every is not None and flush_every < 1:
            raise ValueError("flush_every must be >= 1")
        if flush_every is not None and store is None:
            raise ValueError("flush_every needs a store to flush to")
        self._flush_every = flush_every
        self._seq = 0
        self._counts = {"span": 0, "counter": 0, "gauge": 0}
        self._flushed = 0
        self._closed = False
        # trace-tree state: deterministic span-id allocation (program
        # order) and the stack of open trace() contexts
        self._next_span = 0
        self._stack: list[int] = []

    # ------------------------------------------------------------- clock
    def advance(self, t: float) -> None:
        """Move the logical clock forward (never backward) — the
        simulator calls this as simulated time passes so clock-stamped
        events from time-blind subsystems land at the right instant."""
        if t > self.clock:
            self.clock = t

    # ------------------------------------------------------- trace context
    def allocate_span(self) -> int:
        """Reserve the next deterministic span id without emitting
        anything — for callers whose control flow cannot nest (the
        open-loop harness allocates one per arrival at arrival time and
        emits the root span at the request's terminal event)."""
        sid = self._next_span
        self._next_span += 1
        return sid

    def current_span(self) -> int | None:
        """The innermost open :meth:`trace` context's span id (what an
        auto-parented event would attach to), or None."""
        return self._stack[-1] if self._stack else None

    @contextlib.contextmanager
    def trace(self, name: str, *, t: float | None = None,
              tenant: str = "", epoch: int | None = None,
              wall: bool = False, parent_id=_AUTO,
              **attrs) -> Iterator[SpanHandle]:
        """Open a span context: events emitted inside are auto-parented
        under it, and the span itself is emitted at exit (children first,
        parent last — trees are rebuilt from ids, not emission order).
        The yielded :class:`SpanHandle` takes exit-time facts
        (``handle.set(duration=..., ok=...)``); with ``wall=True`` the
        block is wall-clocked into ``wall_s`` like :meth:`timed`: one
        ``time.time_ns()`` read at each end, the closing one the event's
        ``wall``, so the span covers ``[wall - wall_s, wall]`` on the unix
        clock that ``torch.profiler`` gives its host and device events."""
        if not self.enabled:
            yield SpanHandle(None, name, t, tenant, epoch, dict(attrs))
            return
        h = SpanHandle(self.allocate_span(), name, t, tenant, epoch,
                       dict(attrs))
        if parent_id is _AUTO:
            parent_id = self.current_span()
        self._stack.append(h.span_id)
        t0 = time.time_ns() if wall else None
        try:
            yield h
        finally:
            self._stack.pop()
            t1 = None
            if t0 is not None:
                t1 = time.time_ns()
                if h.wall_s is None:
                    h.wall_s = (t1 - t0) / 1e9
            self._emit("span", h.name, h.duration, h.t, h.tenant, h.epoch,
                       h.wall_s, h.attrs, span_id=h.span_id,
                       parent_id=parent_id,
                       wall=None if t1 is None else t1 / 1e9)

    def child_span(self, name: str, duration: float, *,
                   t: float | None = None, tenant: str = "",
                   epoch: int | None = None, wall_s: float | None = None,
                   parent_id=_AUTO, **attrs) -> int | None:
        """Emit a leaf span with its own id, parented under the current
        context (or an explicit ``parent_id``).  Returns the allocated
        span id — the handle per-stage children (compute/comm/queue-wait
        shards) hang deeper structure from."""
        if not self.enabled:
            return None
        sid = self.allocate_span()
        self._emit("span", name, duration, t, tenant, epoch, wall_s,
                   attrs, span_id=sid, parent_id=parent_id)
        return sid

    # ---------------------------------------------------------- emission
    def _emit(self, kind: str, name: str, value: float, t: float | None,
              tenant: str, epoch: int | None, wall_s: float | None,
              attrs: dict, span_id: int | None = None,
              parent_id=_AUTO, wall: float | None = None) -> None:
        if not self.enabled:
            return
        if parent_id is _AUTO:
            parent_id = self.current_span()
        ev = TelemetryEvent(
            seq=self._seq, kind=kind, name=name, value=float(value),
            t=self.clock if t is None else float(t), tenant=tenant,
            epoch=epoch, attrs=attrs, span_id=span_id,
            parent_id=parent_id,
            wall=time.time() if wall is None else wall, wall_s=wall_s)
        self._seq += 1
        self._counts[kind] += 1
        self.events.append(ev)
        if (self._flush_every is not None
                and len(self.events) >= self._flush_every):
            self.flush()

    def counter(self, name: str, value: float = 1.0, *,
                t: float | None = None, tenant: str = "",
                epoch: int | None = None, parent_id=_AUTO,
                **attrs) -> None:
        """Something happened ``value`` times (default 1)."""
        self._emit("counter", name, value, t, tenant, epoch, None, attrs,
                   parent_id=parent_id)

    def gauge(self, name: str, value: float, *, t: float | None = None,
              tenant: str = "", epoch: int | None = None,
              parent_id=_AUTO, **attrs) -> None:
        """A level sampled at an instant."""
        self._emit("gauge", name, value, t, tenant, epoch, None, attrs,
                   parent_id=parent_id)

    def span(self, name: str, duration: float, *,
             t: float | None = None, tenant: str = "",
             epoch: int | None = None, wall_s: float | None = None,
             span_id: int | None = None, parent_id=_AUTO,
             **attrs) -> None:
        """An extent: ``duration`` in deterministic domain time (pass 0.0
        and ``wall_s=`` for extents only wall clocks can measure).
        ``span_id`` attaches a pre-allocated identity (see
        :meth:`allocate_span`); without one the span is a leaf that
        children cannot reference."""
        self._emit("span", name, duration, t, tenant, epoch, wall_s,
                   attrs, span_id=span_id, parent_id=parent_id)

    @contextlib.contextmanager
    def timed(self, name: str, *, tenant: str = "",
              epoch: int | None = None, **attrs) -> Iterator[None]:
        """Wall-clock a block as a span: the measured seconds land in the
        nondeterministic ``wall_s`` field, ``value`` stays 0 — use for DP
        frontier passes, kernel profiles, benchmark suites.  The block is
        a full :meth:`trace` context, so events inside parent under it."""
        with self.trace(name, tenant=tenant, epoch=epoch, wall=True,
                        **attrs):
            yield

    # -------------------------------------------------------- persistence
    def flush(self, store=None) -> int:
        """Append buffered-but-unflushed events to the store's JSONL log.
        Returns the number written (0 for a disabled/empty recorder)."""
        store = self._store if store is None else store
        pending = self.events[self._flushed:]
        if store is None or not pending:
            return 0
        n = store.append(self.run, pending)
        self._flushed += n
        return n

    def close(self, store=None, **manifest_extra) -> int:
        """Flush the tail and write the run manifest (per-kind counts,
        total events, plus any caller metadata).  Idempotent."""
        store = self._store if store is None else store
        n = self.flush(store)
        if store is not None and self.enabled and not self._closed:
            store.write_manifest(self.run, {
                "events": self._seq, "counts": dict(self._counts),
                "clock_end": self.clock, **manifest_extra})
            self._closed = True
        return n

    def __repr__(self) -> str:
        state = "enabled" if self.enabled else "disabled"
        return (f"TelemetryRecorder(run={self.run!r}, {state}, "
                f"{self._seq} events, clock={self.clock:.3f})")
