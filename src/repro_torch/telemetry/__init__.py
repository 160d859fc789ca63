"""The port's copy of ``repro.telemetry``'s event schema and recorder.

Typed, timestamped events (:class:`TelemetryEvent`) and the one emission
point every subsystem shares (:class:`TelemetryRecorder`, normalised by
:func:`active`).  The serving engine, ``PlanCache``, ``FeedbackLoop``,
``FleetController`` and ``ElasticController`` take one as ``telemetry=``.
The run store, trace trees and reports are not ported yet
(``ROADMAP.md``): ``TelemetryRecorder.flush``/``close`` take any store
object.
"""

from .events import KINDS, WALL_FIELDS, TelemetryEvent  # noqa: F401
from .recorder import SpanHandle, TelemetryRecorder, active  # noqa: F401
