"""The ``telemetry=`` normaliser, copied from
``repro.telemetry.recorder.active``.  The engine receives a recorder as an
object and never imports its class."""

from __future__ import annotations


def active(telemetry):
    """Normalize a ``telemetry=`` constructor argument: a disabled recorder
    becomes ``None`` so instrumented hot paths pay only a single
    ``is not None`` check per event site."""
    if telemetry is None or not telemetry.enabled:
        return None
    return telemetry
