"""The port's copy of the telemetry helper the serving engine needs."""

from .recorder import active  # noqa: F401
