"""Planning-objective metric names, copied from ``repro.core.objective``."""

METRICS = ("latency", "energy", "edp")
