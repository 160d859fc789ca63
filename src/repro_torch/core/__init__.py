"""The port's copies of the pure helpers from ``repro.core`` that the serving
engine uses: the scheduler FSM states, the objective metric names and the
workload fingerprint."""

from .fingerprint import dag_fingerprint  # noqa: F401
from .objective import METRICS  # noqa: F401
from .scheduler import State  # noqa: F401
