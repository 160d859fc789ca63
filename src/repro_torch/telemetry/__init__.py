"""The port's copy of ``repro.telemetry``: structured fleet telemetry and
the queryable run store.

Typed, timestamped events (:class:`TelemetryEvent`) and the one emission
point every subsystem shares (:class:`TelemetryRecorder`, normalised by
:func:`active`).  The serving engine, ``EdgeSimulator``, ``PlanCache``,
``FeedbackLoop``, ``FleetController``, ``ElasticController`` and the
open-loop harness take one as ``telemetry=``.

Events land in a :class:`RunStore` (JSONL log + atomic manifest, one
directory per run, the same on-disk layout as the JAX package's, so either
package reads a store the other wrote); :mod:`repro_torch.telemetry.trace`
rebuilds the causal span trees, :mod:`repro_torch.telemetry.report` turns a
run into a p50/p99/energy/hit-rate summary and reconstructs the
simulator's ``SimReport`` aggregates exactly from the log, and
:mod:`repro_torch.telemetry.regress` diffs two metric snapshots.
"""

from .events import KINDS, WALL_FIELDS, TelemetryEvent  # noqa: F401
from .recorder import SpanHandle, TelemetryRecorder, active  # noqa: F401
from .report import run_summary, sim_aggregates  # noqa: F401
from .store import RunStore  # noqa: F401
from .trace import (SpanNode, critical_path,  # noqa: F401
                    node_utilization, overlap_headroom,
                    request_critical_paths, span_trees, tree_lines)
