"""The port's copy of ``repro.core.fingerprint``.

Fingerprinting — the hashes calibration and plan caching key on.

A calibration (and therefore a cached plan frontier) is only valid for the
hardware it was computed against, so both ``CalibrationStore`` paths and
``PlanCache`` keys start with a fingerprint of the cluster's declared
topology: node and processor names, datasheet rates, link bandwidths, and
affinity tables.  Any change to the fleet — a board swapped, a link
upgraded, an affinity retuned — changes the fingerprint and cleanly
invalidates both stores at once.

A cached frontier is likewise only valid for the *workload* it was planned
for, so multi-tenant cache keys carry a :func:`dag_fingerprint` — a digest
of the block DAG's full cost surface (names, FLOPs, byte counts, kinds,
splittability) rather than just its name.  Two tenants that happen to share
a model name but differ in shape can never collide, and editing a model's
blocks orphans its persisted fronts exactly like a board swap orphans
calibrations.

A cached frontier is finally only valid for the *membership* it was planned
over: the planner restricts itself to available nodes (Eq. 4's A(N_φ)), so
a plan computed while a node was away is a different plan than one computed
with it present, even though the declared topology — and therefore the
cluster fingerprint — is unchanged.  :func:`membership_fingerprint` digests
the availability mask over the declared node list, which lets caches file
fronts for distinct memberships *side by side*: a node that leaves and
later returns flips the mask back to a previously-seen value, and the warm
front for that membership serves again with zero DP work
(``repro.fleet`` drives this lifecycle).

Keeping all three hashes here (rather than duplicated in each subsystem) is
what guarantees the key spaces cannot drift apart.
"""

from __future__ import annotations

import hashlib
import json
from typing import TYPE_CHECKING

from .cost_model import Cluster

if TYPE_CHECKING:
    from .dag import ModelDAG


def _digest(spec) -> str:
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]


def cluster_fingerprint(cluster: Cluster) -> str:
    """A 16-hex-digit digest of the cluster's declared topology."""
    spec = [
        (n.name, n.net_bw, n.default_processor,
         [(p.name, p.kind, p.peak_flops, p.local_bw, list(p.affinity))
          for p in n.processors])
        for n in cluster.nodes
    ]
    return _digest(spec)


def membership_fingerprint(cluster: Cluster) -> str:
    """A 16-hex-digit digest of the cluster's availability mask A(N_φ),
    ordered by the declared node list.  Two clusters with the same declared
    topology hash equal under :func:`cluster_fingerprint` whatever their
    availability; this hash separates their *memberships* — the same set of
    nodes away always yields the same digest, so a leave-then-return
    membership maps back onto its original cache entries."""
    return _digest([(n.name, bool(n.available)) for n in cluster.nodes])


def dag_fingerprint(dag: "ModelDAG") -> str:
    """A 16-hex-digit digest of a workload's identity: every field the cost
    model prices, so plans cached (or persisted) under this hash can only be
    served back to the exact same workload.

    Memoized per DAG instance (a direct ``__dict__`` write, which a frozen
    dataclass permits and its field-based ``__eq__``/``replace`` ignore) —
    the serving hot path fingerprints on every lookup and must stay at
    dict-access cost."""
    cached = dag.__dict__.get("_fingerprint")
    if cached is None:
        spec = (dag.name, dag.input_bytes, dag.output_bytes,
                [(b.name, b.flops, b.param_bytes, b.bytes_in, b.bytes_out,
                  b.data_splittable, b.halo_fraction, b.kind)
                 for b in dag.blocks])
        cached = _digest(spec)
        dag.__dict__["_fingerprint"] = cached
    return cached
