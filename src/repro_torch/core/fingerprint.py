"""Workload fingerprint, byte-for-byte the digest of
``repro.core.fingerprint.dag_fingerprint``: plan caches key tenants on it, so
the port and the JAX package must agree on every DAG."""

from __future__ import annotations

import hashlib
import json


def _digest(spec) -> str:
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]


def dag_fingerprint(dag) -> str:
    """A 16-hex-digit digest of a workload's identity: every field the cost
    model prices (names, FLOPs, byte counts, kinds, splittability).

    ``dag`` is any object with a ModelDAG's fields.  Memoized per DAG
    instance under the same ``__dict__`` key as the JAX package (the digests
    are equal, so either package may fill it)."""
    cached = dag.__dict__.get("_fingerprint")
    if cached is None:
        spec = (dag.name, dag.input_bytes, dag.output_bytes,
                [(b.name, b.flops, b.param_bytes, b.bytes_in, b.bytes_out,
                  b.data_splittable, b.halo_fraction, b.kind)
                 for b in dag.blocks])
        cached = _digest(spec)
        dag.__dict__["_fingerprint"] = cached
    return cached
