"""The port's copy of ``repro.core.dp_cache``.

PlannerWorkspace — memoized setup and DP row reuse for the fast planner.

The DP partitioner's cold pass re-derives the same intermediate state over
and over: the heterogeneity order and per-resource prefix sums are rebuilt
on every ``partition_*`` call, the scalar seed DP inside a frontier pass
re-solves exactly the subproblems the frontier DP just visited, and a
membership epoch re-solves every survivor's rows from scratch.  This module
is the shared scratch space that stops all of that:

* **setup memos** — the heterogeneity order, per-resource segment-cost /
  energy matrices and comm vectors, keyed by ``(dag fingerprint,
  resources)``, so a frontier sweep builds each prefix sum once;
* **DP row caches** — the scalar DP's per-resource rows
  ``(dp, best, bestj, parent)`` and the frontier DP's per-resource cell
  rows, keyed by ``(dag fingerprint, flags, ordered-resource *prefix*)``.
  Row *j* of either DP depends only on the first *j* resources in
  heterogeneity order, so when a membership epoch removes a node at
  position *k*, every row before *k* is byte-for-byte reusable — the
  departure invalidates only the rows that used it.  ``rows_computed`` /
  ``rows_reused`` count exactly this (the tab1 incremental-replan gate
  reads them);
* **result memos** — whole ``partition_model`` / front-search /
  data-candidate / local-front results, so the duplicated sub-calls of a
  hierarchical pass (the seed anchor inside ``partition_model_front``, the
  scalar re-plan inside ``plan_local_front``, …) collapse to one solve.

Workspaces are keyed **per cost provider**: the analytic provider (a
stateless singleton) shares one process-wide workspace; any other provider
gets its own, anchored weakly on the provider's fitted ``model`` when it
has one (so ``at_delta`` rebinds — which create fresh provider objects
around the same model — keep hitting the same rows) and dropped when the
model is garbage-collected.  A provider whose model carries a ``revision``
counter (``repro_torch.profiling.LearnedCostModel`` bumps it on every
``observe``/``fit``) invalidates its workspace automatically on refit:
stale rows can never price a plan after the calibration moved.

Everything cached here is immutable once inserted (numpy rows are never
written after publication; frontier states are tuples), so sharing across
calls — and across the ``PlanCache`` pre-warm path — is safe by
construction.  All caches are bounded LRU; ``reset_workspaces()`` clears
every workspace (benchmarks use it to measure genuinely cold passes).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence
from weakref import WeakKeyDictionary

import numpy as np

# Per-table entry bound.  Entries are small (a few KB: one (n+1)² float64
# matrix per resource, n ≤ ~200 blocks), so this caps a workspace well
# under typical plan-cache budgets while keeping every live tenant warm.
MAX_ENTRIES = 1024


class _LRU:
    """A bounded, insertion-refreshing mapping (oldest evicted first)."""

    __slots__ = ("cap", "data")

    def __init__(self, cap: int = MAX_ENTRIES):
        self.cap = cap
        self.data: OrderedDict = OrderedDict()

    def get(self, key):
        val = self.data.get(key)
        if val is not None:
            self.data.move_to_end(key)
        return val

    def put(self, key, val) -> None:
        self.data[key] = val
        self.data.move_to_end(key)
        while len(self.data) > self.cap:
            self.data.popitem(last=False)

    def __len__(self) -> int:
        return len(self.data)

    def clear(self) -> None:
        self.data.clear()


class PlannerWorkspace:
    """One provider's memo space for the vectorized DP.

    Attributes:
        orders: ``(dag_fp, resources) → (ordered resources, index order)``.
        arrays: ``(dag_fp, resource, tag, …) → ndarray`` — comm vectors,
            segment cost/energy matrices, weight-transfer matrices.
        scalar_rows: ``(dag_fp, weight_transfer, prefix) → (dp, best,
            bestj, parent)`` numpy rows of the scalar latency DP.
        front_rows: ``(dag_fp, weight_transfer, radio, cap, prefix) →
            (dp_cells, best_cells)`` frontier DP rows.
        results: whole-call memo (partitions, fronts, data candidates).
        rows_computed / rows_reused: lifetime DP row counters — the
            incremental-replan currency (cold pass: all computed; epoch
            re-plan: only rows at/after the departed node's position).
        revision: the provider model revision these entries were built
            against (None for stateless providers).
    """

    __slots__ = ("orders", "arrays", "scalar_rows", "front_rows", "results",
                 "rows_computed", "rows_reused", "revision", "_masks")

    def __init__(self):
        self.orders = _LRU()
        self.arrays = _LRU()
        self.scalar_rows = _LRU()
        self.front_rows = _LRU()
        self.results = _LRU()
        self.rows_computed = 0
        self.rows_reused = 0
        self.revision = None
        self._masks: dict[int, np.ndarray] = {}

    # ------------------------------------------------------------- helpers
    def valid_mask(self, n: int) -> np.ndarray:
        """The strict upper-triangular (s < i) validity mask shared by every
        (n+1)×(n+1) DP transition matrix."""
        mask = self._masks.get(n)
        if mask is None:
            mask = np.triu(np.ones((n + 1, n + 1), dtype=bool), k=1)
            if len(self._masks) > 32:
                self._masks.clear()
            self._masks[n] = mask
        return mask

    def clear(self) -> None:
        self.orders.clear()
        self.arrays.clear()
        self.scalar_rows.clear()
        self.front_rows.clear()
        self.results.clear()
        self._masks.clear()

    def reset_counters(self) -> None:
        self.rows_computed = 0
        self.rows_reused = 0

    def stats(self) -> dict:
        return {"rows_computed": self.rows_computed,
                "rows_reused": self.rows_reused,
                "orders": len(self.orders), "arrays": len(self.arrays),
                "scalar_rows": len(self.scalar_rows),
                "front_rows": len(self.front_rows),
                "results": len(self.results)}


# The analytic provider is a stateless singleton — one shared workspace.
_ANALYTIC_WS = PlannerWorkspace()
# Other providers anchor weakly on their fitted model (or themselves):
# anchor → {sub-key → PlannerWorkspace}.
_PROVIDER_WS: "WeakKeyDictionary" = WeakKeyDictionary()
_MAX_PER_ANCHOR = 16


def workspace_for(provider) -> PlannerWorkspace | None:
    """The workspace serving ``provider`` — None when the provider cannot
    be safely cached against (unhashable / not weak-referenceable), which
    sends the caller down the uncached-but-still-vectorized path."""
    from .cost_model import ANALYTIC
    if provider is None or provider is ANALYTIC:
        return _ANALYTIC_WS
    anchor = getattr(provider, "model", None)
    if anchor is None:
        anchor = provider
    try:
        per = _PROVIDER_WS.get(anchor)
    except TypeError:
        return None
    if per is None:
        per = OrderedDict()
        try:
            _PROVIDER_WS[anchor] = per
        except TypeError:
            return None
    # δ-rebound providers around the same model each get their own rows
    # (rates differ per δ); the model anchor keeps them alive together
    sub = (type(provider).__name__, getattr(provider, "delta", None))
    ws = per.get(sub)
    if ws is None:
        ws = PlannerWorkspace()
        per[sub] = ws
        while len(per) > _MAX_PER_ANCHOR:
            per.popitem(last=False)
    # a refit model (revision bump) orphans every cached row
    rev = getattr(anchor, "revision", None)
    if rev != ws.revision:
        ws.clear()
        ws.revision = rev
    return ws


def reset_workspaces() -> None:
    """Drop every cached row/memo (cold-start; benchmarks and tests)."""
    _ANALYTIC_WS.clear()
    _ANALYTIC_WS.reset_counters()
    for per in list(_PROVIDER_WS.values()):
        for ws in per.values():
            ws.clear()
            ws.reset_counters()


def single_departure_masks(cluster) -> list[tuple[bool, ...]]:
    """The likely next memberships: the current availability mask with one
    available node flipped down (never emptying the fleet) — what
    ``PlanCache.prewarm`` speculates over, ordered by the declared node
    list so the speculation schedule is deterministic."""
    mask = tuple(bool(n.available) for n in cluster.nodes)
    if sum(mask) <= 1:
        return []
    out = []
    for i, up in enumerate(mask):
        if up:
            out.append(tuple(m if k != i else False
                             for k, m in enumerate(mask)))
    return out


def heterogeneity_order(ws: PlannerWorkspace | None, dag, resources, prov,
                        dag_fp: str | None = None):
    """Cached heterogeneity-descending resource order (the seed's
    ``_heterogeneity_order``), keyed by ``(dag fingerprint, resources)``."""
    from .dp_partitioner import _heterogeneity_order
    if ws is None:
        return _heterogeneity_order(dag, resources, prov)
    from .fingerprint import dag_fingerprint
    key = (dag_fp or dag_fingerprint(dag), tuple(resources))
    got = ws.orders.get(key)
    if got is None:
        got = _heterogeneity_order(dag, resources, prov)
        ws.orders.put(key, got)
    return got
