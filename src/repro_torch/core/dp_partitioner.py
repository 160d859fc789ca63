"""The port's copy of ``repro.core.dp_partitioner``.

The HiDP dynamic-programming partitioner (paper §III, Algorithm 1 lines 4-6
and 8-10).

The paper uses one DP routine at both tiers ("the function arguments are
essentially the same in either case including the DNN and the
computation-communication ratio"):

* **model partitioning** — choose cut points turning the block chain into
  contiguous *stages* of heterogeneous width ω, each assigned to one resource;
  the request flows stage → stage, paying an activation transfer at every cut.
  ``Θ_ω = γ·ω`` with γ = Ψ (global) or ψ (local)  — Eq. 5.

* **data partitioning** — choose σ parallel sub-models and per-resource data
  fractions; all resources run concurrently and the slowest finishes last.
  ``Θ_σ = γ·σ``  — Eq. 6.

* **mode selection** — ``Θ = min(Θ_ω, Θ_σ)``  (Alg. 1 line 6 / 10).

The model-partitioning search is an exact DP over (prefix of blocks ×
resources-used):  DP[i][j] = best latency executing blocks[:i] on the first j
resources of a heterogeneity-ordered list.  The paper describes this as a
subset-sum-style O(n·m) recursion seeded "with the largest possible block
sizes following the resource heterogeneity" and back-propagating block by
block; we implement the exact O(n²·m) variant (n = #blocks is small: ≤ ~200)
and keep the paper's heterogeneity-descending resource order, which makes the
greedy seed the DP's first feasible path.

The search runs over numpy transition matrices, with per-resource DP rows
and whole-call results cached in a
:class:`repro_torch.core.dp_cache.PlannerWorkspace`.  Costs enter the inner
loops pre-computed but every accumulation keeps the seed DP's exact float64
association (``(prev + comm) + compute``, first-minimum ties), so plans and
frontiers are bit-identical to the JAX package's, whose pure-Python
reference DP is the oracle; ``tests/test_torch_planner.py`` holds this copy
to the JAX package's planner by exact equality.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .cost_model import CostProvider, Resource, resolve_provider
from .dag import DataPartition, ModelDAG, ModelPartition, Partition
from .dp_cache import PlannerWorkspace, heterogeneity_order, workspace_for
from .fingerprint import dag_fingerprint
from .objective import Objective, resolve_objective
from .pareto import ParetoFront, pareto_filter

# Per-cell frontier cap for the (latency, energy) DP search — the *search
# breadth* knob, distinct from a front's output ``width`` (how many points
# callers get back, e.g. ``PlannerConfig.front_width``).  Endpoints always
# survive thinning, so the cap trades interior resolution for speed.
DP_FRONT_CAP = 8


def _heterogeneity_order(dag: ModelDAG, resources: Sequence[Resource],
                         prov: CostProvider
                         ) -> tuple[list[Resource], list[int]]:
    """Resources by descending effective rate for the DAG's dominant kind —
    the paper's "following the resource heterogeneity" seed order."""
    kind = dag.dominant_kind()
    order = sorted(range(len(resources)),
                   key=lambda i: -prov.effective_rate(resources[i], kind))
    return [resources[i] for i in order], order


# --------------------------------------------------------------------------
# Model partitioning (pipeline over stages of width ω)
# --------------------------------------------------------------------------

def partition_model(dag: ModelDAG, resources: Sequence[Resource],
                    *, weight_transfer: bool = False,
                    provider: CostProvider | None = None,
                    objective: Objective | None = None) -> ModelPartition:
    """Exact DP for heterogeneous contiguous pipeline partitioning.

    Latency objective (single request, sequential stage execution — the
    paper's "inherently temporal" model partitioning):

        T = Σ_stages [ xfer_in(stage) + compute(stage) ]  + xfer_out(last)

    Resources are ordered by descending rate ("following the resource
    heterogeneity"); the DP may leave later (slower) resources unused, so the
    result uses between 1 and m stages with variable block widths.

    ``weight_transfer``: when True, shipping a stage to a non-leader resource
    also pays its ``param_bytes`` over that resource's link (cold start —
    used by the simulator's first-request path; steady-state serving keeps
    weights resident, the paper's implicit assumption).

    ``objective``: how the winning plan is chosen.  The default (latency)
    runs the seed's scalar DP unchanged.  Any other objective selects over
    the plan frontier (:func:`partition_model_front`) — feasible-first under
    the latency budget, then metric-optimal — instead of scalarizing inside
    the recurrence.
    """
    n = len(dag.blocks)
    if n == 0:
        raise ValueError("empty DAG")
    prov = resolve_provider(provider)
    obj = resolve_objective(objective)
    if not obj.is_latency:
        return partition_model_front(
            dag, resources, weight_transfer=weight_transfer, provider=prov,
            radio_power=obj.radio_power).select(obj)
    return _partition_model_fast(dag, resources,
                                 weight_transfer=weight_transfer, prov=prov,
                                 ws=workspace_for(prov))


# ----------------------------------------------------- fast-engine plumbing

def _cached_array(ws: PlannerWorkspace | None, key, build):
    """Fetch a setup array from the workspace (or build it uncached)."""
    if ws is None:
        return build()
    v = ws.arrays.get(key)
    if v is None:
        v = build()
        ws.arrays.put(key, v)
    return v


def _segment_matrix(prov: CostProvider, dag: ModelDAG,
                    r: Resource) -> np.ndarray:
    """``M[s, i] == segment_coster(dag, r)(s, i)`` — via the provider's
    vectorized method when it has one, else by evaluating the closure over
    the (cached-once) upper triangle."""
    fn = getattr(prov, "segment_cost_matrix", None)
    if fn is not None:
        return np.ascontiguousarray(fn(dag, r), dtype=np.float64)
    return _matrix_from_coster(prov.segment_coster(dag, r), len(dag.blocks))


def _energy_matrix(prov: CostProvider, dag: ModelDAG,
                   r: Resource) -> np.ndarray:
    fn = getattr(prov, "segment_energy_matrix", None)
    if fn is not None:
        return np.ascontiguousarray(fn(dag, r), dtype=np.float64)
    return _matrix_from_coster(prov.segment_energy_coster(dag, r),
                               len(dag.blocks))


def _matrix_from_coster(coster, n: int) -> np.ndarray:
    M = np.zeros((n + 1, n + 1), dtype=np.float64)
    for a in range(n + 1):
        row = M[a]
        for b in range(a + 1, n + 1):
            row[b] = coster(a, b)
    return M


def _xfer_bytes(dag: ModelDAG) -> list[float]:
    """Activation bytes entering a stage that starts at block ``s`` (the
    scalar DP's ``xfer``); index n is padding for the masked diagonal."""
    n = len(dag.blocks)
    return ([dag.input_bytes]
            + [dag.blocks[s].bytes_in for s in range(1, n)] + [0.0])


def _comm_vector(prov: CostProvider, dag: ModelDAG,
                 r: Resource) -> np.ndarray:
    """``v[s] == prov.comm_time(xfer(s), r)`` for every stage start s."""
    xfer = _xfer_bytes(dag)
    fn = getattr(prov, "comm_time_array", None)
    v = fn(np.asarray(xfer, dtype=np.float64), r) if fn is not None else None
    if v is None:
        v = np.asarray([prov.comm_time(x, r) for x in xfer],
                       dtype=np.float64)
    return v


def _comm_energy_vector(prov: CostProvider, dag: ModelDAG,
                        r: Resource) -> np.ndarray:
    xfer = _xfer_bytes(dag)
    fn = getattr(prov, "comm_energy_array", None)
    v = fn(np.asarray(xfer, dtype=np.float64), r) if fn is not None else None
    if v is None:
        v = np.asarray([prov.comm_energy(x, r) for x in xfer],
                       dtype=np.float64)
    return v


def _cum_params(dag: ModelDAG) -> np.ndarray:
    pre = [0.0]
    for b in dag.blocks:
        pre.append(pre[-1] + b.param_bytes)
    return np.asarray(pre, dtype=np.float64)


def _weight_matrix(prov: CostProvider, dag: ModelDAG,
                   r: Resource) -> np.ndarray:
    """``W[s, i] == prov.comm_time(seg_params(s, i), r, rtt=0.0)``."""
    cp = _cum_params(dag)
    seg = cp[None, :] - cp[:, None]
    fn = getattr(prov, "comm_time_array", None)
    W = fn(seg, r, 0.0) if fn is not None else None
    if W is None:
        n = len(dag.blocks)
        W = np.zeros((n + 1, n + 1), dtype=np.float64)
        for a in range(n + 1):
            for b in range(a + 1, n + 1):
                W[a, b] = prov.comm_time(float(seg[a, b]), r, rtt=0.0)
    return W


def _weight_energy_matrix(prov: CostProvider, dag: ModelDAG,
                          r: Resource) -> np.ndarray:
    cp = _cum_params(dag)
    seg = cp[None, :] - cp[:, None]
    fn = getattr(prov, "comm_energy_array", None)
    WE = fn(seg, r, 0.0) if fn is not None else None
    if WE is None:
        n = len(dag.blocks)
        WE = np.zeros((n + 1, n + 1), dtype=np.float64)
        for a in range(n + 1):
            for b in range(a + 1, n + 1):
                WE[a, b] = prov.comm_energy(float(seg[a, b]), r, rtt=0.0)
    return WE


def _partition_model_fast(dag: ModelDAG, resources: Sequence[Resource],
                          *, weight_transfer: bool, prov: CostProvider,
                          ws: PlannerWorkspace | None) -> ModelPartition:
    """The scalar DP as a per-resource matrix recurrence.

    Row j over all cells at once: ``M[s, i] = (best[j-1][s] + comm[s]) +
    C[s, i] (+ W[s, i])`` masked to s < i; ``dp[j] = M.min(axis=0)`` and
    ``parent[j] = M.argmin(axis=0)`` (numpy's first-minimum matches the
    reference's strict-less replacement, so ties pick the same s).  Each
    addition keeps the reference's left-to-right association, so every cell
    — and the backtracked plan — is bit-identical to the seed's scalar
    DP.

    Rows are cached in the workspace keyed by the ordered resource
    *prefix*: row j depends only on ``res[:j]``, so a membership epoch that
    removes the node at order position k recomputes only rows ≥ k, and a
    repeated call recomputes nothing (the whole result is memoized too).
    """
    n = len(dag.blocks)
    dfp = dag_fingerprint(dag)
    rkey = ("pm", dfp, tuple(resources), weight_transfer)
    if ws is not None:
        memo = ws.results.get(rkey)
        if memo is not None:
            return memo
    res, order = heterogeneity_order(ws, dag, resources, prov, dfp)
    m = len(res)
    INF = float("inf")
    mask = (ws.valid_mask(n) if ws is not None
            else np.triu(np.ones((n + 1, n + 1), dtype=bool), k=1))

    best_row = np.full(n + 1, np.inf)
    best_row[0] = 0.0
    bestj_row = np.zeros(n + 1, dtype=np.int64)
    rows: list[tuple] = []
    prefix: tuple = ()
    for j in range(1, m + 1):
        r = res[j - 1]
        prefix = prefix + (r,)
        key = ("srow", dfp, weight_transfer, prefix)
        rec = ws.scalar_rows.get(key) if ws is not None else None
        if rec is None:
            C = _cached_array(ws, ("C", dfp, r),
                              lambda: _segment_matrix(prov, dag, r))
            comm = _cached_array(ws, ("comm", dfp, r),
                                 lambda: _comm_vector(prov, dag, r))
            M = (best_row + comm)[:, None] + C
            if weight_transfer and j > 1:
                W = _cached_array(ws, ("W", dfp, r),
                                  lambda: _weight_matrix(prov, dag, r))
                M = M + W
            M = np.where(mask, M, np.inf)
            dp_row = M.min(axis=0)
            parent_row = M.argmin(axis=0)
            dp_row[0] = 0.0
            better = dp_row < best_row
            rec = (dp_row, np.where(better, dp_row, best_row),
                   np.where(better, j, bestj_row).astype(np.int64),
                   parent_row)
            if ws is not None:
                ws.scalar_rows.put(key, rec)
                ws.rows_computed += 1
        elif ws is not None:
            ws.rows_reused += 1
        rows.append(rec)
        best_row, bestj_row = rec[1], rec[2]

    end_j, end_cost = 0, INF
    for j in range(1, m + 1):
        v = rows[j - 1][0][n]
        if v < INF:
            c = float(v) + prov.comm_time(dag.output_bytes, res[j - 1])
            if c < end_cost:
                end_cost, end_j = c, j
    if end_cost == INF:
        raise RuntimeError("model-partition DP found no feasible plan")

    cuts: list[int] = [n]
    assign: list[int] = []
    j, i = end_j, n
    while i > 0:
        s = int(rows[j - 1][3][i])
        assign.append(order[j - 1])
        cuts.append(s)
        j, i = (int(rows[j - 2][2][s]) if j >= 2 else 0), s
    cuts.reverse()
    assign.reverse()
    plan = ModelPartition(boundaries=tuple(cuts), assignment=tuple(assign),
                          predicted_latency=end_cost)
    if ws is not None:
        ws.results.put(rkey, plan)
    return plan


def _model_front_search(dag: ModelDAG, resources: Sequence[Resource],
                        *, weight_transfer: bool, prov: CostProvider,
                        radio_power: float,
                        cap: int = DP_FRONT_CAP) -> list[ModelPartition]:
    """The (latency, energy)-pair DP, keeping a *frontier* per cell.

    Same state space and transitions as the scalar DP; each state carries
    the prefix's accumulated latency *and* energy, and every cell keeps a
    capped non-dominated set of states instead of one scalarized winner.
    Energy is stage-additive: while one pipeline stage runs, its resource
    draws active power and every *other* resource draws idle power, so
    stage energy = active J + (Σ idle − own idle) × stage seconds
    (identically the algebra of :func:`predicted_energy`, unrolled per
    stage), plus ``radio_power`` watts on wireless transfer seconds.

    States are linked records ``(lat, en, j, s, prev)`` — each points at
    its exact predecessor, so reconstruction replays the very chain whose
    cost was reported.  Latency accumulates with the same association as
    the scalar DP (``prev + comm + compute``), so the latency-minimal chain
    here is float-identical to the scalar DP's plan.  Returns the distinct
    partitions realising the final non-dominated states; callers re-price
    them uniformly and skyline-filter.
    """
    return _model_front_search_fast(
        dag, resources, weight_transfer=weight_transfer, prov=prov,
        radio_power=radio_power, cap=cap, ws=workspace_for(prov))


def _model_front_search_fast(
        dag: ModelDAG, resources: Sequence[Resource],
        *, weight_transfer: bool, prov: CostProvider, radio_power: float,
        cap: int, ws: PlannerWorkspace | None) -> list[ModelPartition]:
    """The frontier DP with pre-computed transition costs and cached rows.

    The capped per-cell insertion (``pareto_filter``) is *order-dependent*
    — latency-gap thinning at intermediate overflows depends on arrival
    order — so the cell update cannot be batch-vectorized without changing
    results.  Instead the fast path (1) pre-computes every per-(s, i)
    stage cost as numpy matrices converted once to Python-float lists
    (keeping the reference's exact association, e.g. stage energy is
    ``((comm_en + seg_en) + radio·comm) [+ (wt_en + radio·wt)] +
    idle_rest·((comm + seg) + wt)``), (2) screens whole predecessor groups
    with an exact corner test — the (min-lat, min-en) corner over a
    predecessor list lower-bounds every candidate it generates, and a cell
    point weakly dominating the corner rejects them all, exactly as the
    reference's per-candidate weak-dominance check would one by one — and
    (3) caches finished rows keyed by the ordered resource *prefix* (plus
    the flags and the cluster idle-power total the stage energies bake
    in), so repeated and incremental passes replay instead of re-search.

    States, insertion order, tie-breaks, and caps are identical to the
    reference, so the surviving skylines are bit-identical.
    """
    n, m = len(dag.blocks), len(resources)
    dfp = dag_fingerprint(dag)
    idle_total = sum(r.idle_power for r in resources)
    rkey = ("mfs", dfp, tuple(resources), weight_transfer, radio_power, cap)
    if ws is not None:
        memo = ws.results.get(rkey)
        if memo is not None:
            return memo
    res, order = heterogeneity_order(ws, dag, resources, prov, dfp)

    zero = (0.0, 0.0, 0, 0, None)
    best_prev: list[list] = [[zero]] + [[] for _ in range(n)]
    dp_rows: list[list[list]] = []
    prefix: tuple = ()
    for j in range(1, m + 1):
        r = res[j - 1]
        prefix = prefix + (r,)
        key = ("frow", dfp, weight_transfer, radio_power, cap, idle_total,
               prefix)
        rec = ws.front_rows.get(key) if ws is not None else None
        if rec is None:
            wt_active = weight_transfer and j > 1
            idle_rest = idle_total - r.idle_power
            if all(len(c) <= 1 for c in best_prev):
                rec = _front_row_singleton(
                    ws, dag, r, prov, dfp=dfp, j=j, n=n,
                    wt_active=wt_active, radio_power=radio_power,
                    idle_rest=idle_rest, best_prev=best_prev, cap=cap,
                    zero=zero)
            else:
                rec = _front_row_general(
                    ws, dag, r, prov, dfp=dfp, j=j, n=n,
                    wt_active=wt_active, radio_power=radio_power,
                    idle_rest=idle_rest, best_prev=best_prev, cap=cap,
                    zero=zero)
            if ws is not None:
                ws.front_rows.put(key, rec)
                ws.rows_computed += 1
        elif ws is not None:
            ws.rows_reused += 1
        dp_rows.append(rec[0])
        best_prev = rec[1]

    finals: list = []
    for j in range(1, m + 1):
        r = res[j - 1]
        t_out = prov.comm_time(dag.output_bytes, r)
        e_out = (prov.comm_energy(dag.output_bytes, r)
                 + radio_power * t_out
                 + (idle_total - r.idle_power) * t_out)
        for st in dp_rows[j - 1][n]:
            finals = pareto_filter(
                finals, (st[0] + t_out, st[1] + e_out, st), cap=4 * cap)
    if not finals:
        raise RuntimeError("model-partition DP found no feasible plan")

    plans: list[ModelPartition] = []
    for lat, _en, st in finals:
        cuts: list[int] = [n]
        assign: list[int] = []
        while st[4] is not None:                 # until the zero state
            assign.append(order[st[2] - 1])
            cuts.append(st[3])
            st = st[4]
        cuts.reverse()
        assign.reverse()
        plans.append(ModelPartition(boundaries=tuple(cuts),
                                    assignment=tuple(assign),
                                    predicted_latency=lat))
    if ws is not None:
        ws.results.put(rkey, plans)
    return plans


def _front_energy_array(ws: PlannerWorkspace | None, dag: ModelDAG,
                        r: Resource, prov: CostProvider, *, dfp: str,
                        radio_power: float, wt_active: bool,
                        idle_rest: float) -> np.ndarray:
    """Per-(s, i) stage energy for the frontier DP.

    Mirrors the reference's accumulation exactly:
    ``en = (comm_en + seg_en) + radio·comm``, then ``+ (wt_en + radio·wt)``
    under weight transfer, then ``+ idle_rest · ((comm + seg) + wt)``.
    The idle-independent part is cached per resource; the idle term
    depends on the cluster's total idle power, so it folds in per call
    (one fused numpy op) and the finished table is cached on the row key's
    ``idle_total`` via the front-row cache."""
    def build_pre():
        comm = _comm_vector(prov, dag, r)
        en = (_comm_energy_vector(prov, dag, r)[:, None]
              + _energy_matrix(prov, dag, r)) \
            + (radio_power * comm)[:, None]
        lat = comm[:, None] + _segment_matrix(prov, dag, r)
        if wt_active:
            W = _weight_matrix(prov, dag, r)
            en = en + (_weight_energy_matrix(prov, dag, r) + radio_power * W)
            lat = lat + W
        return en, lat
    en_pre, lat_tot = _cached_array(
        ws, ("ENpre", dfp, r, radio_power, wt_active), build_pre)
    return en_pre + idle_rest * lat_tot


def _front_row_singleton(ws: PlannerWorkspace | None, dag: ModelDAG,
                         r: Resource, prov: CostProvider, *, dfp: str,
                         j: int, n: int, wt_active: bool, radio_power: float,
                         idle_rest: float, best_prev: list, cap: int,
                         zero: tuple) -> tuple:
    """One frontier-DP row where every predecessor cell holds at most one
    state — the common shape (benchmark clusters never leave it), solved
    almost entirely in numpy.

    With singleton predecessors, cell (j, i) sees exactly one candidate per
    start s, so all candidate coordinates form two matrices computed with
    the reference's own per-element association (``(prev + comm) + seg
    [+ wt]`` for latency, ``prev + stage`` for energy — bit-identical
    float64 ops).  The sequential capped insertion then has a closed form
    for most columns.  While every arriving candidate stays *comparable*
    with the running occupant, the occupant after start s is exactly the
    pair of exclusive running minima ``(min lat, min en)`` over starts
    before s — a swap lowers both coordinates to the new joint minimum, a
    rejection lowers neither — so a column with no incomparable arrival
    (checked vectorized against those same exclusive cummins, which *are*
    the occupant up to the first violation) finishes as a single state:
    the joint coordinate-wise minimum, attributed to the earliest start
    achieving both.  Columns where a genuine latency–energy trade-off
    appears (rare) are replayed sequentially — the reference algorithm on
    the pre-tabulated candidate values — so caps, thinning, and tie
    preference behave identically in every regime."""
    p0 = np.array([c[0][0] if c else np.inf for c in best_prev])
    pE = np.array([c[0][1] if c else np.inf for c in best_prev])
    comm = _cached_array(ws, ("comm", dfp, r),
                         lambda: _comm_vector(prov, dag, r))
    LAT = (p0 + comm)[:, None] + _cached_array(
        ws, ("C", dfp, r), lambda: _segment_matrix(prov, dag, r))
    if wt_active:
        LAT = LAT + _cached_array(ws, ("W", dfp, r),
                                  lambda: _weight_matrix(prov, dag, r))
    EN = pE[:, None] + _front_energy_array(
        ws, dag, r, prov, dfp=dfp, radio_power=radio_power,
        wt_active=wt_active, idle_rest=idle_rest)
    mask = (ws.valid_mask(n) if ws is not None
            else np.triu(np.ones((n + 1, n + 1), dtype=bool), k=1))
    inf = np.inf
    LATm = np.where(mask, LAT, inf)
    ENm = np.where(mask, EN, inf)
    accL = np.minimum.accumulate(LATm, axis=0)
    accE = np.minimum.accumulate(ENm, axis=0)
    exL = np.empty_like(accL)
    exL[0] = inf
    exL[1:] = accL[:-1]
    exE = np.empty_like(accE)
    exE[0] = inf
    exE[1:] = accE[:-1]
    event = (((LATm < exL) & (ENm > exE))
             | ((LATm > exL) & (ENm < exE))).any(axis=0)
    minL = np.empty(n + 1)
    minL[0] = inf
    minL[1:] = np.diagonal(accL, offset=1)
    minE = np.empty(n + 1)
    minE[0] = inf
    minE[1:] = np.diagonal(accE, offset=1)
    src = (((LATm == minL) & (ENm == minE)).argmax(axis=0))
    eventl = event.tolist()
    minLl = minL.tolist()
    minEl = minE.tolist()
    srcl = src.tolist()
    prev0s = [c[0] if c else None for c in best_prev]
    valid = [s for s in range(n + 1) if best_prev[s]]
    tail = valid[1:]                       # s = 0 is always valid and first
    dp_cells: list[list] = [[zero]] + [None] * n
    best_cells: list[list] = [[zero]] + [None] * n
    pf = pareto_filter
    for i in range(1, n + 1):
        if not eventl[i]:
            s0 = srcl[i]
            cell = [(minLl[i], minEl[i], j, s0, prev0s[s0])]
        else:
            # a latency–energy trade-off appeared: replay this column's
            # sequential insertion exactly (O(1) while the cell is a
            # single state, pareto_filter once it widens)
            li = LAT[:i, i].tolist()
            ei = EN[:i, i].tolist()
            ol = li[0]
            oe = ei[0]
            osrc = 0
            cell = None
            for s in tail:
                if s >= i:
                    break
                lat = li[s]
                if cell is None:
                    en = ei[s]
                    if ol <= lat and oe <= en:
                        continue                   # dominated by occupant
                    if lat <= ol and en <= oe:
                        ol, oe, osrc = lat, en, s  # occupant replaced
                        continue
                    ost = (ol, oe, j, osrc, prev0s[osrc])
                    nst = (lat, en, j, s, prev0s[s])
                    cell = [ost, nst] if ol < lat else [nst, ost]
                else:
                    cell = pf(cell, (lat, ei[s], j, s, prev0s[s]), cap)
            if cell is None:
                cell = [(ol, oe, j, osrc, prev0s[osrc])]
        dp_cells[i] = cell
        bp = best_prev[i]
        if not bp:
            best_cells[i] = list(cell)
        elif len(bp) == 1 and len(cell) == 1:
            q, c = bp[0], cell[0]
            if q[0] <= c[0] and q[1] <= c[1]:
                best_cells[i] = list(bp)
            elif c[0] <= q[0] and c[1] <= q[1]:
                best_cells[i] = [c]
            else:
                best_cells[i] = [q, c] if q[0] < c[0] else [c, q]
        else:
            merged = list(bp)
            for st in cell:
                merged = pf(merged, st, cap)
            best_cells[i] = merged
    return dp_cells, best_cells


def _front_row_general(ws: PlannerWorkspace | None, dag: ModelDAG,
                       r: Resource, prov: CostProvider, *, dfp: str,
                       j: int, n: int, wt_active: bool, radio_power: float,
                       idle_rest: float, best_prev: list, cap: int,
                       zero: tuple) -> tuple:
    """One frontier-DP row with multi-state predecessor cells — the exact
    sequential insertion over pre-tabulated stage costs, plus the corner
    screen (evaluated at arrival time, so unaffected by later thinning)."""
    # stage-cost tables as Python floats (bit-exact float64 → float)
    CL = _cached_array(
        ws, ("commL", dfp, r),
        lambda: _comm_vector(prov, dag, r).tolist())
    C2 = _cached_array(
        ws, ("CL", dfp, r),
        lambda: _segment_matrix(prov, dag, r).tolist())
    WL = (_cached_array(
        ws, ("WL", dfp, r),
        lambda: _weight_matrix(prov, dag, r).tolist())
        if wt_active else None)
    EN = _front_energy_array(ws, dag, r, prov, dfp=dfp,
                             radio_power=radio_power,
                             wt_active=wt_active,
                             idle_rest=idle_rest).tolist()
    dp_cells: list[list] = [[zero]] + [[] for _ in range(n)]
    best_cells: list[list] = [[zero]] + [[] for _ in range(n)]
    for i in range(1, n + 1):
        cell: list = []
        for s in range(i):
            prevs = best_prev[s]
            if not prevs:
                continue
            cl = CL[s]
            cs = C2[s][i]
            wtv = WL[s][i] if wt_active else 0.0
            es = EN[s][i]
            if cell:
                # exact group screen: the corner lower-bounds every
                # candidate from prevs; a cell point weakly dominating it
                # rejects them all (what the reference's insert would do
                # candidate by candidate)
                lo_lat = prevs[0][0] + cl + cs
                if wtv:
                    lo_lat += wtv
                lo_en = prevs[-1][1] + es
                skip = False
                for q in cell:
                    if q[0] <= lo_lat and q[1] <= lo_en:
                        skip = True
                        break
                if skip:
                    continue
            for prev in prevs:
                lat = prev[0] + cl + cs
                if wtv:
                    lat += wtv
                cell = pareto_filter(
                    cell, (lat, prev[1] + es, j, s, prev), cap)
        dp_cells[i] = cell
        if cell:
            merged = list(best_prev[i])
            for st in cell:
                merged = pareto_filter(merged, st, cap)
            best_cells[i] = merged
        else:
            best_cells[i] = best_prev[i]
    return dp_cells, best_cells


def partition_model_front(dag: ModelDAG, resources: Sequence[Resource],
                          *, weight_transfer: bool = False,
                          provider: CostProvider | None = None,
                          radio_power: float = 0.0,
                          width: int | None = None) -> ParetoFront:
    """The latency–energy frontier of heterogeneous pipeline partitions.

    Candidates are the frontier DP's final non-dominated chains *plus* the
    seed scalar DP's latency optimum, spliced in first so the front's
    ``latency_optimal`` point is bit-identical to :func:`partition_model`
    under the default objective.  Every candidate is re-priced uniformly by
    :func:`predicted_energy` (with ``radio_power`` on transfer seconds) and
    skyline-filtered."""
    prov = resolve_provider(provider)
    ws = workspace_for(prov)
    if ws is not None:
        rkey = ("pmf", dag_fingerprint(dag), tuple(resources),
                weight_transfer, radio_power, width)
        memo = ws.results.get(rkey)
        if memo is not None:
            return memo
    seed = partition_model(dag, resources, weight_transfer=weight_transfer,
                           provider=prov)
    cands = [p for p in _model_front_search(
        dag, resources, weight_transfer=weight_transfer, prov=prov,
        radio_power=radio_power)
        if (p.boundaries, p.assignment) != (seed.boundaries, seed.assignment)]

    def price(p):
        return (p.predicted_latency,
                predicted_energy(dag, resources, p, prov,
                                 radio_power=radio_power), p)

    front = ParetoFront.build([price(p) for p in cands], anchor=price(seed),
                              width=width)
    if ws is not None:
        ws.results.put(rkey, front)
    return front


# --------------------------------------------------------------------------
# Data partitioning (σ parallel sub-models)
# --------------------------------------------------------------------------

def _balanced_fractions(dag: ModelDAG, subset: Sequence[Resource],
                        provider: CostProvider | None = None
                        ) -> tuple[tuple[float, ...], float]:
    """Water-fill data fractions so every resource finishes simultaneously.

    Per-resource time for fraction f:  t_i = f·(F/r_i + B_io/bw_i) + rtt_i
    Setting t_i = t for all i and Σf = 1 gives a closed form.
    """
    prov = resolve_provider(provider)
    # bytes shipped per unit fraction: the input split + merged output + the
    # halo exchange along the deepest halo block.
    halo = max((b.bytes_out * b.halo_fraction for b in dag.blocks), default=0.0)
    bio = dag.input_bytes + dag.output_bytes + 2.0 * halo
    coeffs = [prov.data_coeffs(dag, r) for r in subset]
    k = [lin + prov.comm_time(bio, r, rtt=0.0)
         for (lin, _), r in zip(coeffs, subset)]           # seconds per unit f
    c = [r.rtt + fixed for (_, fixed), r in zip(coeffs, subset)]
    # t = (1 + Σ c_i/k_i) / Σ (1/k_i); f_i = (t - c_i)/k_i
    inv = sum(1.0 / ki for ki in k)
    t = (1.0 + sum(ci / ki for ci, ki in zip(c, k))) / inv
    fr = [(t - ci) / ki for ci, ki in zip(c, k)]
    if any(f <= 0 for f in fr):           # a resource too slow to help
        return tuple(), float("inf")
    s = sum(fr)
    return tuple(f / s for f in fr), t


def partition_data(dag: ModelDAG, resources: Sequence[Resource],
                   *, provider: CostProvider | None = None,
                   objective: Objective | None = None) -> DataPartition:
    """Explore σ = 1..m sub-models over heterogeneity-ordered resources and
    keep the best balanced split (Eq. 6).  Blocks that are not
    data-splittable force σ = 1 (feasibility mask — e.g. recurrent decode
    state, see DESIGN.md §4).

    Each σ's split is water-filled so every participant finishes together
    (the latency-optimal division for that subset); the *objective* then
    selects between subsets over their frontier — under ``energy``/``edp``
    a smaller σ that keeps slow helpers idle (saving their active power and
    the shared medium's radio energy) can beat the latency-optimal wide
    split."""
    prov = resolve_provider(provider)
    obj = resolve_objective(objective)
    if not obj.is_latency:
        return partition_data_front(
            dag, resources, provider=prov,
            radio_power=obj.radio_power).select(obj)
    best: DataPartition | None = None
    for cand in _data_candidates(dag, resources, prov):
        if best is None or cand.predicted_latency < best.predicted_latency:
            best = cand
    if best is None:
        raise RuntimeError("data-partition search found no feasible plan")
    return best


def _data_candidates(dag: ModelDAG, resources: Sequence[Resource],
                     prov: CostProvider) -> list[DataPartition]:
    """One balanced candidate per σ = 1..m over heterogeneity-ordered
    resources (the seed enumeration, every subset kept)."""
    ws = workspace_for(prov)
    if ws is not None:
        rkey = ("dc", dag_fingerprint(dag), tuple(resources))
        memo = ws.results.get(rkey)
        if memo is not None:
            return memo
        _, order = heterogeneity_order(ws, dag, resources, prov)
    else:
        _, order = _heterogeneity_order(dag, resources, prov)
    if not all(b.data_splittable for b in dag.blocks):
        order = order[:1]
    out: list[DataPartition] = []
    for sigma in range(1, len(order) + 1):
        subset_idx = order[:sigma]
        subset = [resources[i] for i in subset_idx]
        fr, t = _balanced_fractions(dag, subset, prov)
        if not fr:
            continue
        out.append(DataPartition(fractions=fr, assignment=tuple(subset_idx),
                                 predicted_latency=t))
    if ws is not None:
        ws.results.put(rkey, out)
    return out


def partition_data_front(dag: ModelDAG, resources: Sequence[Resource],
                         *, provider: CostProvider | None = None,
                         radio_power: float = 0.0,
                         width: int | None = None) -> ParetoFront:
    """The latency–energy frontier over the σ = 1..m balanced splits.
    σ = 1 on the fastest resource is always feasible, so the front is never
    empty; the seed's latency winner is its ``latency_optimal`` point."""
    prov = resolve_provider(provider)
    ws = workspace_for(prov)
    if ws is not None:
        rkey = ("pdf", dag_fingerprint(dag), tuple(resources), radio_power,
                width)
        memo = ws.results.get(rkey)
        if memo is not None:
            return memo
    cands = _data_candidates(dag, resources, prov)
    if not cands:
        raise RuntimeError("data-partition search found no feasible plan")
    # the seed latency winner (first σ on ties, as in partition_data)
    # anchors the latency endpoint
    seed = min(cands, key=lambda p: p.predicted_latency)
    points = [(p.predicted_latency,
               predicted_energy(dag, resources, p, prov,
                                radio_power=radio_power), p)
              for p in cands if p is not seed]
    anchor = (seed.predicted_latency,
              predicted_energy(dag, resources, seed, prov,
                               radio_power=radio_power), seed)
    front = ParetoFront.build(points, anchor=anchor, width=width)
    if ws is not None:
        ws.results.put(rkey, front)
    return front


# --------------------------------------------------------------------------
# Mode selection — Algorithm 1 lines 4-6 / 8-10
# --------------------------------------------------------------------------

def partition(dag: ModelDAG, resources: Sequence[Resource],
              *, weight_transfer: bool = False,
              provider: CostProvider | None = None,
              objective: Objective | None = None) -> Partition:
    """Θ ← best(Θ_ω, Θ_σ): run both searches, return the better plan.

    With the default latency objective this is the paper's
    ``Θ = min(Θ_ω, Θ_σ)`` verbatim (model wins ties, as in the seed); any
    other objective *selects* over the merged frontier
    (:func:`partition_front`) — feasible-first under the latency budget,
    then metric-optimal."""
    obj = resolve_objective(objective)
    if not obj.is_latency:
        return partition_front(dag, resources,
                               weight_transfer=weight_transfer,
                               provider=provider,
                               radio_power=obj.radio_power).select(obj)
    theta_w = partition_model(dag, resources, weight_transfer=weight_transfer,
                              provider=provider)
    theta_s = partition_data(dag, resources, provider=provider)
    if theta_w.predicted_latency <= theta_s.predicted_latency:
        return theta_w
    return theta_s


def partition_front(dag: ModelDAG, resources: Sequence[Resource],
                    *, weight_transfer: bool = False,
                    provider: CostProvider | None = None,
                    radio_power: float = 0.0,
                    width: int | None = None) -> ParetoFront:
    """The merged latency–energy frontier over *both* partitioning modes.

    Model-mode points are inserted first, so an exact (latency, energy) tie
    keeps the model plan — the seed's ``Θ = min(Θ_ω, Θ_σ)`` tie rule.  The
    front's ``latency_optimal`` plan is therefore exactly what
    :func:`partition` returns under the default objective."""
    prov = resolve_provider(provider)
    ws = workspace_for(prov)
    if ws is not None:
        rkey = ("pf", dag_fingerprint(dag), tuple(resources),
                weight_transfer, radio_power, width)
        memo = ws.results.get(rkey)
        if memo is not None:
            return memo
    mf = partition_model_front(dag, resources,
                               weight_transfer=weight_transfer,
                               provider=prov, radio_power=radio_power)
    df = partition_data_front(dag, resources, provider=prov,
                              radio_power=radio_power)
    # Θ = min(Θ_ω, Θ_σ), model on ties — the seed's mode pick is the anchor
    anchor = (mf.latency_optimal
              if mf.latency_optimal.latency <= df.latency_optimal.latency
              else df.latency_optimal)
    front = ParetoFront.build(list(mf) + list(df), anchor=anchor, width=width)
    if ws is not None:
        ws.results.put(rkey, front)
    return front


# --------------------------------------------------------------------------
# Energy prediction for a plan (used by the planners, simulator, benchmarks)
# --------------------------------------------------------------------------

def predicted_energy(dag: ModelDAG, resources: Sequence[Resource],
                     plan: Partition,
                     provider: CostProvider | None = None,
                     *, radio_power: float = 0.0) -> float:
    """∫P dt for one plan: active power while a resource computes or
    communicates, idle power for the rest of the plan's makespan.

    The active joules come from the provider's energy queries, so a
    calibrated provider prices them from *fitted* energy predictors while
    the analytic provider reproduces the seed's ``active_power × busy``
    algebra.  ``radio_power`` adds watts on total transfer seconds (the
    shared-medium transmit energy the simulator meters); it defaults to 0 so
    existing callers see the seed numerics unchanged."""
    prov = resolve_provider(provider)
    T = plan.predicted_latency
    busy: dict[int, float] = {}
    active: dict[int, float] = {}
    comm_s = 0.0
    if isinstance(plan, ModelPartition):
        for si in range(plan.num_stages):
            a, b = plan.boundaries[si], plan.boundaries[si + 1]
            ri = plan.assignment[si]
            r = resources[ri]
            seg = dag.segment(a, b)
            cm = prov.comm_time(seg.bytes_in, r)
            busy[ri] = busy.get(ri, 0.0) + (
                prov.compute_time(seg.flops, r, seg.kind) + cm)
            active[ri] = active.get(ri, 0.0) + (
                prov.compute_energy(seg.flops, r, seg.kind)
                + prov.comm_energy(seg.bytes_in, r))
            comm_s += cm
    else:
        kind = dag.dominant_kind()
        for f, ri in zip(plan.fractions, plan.assignment):
            r = resources[ri]
            nbytes = (dag.input_bytes + dag.output_bytes) * f
            cm = prov.comm_time(nbytes, r)
            busy[ri] = busy.get(ri, 0.0) + (
                prov.compute_time(dag.total_flops * f, r, kind) + cm)
            active[ri] = active.get(ri, 0.0) + (
                prov.compute_energy(dag.total_flops * f, r, kind)
                + prov.comm_energy(nbytes, r))
            comm_s += cm
    e = 0.0
    for i, r in enumerate(resources):
        b = busy.get(i, 0.0)
        ae = active.get(i, 0.0)
        if b > T and b > 0.0:
            ae *= T / b                   # clip active draw to the makespan
            b = T
        e += ae + r.idle_power * max(T - b, 0.0)
    return e + radio_power * comm_s
