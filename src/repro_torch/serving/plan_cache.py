"""The port's copy of ``repro.serving.plan_cache``.

PlanCache — one persistent, evicting plan-frontier cache per cluster.

HiDP's premise is a *shared* heterogeneous edge cluster serving many
concurrent DNN workloads (the paper's Fig. 7 request mixes; CoEdge,
arXiv:2012.03257, frames the same multi-workload scenario).  The paper pays
its ~15 ms two-tier DP on every request; this cache amortizes it across
requests *and tenants*: one (objective-independent) frontier pass per
``(cluster fingerprint, membership fingerprint, calibration version,
dag fingerprint, δ)``, then any request's objective — from any tenant — is
resolved against the cached :class:`~repro_torch.core.pareto.ParetoFront` with
zero DP work: a dict lookup plus an O(front-width) ``select``.

Keys and invalidation:

* the **cluster fingerprint** comes from the shared
  :func:`repro_torch.core.fingerprint.cluster_fingerprint` — the same hash that
  files calibrations in ``CalibrationStore``, so plan-cache keys and
  calibration paths can never drift apart.  A board swap or link upgrade
  changes the fingerprint and cleanly orphans every cached front.
* the **membership fingerprint**
  (:func:`repro_torch.core.fingerprint.membership_fingerprint`) identifies *who
  is in the fleet right now* — the availability mask the planner restricts
  itself to.  Wire ``membership_source=`` (anything with a live
  ``.cluster`` attribute: a ``repro.core.ClusterManager`` or a
  ``repro.fleet.FleetController``) and every lookup keys on — and plans
  against — the current membership.  A node leaving is **not** an
  invalidation: fronts for distinct memberships live side by side in the
  same table (and in the same persisted ``fronts.json``), so a node that
  leaves and later *returns* flips the mask back to a seen value and the
  original warm front serves again with zero DP work, bit-identically.
  Without a ``membership_source`` the cache keys on the construction-time
  mask — the static-fleet behaviour, unchanged.
* the **dag fingerprint** (:func:`repro_torch.core.fingerprint.dag_fingerprint`)
  identifies the tenant by its full cost surface, not its name — two
  workloads that share a model name but differ in shape can never collide,
  and editing a model's blocks orphans its fronts like a board swap
  orphans calibrations.
* the **calibration version** either lives in the cache
  (:meth:`bump_version`) or is read live from a ``version_source`` — any
  object with a ``calibration_version`` attribute, e.g. a
  ``repro_torch.profiling.FeedbackLoop``, whose drift events increment it.
  Either way a bump is **atomic**: the version and the entry table swap in
  a single reference assignment, so a concurrent reader sees either the
  old generation (stale front, still internally consistent) or the new
  empty one — never a half-invalidated mix.
* after a bump, the next lookup *per tenant* misses exactly once and pays
  one EXPLORE re-plan (the frontier pass); every other objective variation
  for that tenant is a hit again.

Eviction (multi-tenant caches are bounded):

* ``eviction=LRUEviction(max_entries=..., max_bytes=...)`` caps the table;
  the least-recently-used tenant entry is dropped first when either budget
  overflows.  The entry the current request just touched (the in-flight
  tenant) is never evicted, even if it alone exceeds the byte budget — a
  request can always be served from the front it just built.
* an evicted tenant is not an error: its next request re-plans (a miss)
  and re-enters the table.  ``evictions`` counts drops.

Persistence (warm restarts):

* :meth:`persist` writes the current generation's fronts next to the
  calibrations in a ``repro_torch.profiling.CalibrationStore`` (JSON round-trip
  via ``repro_torch.core.plan_to_dict``); :meth:`warm_from` — or passing
  ``store=`` at construction — loads them back, **dropping any entry
  whose calibration version does not match the live one or whose
  on-disk calibration anchor moved** (a re-profiling between persist and
  restart invalidates even when in-memory counters collide), so a stale
  front can never serve.  A restarted process then serves every tenant's
  first request with zero DP work, and selections off loaded fronts are
  bit-identical to the freshly built ones (floats survive JSON exactly).
* ``persist_every=N`` auto-persists after every N-th insert (frontier
  pass), so a crashed process loses at most one generation of N-1 new
  fronts; the underlying ``save_fronts`` write is atomic and guarded by a
  best-effort advisory file lock, so two serving processes sharing one
  store never interleave a write.

``get`` stamps the returned plan's ``planning_seconds`` with what the
caller actually waited — the full frontier pass on a miss, the lookup
microseconds on a hit — so simulators and benchmarks measure the warm path
honestly.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import OrderedDict

from repro_torch.core.cost_model import Cluster
from repro_torch.core.dag import ModelDAG
from repro_torch.core.fingerprint import (cluster_fingerprint, dag_fingerprint,
                                    membership_fingerprint)
from repro_torch.core.hidp import (HiDPPlan, HiDPPlanner, plan_from_dict,
                             plan_to_dict)
from repro_torch.core.objective import Objective
from repro_torch.core.pareto import ParetoFront


@dataclasses.dataclass
class CacheEntry:
    """One tenant's cached frontier, plus what persistence needs to file it
    (``nbytes`` is the JSON-serialized size — the byte-budget currency,
    computed lazily so misses pay for serialization only when a byte
    budget, a persist, or a stats call actually needs it)."""

    dag_name: str
    dag_fingerprint: str
    delta: float
    front: ParetoFront
    membership_fingerprint: str = ""
    # the live DAG object (when the front was planned in-process) — what
    # prewarming re-plans against other memberships; None for fronts loaded
    # from a store (they cannot be speculated over, only served)
    dag: ModelDAG | None = None
    # built by the pre-warmer, not yet demanded; promoted (and counted as a
    # prewarm hit) the first time a request lands on it
    speculative: bool = False
    _nbytes: int | None = None

    @property
    def nbytes(self) -> int:
        if self._nbytes is None:
            self._nbytes = len(json.dumps(self.front.to_dict(plan_to_dict)))
        return self._nbytes


class LRUEviction:
    """Bounded LRU over tenant entries.

    Attributes:
        max_entries: entry-count budget (None = unbounded).
        max_bytes: serialized-front byte budget (None = unbounded).

    ``victims`` returns the least-recently-used keys to drop so the table
    fits both budgets, never including ``protect`` — the in-flight tenant's
    entry survives even when it alone exceeds ``max_bytes``.
    """

    def __init__(self, max_entries: int | None = None,
                 max_bytes: int | None = None):
        if max_entries is not None and max_entries < 1:
            raise ValueError("max_entries must be >= 1 (the in-flight "
                             "tenant's entry is never evicted)")
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        self.max_entries = max_entries
        self.max_bytes = max_bytes

    def victims(self, entries: "OrderedDict[tuple, CacheEntry]",
                protect: tuple | None = None) -> list[tuple]:
        drop: list[tuple] = []
        n = len(entries)
        # entry sizes are only materialized when a byte budget exists
        nbytes = (sum(e.nbytes for e in entries.values())
                  if self.max_bytes is not None else 0)
        for key, entry in entries.items():          # LRU first
            over = ((self.max_entries is not None and n > self.max_entries)
                    or (self.max_bytes is not None and nbytes > self.max_bytes))
            if not over:
                break
            if key == protect:
                continue
            drop.append(key)
            n -= 1
            if self.max_bytes is not None:
                nbytes -= entry.nbytes
        return drop

    def __repr__(self) -> str:
        return (f"LRUEviction(max_entries={self.max_entries}, "
                f"max_bytes={self.max_bytes})")


class PlanCache:
    """Cached plan frontiers for one cluster, served to many tenants.

    Attributes:
        planner: the :class:`~repro_torch.core.hidp.HiDPPlanner` that computes
            frontiers on a miss (its config fixes provider, radio pricing,
            and the default δ).
        fingerprint: the cluster's topology hash (shared with
            ``CalibrationStore``).
        eviction: the bounded-budget policy (:class:`LRUEviction`), or
            None for an unbounded table.
        persist_every: auto-persist period in inserts (None = only on
            demand); requires ``store=``.
        hits / misses / evictions / invalidations / loaded: lifetime
            counters; ``misses`` counts EXPLORE re-plans (full frontier
            passes), ``loaded`` counts fronts served warm from a store.
        telemetry: optional recorder (the JAX package's
            ``repro.telemetry.TelemetryRecorder`` fits) — every
            hit/miss/eviction/invalidation/persist becomes a per-tenant
            counter and each DP frontier pass a wall-timed
            ``plan.frontier_pass`` span (docs/observability.md).
    """

    def __init__(self, planner: HiDPPlanner, cluster: Cluster, *,
                 version: int = 0, version_source=None,
                 eviction: LRUEviction | None = None, store=None,
                 membership_source=None, persist_every: int | None = None,
                 telemetry=None):
        self.planner = planner
        self.cluster = cluster
        self.fingerprint = cluster_fingerprint(cluster)
        self.eviction = eviction
        from repro_torch.telemetry import active as _tel_active
        self.telemetry = _tel_active(telemetry)
        self._store = store
        self._version_source = version_source
        self.membership_source = membership_source
        if persist_every is not None:
            if persist_every < 1:
                raise ValueError("persist_every must be >= 1")
            if store is None:
                raise ValueError("persist_every needs a store to persist "
                                 "to: wire store= at construction")
        self.persist_every = persist_every
        self._inserts_since_persist = 0
        if version_source is not None:
            version = version_source.calibration_version
        # one atomically-swapped generation: (version, {key: CacheEntry}),
        # the table ordered least- to most-recently used
        self._generation: tuple[int, "OrderedDict[tuple, CacheEntry]"] = \
            (int(version), OrderedDict())
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.loaded = 0
        self.prewarmed = 0
        self.prewarm_hits = 0
        self.prewarm_misses = 0
        self._prewarm_active = False
        if store is not None:
            self.warm_from(store)

    # -------------------------------------------------------------- keying
    @property
    def version(self) -> int:
        """The calibration version cached fronts are valid for — read live
        from ``version_source`` when one is wired, so a FeedbackLoop drift
        event invalidates without calling into the cache at all."""
        if self._version_source is not None:
            return int(self._version_source.calibration_version)
        return self._generation[0]

    def live_cluster(self) -> Cluster:
        """The cluster lookups plan against: the ``membership_source``'s
        current view when one is wired (live availability over the same
        declared topology), the construction-time cluster otherwise."""
        if self.membership_source is not None:
            return self.membership_source.cluster
        return self.cluster

    @property
    def membership_fingerprint(self) -> str:
        """The availability-mask hash of :meth:`live_cluster` — read live,
        so a ``FleetController`` membership epoch re-keys lookups without
        calling into the cache at all (a returning membership lands back
        on its original entries)."""
        return membership_fingerprint(self.live_cluster())

    def key(self, dag: ModelDAG, delta: float | None = None) -> tuple:
        """``(cluster fp, membership fp, calibration version,
        dag fingerprint, δ)``."""
        if delta is None:
            delta = self.planner.config.delta
        return (self.fingerprint, self.membership_fingerprint, self.version,
                dag_fingerprint(dag), delta)

    # ------------------------------------------------------------- lookups
    def _table(self, version: int) -> "OrderedDict[tuple, CacheEntry]":
        """The current generation's table, swapping in a fresh one
        atomically when ``version_source`` moved on."""
        gen_version, entries = self._generation
        if gen_version != version:
            entries = OrderedDict()
            self._generation = (version, entries)
            self.invalidations += 1
            if self.telemetry is not None:
                self.telemetry.counter("plan_cache.invalidation",
                                       version=version)
        return entries

    def front(self, dag: ModelDAG, delta: float | None = None) -> ParetoFront:
        """The cached frontier for ``dag`` — one DP pass per tenant per
        (membership, generation).  A hit refreshes the tenant's LRU
        position; a miss plans against the *live* membership, inserts, and
        then lets the eviction policy trim *other* tenants back under
        budget.  With ``persist_every`` wired, every N-th insert flushes
        the warm table to the store."""
        key = self.key(dag, delta)
        entries = self._table(key[2])
        entry = entries.get(key)
        tel = self.telemetry
        if entry is not None:
            self.hits += 1
            entries.move_to_end(key)
            if entry.speculative:
                # speculation paid off: the membership the pre-warmer bet
                # on arrived, and this epoch is served with zero DP work
                entry.speculative = False
                self.prewarm_hits += 1
                if tel is not None:
                    tel.counter("plan_cache.prewarm_hit", tenant=dag.name,
                                dag_fp=key[3][:12], membership=key[1][:12])
            if entry.dag is None:
                entry.dag = dag       # a loaded front becomes speculatable
            if tel is not None:
                tel.counter("plan_cache.hit", tenant=dag.name,
                            dag_fp=key[3][:12])
            return entry.front
        self.misses += 1
        if delta is None:
            delta = self.planner.config.delta
        if tel is not None:
            tel.counter("plan_cache.miss", tenant=dag.name,
                        dag_fp=key[3][:12])
        if self._prewarm_active:
            # a demand frontier pass the speculation schedule did not cover
            # (first-seen tenant, or a multi-node membership jump)
            self.prewarm_misses += 1
            if tel is not None:
                tel.counter("plan_cache.prewarm_miss", tenant=dag.name,
                            dag_fp=key[3][:12], membership=key[1][:12])
        t0 = time.perf_counter()
        front = self.planner.at_delta(delta).front(dag, self.live_cluster())
        if tel is not None:
            # the DP frontier pass — the EXPLORE cost the cache amortizes;
            # its duration is wall-measured, so it rides the wall_s field
            tel.span("plan.frontier_pass", 0.0, tenant=dag.name,
                     wall_s=time.perf_counter() - t0, dag_fp=key[3][:12],
                     membership=key[1][:12], version=key[2])
        entries[key] = CacheEntry(dag_name=dag.name,
                                  dag_fingerprint=key[3], delta=delta,
                                  front=front,
                                  membership_fingerprint=key[1], dag=dag)
        self._evict(entries, protect=key)
        self._inserts_since_persist += 1
        if (self.persist_every is not None
                and self._inserts_since_persist >= self.persist_every):
            self.persist()
        return front

    def get(self, dag: ModelDAG, objective: Objective | str | None = None,
            delta: float | None = None) -> HiDPPlan:
        """Resolve one request: select ``objective`` over the tenant's
        cached front.  Zero DP work on a hit.  ``objective`` may be an
        :class:`~repro_torch.core.objective.Objective` or a metric name
        (``"latency"`` | ``"energy"`` | ``"edp"``)."""
        if isinstance(objective, str):
            objective = Objective(objective)
        t0 = time.perf_counter()
        misses = self.misses
        front = self.front(dag, delta)
        plan = front.select(objective)
        if misses != self.misses:
            return plan          # cold: keep the frontier pass's own timing
        return dataclasses.replace(
            plan, planning_seconds=time.perf_counter() - t0)

    # ---------------------------------------------------------- prewarming
    def prewarm(self, memberships=None, dags=None,
                delta: float | None = None) -> int:
        """Speculatively build fronts for the memberships likely to arrive
        next, so the epoch that realizes one is served with **zero**
        frontier passes.

        ``memberships`` is an iterable of availability masks (tuples of
        bool over the declared node list); by default the current live
        mask plus every single-departure neighbour
        (:func:`repro_torch.core.dp_cache.single_departure_masks`) — the
        churn-trace-observed common case of one node dropping out.
        ``dags`` defaults to every tenant this cache has planned
        in-process (each at the δ it was planned at); pass DAGs explicitly
        to pre-warm tenants before their first request.

        Fronts that already exist (any earlier demand or speculative pass)
        are skipped, so re-running after every epoch costs only the truly
        new memberships.  Speculative entries are inserted **LRU-cold**:
        under an eviction budget they are the first victims, and a
        pre-warm sweep can never push a demanded tenant's front out of the
        table.  The fast DP engine's row caches make each speculative pass
        cheap — an N-1 membership shares every per-resource row with the
        full-membership pass that preceded it.

        Each front built emits a ``plan.prewarm`` telemetry span;
        ``prewarmed`` / ``prewarm_hits`` / ``prewarm_misses`` count the
        speculation economy in :meth:`stats`.  Returns the number of
        fronts built by this call."""
        self._prewarm_active = True
        base = self.live_cluster()
        if memberships is None:
            from repro_torch.core.dp_cache import single_departure_masks
            live = tuple(bool(n.available) for n in base.nodes)
            memberships = [live] + single_departure_masks(base)
        version = self.version
        entries = self._table(version)
        if dags is None:
            targets_by_key: dict = {}
            for e in list(entries.values()):
                if e.dag is not None:
                    targets_by_key.setdefault((e.dag_fingerprint, e.delta),
                                              (e.dag, e.delta))
            targets = list(targets_by_key.values())
        else:
            d = self.planner.config.delta if delta is None else delta
            targets = [(dag, d) for dag in dags]
        tel = self.telemetry
        built = 0
        for mask in memberships:
            masked = base.with_availability(list(mask))
            if not any(mask):
                continue                       # never plan an empty fleet
            mfp = membership_fingerprint(masked)
            for dag, dg_delta in targets:
                key = (self.fingerprint, mfp, version,
                       dag_fingerprint(dag), dg_delta)
                if key in entries:
                    continue                   # already warm — free skip
                t0 = time.perf_counter()
                front = self.planner.at_delta(dg_delta).front(dag, masked)
                if tel is not None:
                    tel.span("plan.prewarm", 0.0, tenant=dag.name,
                             wall_s=time.perf_counter() - t0,
                             dag_fp=key[3][:12], membership=mfp[:12],
                             version=version)
                entries[key] = CacheEntry(
                    dag_name=dag.name, dag_fingerprint=key[3],
                    delta=dg_delta, front=front,
                    membership_fingerprint=mfp, dag=dag, speculative=True)
                entries.move_to_end(key, last=False)     # LRU-cold
                built += 1
                self.prewarmed += 1
        self._evict(entries)
        return built

    # ------------------------------------------------------------ eviction
    def _evict(self, entries: "OrderedDict[tuple, CacheEntry]",
               protect: tuple | None = None) -> None:
        if self.eviction is None:
            return
        for key in self.eviction.victims(entries, protect):
            if self.telemetry is not None:
                self.telemetry.counter("plan_cache.eviction",
                                       tenant=entries[key].dag_name,
                                       dag_fp=key[3][:12])
            del entries[key]
            self.evictions += 1

    # -------------------------------------------------------- invalidation
    def bump_version(self, version: int | None = None) -> int:
        """Atomically invalidate every cached front: the (version, table)
        pair swaps in one assignment.  Raises when a ``version_source``
        drives the version (bump it there — FeedbackLoop drift events do
        this automatically)."""
        if self._version_source is not None:
            raise RuntimeError(
                "version is driven by version_source; bump it there "
                "(FeedbackLoop drift events do this automatically)")
        new = self._generation[0] + 1 if version is None else int(version)
        self._generation = (new, OrderedDict())
        self.invalidations += 1
        if self.telemetry is not None:
            self.telemetry.counter("plan_cache.invalidation", version=new)
        return new

    def on_drift(self) -> None:
        """Hook for ``FeedbackLoop(on_drift=cache.on_drift)`` when no
        version_source is wired: one drift event → one atomic bump → the
        next lookup *per tenant* is that tenant's single EXPLORE re-plan."""
        if self._version_source is None:
            self.bump_version()

    # --------------------------------------------------------- persistence
    def _store_version(self, store) -> int:
        """The latest *on-disk* calibration version for this cluster — the
        durable stale-front anchor.  The in-memory counter resets with the
        process, but the store's ``v*.json`` history does not: a front
        persisted before a re-profiling (a new calibration file) can never
        be served after it, whatever the counters say."""
        versions = store.versions(self.cluster)
        return versions[-1] if versions else 0

    def persist(self, store=None) -> int:
        """Write the current generation's warm fronts next to the
        calibrations in ``store`` (a ``repro_torch.profiling.CalibrationStore``;
        defaults to the one wired at construction).  Each entry is stamped
        with the generation's calibration version *and* the store's
        latest on-disk calibration version, so a loader under a newer
        calibration — counter bump or re-profiled store — drops it rather
        than serving a stale front.  Returns the number of fronts
        written."""
        store = self._store if store is None else store
        if store is None:
            raise ValueError("no CalibrationStore to persist to: pass one "
                             "here or wire store= at construction")
        version, entries = self._generation
        store_version = self._store_version(store)
        payload = [
            {"dag_fingerprint": e.dag_fingerprint, "dag_name": e.dag_name,
             "delta": e.delta, "calibration_version": version,
             "store_calibration_version": store_version,
             "membership_fingerprint": e.membership_fingerprint,
             "front": e.front.to_dict(plan_to_dict)}
            for e in entries.values()
        ]
        self._inserts_since_persist = 0
        n = store.save_fronts(self.cluster, payload)
        if self.telemetry is not None:
            self.telemetry.counter("plan_cache.persist", n,
                                   version=version)
        return n

    def warm_from(self, store=None) -> int:
        """Load persisted fronts into the current generation, skipping the
        cold frontier pass for every tenant they cover.  Stale entries are
        dropped, never served: an entry loads only if **both** its
        ``calibration_version`` matches the live version (restarting
        serving should seed its ``FeedbackLoop(calibration_version=...)``
        — and therefore this cache — with the same counter it persisted
        at) *and* its ``store_calibration_version`` matches the store's
        latest on-disk calibration, so a re-profiling between persist and
        restart invalidates even when the in-memory counters happen to
        collide.  A mismatch is conservative — the tenant re-plans cold —
        never wrong.  The eviction budget is enforced after loading.
        Returns the number of fronts loaded."""
        store = self._store if store is None else store
        if store is None:
            raise ValueError("no CalibrationStore to warm from: pass one "
                             "here or wire store= at construction")
        version = self.version
        store_version = self._store_version(store)
        entries = self._table(version)
        # entries written before membership keying existed carry no mask
        # hash; file them under the full-membership mask they were planned
        # over (every declared node available)
        full = membership_fingerprint(self.cluster.with_availability(
            [True] * len(self.cluster.nodes)))
        n = 0
        for raw in store.load_fronts(self.cluster):
            if (raw.get("calibration_version") != version
                    or raw.get("store_calibration_version")
                    != store_version):
                continue                      # stale: never serve it
            front = ParetoFront.from_dict(
                raw["front"], lambda d: plan_from_dict(d, self.cluster))
            mfp = raw.get("membership_fingerprint") or full
            # fronts for *every* membership load side by side: a returning
            # membership finds its entry warm even across a restart
            key = (self.fingerprint, mfp, version,
                   raw["dag_fingerprint"], raw["delta"])
            entries[key] = CacheEntry(
                dag_name=raw["dag_name"],
                dag_fingerprint=raw["dag_fingerprint"], delta=raw["delta"],
                front=front, membership_fingerprint=mfp,
                _nbytes=len(json.dumps(raw["front"])))
            n += 1
        self._evict(entries)
        self.loaded += n
        return n

    # --------------------------------------------------------------- stats
    def __len__(self) -> int:
        return len(self._generation[1])

    def nbytes(self) -> int:
        """Serialized size of every cached front — what ``max_bytes``
        budgets."""
        return sum(e.nbytes for e in self._generation[1].values())

    def tenants(self) -> tuple[str, ...]:
        """Dag names currently cached, least- to most-recently used."""
        return tuple(e.dag_name for e in self._generation[1].values())

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations, "loaded": self.loaded,
                "prewarmed": self.prewarmed,
                "prewarm_hits": self.prewarm_hits,
                "prewarm_misses": self.prewarm_misses,
                "speculative": sum(1 for e in self._generation[1].values()
                                   if e.speculative),
                "entries": len(self), "nbytes": self.nbytes(),
                "tenants": self.tenants(), "version": self.version,
                "fingerprint": self.fingerprint,
                "membership": self.membership_fingerprint,
                "hit_rate": self.hit_rate()}


class SpeculativePrewarmer:
    """Membership speculation driven by fleet epochs.

    Wires a :class:`PlanCache` to a ``repro.fleet.FleetController``: every
    membership epoch (and every explicit :meth:`prime` call — "idle time"
    in a serving loop) pre-builds fronts for the current membership and all
    single-departure neighbours, so the *next* departure is served entirely
    from cache — zero frontier passes, counter-verified via
    ``plan_cache.prewarm_hit`` and the absence of ``plan.frontier_pass``
    spans.  The fast DP engine makes each speculative pass share its rows
    with the pass that preceded it, which is what keeps idle-time
    speculation affordable (benchmarks/tab1_planner_overhead.py gates it).

    Attributes:
        cache: the plan cache speculated into.
        controller: the epoch source (its ``add_epoch_hook`` is used, so a
            serving engine's own ``on_epoch`` callback is untouched).
        epochs_seen: epochs observed via the hook.
        fronts_built: speculative fronts built by this prewarmer.
    """

    def __init__(self, cache: PlanCache, controller=None):
        self.cache = cache
        self.controller = controller
        self.epochs_seen = 0
        self.fronts_built = 0
        if controller is not None:
            if cache.membership_source is None:
                cache.membership_source = controller
            controller.add_epoch_hook(self._on_epoch)

    def prime(self, dags=None) -> int:
        """Run one speculation sweep now (idle-time trigger).  Returns the
        number of fronts built; already-warm memberships cost nothing."""
        built = self.cache.prewarm(dags=dags)
        self.fronts_built += built
        return built

    def _on_epoch(self, epoch) -> int:
        self.epochs_seen += 1
        return self.prime()

    def stats(self) -> dict:
        return {"epochs_seen": self.epochs_seen,
                "fronts_built": self.fronts_built}
