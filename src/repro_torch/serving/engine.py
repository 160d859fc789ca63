"""Serving engine: continuous batching over a slotted KV cache, driven by the
HiDP plan — the port of ``repro.serving.engine``.

The engine renders the paper's Run-time Scheduler FSM (Fig. 4): ANALYZE
admits queued requests into free slots (prefill through the flash-attention
kernel), EXPLORE re-enters planning on drift or a membership epoch, EXECUTE
runs one decode step over every slot (decode-attention kernel) and merges the
emitted tokens per request.

``plan_cache``, ``feedback`` and ``telemetry`` arrive as objects, and the
engine never imports their classes: the port's own ``PlanCache``
(``repro_torch.serving.plan_cache``) and ``FeedbackLoop``
(``repro_torch.profiling``) fit, and so do the JAX package's, which are pure
Python, and its ``TelemetryRecorder``.  The KV cache is
updated in place (the JAX engine donates it instead).

With a recorder wired, every ``step`` is a tree of wall-clocked spans
(``SPANS``), each on the unix clock of ``torch.profiler``'s host and device
events: ``engine.step`` over ``engine.admit`` (one ``engine.prefill`` per
admitted request, over its ``engine.slot_write`` and ``engine.first_token``),
``engine.decode``, ``engine.feedback`` and ``engine.emit``; the recorder is
handed to the model, whose layers span themselves beneath.  Without one the
engine passes the model nothing and each span site is one ``is None`` check.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.fingerprint import dag_fingerprint
from repro_torch.core.objective import METRICS
from repro_torch.core.scheduler import State
from repro_torch.models.model import Model
from repro_torch.telemetry import active as _tel_active
from repro_torch.telemetry import wall_span as _span

#: the spans a recorder receives from ``step`` (``submit`` adds
#: ``engine.resolve``, a re-plan ``engine.replan_pass``)
SPANS = ("engine.step", "engine.admit", "engine.prefill", "engine.slot_write",
         "engine.first_token", "engine.decode", "engine.feedback",
         "engine.emit")
#: the FSM's states ``ServingEngine.trace`` keeps, the newest
TRACE_STATES = 4096


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray                  # (P,) int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    # what this request asks the planner to minimize when (re-)planning:
    # "latency" | "energy" | "edp" (an Objective's metric name)
    objective: str = "latency"
    # which tenant (ModelDAG) this request belongs to — resolved against
    # the shared PlanCache; None when the engine serves without a cache
    dag: Any = None
    # filled during serving
    slot: int | None = None
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # unix ns of the submit, read only when the engine records telemetry
    submitted_ns: int | None = None


class ServingEngine:
    """Same contract as ``repro.serving.engine.ServingEngine``.

    ``feedback`` (a ``FeedbackLoop``) receives every decode step's latency,
    measured after a device synchronisation, as an observation keyed
    ``engine/decode``; when it flags drift the engine re-enters EXPLORE
    (counted in ``replans``), re-plans each in-flight tenant once through
    ``plan_cache`` and calls ``on_replan``.  Requests carry a planning
    objective and :meth:`dominant_objective` reports the most requested one.
    Each ``submit`` names its tenant with ``dag=`` (or ``default_dag``) when
    a ``plan_cache`` is wired.  :meth:`on_membership_change` is the fleet's
    epoch callback.  ``telemetry`` records submits and re-plans as counters
    and every step as spans (``SPANS``); the model gets it as
    ``telemetry=`` only when it is wired.

    ``prefill_seconds`` and ``decode_seconds`` keep the wall time of every
    prefill and decode step, each ended by a device synchronisation;
    ``trace`` the FSM's newest ``TRACE_STATES`` states.
    """

    def __init__(self, model: Model, params: dict, *, max_batch: int = 4,
                 max_len: int = 128, plan=None, device="cuda",
                 feedback=None, on_replan: Callable[[], Any] | None = None,
                 plan_cache=None, default_dag=None, telemetry=None):
        self.device = _device.resolve(device)
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.plan = plan
        self.feedback = feedback
        self.on_replan = on_replan
        self.telemetry = _tel_active(telemetry)
        self._model_kw = ({} if self.telemetry is None
                          else {"telemetry": self.telemetry})
        if plan_cache is None and default_dag is not None:
            raise ValueError(
                "default_dag names the tenant submits resolve against a "
                "plan_cache; without a cache there is nothing to resolve "
                "— pass plan_cache too")
        self.plan_cache = plan_cache
        self.default_dag = default_dag
        # most recent plan selection per tenant, keyed by dag fingerprint,
        # and each tenant's compute intensity (part of its cache key)
        self.tenant_plans: dict[str, Any] = {}
        self._tenant_deltas: dict[str, float | None] = {}
        self.replans = 0
        self._decode_steps = 0
        self.prefill_seconds: list[float] = []
        self.decode_seconds: list[float] = []
        self.cache = model.init_cache(max_batch, max_len, device=self.device)
        self.lengths = np.zeros((max_batch,), np.int32)
        self.slot_req: list[Request | None] = [None] * max_batch
        self.queue: deque[Request] = deque()
        self.completed: dict[int, Request] = {}
        self._next_id = 0
        self.state = State.ANALYZE
        self.trace: deque[State] = deque(maxlen=TRACE_STATES)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ API
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               eos_id: int | None = None, objective: str = "latency",
               dag=None, delta: float | None = None) -> int:
        """Queue one request.  ``objective`` names the planning metric this
        request wants (``"latency"`` | ``"energy"`` | ``"edp"``); ``dag``
        names its tenant (falling back to ``default_dag``) and ``delta``
        the tenant's compute intensity — part of the cache key.  With a
        ``plan_cache`` wired, the objective is resolved against that
        tenant's cached frontier right here."""
        if objective not in METRICS:
            raise ValueError(f"unknown objective {objective!r}; "
                             f"expected one of {METRICS}")
        dag = dag if dag is not None else self.default_dag
        if dag is not None and self.plan_cache is None:
            raise ValueError(
                "submit(dag=...) names a tenant to resolve against a "
                "plan_cache, but the engine has none — wire plan_cache=")
        submitted_ns = time.time_ns() if self.telemetry is not None else None
        rid = self._next_id
        self._next_id += 1
        if self.plan_cache is not None:
            if dag is None:
                raise ValueError(
                    "a plan_cache is wired but this submit names no "
                    "tenant: pass dag= here or default_dag= to the engine")
            misses0 = self.plan_cache.misses
            # the resolve context roots this submit's trace subtree
            with _span(self.telemetry, "engine.resolve", tenant=dag.name,
                       request=rid, objective=objective):
                self.plan = self.plan_cache.get(dag, objective=objective,
                                                delta=delta)
                fp = dag_fingerprint(dag)
                self.tenant_plans[fp] = self.plan
                self._tenant_deltas[fp] = delta
                if self.telemetry is not None:
                    self.telemetry.counter(
                        "engine.submit", tenant=dag.name, request=rid,
                        objective=objective,
                        resolved="miss" if self.plan_cache.misses > misses0
                        else "hit")
        elif self.telemetry is not None:
            self.telemetry.counter("engine.submit", request=rid,
                                   objective=objective, resolved="none")
        self.queue.append(Request(rid, np.asarray(prompt, np.int32),
                                  max_new_tokens, eos_id,
                                  objective=objective, dag=dag,
                                  submitted_ns=submitted_ns))
        return rid

    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def _requests(self):
        """Queued + in-flight requests, queue first."""
        yield from self.queue
        for r in self.slot_req:
            if r is not None:
                yield r

    def _tenant_traffic(self) -> dict:
        """``{dag fingerprint: (dag, request count)}`` over queued +
        in-flight requests."""
        by_fp: dict[str, Any] = {}
        for r in self._requests():
            if r.dag is not None:
                fp = dag_fingerprint(r.dag)
                dag, n = by_fp.get(fp, (r.dag, 0))
                by_fp[fp] = (dag, n + 1)
        return by_fp

    def tenant_dags(self) -> list:
        """The distinct tenants with queued or in-flight traffic, ordered
        by dag fingerprint."""
        traffic = self._tenant_traffic()
        return [traffic[fp][0] for fp in sorted(traffic)]

    def dominant_objective(self, dag=None) -> str:
        """The most-requested objective among queued + in-flight requests
        (restricted to one tenant when ``dag`` is given).  Ties break by
        the fixed ``METRICS`` order; an empty engine gives "latency"."""
        fp = None if dag is None else dag_fingerprint(dag)
        counts = dict.fromkeys(METRICS, 0)
        for r in self._requests():
            if fp is None or (r.dag is not None
                              and dag_fingerprint(r.dag) == fp):
                counts[r.objective] += 1
        return max(METRICS, key=counts.__getitem__)

    def _replan_in_flight_tenants(self) -> None:
        """One cache resolution per in-flight tenant, each at that tenant's
        dominant objective and keyed delta; the engine-level plan follows
        the busiest tenant (ties break low-fingerprint-first)."""
        traffic = self._tenant_traffic()
        for fp in sorted(traffic):
            dag = traffic[fp][0]
            self.tenant_plans[fp] = self.plan_cache.get(
                dag, objective=self.dominant_objective(dag),
                delta=self._tenant_deltas.get(fp))
        if traffic:
            busiest = max(sorted(traffic), key=lambda f: traffic[f][1])
            self.plan = self.tenant_plans[busiest]

    def on_membership_change(self, epoch=None) -> None:
        """The fleet's membership moved: re-enter EXPLORE with exactly one
        plan resolution per in-flight tenant.  ``epoch`` is accepted and
        ignored so the callback wires directly."""
        self.state = State.EXPLORE
        self.trace.append(self.state)
        self.replans += 1
        with _span(self.telemetry, "engine.replan_pass", reason="epoch",
                   epoch=getattr(epoch, "epoch", None)):
            if self.telemetry is not None:
                self.telemetry.counter(
                    "engine.replan", reason="epoch",
                    epoch=getattr(epoch, "epoch", None),
                    tenants=len(self._tenant_traffic()))
            if self.plan_cache is not None:
                self._replan_in_flight_tenants()
            if self.on_replan is not None:
                self.on_replan()

    def run_until_done(self, max_steps: int = 10_000) -> dict[int, Request]:
        for _ in range(max_steps):
            if not self.queue and self.active() == 0:
                break
            self.step()
        return self.completed

    # ----------------------------------------------------------------- admit
    def _admit(self) -> int:
        """Prefill queued requests into free slots; returns how many."""
        self.state = State.ANALYZE
        self.trace.append(self.state)
        admitted = 0
        with _span(self.telemetry, "engine.admit"):
            for slot in range(self.max_batch):
                if self.slot_req[slot] is not None or not self.queue:
                    continue
                self._prefill(slot, self.queue.popleft())
                admitted += 1
        return admitted

    def _prefill(self, slot: int, req: Request) -> None:
        plen = len(req.prompt)
        batch = {"tokens": torch.as_tensor(req.prompt[None, :],
                                           device=self.device),
                 "lengths": torch.tensor([plen], dtype=torch.int32,
                                         device=self.device)}
        # the stub frontends' inputs, zeros as in the JAX engine: the audio
        # cross cache gets plen // 2 rows, and rows past them keep what an
        # earlier request left there
        cfg = self.model.cfg
        if cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (1, max(plen // 2, 1), cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        if cfg.family == "vlm":
            batch["vision"] = torch.zeros(
                (1, cfg.n_vision_tokens, cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        tel = self.telemetry
        queued_s = (None if req.submitted_ns is None
                    else (time.time_ns() - req.submitted_ns) / 1e9)
        with _span(tel, "engine.prefill", request=req.request_id,
                   tokens=plen, queued_s=queued_s):
            t0 = time.perf_counter()
            logits, pcache = self.model.apply_prefill(self.params, batch,
                                                      **self._model_kw)
            with _span(tel, "engine.slot_write"):
                self._write_slot(slot, pcache)
            with _span(tel, "engine.first_token"):
                first = int(torch.argmax(logits[0, -1]))
                self._sync()
            self.prefill_seconds.append(time.perf_counter() - t0)
        req.slot = slot
        req.generated.append(first)
        self.slot_req[slot] = req
        self.lengths[slot] = plen + 1

    def _write_slot(self, slot: int, pcache: dict) -> None:
        """Copy a (L, 1, P, ...) prefill cache into slot ``slot`` of the
        engine cache, in place."""
        for k, dst in self.cache.items():
            src = pcache[k]
            if k in ("k", "v", "xk", "xv"):
                # (..., 1, P, H, D) → slot write at seq prefix
                p = src.shape[-3]
                dst[..., slot, :p, :, :] = src[..., 0, :p, :, :]
            elif k == "h":
                dst[..., slot, :, :, :] = src[..., 0, :, :, :]
            elif k == "conv":
                dst[..., slot, :, :] = src[..., 0, :, :]

    # ---------------------------------------------------------------- decode
    def step(self) -> None:
        """Admit what fits, then one decode step over every slot."""
        with _span(self.telemetry, "engine.step") as h:
            admitted = self._admit()
            rows = self.active()
            if rows:
                self._decode(rows)
            if h is not None:
                h.set(admitted=admitted, rows=rows)

    def _decode(self, rows: int) -> None:
        self.state = State.EXECUTE
        self.trace.append(self.state)
        tokens = np.zeros((self.max_batch, 1), np.int32)
        for s, req in enumerate(self.slot_req):
            if req is not None:
                tokens[s, 0] = req.generated[-1]
        batch = {"tokens": torch.from_numpy(tokens).to(self.device),
                 "lengths": torch.from_numpy(
                     np.maximum(self.lengths, 1)).to(self.device)}
        tel = self.telemetry
        # the keys attended, from the host's lengths (no device read)
        kv_tokens = int(self.lengths.sum()) if tel is not None else None
        with _span(tel, "engine.decode", rows=rows, kv_tokens=kv_tokens):
            t0 = time.perf_counter()
            logits, self.cache = self.model.apply_decode(
                self.params, self.cache, batch, **self._model_kw)
            self._sync()
            step_s = time.perf_counter() - t0
        self.decode_seconds.append(step_s)
        self._decode_steps += 1
        if self.feedback is not None and self._decode_steps > 1:
            # step 1 pays the kernel build and warm-up — not a hardware
            # signal.  work = decoded tokens this step (batch-occupancy
            # proxy for FLOPs; the loop's regressor absorbs the constant)
            with _span(tel, "engine.feedback"):
                if self.feedback.observe("engine/decode", "decode",
                                         float(rows), 0.0, step_s):
                    self._replan_on_drift()
        with _span(tel, "engine.emit"):
            self._emit(torch.argmax(logits[:, -1], dim=-1).cpu().numpy())

    def _replan_on_drift(self) -> None:
        self.state = State.EXPLORE
        self.trace.append(self.state)
        self.replans += 1
        with _span(self.telemetry, "engine.replan_pass", reason="drift"):
            if self.telemetry is not None:
                self.telemetry.counter(
                    "engine.replan", reason="drift",
                    tenants=len(self._tenant_traffic()))
            if self.plan_cache is not None:
                # the drift already bumped the calibration version;
                # re-plan exactly once per in-flight tenant
                self.plan_cache.on_drift()
                self._replan_in_flight_tenants()
            if self.on_replan is not None:
                self.on_replan()

    def _emit(self, nxt: np.ndarray) -> None:
        """Append each slot's next token; finish and free the slots whose
        request is done."""
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = int(nxt[s])
            req.generated.append(tok)
            self.lengths[s] += 1
            over = len(req.generated) >= req.max_new_tokens
            hit_eos = req.eos_id is not None and tok == req.eos_id
            full = self.lengths[s] >= self.max_len
            if over or hit_eos or full:
                req.done = True
                self.completed[req.request_id] = req
                self.slot_req[s] = None
                self.lengths[s] = 0
