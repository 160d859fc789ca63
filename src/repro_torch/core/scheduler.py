"""The port's copy of ``repro.core.scheduler``.

Run-time Scheduler — the leader/follower finite-state machine (Fig. 4).

Leader:    ANALYZE → EXPLORE → GLOBAL_OFFLOAD → LOCAL_MAP → EXECUTE
                ▲                                   │
                └────────── merge & report ◄────────┘
Follower:  ANALYZE (receive) → LOCAL_MAP → EXECUTE → report

The FSM is transport-agnostic: ``Transport`` is injected (the simulator uses
simulated links; the TPU runtime uses in-process dispatch).  The FSM itself is
synchronous and step-driven so the event simulator can interleave many nodes;
``step()`` consumes/produces events.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Protocol

from .cluster import ClusterManager
from .cost_model import Cluster, Node
from .dag import ModelDAG
from .hidp import HiDPPlan, PlannerConfig, plan, sub_dag_for
from .local_partitioner import LocalPlan, plan_local


class State(enum.Enum):
    ANALYZE = "analyze"
    EXPLORE = "explore"
    GLOBAL_OFFLOAD = "global_offload"
    LOCAL_MAP = "local_map"
    EXECUTE = "execute"


@dataclasses.dataclass
class InferenceRequest:
    request_id: int
    dag: ModelDAG
    arrival_time: float
    delta: float = 1.0


@dataclasses.dataclass
class ShardResult:
    request_id: int
    node_name: str
    stage_index: int
    payload: Any
    finish_time: float


class Transport(Protocol):
    """Inter-node communication abstraction (paper: Communication Module)."""

    def send(self, src: str, dst: str, nbytes: float, payload: Any,
             now: float) -> float:
        """Deliver payload; returns arrival time (src==dst → now)."""
        ...


@dataclasses.dataclass
class LeaderFSM:
    """One request's journey through the leader's scheduling policy."""

    manager: ClusterManager
    transport: Transport
    planner_config: PlannerConfig = dataclasses.field(
        default_factory=PlannerConfig)
    state: State = State.ANALYZE
    current: InferenceRequest | None = None
    plan_result: HiDPPlan | None = None
    pending_shards: set[int] = dataclasses.field(default_factory=set)
    results: list[ShardResult] = dataclasses.field(default_factory=list)
    trace: list[tuple[float, State]] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------- transitions
    def on_request(self, req: InferenceRequest, now: float) -> HiDPPlan:
        """ANALYZE: request arrives; leader elected; availability probed.
        EXPLORE: the DSE agent (DP) finds the partitioning mode and points."""
        assert self.state == State.ANALYZE, f"busy in {self.state}"
        self.current = req
        self.trace.append((now, State.ANALYZE))
        # churn-aware leadership: keep the sitting leader while it is alive,
        # otherwise fail over to the first available node (the request is
        # re-received there — Alg. 1 line 2 with a churned fleet)
        if self.manager.ensure_leader() is None:
            raise RuntimeError("no available node to lead the request")
        cluster = self.manager.refresh_availability(now)

        self.state = State.EXPLORE
        self.trace.append((now, State.EXPLORE))
        cfg = dataclasses.replace(self.planner_config, delta=req.delta)
        self.plan_result = plan(req.dag, cluster, cfg)

        self.state = State.GLOBAL_OFFLOAD
        self.trace.append((now, State.GLOBAL_OFFLOAD))
        return self.plan_result

    def offload(self, now: float) -> list[tuple[str, float, int]]:
        """GLOBAL_OFFLOAD: ship each non-leader assignment via the transport.
        Returns [(dst_node, arrival_time, stage_index)] for the simulator."""
        assert self.state == State.GLOBAL_OFFLOAD and self.plan_result
        leader = self.manager.leader
        sent = []
        gp = self.plan_result.global_plan
        for a in gp.assignments:
            self.pending_shards.add(a.stage_index)
            if a.node.name == leader:
                continue
            sd = sub_dag_for(self.current.dag, a)
            arrive = self.transport.send(leader, a.node.name, sd.input_bytes,
                                         ("shard", self.current.request_id,
                                          a.stage_index), now)
            sent.append((a.node.name, arrive, a.stage_index))
        self.state = State.LOCAL_MAP
        self.trace.append((now, State.LOCAL_MAP))
        return sent

    def local_map(self, now: float) -> LocalPlan:
        """LOCAL_MAP: tier-2 DP for the leader's own share."""
        assert self.state == State.LOCAL_MAP and self.plan_result
        leader = self.manager.leader
        idx = next(i for i, a in enumerate(
            self.plan_result.global_plan.assignments)
            if a.node.name == leader)
        lp = self.plan_result.local_plans[idx]
        self.state = State.EXECUTE
        self.trace.append((now, State.EXECUTE))
        return lp

    def on_shard_result(self, r: ShardResult, now: float) -> bool:
        """EXECUTE: gather local and global results (Alg. 1 line 12).
        Returns True when all shards have reported and the FSM merged."""
        assert self.state == State.EXECUTE
        self.results.append(r)
        self.pending_shards.discard(r.stage_index)
        if self.pending_shards:
            return False
        # merge & report (Alg. 1 line 13), back to ANALYZE
        self.state = State.ANALYZE
        self.trace.append((now, State.ANALYZE))
        self.current = None
        return True


@dataclasses.dataclass
class FollowerFSM:
    """Follower policy: receive → local map → execute → report (Fig. 4)."""

    node: Node
    transport: Transport
    state: State = State.ANALYZE

    def on_shard(self, sub: ModelDAG, delta: float, now: float) -> LocalPlan:
        assert self.state == State.ANALYZE
        self.state = State.LOCAL_MAP
        lp = plan_local(sub, self.node, delta=delta)
        self.state = State.EXECUTE
        return lp

    def report(self, leader: str, nbytes: float, payload: Any,
               now: float) -> float:
        arrive = self.transport.send(self.node.name, leader, nbytes, payload,
                                     now)
        self.state = State.ANALYZE
        return arrive
