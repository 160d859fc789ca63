"""The port's copy of ``repro.core.cluster``.

Cluster registry, availability tracking and leader election.

Paper semantics: the node that *receives* an inference request becomes the
leader (φ* — Alg. 1 line 2); availability A(N_φ) is probed by pseudo packets
(Eq. 4).  Here availability is maintained by a heartbeat monitor that both the
event-driven simulator and the GPU/TPU runtime drive; a node missing
``miss_threshold`` consecutive heartbeats flips α_j to 0 and triggers
re-planning (runtime/elastic.py).
"""

from __future__ import annotations

import dataclasses

from .cost_model import Cluster, Node


@dataclasses.dataclass
class HeartbeatMonitor:
    """Tracks last-seen times; the clock is injected (sim time or wall time)."""

    interval: float = 0.5              # seconds between expected beats
    miss_threshold: int = 3
    last_seen: dict[str, float] = dataclasses.field(default_factory=dict)

    def beat(self, node_name: str, now: float) -> None:
        self.last_seen[node_name] = now

    def alive(self, node_name: str, now: float) -> bool:
        t = self.last_seen.get(node_name)
        if t is None:
            return False
        return (now - t) <= self.interval * self.miss_threshold


@dataclasses.dataclass
class ClusterManager:
    """Mutable wrapper over the frozen Cluster: availability, leadership."""

    cluster: Cluster
    monitor: HeartbeatMonitor = dataclasses.field(
        default_factory=HeartbeatMonitor)
    leader: str | None = None

    def nodes(self) -> tuple[Node, ...]:
        return self.cluster.nodes

    def node(self, name: str) -> Node:
        for n in self.cluster.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def first_available(self) -> Node | None:
        """The first declared node with α_j = 1 — the deterministic
        fail-over leader candidate when the current leader goes away."""
        for n in self.cluster.nodes:
            if n.available:
                return n
        return None

    def leader_available(self) -> bool:
        if self.leader is None:
            return False
        try:
            return self.node(self.leader).available
        except KeyError:
            return False

    def ensure_leader(self, preferred: str | None = None) -> str | None:
        """The one fail-over policy (Alg. 1 line 2 under churn), shared by
        the scheduler FSM and the fleet controller: elect ``preferred``
        when it names an available node; otherwise keep the sitting leader
        while it is available; otherwise the first available declared
        node.  Returns the leader's name, or None — clearing the seat —
        when no node is available."""
        if preferred is not None:
            try:
                if self.node(preferred).available:
                    return self.elect_leader(preferred).name
            except KeyError:
                pass
        if self.leader_available():
            return self.leader
        candidate = self.first_available()
        if candidate is None:
            self.leader = None
            return None
        return self.elect_leader(candidate.name).name

    def elect_leader(self, receiving_node: str) -> Node:
        """Alg. 1 line 2: leader = the node that received the request."""
        for n in self.cluster.nodes:
            if n.name == receiving_node:
                if not n.available:
                    raise RuntimeError(f"leader candidate {receiving_node} "
                                       "is unavailable")
                self.leader = n.name
                return n
        raise KeyError(receiving_node)

    def refresh_availability(self, now: float) -> Cluster:
        """Re-evaluate A(N_φ) from heartbeats (Alg. 1 line 3).  The leader is
        always considered available to itself."""
        alphas = []
        for n in self.cluster.nodes:
            if n.name == self.leader:
                alphas.append(True)
            else:
                alphas.append(self.monitor.alive(n.name, now))
        self.cluster = self.cluster.with_availability(alphas)
        return self.cluster

    def set_available(self, node_name: str, available: bool) -> Cluster:
        """Direct availability override (node join/leave/failure)."""
        alphas = [(n.available if n.name != node_name else available)
                  for n in self.cluster.nodes]
        self.cluster = self.cluster.with_availability(alphas)
        return self.cluster

    def available_count(self) -> int:
        return sum(self.cluster.availability())
