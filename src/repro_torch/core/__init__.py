"""The port's copy of ``repro.core``, the paper's hardware-agnostic planner:
the cost model, block DAGs, objectives, fingerprints, the frontier DP at
both tiers and the two-tier HiDP planner, the cluster manager (heartbeats,
availability, leader election), the paper's edge-model zoo and Table II
boards, the leader/follower scheduler FSMs (Fig. 4), the §IV-A baselines
(``STRATEGIES`` / ``STRATEGY_FRONTS``) and the event-driven edge simulator
(``EdgeSimulator`` / ``simulate``)."""

from .cost_model import (ANALYTIC, AnalyticCostProvider,  # noqa: F401
                         Cluster, CostProvider, Node, Processor, Resource,
                         gpu_chip, gpu_node, node_as_resource,
                         processors_as_resources, resolve_provider, tpu_chip,
                         tpu_pod)
from .dag import Block, DataPartition, ModelDAG, ModelPartition, chain  # noqa: F401
from .objective import LATENCY, METRICS, Objective, resolve_objective  # noqa: F401
from .pareto import ParetoFront, ParetoPoint  # noqa: F401
from .fingerprint import (cluster_fingerprint, dag_fingerprint,  # noqa: F401
                          membership_fingerprint)
from .dp_partitioner import (partition, partition_data,  # noqa: F401
                             partition_data_front, partition_front,
                             partition_model, partition_model_front,
                             predicted_energy)
from .global_partitioner import (GlobalPlan, plan_global,  # noqa: F401
                                 plan_global_front)
from .local_partitioner import (LocalPlan, p1_plan, plan_local,  # noqa: F401
                                plan_local_front)
from .hidp import (HiDPPlan, HiDPPlanner, PlannerConfig, plan,  # noqa: F401
                   plan_from_dict, plan_front, plan_to_dict, sub_dag_for)
from .baselines import STRATEGIES, STRATEGY_FRONTS  # noqa: F401
from .scheduler import FollowerFSM, InferenceRequest, LeaderFSM, State  # noqa: F401
from .cluster import ClusterManager, HeartbeatMonitor  # noqa: F401
from .simulator import EdgeSimulator, SimReport, SimRequest, simulate  # noqa: F401
from .edge_models import (EDGE_MODELS, MODEL_DELTA,  # noqa: F401
                          battery_cluster, paper_cluster)
