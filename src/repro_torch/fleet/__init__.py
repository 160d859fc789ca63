"""The port's copy of ``repro.fleet`` — churn-aware cluster dynamics.

Seeded, replayable availability traces (:mod:`~repro_torch.fleet.traces`)
and a :class:`FleetController` that replays them into membership epochs
over the port's ``ClusterManager``/``HeartbeatMonitor``
(:mod:`~repro_torch.fleet.controller`).  Through
``repro_torch.core.fingerprint.membership_fingerprint`` a membership-keyed
``PlanCache`` files warm fronts for distinct memberships side by side, so
a node that leaves and returns re-serves its front with zero DP work; the
epochs drive ``ServingEngine.on_membership_change`` and
``ElasticController.on_epoch``.
"""

from .controller import FleetController, MembershipEpoch  # noqa: F401
from .traces import (DOWN_KINDS, FAILURE_KINDS, KINDS,  # noqa: F401
                     UP_KINDS, ChurnEvent, ChurnTrace)
