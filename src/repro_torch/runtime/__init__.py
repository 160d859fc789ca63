"""The port's runtime layer: elastic re-planning on membership changes
(``ElasticController``) and fault tolerance for training runs
(``CheckpointPolicy``, ``StragglerPolicy``, ``FaultTolerantRunner``)."""

from .elastic import ElasticController  # noqa: F401
from .fault_tolerance import (CheckpointPolicy,  # noqa: F401
                              FaultTolerantRunner, StragglerPolicy)
