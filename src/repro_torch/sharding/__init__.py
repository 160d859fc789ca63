"""The port's copy of ``repro.sharding``'s planner: HiDP's two tiers over a
mesh of accelerators, with the chip (``V5E`` or ``H100``) a parameter.
The JAX package's sharding contexts, specs and pipeline are not ported yet
(``ROADMAP.md``).  The one planning function, ``plan.plan(model, shape,
mesh, chip)``, is not re-exported here: the name would hide the module."""

from .plan import (GPU_MULTI_NODE, GPU_NODE, H100, MULTI_POD,  # noqa: F401
                   SINGLE_POD, V5E, ChipSpec, MeshDesc, ShardingPlan,
                   plan_gpu, plan_tpu)
