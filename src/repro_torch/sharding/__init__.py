"""The port's copy of ``repro.sharding``: HiDP's two-tier planner over a
mesh of accelerators, with the chip (``V5E`` or ``H100``) a parameter
(``plan``), and the multi-GPU layer that runs its plans with
``torch.distributed``: the activation-sharding context (``ctx``), the
parameter, batch and cache specs and their DTensor placements (``specs``),
the collectives the model code issues (``comm``), the sharded train step
(``spmd``: training, prefill and decode under every layout the planners
offer, tensor parallelism over two axes or beside a sequence split
included) and the GPipe pipeline (``pipeline``).  The one
planning function, ``plan.plan(model, shape, mesh, chip)``, is not
re-exported here: the name would hide the module."""

from .plan import (GPU_MULTI_NODE, GPU_NODE, H100, MULTI_POD,  # noqa: F401
                   SINGLE_POD, V5E, ChipSpec, MeshDesc, ShardingPlan,
                   plan_gpu, plan_tpu)
