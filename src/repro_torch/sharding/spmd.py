"""The sharded train step: the counterpart of the reference's
``jax.jit(make_train_step(...), in_shardings=...)`` (``launch/dryrun.py``),
for every plan whose ``tp_axes`` are empty (data parallelism, FSDP, and the
sequence split with expert parallelism).

* Parameters and optimizer state are DTensors placed by ``specs``: that is
  the memory layout.  The batch is each rank's shard of it
  (``local_batch``).
* The model code runs on local tensors, so every module and kernel stays as
  it is.  The parameters outside the layer stacks (embedding, head, final
  norms) are gathered once at the step's entry.  Each layer's leaves are
  gathered to their compute placement inside the layer
  (``ctx.gather_layer``, called within the layer's remat checkpoint, so the
  backward pass gathers them again: the FSDP all-gather), then leave
  DTensor through ``to_local(grad_placements=...)`` with ``Partial`` over
  the mesh axes the tokens are split over, so that autograd reduce-scatters
  or all-reduces their gradients back to the parameters' placements.
* The compute placement is replicated, except the MoE expert stacks under
  an expert-parallel lowering: those keep their experts split over the EP
  axis (``Shard``) and ``moe_ep`` exchanges tokens over an all-to-all.
* Under ``seq_axes`` attention gathers keys and values over the sequence
  group (``layers.attention``) and the queries keep their global positions.
* Each rank's loss is its token sum over the global token count, so that
  the reduced gradient equals the unsharded one; the clip norm is global
  (``optimizer.global_norm``).

A plan with ``tp_axes`` raises ``NotImplementedError``: tensor parallelism
comes with the serving slice that needs it.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch

from repro_torch.training import optimizer as optim
from repro_torch.training import train_loop, tree
from . import comm, specs
from . import ctx as shard_ctx
from .plan import ShardingPlan

# the parameter trees the model code unstacks layer by layer (the decoder
# stack, whisper's encoder and decoder, the VLM's self and cross groups)
STACKED = ("layers", "encoder", "decoder", "self", "cross")
EXPERT_STACKS = ("w_gate", "w_up", "w_down")


def require_no_tp(plan: ShardingPlan) -> None:
    if plan.tp_axes:
        raise NotImplementedError(
            f"layout {plan.local_layout!r} shards over tp_axes "
            f"{plan.tp_axes}: tensor parallelism comes with the "
            "tensor-parallel serving slice")


def act_specs(plan: ShardingPlan) -> tuple[specs.Spec, specs.Spec]:
    """The activation (B, T, d) and logits (B, T, V) specs the plan
    publishes (the reference's ``dryrun._plan_act_specs``)."""
    ax = specs._ax
    return (specs.Spec(ax(plan.batch_axes), ax(plan.seq_axes), None),
            specs.Spec(ax(plan.batch_axes), None, ax(plan.tp_axes)))


def ep_axis_of(mesh, plan: ShardingPlan) -> str:
    """The expert-parallel axis, as the reference's dry-run picks it."""
    names = tuple(mesh.mesh_dim_names)
    if "model" in names:
        return "model"
    return plan.tp_axes[0] if plan.tp_axes else names[-1]


def token_axes(mesh, batch: dict, plan: ShardingPlan) -> tuple[str, ...]:
    """The mesh axes the batch's tokens are split over (after
    ``sanitize``), in the mesh's order."""
    spec = specs.sanitize(mesh, specs.batch_pspec(
        "tokens", batch["tokens"], plan), tuple(batch["tokens"].shape))
    used = set()
    for e in spec:
        used |= set(specs._entry_axes(e))
    return tuple(a for a in mesh.mesh_dim_names if a in used)


def local_batch(mesh, batch: dict, plan: ShardingPlan) -> dict:
    """This rank's shard of a batch every rank holds whole, split by
    ``specs.batch_pspec``."""
    sp = specs.batch_specs_tree(mesh, batch, plan)
    return {k: specs.local_slice(mesh, sp[k], v).contiguous()
            for k, v in batch.items()}


class _Gather:
    """Leaves (DTensors) to the local tensors the model computes with:
    ``redistribute`` to the compute placement, then ``to_local`` with the
    gradient's placement (``Partial`` over the token axes where the
    compute is replicated)."""

    def __init__(self, mesh, plan: ShardingPlan, toks: tuple[str, ...],
                 num_experts: int | None):
        from torch.distributed.tensor import Partial, Replicate
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self.replicate = tuple(Replicate() for _ in names)
        self.grad = tuple(Partial() if a in toks else Replicate()
                          for a in names)
        # the mesh dim the expert stacks keep their experts split over
        self.ep_dim = None
        if num_experts and plan.moe_impl in ("ep_a2a", "ep_a2a_q8"):
            i = names.index(ep_axis_of(mesh, plan))
            if num_experts % mesh.shape[i] == 0:
                self.ep_dim = i

    def compute(self, path: tuple, leaf) -> tuple[tuple, tuple]:
        """(compute placements, gradient placements) of a layer's leaf; the
        expert dim of an expert stack is its third from last."""
        if (self.ep_dim is not None and "moe" in path
                and path[-1] in EXPERT_STACKS):
            from torch.distributed.tensor import Shard
            pl, gp = list(self.replicate), list(self.grad)
            pl[self.ep_dim] = gp[self.ep_dim] = Shard(leaf.ndim - 3)
            return tuple(pl), tuple(gp)
        return self.replicate, self.grad

    def leaf(self, path: tuple, x):
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        pl, gp = self.compute(path, x)
        return x.redistribute(self.mesh, pl).to_local(grad_placements=gp)

    def __call__(self, p: Any, path: tuple = ()) -> Any:
        return specs.tree_map_with_path(self.leaf, p, path)


@contextlib.contextmanager
def local_view(mesh, plan: ShardingPlan, gather: _Gather):
    """The plan's specs, mesh and EP axis published, and the per-layer
    gather installed, for the model code's run on local tensors."""
    act, logits = act_specs(plan)
    with shard_ctx.plan_specs(act, logits, mesh=mesh,
                              ep_axis=ep_axis_of(mesh, plan)), \
            shard_ctx.layer_gather(gather):
        yield


def local_params(params: dict, gather: _Gather) -> dict:
    """The tree the model sees: the parameters outside the layer stacks
    gathered (once a step), the stacks left as DTensors for the layers to
    gather."""
    return {k: (v if k in STACKED else gather(v, (k,)))
            for k, v in params.items()}


def make_sharded_train_step(model, opt_cfg: optim.OptConfig,
                            plan: ShardingPlan, mesh) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): ``params`` and ``opt_state`` DTensors (``specs.
    param_shardings`` and ``optimizer.init`` on them), ``batch`` the global
    batch, which every rank holds and the step splits by
    ``specs.batch_pspec``.  The microbatch count, remat, ``remat_group`` and
    ``moe_impl`` come from the plan, as in ``train_loop.make_train_step``;
    the metrics are global, the same on every rank."""
    require_no_tp(plan)
    cfg = model.cfg
    n_micro = max(plan.microbatches, 1)
    sizes = specs.axis_sizes(mesh)
    num_experts = cfg.moe.num_experts if cfg.moe is not None else None
    if plan.seq_axes and cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: a sequence split of the SSM scan; no GPU plan "
            "asks for one")

    def grads_of(params, batch, gather, frac):
        """(this rank's share of the loss, gradients as DTensors)."""
        with torch.enable_grad(), local_view(mesh, plan, gather):
            ps = tree.map(lambda p: p.detach().requires_grad_(True), params)
            loss = train_loop.loss_fn(
                model, local_params(ps, gather), batch, remat=plan.remat,
                remat_group=getattr(plan, "remat_group", 1),
                moe_impl=plan.moe_impl) * frac
            grads = torch.autograd.grad(loss, tree.leaves(ps))
        # each gradient in its parameter's placements (reduced, not partial)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 for g, p in zip(grads, tree.leaves(params))]
        return loss.detach(), tree.unflatten(params, grads)

    def train_step(params, opt_state, batch):
        toks = token_axes(mesh, batch, plan)
        gather = _Gather(mesh, plan, toks, num_experts)
        batch = local_batch(mesh, batch, plan)
        n_tok = 1
        for a in toks:
            n_tok *= sizes[a]
        # each rank's loss is its token mean over the ranks the tokens are
        # split over: the ranks' sum is the global mean.  Ranks that repeat
        # one another's tokens (an axis the batch does not divide over)
        # count 1/r each in the reported loss
        frac = 1.0 / n_tok
        if n_micro == 1:
            loss, grads = grads_of(params, batch, gather, frac)
        else:
            micro = train_loop._split_microbatches(batch, n_micro)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = tree.map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for i in range(n_micro):
                mb_loss, g = grads_of(params,
                                      {k: v[i] for k, v in micro.items()},
                                      gather, frac)
                for acc, gi in zip(tree.leaves(grads), tree.leaves(g)):
                    acc.add_(gi)                  # fp32 accumulation
                loss = loss + mb_loss
            loss = loss / n_micro
            grads = tree.map(lambda g: g / n_micro, grads)
        loss = _sum_over_mesh(loss / (mesh.size() // n_tok), mesh)
        params, opt_state, metrics = optim.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _sum_over_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    return comm.all_reduce(x, optim._world_of(mesh))
