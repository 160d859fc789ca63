"""The sharded steps: the counterparts of the reference's
``jax.jit(make_train_step(...), in_shardings=...)`` and of its serving
``jax.jit(prefill | decode, in_shardings=..., out_shardings=...)``
(``launch/dryrun.py``).

The train step covers every training plan the planners offer: at most one
``tp_axes`` axis and no sequence split beside it (data parallelism, FSDP,
the sequence split, with expert parallelism too, and ``dp_tp``,
``dp_tp_fsdp`` and their ``_ep``/``_ep_q8`` variants):

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
* Under ``tp_axes`` every leaf keeps its shard over the tp axis (only its
  FSDP dims are gathered), the step publishes a ``ctx.TPState`` as the
  prefill does, and the layers compute on their shards and move
  activations through ``comm``'s differentiable crossings.  The ranks of
  a tp group hold the same tokens; each takes ``1/tp`` of their loss, so
  that a replicated activation, and a leaf the tp axis replicates, carries
  a partial gradient (``Partial`` over the tp axis too).  The cross entropy
  reduces over the vocab split (``train_loop._ce``).
* Each rank's loss is its token sum over the global token count (and the
  tp width), so that the reduced gradient equals the unsharded one; the
  reported loss is the global mean and the clip norm global
  (``optimizer.global_norm``).  ``make_sharded_grad_fn`` gives the loss
  and the gradients without the update.

Training under tensor parallelism beside a sequence split (``ctx_tp``,
``seq_tp``) or over two axes (``tp_all``) raises ``NotImplementedError``
(``require_ported_layout``): neither planner offers those layouts for
training.  The sequence split of the SSM scan (``dp_sp_fsdp`` for the
``ssm`` and ``hybrid`` families) runs (``layers.mamba_block``).

The serving steps (``make_sharded_prefill``, ``make_sharded_decode``) cover
every prefill and decode layout the planners offer: ``dp_tp``,
``dp_tp_fsdp`` and their ``_ep``/``_ep_q8`` variants, ``dp_sp_fsdp``,
``seq_tp`` (the prompt's sequence over ``data`` beside tensors over
``model``), ``ctx_tp`` and its ``_ep``/``_ep_q8`` variants (the decode
cache's sequence over ``data``, and over ``model`` too where the KV heads
do not divide it), ``tp_all`` (tensors over ``("data", "model")`` at
B = 1, over ``model`` above), and the plans without ``tp_axes``.  A decode
cache split over ``seq_axes`` without tensor parallelism, which no plan
offers, raises.  The parameters (bf16) and caches are DTensors placed by
``specs``; the step publishes the plan and a ``ctx.TPState`` (the groups of
the tp axes, of each weight dim's split and of the caches' head and
sequence splits, read after ``sanitize``) and runs the model on local
tensors under ``torch.no_grad()``.  The logits come back as a DTensor under
``specs.logits_pspec``, the cache as DTensors in its own placements,
updated in place at decode.
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


def require_ported_layout(plan: ShardingPlan, kind: str) -> None:
    """Raises for the layouts the steps of ``kind`` ("train", "prefill" or
    "decode") do not cover, none of which either planner offers
    (``sharding.plan``): training under tensor parallelism beside a
    sequence split (``ctx_tp``, ``seq_tp``) or over two axes (``tp_all``),
    and a decode cache split over ``seq_axes`` without tensor parallelism.
    Every prefill and decode layout the planners offer passes."""
    if kind == "decode" and plan.seq_axes and not plan.tp_axes:
        raise NotImplementedError(
            f"layout {plan.local_layout!r} splits the decode cache over "
            f"seq_axes {plan.seq_axes} without tensor parallelism: no plan "
            "offers it, not ported")
    if kind != "train":
        return
    if len(plan.tp_axes) > 1:
        raise NotImplementedError(
            f"layout {plan.local_layout!r} trains with tensors split over "
            f"two axes {plan.tp_axes}: no plan offers it for training, not "
            "ported")
    if plan.tp_axes and plan.seq_axes:
        raise NotImplementedError(
            f"layout {plan.local_layout!r} trains with a sequence split "
            f"over {plan.seq_axes} beside tensor parallelism over "
            f"{plan.tp_axes}: no plan offers it for training, not ported")


def act_specs(plan: ShardingPlan, decode: bool = False
              ) -> tuple[specs.Spec, specs.Spec]:
    """The activation (B, T, d) and logits (B, T, V) specs the plan
    publishes (the reference's ``dryrun._plan_act_specs``).  At decode the
    sequence entry is dropped: ``ctx_tp`` names ``data`` there, on a T of
    1 that no split divides (the reference's constraint fails and is
    skipped), and nothing may treat the decode token as split."""
    ax = specs._ax
    seq = None if decode else ax(plan.seq_axes)
    return (specs.Spec(ax(plan.batch_axes), seq, None),
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
    compute is replicated, and over the tp axis where the leaf is
    replicated over it)."""

    def __init__(self, mesh, plan: ShardingPlan, toks: tuple[str, ...],
                 num_experts: int | None):
        from torch.distributed.tensor import Partial, Replicate
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self.replicate = tuple(Replicate() for _ in names)
        self.grad = tuple(Partial() if a in toks else Replicate()
                          for a in names)
        # under tensor parallelism every leaf keeps its shards over the tp
        # axes; only its FSDP dims are gathered
        self.tp_dims = tuple(names.index(a) for a in plan.tp_axes)
        # the mesh dim the expert stacks keep their experts split over
        self.ep_dim = None
        if num_experts and plan.moe_impl in ("ep_a2a", "ep_a2a_q8"):
            i = names.index(ep_axis_of(mesh, plan))
            if num_experts % mesh.shape[i] == 0:
                self.ep_dim = i

    def compute(self, path: tuple, leaf) -> tuple[tuple, tuple]:
        """(compute placements, gradient placements) of a layer's leaf; the
        expert dim of an expert stack is its third from last."""
        if self.tp_dims:
            from torch.distributed.tensor import Partial
            pl, gp = list(self.replicate), list(self.grad)
            for i in self.tp_dims:
                own = leaf.placements[i]
                pl[i] = own
                # a shard's gradient is whole over the group (the crossings'
                # backward brings every rank's part); a replicated leaf's,
                # like a replicated activation's, is each rank's partial
                gp[i] = own if own.is_shard() else Partial()
            return tuple(pl), tuple(gp)
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
def local_view(mesh, plan: ShardingPlan, gather: _Gather,
               decode: bool = False):
    """The plan's specs, mesh and EP axis published, and the per-layer
    gather installed, for the model code's run on local tensors."""
    act, logits = act_specs(plan, decode)
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


def require_sharded_family(cfg) -> None:
    """The sharded steps compute every family but ``hybrid_moe``, whose
    per-kind stacks and caches have no sharding specs."""
    if cfg.family == "hybrid_moe":
        raise NotImplementedError(
            f"{cfg.name}: the hybrid_moe family has no sharded step; it "
            "serves on one device through Model.apply_prefill/apply_decode")


def make_sharded_grad_fn(model, plan: ShardingPlan, mesh) -> Callable:
    """Returns grads(params, batch) -> (loss, gradients): ``params``
    DTensors (``specs.param_shardings``), ``batch`` the global batch, which
    every rank holds and the step splits by ``specs.batch_pspec``; the loss
    is the global mean, the same on every rank, and the gradients DTensors
    in their parameters' placements.  The microbatch count, remat,
    ``remat_group`` and ``moe_impl`` come from the plan, as in
    ``train_loop.make_train_step``."""
    require_sharded_family(model.cfg)
    require_ported_layout(plan, "train")
    cfg = model.cfg
    n_micro = max(plan.microbatches, 1)
    sizes = specs.axis_sizes(mesh)
    n_tp = sizes[plan.tp_axes[0]] if plan.tp_axes else 1
    num_experts = cfg.moe.num_experts if cfg.moe is not None else None

    def grads_of(params, batch, gather, tp, frac):
        """(this rank's share of the loss, gradients as DTensors)."""
        with torch.enable_grad(), local_view(mesh, plan, gather), \
                shard_ctx.tensor_parallel(tp):
            ps = tree.map(lambda p: p.detach().requires_grad_(True), params)
            loss = train_loop.loss_fn(
                model, local_params(ps, gather), batch, remat=plan.remat,
                remat_group=getattr(plan, "remat_group", 1),
                moe_impl=plan.moe_impl) * frac
            # the ranks of a tp group hold the same tokens: each takes its
            # 1/tp of their loss (``comm``'s convention)
            grads = torch.autograd.grad(loss / n_tp, tree.leaves(ps))
        # each gradient in its parameter's placements (reduced, not partial)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 for g, p in zip(grads, tree.leaves(params))]
        return loss.detach(), tree.unflatten(params, grads)

    def grad_fn(params, batch):
        toks = token_axes(mesh, batch, plan)
        gather = _Gather(mesh, plan, toks, num_experts)
        tp = tp_state(mesh, plan, prompt_cache_meta(model, batch))
        batch = local_batch(mesh, batch, plan)
        n_tok = 1
        for a in toks:
            n_tok *= sizes[a]
        # each rank's loss is its token mean over the ranks the tokens are
        # split over: the ranks' sum is the global mean.  Ranks that repeat
        # one another's tokens (the tp group, an axis the batch does not
        # divide over) count 1/r each in the reported loss
        frac = 1.0 / n_tok
        if n_micro == 1:
            loss, grads = grads_of(params, batch, gather, tp, frac)
        else:
            micro = train_loop._split_microbatches(batch, n_micro)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = tree.map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for i in range(n_micro):
                mb_loss, g = grads_of(params,
                                      {k: v[i] for k, v in micro.items()},
                                      gather, tp, frac)
                for acc, gi in zip(tree.leaves(grads), tree.leaves(g)):
                    acc.add_(gi)                  # fp32 accumulation
                loss = loss + mb_loss
            loss = loss / n_micro
            grads = tree.map(lambda g: g / n_micro, grads)
        return _sum_over_mesh(loss / (mesh.size() // n_tok), mesh), grads

    return grad_fn


def make_sharded_train_step(model, opt_cfg: optim.OptConfig,
                            plan: ShardingPlan, mesh) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): ``params`` and ``opt_state`` DTensors (``specs.
    param_shardings`` and ``optimizer.init`` on them), ``batch`` the global
    batch (``make_sharded_grad_fn``); the metrics are global, the same on
    every rank."""
    grad_fn = make_sharded_grad_fn(model, plan, mesh)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        params, opt_state, metrics = optim.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _sum_over_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    return comm.all_reduce(x, optim._world_of(mesh))


# --------------------------------------------------------------------------
# Serving: the sharded prefill and decode steps
# --------------------------------------------------------------------------

def axes_group(mesh, axes: tuple[str, ...]) -> shard_ctx.Group:
    """The ``ctx.Group`` of the mesh axes ``axes``: its process group
    (``comm.mesh_group``), this rank's data-major index and the width."""
    if not axes:
        return shard_ctx.NO_SPLIT
    names = list(mesh.mesh_dim_names)
    idx = [names.index(a) for a in axes]
    if idx != sorted(idx):
        raise NotImplementedError(
            f"axes {axes} are not in the mesh's order {tuple(names)}")
    rank, size = 0, 1
    for i in idx:
        rank = rank * mesh.shape[i] + mesh.get_local_rank(i)
        size *= mesh.shape[i]
    return shard_ctx.Group(axes=tuple(axes),
                           group=comm.mesh_group(mesh, tuple(axes)),
                           rank=rank, size=size)


def tp_state(mesh, plan: ShardingPlan, cache: dict
             ) -> shard_ctx.TPState | None:
    """The tensor-parallel state of a step over ``cache`` (whole shapes:
    DTensors, or ``meta`` stand-ins of a prompt's cache): the group of the
    tp axes and of each of their sub-sets in the mesh's order (the weight
    dims' splits), and where ``specs.cache_specs_tree`` (after
    ``sanitize``) splits each cache leaf: the KV heads, the KV sequence
    (the plan's ``seq_axes`` and the tp axes the heads do not divide), the
    cross caches' heads, the SSM heads and the conv channels.  None without
    ``tp_axes``."""
    if not plan.tp_axes:
        return None
    names = list(mesh.mesh_dim_names)
    tp_axes = tuple(sorted(plan.tp_axes, key=names.index))
    subsets = [tuple(a for j, a in enumerate(tp_axes) if m >> j & 1)
               for m in range(1 << len(tp_axes))]
    groups = {sub: axes_group(mesh, sub) for sub in subsets}
    sp = specs.cache_specs_tree(mesh, cache, plan)

    def on(name: str, dim: int) -> shard_ctx.Group:
        if name not in sp:
            return shard_ctx.NO_SPLIT
        return axes_group(mesh, specs._entry_axes(sp[name][dim]))

    seq = on("k", -3)
    return shard_ctx.TPState(
        mesh=mesh, tp=groups[tp_axes], groups=groups,
        kv_heads=on("k", -2), kv_seq=seq,
        kv_seq_tp=axes_group(mesh, tuple(a for a in seq.axes
                                         if a not in plan.seq_axes)),
        xkv=on("xk", -2), ssm_heads=on("h", -3), conv=on("conv", -1))


def prompt_cache_meta(model, batch: dict) -> dict:
    """``meta`` stand-ins of the cache a prefill of ``batch`` returns: its
    length is the prompt's (the audio family's cross rows the frames', the
    VLM's the vision tokens')."""
    from repro_torch.models import encdec, transformer, vlm
    cfg = model.cfg
    b, t = batch["tokens"].shape
    meta = torch.device("meta")
    if cfg.family == "audio":
        return encdec.init_cache(cfg, b, t, batch["frames"].shape[1], meta)
    if cfg.family == "vlm":
        return vlm.init_cache(cfg, b, t, meta)
    return transformer.init_cache(cfg, b, t, meta)


def _as_dtensor(mesh, local: torch.Tensor, spec: specs.Spec, shape):
    from torch.distributed.tensor import DTensor
    shape = tuple(int(s) for s in shape)
    return DTensor.from_local(local, mesh, specs.placements(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=specs._contiguous_stride(shape))


def _logits_out(mesh, plan: ShardingPlan, logits: torch.Tensor,
                batch: dict, vocab: int):
    shape = (batch["tokens"].shape[0], logits.shape[1], vocab)
    return _as_dtensor(mesh, logits, specs.logits_pspec(mesh, plan, shape),
                       shape)


def serving_params(params: dict, gather: _Gather
                   ) -> tuple[dict, _Gather | None]:
    """The tree a serving step computes with, and the per-layer gather to
    publish.  Where every leaf already lies as the layers compute with it
    (no FSDP dim to gather: ``dp_tp``, ``P1_pure_dp``), every local shard
    at once and no gather, so that the step runs no DTensor op (a layer's
    ten redistributions cost about 2 ms of host time at decode); else
    ``local_params`` and the per-layer gather."""
    placed = []
    specs.tree_map_with_path(lambda path, x: placed.append(
        tuple(x.placements) == gather.compute(path, x)[0]), params)
    if all(placed):
        return specs.tree_map_with_path(lambda _, x: x.to_local(),
                                        params), None
    return local_params(params, gather), gather


def _shapes(tree: dict) -> tuple:
    return tuple((k, tuple(v.shape)) for k, v in tree.items())


class _ServingSetup:
    """What a serving step derives from its plan, mesh, parameters and
    shapes: the tree the model computes with and the gather
    (``serving_params``), the ``TPState`` and the cache's specs.  Worked
    out on the first call and again only when the parameters' leaves or
    the batch's or cache's shapes change; a decode step reuses them.  It
    keeps the leaves it was given, so their ids stay theirs.  Under an FSDP
    dim the parameters outside the stacks are gathered anew each call, as
    the train step does, rather than kept whole."""

    def __init__(self, model, plan: ShardingPlan, mesh):
        self.model, self.plan, self.mesh = model, plan, mesh
        self._key = None
        self._leaves: list = []
        self._val: tuple = ()

    def __call__(self, params: dict, batch: dict, cache: dict) -> tuple:
        """(tree, gather, TPState, cache specs) for ``cache``'s whole
        shapes (DTensors, or ``meta`` stand-ins)."""
        leaves = tree.leaves(params)
        key = (tuple(map(id, leaves)), _shapes(batch), _shapes(cache))
        if key != self._key:
            cfg, mesh, plan = self.model.cfg, self.mesh, self.plan
            gather = _Gather(mesh, plan, token_axes(mesh, batch, plan),
                             cfg.moe.num_experts if cfg.moe else None)
            ps, gather = serving_params(params, gather)
            tp = tp_state(mesh, plan, cache)
            sp = specs.cache_specs_tree(mesh, cache, plan)
            self._val = (None if gather else ps, gather, tp, sp)
            self._key, self._leaves = key, leaves
            return ps, gather, tp, sp
        ps, gather, tp, sp = self._val
        if gather is not None:
            ps = local_params(params, gather)
        return ps, gather, tp, sp


def make_sharded_prefill(model, plan: ShardingPlan, mesh) -> Callable:
    """Returns prefill(params, batch) -> (logits, cache): ``params`` bf16
    DTensors (``specs.param_shardings``), ``batch`` the global batch every
    rank holds (split here by ``specs.batch_pspec``).  The last position's
    logits (B, 1, V) come back as a DTensor under ``specs.logits_pspec``,
    the prompt's cache as DTensors under ``specs.cache_specs_tree`` of its
    shapes (the reference's ``out_shardings``)."""
    require_sharded_family(model.cfg)
    require_ported_layout(plan, "prefill")
    cfg = model.cfg
    setup = _ServingSetup(model, plan, mesh)

    def prefill(params, batch):
        whole = prompt_cache_meta(model, batch)
        ps, gather, tp, sp = setup(params, batch, whole)
        local = local_batch(mesh, batch, plan)
        with torch.no_grad(), local_view(mesh, plan, gather), \
                shard_ctx.tensor_parallel(tp):
            logits, cache = model.apply_prefill(ps, local,
                                                moe_impl=plan.moe_impl)
        cache = {k: _as_dtensor(mesh, v, sp[k], whole[k].shape)
                 for k, v in cache.items()}
        return _logits_out(mesh, plan, logits, batch, cfg.vocab), cache

    return prefill


def make_sharded_decode(model, plan: ShardingPlan, mesh) -> Callable:
    """Returns decode(params, cache, batch) -> (logits, cache): one token a
    sequence at position ``lengths - 1`` (``batch`` global, ``tokens`` (B,
    1) and ``lengths`` (B,)); ``cache`` DTensors under ``specs.
    cache_shardings``, written in place (the reference donates it) and
    returned; the logits (B, 1, V) a DTensor under ``specs.logits_pspec``."""
    require_sharded_family(model.cfg)
    require_ported_layout(plan, "decode")
    cfg = model.cfg
    setup = _ServingSetup(model, plan, mesh)

    def decode(params, cache, batch):
        ps, gather, tp, _ = setup(params, batch, cache)
        local = local_batch(mesh, batch, plan)
        lc = {k: v.to_local() for k, v in cache.items()}
        with torch.no_grad(), local_view(mesh, plan, gather, decode=True), \
                shard_ctx.tensor_parallel(tp):
            logits, _ = model.apply_decode(ps, lc, local,
                                           moe_impl=plan.moe_impl)
        return _logits_out(mesh, plan, logits, batch, cfg.vocab), cache

    return decode
