"""GPipe-style pipeline parallelism over the ``pod`` axis, ported from
``repro.sharding.pipeline``: the accelerator rendering of HiDP's *global
model partitioning* (layer blocks pipelined across nodes).

Each rank of the ``pod`` axis holds a contiguous stage of layers (the
stacked parameters reshaped (S, L/S, ...) and split on the stage dim).
Microbatches stream through M + S − 1 ticks; stage 0 embeds its microbatch
at every tick, activations hop stages with ``_PPermute`` (a send to stage
+ 1 and a receive from stage − 1 over ``batch_isend_irecv``, its gradient
sent the other way), and the last stage's outputs are zero-masked and summed
over the ``pod`` group (``_SumOverStages``) back to every rank.  Autograd
through the ticks gives the GPipe forward-then-backward schedule; the bubble
fraction (S−1)/(M+S−1) is what the HiDP global DP weighs against data
partitioning's gradient all-reduce.

The reference's ``shard_map`` differentiates its replicated inputs by
summing over the devices; here each rank's loss is the same global loss,
counted once: the summed outputs pass their gradient straight through, and
the embedding, which only stage 0 reads for its input, sums its gradient
over the stages (``_SumGradOverStages``).  Every rank computes every tick,
as the reference's ``where(stage == 0, ...)`` does, so that each collective
of the backward pass runs on every rank.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig
from repro_torch.training import optimizer as optim
from repro_torch.training import train_loop, tree
from . import comm, specs


def stage_params(cfg: ArchConfig, params: dict, n_stages: int) -> dict:
    """Reshape the stacked layer params (L, ...) → (S, L/S, ...)."""
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers not divisible into "
                         f"{n_stages} stages")
    per = cfg.n_layers // n_stages
    out = dict(params)
    out["layers"] = tree.map(
        lambda a: a.reshape((n_stages, per) + tuple(a.shape[1:])),
        params["layers"])
    return out


def stage_param_specs(params_staged: dict, axis: str = "pod") -> dict:
    """The stage dim over ``axis``, everything else replicated (weights
    stay stage-resident; no intra-stage sharding, as in the reference)."""
    return specs.tree_map_with_path(
        lambda path, leaf: (specs.Spec(axis) if path[0] == "layers"
                            else specs.Spec()), params_staged)


def stage_param_shardings(mesh, params_staged: dict, axis: str = "pod",
                          device=None) -> dict:
    """``params_staged`` as DTensors placed by ``stage_param_specs``: each
    rank keeps its stage (1, L/S, ...) of the layers."""
    return specs.distribute(mesh, params_staged,
                            stage_param_specs(params_staged, axis), device)


# --------------------------------------------------------------------------
# Collectives over the stages, with their gradients
# --------------------------------------------------------------------------

def _send_recv(x: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Send ``x`` to the group's rank ``to`` and receive a tensor like it
    from ``frm``."""
    import torch.distributed as dist
    out = torch.empty_like(x)
    x = x.contiguous()
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, frm),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    """The reference's ``ppermute`` over the ring of stages: forward to
    stage + 1, the gradient back to stage − 1."""

    @staticmethod
    def forward(ctx, y, group, stage: int, n: int):
        ctx.group, ctx.stage, ctx.n = group, stage, n
        if n == 1:
            return y.clone()
        return _send_recv(y, group, (stage + 1) % n, (stage - 1) % n)

    @staticmethod
    def backward(ctx, g):
        if ctx.n == 1:
            return g, None, None, None
        return (_send_recv(g, ctx.group, (ctx.stage - 1) % ctx.n,
                           (ctx.stage + 1) % ctx.n), None, None, None)


class _SumOverStages(torch.autograd.Function):
    """The reference's ``psum`` of the masked outputs: a sum over the
    stages forward; the gradient, the same on every rank, passes through."""

    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGradOverStages(torch.autograd.Function):
    """The identity forward; the gradient summed over the stages (a
    replicated input that only some stages use)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g, ctx.group), None


# --------------------------------------------------------------------------
# The pipelined stack
# --------------------------------------------------------------------------

def _stage_local(x, stage: int, n_stages: int):
    """A layers leaf of this rank's stage (L/S, ...): from a DTensor's
    local (1, L/S, ...) shard, or from a whole (S, L/S, ...) tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.to_local()[0]
    return x[stage] if x.shape[0] == n_stages else x[0]


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def pipeline_hidden(cfg: ArchConfig, params_staged: dict,
                    tokens: torch.Tensor, *, mesh, n_stages: int,
                    microbatches: int, axis: str = "pod") -> torch.Tensor:
    """Forward through the pipelined stack.  tokens: (B, T) integer, the
    same on every rank.  Returns the final-normed hidden states (B, T, d),
    the same on every rank of ``axis``."""
    B, T = tokens.shape
    M = microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    mb = B // M
    names = list(mesh.mesh_dim_names)
    i = names.index(axis)
    if mesh.shape[i] != n_stages:
        raise ValueError(f"{n_stages} stages over a {axis!r} axis of "
                         f"{mesh.shape[i]}")
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(i)
    layers = transformer.unstack(tree.map(
        lambda a: _stage_local(a, stage, n_stages), params_staged["layers"]))
    embed_p = {k: _SumGradOverStages.apply(_local(v), group)
               for k, v in params_staged["embed"].items()}
    norm_p = tree.map(_local, params_staged["final_norm"])
    tokens_m = tokens.reshape(M, mb, T)
    positions = torch.arange(T, device=tokens.device)[None].expand(mb, T)

    def run_stage(x):
        for p in layers:
            x, _ = transformer.apply_layer(
                cfg, p, x, mode="train", positions=positions, window=None,
                layer_cache=None, lengths=None)
        return x

    d = cfg.d_model
    first = torch.tensor(stage == 0, device=tokens.device)
    last = stage == n_stages - 1
    zero = torch.zeros((mb, T, d), dtype=torch.bfloat16,
                       device=tokens.device)
    buf, masked = zero, []
    for t in range(M + n_stages - 1):
        emb = L.embed(embed_p, tokens_m[min(t, M - 1)]).to(torch.bfloat16)
        y = run_stage(torch.where(first, emb, buf))
        # the last stage finished microbatch t − S + 1; every tick's output
        # enters the masked sum, zero where it is no output, so that the
        # loss reaches every tick on every rank and each hop's backward
        # runs everywhere
        valid = torch.tensor(last and t >= n_stages - 1,
                             device=tokens.device)
        masked.append(torch.where(valid, y, zero))
        buf = _PPermute.apply(y, group, stage, n_stages)
    outs = masked[n_stages - 1:]
    outs[0] = outs[0] + sum(masked[:n_stages - 1], zero)   # the bubble: 0
    # only the last stage holds real outputs: sum the masked stack
    x = _SumOverStages.apply(torch.stack(outs), group).reshape(B, T, d)
    return L.apply_norm(cfg, norm_p, x)


def make_pipeline_train_step(model, opt_cfg: optim.OptConfig, plan, mesh):
    """Pipeline-parallel training step (CE loss over the pipelined hidden),
    train_step(params_staged, opt_state, batch) -> (params, opt_state,
    metrics) with ``params_staged`` from ``stage_param_shardings`` and
    ``optimizer.init`` on them.  The batch stays whole on every rank, as in
    the reference (stage-resident weights); the planner prices this against
    data mode through the bubble term."""
    cfg = model.cfg
    S = plan.pipeline_stages
    M = max(plan.microbatches, S)

    def loss_fn(params_staged, batch):
        hidden = pipeline_hidden(cfg, params_staged, batch["tokens"],
                                 mesh=mesh, n_stages=S, microbatches=M)
        head = {"embed": tree.map(_local, params_staged["embed"])}
        return train_loop.chunked_ce_loss(model, head, hidden,
                                          batch["targets"], chunks=8)

    def train_step(params_staged, opt_state, batch):
        with torch.enable_grad():
            ps = tree.map(lambda p: p.detach().requires_grad_(True),
                          params_staged)
            loss = loss_fn(ps, batch)
            grads = torch.autograd.grad(loss, tree.leaves(ps))
        grads = tree.unflatten(params_staged, grads)
        params_staged, opt_state, metrics = optim.apply_updates(
            opt_cfg, params_staged, grads, opt_state)
        metrics["loss"] = loss.detach()
        return params_staged, opt_state, metrics

    return train_step
