"""The train step, ported from ``repro.training.train_loop``: CE loss
(whole or in sequence chunks), microbatched gradient accumulation in fp32
and remat, all driven by a ``ShardingPlan``.

``chunked_ce_loss`` pins each slice's logits with ``shard_ctx.
constrain_logits`` as the reference does: the identity on the local tensors
the port's steps compute with (``sharding.spmd`` runs this same loss on
each rank's shard).  Under tensor parallelism the head gives each rank its
vocab slice of the logits, and the cross entropy reduces over the group
(``_ce``): the reference contracts with a one-hot for the same reason,
so that a vocab-split tensor partitions.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.model import Model
from repro_torch.sharding import comm
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding.plan import ShardingPlan
from . import optimizer as optim
from . import tree


def _gold(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The target's logit at every position.  The reference contracts with a
    one-hot so that a vocab-sharded tensor partitions cleanly; on one device
    a gather reads the same values, without a (B, T, V) one-hot."""
    return logits.gather(-1, targets.long()[..., None])[..., 0]


def _ce(logits: torch.Tensor, targets: torch.Tensor,
        vocab: int | None = None) -> torch.Tensor:
    """The cross entropy at every position.  Where ``logits`` are this
    rank's slice of a ``vocab`` split over the tensor-parallel axes its
    spec names (``TPState.split``; rank r of that group holds ids
    [r·V/n, (r+1)·V/n)), the log-sum-exp and the gold logit
    reduce over the group: the max all-reduced as a max (a constant to
    autograd), then the sum of exponentials and the gold logit (a gather
    masked to the rank's ids) in one all-reduce.  Each rank's value is the
    whole loss of its tokens."""
    tp = shard_ctx.tp()
    vl = logits.shape[-1]
    if tp is None or vocab is None or vl == vocab:
        return torch.logsumexp(logits, dim=-1) - _gold(logits, targets)
    g = tp.split(vl, vocab)
    m = comm.all_reduce(logits.detach().amax(-1), g.group, "max")
    local = targets.long() - g.rank * vl
    mine = (local >= 0) & (local < vl)
    gold = torch.where(mine, _gold(logits, local.clamp(0, vl - 1)), 0.0)
    sums = comm.all_reduce_autograd(
        torch.stack([torch.exp(logits - m[..., None]).sum(-1), gold]),
        g.group)
    return m + torch.log(sums[0]) - sums[1]


def ce_loss(logits: torch.Tensor, targets: torch.Tensor,
            vocab: int | None = None) -> torch.Tensor:
    """Next-token cross entropy, mean over all positions.  logits: (B, T, V)
    fp32, or this rank's vocab slice of them (``_ce``); targets: (B,
    T), already shifted by the data pipeline (targets[t] is the token after
    position t)."""
    return _ce(logits, targets, vocab).mean()


def chunked_ce_loss(model: Model, params: dict, hidden: torch.Tensor,
                    targets: torch.Tensor, chunks: int) -> torch.Tensor:
    """CE computed in sequence slices, so that the fp32 logits working set
    is (B, T/chunks, V) instead of (B, T, V).  Under autograd each slice's
    body is checkpointed: the backward recomputes its logits instead of
    storing them."""
    b, t, d = hidden.shape
    chunks = min(chunks, t)
    while t % chunks:
        chunks -= 1
    hs = hidden.reshape(b, chunks, t // chunks, d).swapaxes(0, 1)
    ts = targets.reshape(b, chunks, t // chunks).swapaxes(0, 1)

    def body(h, tg):
        logits = shard_ctx.constrain_logits(model.unembed_hidden(params, h))
        return _ce(logits, tg, model.cfg.vocab).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for h, tg in zip(hs, ts):
        total = total + (checkpoint(body, h, tg, use_reentrant=False)
                         if torch.is_grad_enabled() else body(h, tg))
    return total / (b * t)


def loss_fn(model: Model, params: dict, batch: dict, *,
            remat: bool = True, moe_impl: str = "dense",
            remat_group: int = 1, loss_chunks: int = 8) -> torch.Tensor:
    if loss_chunks > 1:
        hidden = model.apply_train(params, batch, remat=remat,
                                   remat_group=remat_group,
                                   moe_impl=moe_impl, return_hidden=True)
        return chunked_ce_loss(model, params, hidden, batch["targets"],
                               loss_chunks)
    logits = model.apply_train(params, batch, remat=remat,
                               remat_group=remat_group, moe_impl=moe_impl)
    return ce_loss(logits, batch["targets"], model.cfg.vocab)


def _split_microbatches(batch: dict, n: int) -> dict:
    """(B, ...) → (n, B/n, ...)."""
    return {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def make_train_step(model: Model, opt_cfg: optim.OptConfig,
                    plan: ShardingPlan) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``batch`` holds tensors on the parameters' device.  The
    microbatch count, remat, ``remat_group`` and ``moe_impl`` come from the
    plan; the step consumes ``opt_state`` (``optimizer.apply_updates``)."""
    n_micro = max(plan.microbatches, 1)

    def grads_of(params, batch):
        """(loss, gradients) of one batch, the gradients in the parameters'
        dtype, by autograd from detached copies that require grad."""
        with torch.enable_grad():
            ps = tree.map(lambda p: p.detach().requires_grad_(True), params)
            loss = loss_fn(model, ps, batch, remat=plan.remat,
                           remat_group=getattr(plan, "remat_group", 1),
                           moe_impl=plan.moe_impl)
            grads = torch.autograd.grad(loss, tree.leaves(ps))
        return loss.detach(), tree.unflatten(params, grads)

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = grads_of(params, batch)
        else:
            micro = _split_microbatches(batch, n_micro)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = tree.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(n_micro):
                mb_loss, g = grads_of(params,
                                      {k: v[i] for k, v in micro.items()})
                for acc, gi in zip(tree.leaves(grads), tree.leaves(g)):
                    acc.add_(gi)                  # fp32 accumulation
                loss = loss + mb_loss
            loss = loss / n_micro
            grads = tree.map(lambda g: g / n_micro, grads)
        params, opt_state, metrics = optim.apply_updates(
            opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
