"""The expert-parallel MoE step, ported from
``repro.models.moe_ep.moe_ep_a2a``: routed tokens go to the ranks that own
their experts over an all-to-all, through grouped products there, and back.

With no mesh published (``sharding.ctx``), the step runs at an EP axis of
width 1, in this process: the reference's all-to-alls are identities there,
and what is left is its local step (``moe_ep.py:147-225`` there):

  1. routing (fp32 softmax, top-k, renormalised), as ``layers.moe_router``;
  2. the capacity bound: of the t·k assignments, those whose flat index is
     below ``cap`` are kept (the reference's ``pos < cap`` at width 1);
  3. the kept assignments sorted by expert, and three grouped products over
     the experts' token groups (gate, up, then down after the fp32 SiLU);
  4. each row weighted in fp32 and added to its token (``index_add_``).

The same step without the capacity bound, every assignment kept, is the
inference lowering (``moe_routed``, "routed" in ``layers.moe_apply``), which
``Model.apply_prefill`` and ``apply_decode`` take by default: the serving
engine computes each token's top-k experts and no other.

With a mesh published, the step is the reference's across the ranks of the
EP axis (``_ep_step``): each rank routes its own token slice (or, when the
sequence is already split over the EP axis, its own tokens), fills
capacity-bounded (ep, cap, d) dispatch buffers by destination rank and
position, exchanges them with ``all_to_all_single`` (autograd-aware),
computes its local experts' grouped products, sends the rows back and
combines them, then all-gathers the token slices over the EP axis unless
the tokens were its own.  Fewer experts than EP ranks replicate each expert
over ``ep // E`` ranks; counts that divide neither way, or a token slice
that does not divide, run ``layers.moe_dense`` as the reference does.
Expert stacks may come whole (E, d, f), and the rank takes its experts, or
as the rank's own (E / ep, d, f), as the sharded step gathers them.

With ``a2a_dtype="int8"`` (the ``"ep_a2a_q8"`` lowering) the payload of
both all-to-alls crosses as int8 with fp32 row scales, as in the reference
(``_a2a_i8``, ``moe_ep.py:40-71`` there), with a straight-through gradient
that is itself quantised on the reverse all-to-all.  At width 1 the
all-to-alls are identities and only the quantisation round trip is left
(``A2AInt8Fn``), applied where the reference applies it, to the gathered
token rows in x's dtype before the bf16 cast and to the grouped output cast
to fp32 before the combine.

The grouped product is ``torch._grouped_mm``, the counterpart of the XLA
primitive ``jax.lax.ragged_dot`` (no Pallas kernel computes it in the JAX
package).  It takes the sorted rows (n, d), the expert stack (E, d, f) as it
lies in the parameters and the groups' int32 end offsets, reads only the
experts that have rows, and accepts empty groups; autograd differentiates
it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import comm
from repro_torch.sharding import ctx as shard_ctx
from . import layers as L
from .config import ArchConfig


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(t: int, top_k: int, capacity_factor: float) -> int:
    """Assignments kept of the t·k routed ones (``moe_ep.py:161`` at an EP
    axis of width 1)."""
    return _round_up(max(int(t * top_k * capacity_factor), 8), 8)


A2A_DTYPES = ("bfloat16", "int8")


def _quant_i8(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantisation (rows = tokens): the fp32 scale
    max|v| / 127 + 1e-12, then the values divided by it, rounded half to
    even and clipped to ±127.  Returns (int8 values, fp32 scales (..., 1))."""
    vf = v.float()
    scale = vf.abs().amax(-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(vf / scale), -127, 127).to(torch.int8)
    return q, scale


def _round_trip_i8(v: torch.Tensor) -> torch.Tensor:
    """``v`` quantised to int8 and back, in v's dtype."""
    q, s = _quant_i8(v)
    return (q.float() * s).to(v.dtype)


class A2AInt8Fn(torch.autograd.Function):
    """The int8 all-to-all at an EP axis of width 1: the forward returns
    the payload's quantisation round trip; the backward passes the gradient
    straight through, itself quantised (the reference's ``_a2a_i8`` and its
    ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, v: torch.Tensor) -> torch.Tensor:
        return _round_trip_i8(v)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return _round_trip_i8(g)


#: calls of the step at an EP axis of width 1 in this process (``moe_routed``,
#: and ``moe_ep_a2a`` with no mesh published), as the kernel wrappers count
#: their ``launches``
calls = 0


def moe_routed(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The inference lowering ("routed"): the step at an EP axis of width 1
    over every one of the t·k assignments, whatever the capacity factor.
    This is ``layers.moe_dense``'s arithmetic (its router, bf16 products,
    the SiLU in fp32 rounded to bf16, the fp32 combine with the same
    weights) without the experts a token is not routed to.  The expert
    stacks must be whole: under a published mesh or tensor-parallel state
    they may be shards, and the sharded steps pass their plan's lowering."""
    if shard_ctx.get_mesh() is not None or shard_ctx.tp() is not None:
        raise ValueError("moe impl 'routed' runs on whole expert stacks in "
                         "this process; a sharded step passes its plan's "
                         "moe_impl")
    return _width_one(cfg, p, x, None, "bfloat16")


def moe_ep_a2a(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
               axis: str | None = None,
               capacity_factor: float | None = None,
               a2a_dtype: str = "bfloat16") -> torch.Tensor:
    """x: (B, T, d), this rank's block under the published activation spec;
    p: one layer's MoE parameters (router (d, E), w_gate and w_up (E, d, f),
    w_down (E, f, d), or the rank's experts of them).  Returns (B, T, d) in
    x's dtype, like ``layers.moe_dense``; assignments beyond the capacity
    add nothing.  ``axis``: the EP mesh axis (the context's by default);
    ``a2a_dtype``: the all-to-alls' payload, "bfloat16" or "int8"."""
    if a2a_dtype not in A2A_DTYPES:
        raise ValueError(f"a2a_dtype {a2a_dtype!r} not in {A2A_DTYPES}")
    mesh = shard_ctx.get_mesh()
    cf = capacity_factor or cfg.moe.capacity_factor
    if mesh is not None:
        return _ep_step(cfg, p, x, mesh,
                        axis or shard_ctx.get_ep_axis() or "model", cf,
                        a2a_dtype)
    b, s, _ = x.shape
    return _width_one(cfg, p, x, capacity(b * s, cfg.moe.top_k, cf),
                      a2a_dtype)


def _width_one(cfg: ArchConfig, p: dict, x: torch.Tensor, cap: int | None,
               a2a_dtype: str) -> torch.Tensor:
    """The step at an EP axis of width 1: of the t·k assignments in flat
    order the first ``cap`` (all of them with None), sorted by expert,
    through the three grouped products, weighted and added to their tokens
    in fp32.  It reads nothing back to the host."""
    global calls
    calls += 1
    spec = cfg.moe
    k = spec.top_k
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    vals, idx = L.moe_router(spec, p["router"], x2)
    n = t * k if cap is None else min(t * k, cap)
    # sort by expert; the groups' end offsets are cumsum(bincount(ids, E)),
    # read off the sorted ids (CUDA's bincount syncs with the host for the
    # largest id, searchsorted does not)
    sorted_e, order = torch.sort(idx.reshape(-1)[:n], stable=True)
    offs = torch.searchsorted(
        sorted_e, torch.arange(spec.num_experts, dtype=sorted_e.dtype,
                               device=x.device), right=True, out_int32=True)
    tok = order // k                          # each sorted row's token
    xs = x2[tok]
    if a2a_dtype == "int8":
        xs = A2AInt8Fn.apply(xs)
    # the products in bf16 (the reference's literal jnp.bfloat16, which is
    # layers.COMPUTE_DTYPE); F.silu on bf16 evaluates in fp32 and rounds
    bf = L.COMPUTE_DTYPE
    xs = xs.to(bf)
    gate = torch._grouped_mm(xs, p["w_gate"].to(bf), offs=offs)
    up = torch._grouped_mm(xs, p["w_up"].to(bf), offs=offs)
    h = F.silu(gate) * up
    out = torch._grouped_mm(h, p["w_down"].to(bf), offs=offs)
    if a2a_dtype == "int8":
        out = A2AInt8Fn.apply(out.float())
    # weighted in fp32 (a bf16 row times fp32 weights computes in fp32) and
    # added to the tokens in sorted order: at k = 2 each token's sum is
    # two terms onto zero, the same in either order
    contrib = out * vals.reshape(-1)[order][:, None]
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, tok, contrib)
    return y.reshape(b, s, d).to(x.dtype)


# --------------------------------------------------------------------------
# Across the ranks of the EP axis
# --------------------------------------------------------------------------

class A2AInt8GroupFn(torch.autograd.Function):
    """The reference's ``_a2a_i8`` across ranks: the payload crosses as
    int8 with fp32 row scales and is dequantised to v's dtype on arrival;
    the gradient goes back the same way, itself quantised."""

    @staticmethod
    def forward(ctx, v: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        q, s = _quant_i8(v)
        return (comm.all_to_all(q, group).float()
                * comm.all_to_all(s, group)).to(v.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        q, s = _quant_i8(g)
        return (comm.all_to_all(q, ctx.group).float()
                * comm.all_to_all(s, ctx.group)).to(g.dtype), None


def _a2a_payload(v: torch.Tensor, group, a2a_dtype: str) -> torch.Tensor:
    """The dispatch or return all-to-all of (ep, cap, d) rows."""
    if a2a_dtype == "int8":
        return A2AInt8GroupFn.apply(v, group)
    return comm.all_to_all_autograd(v, group)


def _axes_of(entry) -> set:
    if entry is None:
        return set()
    return set(entry) if isinstance(entry, tuple) else {entry}


def _ep_step(cfg: ArchConfig, p: dict, x: torch.Tensor, mesh, ep_axis,
             cf: float, a2a_dtype: str) -> torch.Tensor:
    """``moe_ep_a2a`` over the EP axis of ``mesh`` (``moe_ep.py:84-232``
    there)."""
    spec = cfg.moe
    k, E = spec.top_k, spec.num_experts
    names = list(mesh.mesh_dim_names)
    if isinstance(ep_axis, str):
        ep = mesh.shape[names.index(ep_axis)]
    else:
        ep = 1
    if E % ep == 0:
        replicas, e_loc = 1, E // ep
    elif ep % E == 0:
        # fewer experts than EP ranks (mixtral's 8 over a 16-wide axis):
        # each expert on ep // E ranks, tokens balanced over its replicas
        replicas, e_loc = ep // E, 1
    else:
        return L.moe_dense(cfg, p, x)
    act_spec = shard_ctx.get_act_spec() or ()
    # the sequence already split over the EP axis: each rank's block is its
    # token slice, no slicing on entry and no all-gather on exit.  So is a
    # batch split over it (the reference slices and all-gathers there as
    # if the blocks were replicated, which mixes the ranks' tokens; no plan
    # of its asks for that)
    pre_sharded = ep_axis in set().union(
        *(_axes_of(e) for e in tuple(act_spec)[:2]))
    bl, tl, d = x.shape
    t_full = bl * tl
    if not pre_sharded and t_full % ep:
        return L.moe_dense(cfg, p, x)
    rank = mesh.get_local_rank(names.index(ep_axis)) if ep > 1 else 0
    group = mesh.get_group(ep_axis)
    x_all = x.reshape(t_full, d)
    if pre_sharded:
        t, x2 = t_full, x_all
    else:
        # activations replicated over the EP axis: each rank owns a 1/ep
        # token slice, so that no assignment is dispatched twice
        t = t_full // ep
        x2 = x_all[rank * t:(rank + 1) * t]
    cap = _round_up(max(int(t * k * cf / ep), 8), 8)
    w_gate, w_up, w_down = (_local_experts(p[n], E, e_loc, replicas, rank)
                            for n in ("w_gate", "w_up", "w_down"))
    # 1. routing (fp32)
    vals, idx = L.moe_router(spec, p["router"], x2)
    flat_e = idx.reshape(-1).long()                          # (t*k,)
    flat_w = vals.reshape(-1)
    flat_tok = torch.arange(t * k, device=x.device) // k
    if replicas == 1:
        dest = flat_e // e_loc
        local_e = flat_e % e_loc
    else:
        dest = flat_e * replicas + (flat_tok % replicas)
        local_e = torch.zeros_like(flat_e)
    # 2. capacity-bounded dispatch buffers: an assignment's position is the
    # count of earlier assignments to its destination; those at or past
    # ``cap`` go to a spare slot that is cut off
    onehot = F.one_hot(dest, ep)
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    keep = pos < cap
    slot = torch.where(keep, pos, cap)
    send_x = x2.new_zeros((ep, cap + 1, d)).index_put(
        (dest, slot), x2[flat_tok])[:, :cap]
    send_el = torch.zeros((ep, cap + 1), dtype=torch.int32,
                          device=x.device).index_put(
        (dest, slot), torch.where(keep, local_e, 0).to(torch.int32))[:, :cap]
    # 3. to the experts' ranks
    recv_x = _a2a_payload(send_x, group, a2a_dtype)
    rel = comm.all_to_all(send_el, group).reshape(ep * cap).long()
    n = ep * cap
    # 4. sorted by local expert, grouped products, unsorted
    sorted_e, order = torch.sort(rel, stable=True)
    offs = torch.searchsorted(
        sorted_e, torch.arange(e_loc, dtype=sorted_e.dtype,
                               device=x.device), right=True).to(torch.int32)
    bf = L.COMPUTE_DTYPE
    xs = recv_x.reshape(n, d)[order].to(bf)
    gate = torch._grouped_mm(xs, w_gate.to(bf), offs=offs)
    up = torch._grouped_mm(xs, w_up.to(bf), offs=offs)
    h = F.silu(gate.float()).to(bf) * up
    out = torch._grouped_mm(h, w_down.to(bf), offs=offs)
    back = torch.empty_like(out)
    back[order] = out                                   # unsort
    back = back.reshape(ep, cap, d)
    # 5. back to the tokens' ranks, and the weighted combine there
    back = _a2a_payload(back.float() if a2a_dtype == "int8" else back,
                        group, a2a_dtype)
    contrib = back[dest, pos.clamp(max=cap - 1)].float()      # (t*k, d)
    contrib = contrib * (flat_w * keep)[:, None]
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    y = y.index_add(0, flat_tok, contrib).to(x.dtype)
    if pre_sharded:
        return y.reshape(bl, tl, d)
    # replication over the EP axis restored: each rank computed its slice
    return comm.all_gather_autograd(y, 0, group).reshape(bl, tl, d)


def _local_experts(w: torch.Tensor, E: int, e_loc: int, replicas: int,
                   rank: int) -> torch.Tensor:
    """This rank's experts of a stack that is whole (E, ...) or already the
    rank's own (e_loc, ...)."""
    if w.shape[0] == E and (E != e_loc or replicas > 1):
        first = rank // replicas if replicas > 1 else rank * e_loc
        return w[first:first + e_loc]
    if w.shape[0] != e_loc:
        raise ValueError(f"expert stack of {w.shape[0]} experts: neither all "
                         f"{E} nor this rank's {e_loc}")
    return w
