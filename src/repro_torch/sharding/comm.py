"""The collectives the port's model code issues on local tensors, over a
process group.  Every backend runs them (NCCL on the card, gloo on the CPU
and on CUDA tensors, the fake group of the dry-run) and a dispatch mode
sees them (``launch.dryrun``'s collective record).

The crossings that carry gradients are ``torch.autograd.Function``s with
their backward written out, in one convention: each rank's loss is its
share of the global loss, so that a tensor every rank of a group holds
alike (a replicated activation) carries a partial gradient there, and the
ranks' partials sum to the whole.  Under it:

* an all-gather's gradient is a reduce-scatter (``all_gather_autograd``);
* an all-reduce's gradient is an all-reduce (``all_reduce_autograd``);
* a rank's slice of a replicated tensor needs no collective: autograd's
  own backward of the slice pads the gradient with zeros.

The all-gather and the reduce-scatter are c10d's (gloo's functional
all-gather of CUDA tensors crashes the process, its c10d one does not),
the all-reduce the functional one.  The all-to-all's gradient is the
reverse all-to-all.  Each is issued on the current stream and waited for
on the device, without a host sync.

``mesh_group`` gives the process group over several mesh axes at once (a
tensor-parallel group over ``("data", "model")``, a cache's sequence split
over both), made once per mesh and kept.
"""

from __future__ import annotations

import torch


def _funcol():
    from torch.distributed import _functional_collectives as funcol
    return funcol


# (id of the mesh, its axes) -> (the mesh, kept alive so that its id stays
# its own, and the group)
_GROUPS: dict = {}


def mesh_group(mesh, axes: tuple[str, ...]):
    """The process group over the mesh axes ``axes`` (in the mesh's order):
    the axis's own group for one axis, else the flattened sub-mesh's, its
    ranks data-major (outermost axis first) as a spec entry of several axes
    orders a dim's shards.  Made on the first call for a mesh, by every
    rank at once, and kept."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), tuple(axes))
    if key not in _GROUPS:
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():     # the dry-run's fake tensors
            flat = mesh[tuple(axes)]._flatten("_".join(axes))
        _GROUPS[key] = (mesh, flat.get_group())
    return _GROUPS[key][1]


def _width(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along its leading dim in rank order,
    without a gradient: c10d's ``all_gather_into_tensor`` (the dispatch mode
    sees it as ``_allgather_base_``)."""
    import torch.distributed as dist
    x = x.contiguous()
    out = x.new_empty((_width(group) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the ranks' sum of ``x``, the leading dim cut
    into equal blocks in rank order, without a gradient: c10d's
    ``reduce_scatter_tensor`` (``_reduce_scatter_base_``)."""
    import torch.distributed as dist
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // _width(group), *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or ``op``: "max") over the group's ranks, without a
    gradient."""
    f = _funcol()
    return f.wait_tensor(f.all_reduce(x.contiguous(), op, group))


class AllGatherFn(torch.autograd.Function):
    """The ranks' ``x`` concatenated along ``dim``; the gradient is this
    rank's block of the ranks' summed cotangents (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.group = dim, group
        g = all_gather(x.movedim(dim, 0), group)
        return g.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        out = reduce_scatter(g.movedim(ctx.dim, 0), ctx.group)
        return out.movedim(0, ctx.dim), None, None


class AllReduceFn(torch.autograd.Function):
    """The sum over the ranks; the gradient is the sum of the ranks'
    cotangents (each rank's a partial of the replicated sum's)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_reduce(g, ctx.group), None


def all_gather_autograd(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    return AllGatherFn.apply(x, dim, group)


def all_reduce_autograd(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' ``x``."""
    return AllReduceFn.apply(x, group)


def all_to_all_autograd(x: torch.Tensor, group) -> torch.Tensor:
    """Block i of ``x``'s leading dim to rank i; block j of the result
    from rank j."""
    f = _funcol()
    return f.wait_tensor(f.all_to_all_single_autograd(
        x.contiguous(), None, None, group))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_autograd`` without a gradient."""
    f = _funcol()
    return f.wait_tensor(f.all_to_all_single(x.contiguous(), None, None,
                                             group))


def all_gather_out_lse(out: torch.Tensor, lse: torch.Tensor, group
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every rank's decode output (B, 1, Hq, D) and fp32 log-sum-exps
    (B, Hq) over ``group`` (any group: one axis, or several flattened), as
    (B, Hq, R, D) and (B, Hq, R) in the group's rank order: one all-gather,
    the log-sum-exps' bytes packed beside the outputs' rows."""
    b, _, hq, d = out.shape
    packed = torch.cat([out.reshape(b, hq, d),
                        lse.contiguous().view(out.dtype).reshape(b, hq, -1)],
                       -1)
    g = all_gather(packed[None], group).permute(1, 2, 0, 3)
    return (g[..., :d].contiguous(),
            g[..., d:].contiguous().view(torch.float32)[..., 0])
