"""The collectives the port's model code issues on local tensors, over a
process group: functional collectives (``torch.distributed.
_functional_collectives``), which every backend runs (NCCL on the card,
gloo on the CPU, the fake group of the dry-run) and a dispatch mode sees
(``launch.dryrun``'s collective record).  The ``*_autograd`` ones carry
gradients: an all-gather's is a reduce-scatter, an all-to-all's the
reverse all-to-all.  The others are forward-only, for serving; each is
issued on the current stream and waited for on the device, without a
host sync."""

from __future__ import annotations

import torch


def _funcol():
    from torch.distributed import _functional_collectives as funcol
    return funcol


def all_gather_autograd(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    f = _funcol()
    gather = getattr(f, "all_gather_single_autograd", None) \
        or f.all_gather_tensor_autograd
    return f.wait_tensor(gather(x.contiguous(), dim, group))


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


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's ranks, without a gradient."""
    f = _funcol()
    return f.wait_tensor(f.all_reduce(x.contiguous(), "sum", group))


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along its leading dim in rank order,
    without a gradient.  c10d's ``all_gather_into_tensor`` (the dispatch
    mode sees it as ``_allgather_base_``): gloo's functional all-gather of
    CUDA tensors crashes the process, its c10d one does not."""
    import torch.distributed as dist
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],
                       *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def all_gather_out_lse(out: torch.Tensor, lse: torch.Tensor, group
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every rank's decode output (B, 1, Hq, D) and fp32 log-sum-exps
    (B, Hq), as (B, Hq, R, D) and (B, Hq, R): one all-gather, the
    log-sum-exps' bytes packed beside the outputs' rows."""
    b, _, hq, d = out.shape
    packed = torch.cat([out.reshape(b, hq, d),
                        lse.contiguous().view(out.dtype).reshape(b, hq, -1)],
                       -1)
    g = all_gather(packed[None], group).permute(1, 2, 0, 3)
    return (g[..., :d].contiguous(),
            g[..., d:].contiguous().view(torch.float32)[..., 0])
