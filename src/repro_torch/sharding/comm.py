"""The collectives the port's model code issues on local tensors, over a
process group: functional collectives (``torch.distributed.
_functional_collectives``), which every backend runs (NCCL on the card,
gloo on the CPU, the fake group of the dry-run) and a dispatch mode sees
(``launch.dryrun``'s collective record).  The ``*_autograd`` ones carry
gradients: an all-gather's is a reduce-scatter, an all-to-all's the
reverse all-to-all."""

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
