"""The expert-parallel MoE step at an EP axis of width 1, ported from
``repro.models.moe_ep.moe_ep_a2a``.

On one GPU the JAX function's all-to-alls are identities, and what is left
is its local step (``moe_ep.py:147-225`` there), which this module computes:

  1. routing (fp32 softmax, top-k, renormalised), as ``layers.moe_router``;
  2. the capacity bound: of the t·k assignments, those whose flat index is
     below ``cap`` are kept (the reference's ``pos < cap`` at width 1);
  3. the kept assignments sorted by expert, and three grouped products over
     the experts' token groups (gate, up, then down after the fp32 SiLU);
  4. the rows put back in assignment order and combined, weighted, in fp32.

The grouped product is ``torch._grouped_mm``, the counterpart of the XLA
primitive ``jax.lax.ragged_dot`` (no Pallas kernel computes it in the JAX
package).  It takes the sorted rows (n, d), the expert stack (E, d, f) as it
lies in the parameters and the groups' int32 end offsets, reads only the
experts that have rows, and accepts empty groups.  The all-to-all over
several GPUs comes with the multi-GPU slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as L
from .config import ArchConfig


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _world_size() -> int:
    dist = torch.distributed
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def capacity(t: int, top_k: int, capacity_factor: float) -> int:
    """Assignments kept of the t·k routed ones (``moe_ep.py:161`` at an EP
    axis of width 1)."""
    return _round_up(max(int(t * top_k * capacity_factor), 8), 8)


def moe_ep_a2a(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
               capacity_factor: float | None = None) -> torch.Tensor:
    """x: (B, T, d); p: one layer's MoE parameters (router (d, E), w_gate and
    w_up (E, d, f), w_down (E, f, d)).  Returns (B, T, d) in x's dtype, like
    ``layers.moe_dense``; assignments beyond the capacity add nothing."""
    if _world_size() > 1:
        raise NotImplementedError(
            "the all-to-all across GPUs comes with the multi-GPU slice; this "
            "port runs moe_ep_a2a at an EP axis of width 1, in one process")
    spec = cfg.moe
    k = spec.top_k
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    vals, idx = L.moe_router(spec, p["router"], x2)
    cap = capacity(t, k, capacity_factor or spec.capacity_factor)
    n = min(t * k, cap)
    flat_e = idx.reshape(-1)[:n]
    flat_w = vals.reshape(-1)[:n]
    flat_tok = torch.arange(n, device=x.device) // k
    # sort by expert; the groups' end offsets are cumsum(bincount(ids, E)),
    # read off the sorted ids (CUDA's bincount syncs with the host for the
    # largest id, searchsorted does not)
    sorted_e, order = torch.sort(flat_e, stable=True)
    offs = torch.searchsorted(
        sorted_e, torch.arange(spec.num_experts, dtype=sorted_e.dtype,
                               device=x.device), right=True).to(torch.int32)
    xs = x2[flat_tok[order]].to(torch.bfloat16)
    gate = torch._grouped_mm(xs, p["w_gate"].to(torch.bfloat16), offs=offs)
    up = torch._grouped_mm(xs, p["w_up"].to(torch.bfloat16), offs=offs)
    h = F.silu(gate.float()).to(torch.bfloat16) * up
    out = torch._grouped_mm(h, p["w_down"].to(torch.bfloat16), offs=offs)
    back = torch.empty_like(out)
    back[order] = out                                   # unsort
    contrib = back.float() * flat_w[:, None]
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, flat_tok, contrib)
    return y.reshape(b, s, d).to(x.dtype)
