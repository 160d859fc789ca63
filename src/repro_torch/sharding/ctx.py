"""Activation-sharding context, ported from ``repro.sharding.ctx``.

The launcher publishes the HiDP plan's activation and logits specs, the
mesh and the expert-parallel axis here.  The model code pins activations to
them at layer boundaries (``constrain_act`` / ``constrain_logits``): a
DTensor is redistributed to the published placements, a plain tensor comes
back unchanged, as the reference's constraint is a no-op without a mesh.

The port's sharded step runs the model on each rank's local tensors, as the
reference's ``shard_map`` bodies do, and publishes two more things here:

* ``gather_layer``: how one layer's parameters (DTensor shards) become the
  local tensors the layer computes with.  ``sharding.spmd`` sets it; every
  family's layer calls it first, inside the layer's remat checkpoint, so
  that the backward pass gathers again instead of keeping the weights;
* the sequence split, read off the activation spec's sequence entry: under
  it, attention gathers keys and values over ``seq_group()`` and offsets
  its queries by ``seq_offset``.

The tensor-parallel steps (``spmd.make_sharded_grad_fn``,
``make_sharded_prefill`` and ``make_sharded_decode``) publish a ``TPState``
(``tensor_parallel``): the group of the plan's ``tp_axes`` with this rank's
index and its width, and how the caches lie over it, read from
``specs.cache_pspec`` after ``sanitize`` on the caches' real shapes (a
train step reads the layout of the cache its batch's prompt would build,
so that its layers split as the prefill's do).  The layers read it
(``layers``): each weight computes on the shard its spec gives it, and
activations cross the group where a split cuts through heads.  Without it
every accessor gives the unsplit answer (width 1, offset 0), so every other
path is unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

from .specs import Spec, placements

_ACT_SPEC: Spec | None = None       # (batch, seq, d)
_LOGITS_SPEC: Spec | None = None    # (batch, seq, vocab)
_MESH = None                        # DeviceMesh of the collective paths
_EP_AXIS: str | tuple | None = None  # expert-parallel mesh axis
_GATHER: Callable | None = None     # the sharded step's per-layer gather
_TP: "TPState | None" = None        # the tensor-parallel state


def set_specs(act: Spec | None, logits: Spec | None, mesh=None,
              ep_axis=None) -> None:
    global _ACT_SPEC, _LOGITS_SPEC, _MESH, _EP_AXIS
    _ACT_SPEC, _LOGITS_SPEC = act, logits
    _MESH, _EP_AXIS = mesh, ep_axis


@contextlib.contextmanager
def plan_specs(act: Spec | None, logits: Spec | None, mesh=None,
               ep_axis=None):
    prev = (_ACT_SPEC, _LOGITS_SPEC, _MESH, _EP_AXIS)
    set_specs(act, logits, mesh, ep_axis)
    try:
        yield
    finally:
        set_specs(*prev)


def get_mesh():
    return _MESH


def get_ep_axis():
    return _EP_AXIS


def get_act_spec() -> Spec | None:
    return _ACT_SPEC


def _constrain(x, spec: Spec | None):
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x                      # local tensors: the layout is given
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


def constrain_act(x):
    """Pin a (B, T, d) activation to the plan's layout."""
    return _constrain(x, _ACT_SPEC)


def constrain_logits(x):
    return _constrain(x, _LOGITS_SPEC)


# --------------------------------------------------------------------------
# The sharded step's local view
# --------------------------------------------------------------------------

@contextlib.contextmanager
def layer_gather(fn: Callable | None):
    """Publish ``fn(layer_params) -> local layer_params`` for the layers."""
    global _GATHER
    prev, _GATHER = _GATHER, fn
    try:
        yield
    finally:
        _GATHER = prev


def gather_layer(p: Any) -> Any:
    """One layer's parameters as the local tensors it computes with; the
    identity unless a sharded step published a gather."""
    return p if _GATHER is None else _GATHER(p)


def seq_axes() -> tuple[str, ...]:
    """The mesh axes the activations' sequence dim is split over."""
    if _MESH is None or _ACT_SPEC is None or len(_ACT_SPEC) < 2:
        return ()
    e = _ACT_SPEC[1]
    return () if e is None else (tuple(e) if isinstance(e, tuple) else (e,))


def _seq_axis() -> str | None:
    """The one mesh axis of the sequence split, or None without one."""
    axes = seq_axes()
    if len(axes) > 1:
        raise NotImplementedError(
            f"a sequence split over several axes {axes}: no GPU plan asks "
            "for one")
    return axes[0] if axes else None


def seq_group():
    """The process group of the sequence split, or None without one."""
    axis = _seq_axis()
    return None if axis is None else _MESH.get_group(axis)


def seq_rank_size() -> tuple[int, int]:
    """(this rank's index in the sequence split, its width); (0, 1)
    without a split."""
    axis = _seq_axis()
    if axis is None:
        return 0, 1
    i = list(_MESH.mesh_dim_names).index(axis)
    return _MESH.get_local_rank(i), _MESH.shape[i]


def seq_offset(t_local: int) -> int:
    """The global position of this rank's first token."""
    r, _ = seq_rank_size()
    return r * t_local


# --------------------------------------------------------------------------
# Tensor parallelism
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPState:
    """The tensor-parallel layout a step runs under.

    ``kv``: the self-attention cache ``k``/``v`` split over the group by its
    KV heads ("heads"), by its sequence ("seq": this rank holds rows
    [rank·S, (rank+1)·S) of the whole), or whole on every rank (None).
    ``xkv``: the cross caches ``xk``/``xv``, "heads" or None.  ``ssm_heads``
    and ``conv``: the SSM state ``h`` split by heads, the conv context by
    channels."""
    group: Any
    rank: int
    size: int
    kv: str | None = None
    xkv: str | None = None
    ssm_heads: bool = False
    conv: bool = False


@contextlib.contextmanager
def tensor_parallel(state: TPState | None):
    """Publish ``state`` for the model code's run on local tensors."""
    global _TP
    prev, _TP = _TP, state
    try:
        yield
    finally:
        _TP = prev


def tp() -> TPState | None:
    """The published tensor-parallel state, or None outside a tp step."""
    return _TP


def tp_rank_size() -> tuple[int, int]:
    """(this rank's index in the tensor-parallel group, its width); (0, 1)
    without one."""
    return (0, 1) if _TP is None else (_TP.rank, _TP.size)


def k_offset(s_local: int) -> int:
    """The global position of this rank's first self-attention cache row,
    for a share of ``s_local`` rows."""
    if _TP is None or _TP.kv != "seq":
        return 0
    return _TP.rank * s_local


def kv_len(s_local: int) -> int:
    """The whole self-attention cache's length, from this rank's share."""
    if _TP is None or _TP.kv != "seq":
        return s_local
    return s_local * _TP.size
