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
(``tensor_parallel``): explicit ``Group``s (process group, this rank's
index, width) for the plan's ``tp_axes`` (one axis, or two under
``tp_all``), for each weight dim's split (``TPState.dim``: the axes its
sanitized spec names), and for the caches' head and sequence splits, read
from ``specs.cache_pspec`` after ``sanitize`` on the caches' real shapes
(a train step reads the layout of the cache its batch's prompt would
build, so that its layers split as the prefill's do).  A cache's sequence
may lie over the plan's ``seq_axes`` and the tp axes at once (``ctx_tp``,
``tp_all``).  The layers read it (``layers``): each weight computes on the
shard its spec gives it, and activations cross the group of the axes its
spec names where a split cuts through heads.  Without it every accessor
gives the unsplit answer (width 1, offset 0), so every other path is
unchanged.
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
            f"an activation sequence split over several axes {axes}: no "
            "plan of either planner asks for one (a cache's sequence may "
            "lie over several: ``TPState.kv_seq``)")
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
class Group:
    """A group of mesh axes: its process group, this rank's index in it and
    its width.  The ranks are data-major (the outermost axis first), as a
    spec entry of several axes orders a dim's shards (``specs.
    placements``), so that rank i of the group holds a split dim's i-th
    block.  ``Group()`` is no split: width 1, no process group."""
    axes: tuple[str, ...] = ()
    group: Any = None
    rank: int = 0
    size: int = 1


NO_SPLIT = Group()


@dataclasses.dataclass(frozen=True)
class TPState:
    """The tensor-parallel layout a step runs under, as explicit groups.

    ``tp``: the group over all the plan's ``tp_axes`` (one axis, or
    ``("data", "model")`` under ``tp_all``).  A weight dim the parameter
    rules give to the tp axes lies over the axes that ``sanitize`` leaves of
    them for its width (``split``): over both, over one of them, or whole;
    at (2, 2) a dim split over ``data`` alone has the shape of one split
    over ``model`` alone, so the group comes from the spec, never from the
    shape.

    The caches, as ``specs.cache_pspec`` puts them after ``sanitize``:
    ``kv_heads`` the self-attention ``k``/``v`` split by KV heads;
    ``kv_seq`` their sequence split (the plan's ``seq_axes``, then the tp
    axes the KV heads do not divide: this rank holds rows [rank·S,
    (rank+1)·S) of the whole); ``kv_seq_tp`` the part of ``kv_seq`` that
    the activations' own sequence split does not cover (a prompt's rows
    are shared over it as its cache is written).  ``xkv`` the cross caches
    ``xk``/``xv`` by heads; ``ssm_heads`` the SSM state ``h`` by heads;
    ``conv`` the conv context by channels."""
    mesh: Any
    tp: Group
    groups: Any = dataclasses.field(default=None, compare=False)
    kv_heads: Group = NO_SPLIT
    kv_seq: Group = NO_SPLIT
    kv_seq_tp: Group = NO_SPLIT
    xkv: Group = NO_SPLIT
    ssm_heads: Group = NO_SPLIT
    conv: Group = NO_SPLIT

    def dim(self, full: int) -> Group:
        """The group of a weight dim of ``full`` entries that the parameter
        rules split over the tp axes: the axes its sanitized spec entry
        names (every rule gives such a dim the entry ``tp_axes``, and
        ``sanitize`` reads only the dim's own width)."""
        from .specs import Spec, _ax, _entry_axes, sanitize
        entry = sanitize(self.mesh, Spec(_ax(self.tp.axes)), (full,))[0]
        return self.groups[_entry_axes(entry)]

    def split(self, local: int, full: int) -> Group:
        """The group a weight dim of ``full`` entries that reached this
        rank with ``local`` of them is split over: none where it came whole
        (a rule that leaves the dim to other axes: the expert-FF dim beside
        split experts), else ``dim(full)``, checked against ``local``."""
        if local == full:
            return NO_SPLIT
        g = self.dim(full)
        if local * g.size != full:
            raise ValueError(f"a dim of {local} entries is neither {full} "
                             f"nor its 1/{g.size} share over {g.axes}")
        return g


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


def kv_len(s_local: int) -> int:
    """The whole self-attention cache's length, from this rank's share."""
    return s_local if _TP is None else s_local * _TP.kv_seq.size
