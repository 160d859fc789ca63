"""A HiDP ``ShardingPlan`` rendered into placements for parameters,
optimizer state, batches and caches, ported from ``repro.sharding.specs``.

Rules are name-based on the trailing dims of each leaf (stack dims — layer,
group, expert-group — are padded with None on the left), so the same table
serves the flat decoder stack, whisper's enc/dec stacks and the VLM's
two-level stack.

A ``Spec`` is the counterpart of ``jax.sharding.PartitionSpec``: a tuple
with one entry per tensor dim, each None, a mesh axis name, or a tuple of
axis names (the dim split over those axes, the first outermost).  A path is
the tuple of dict keys from the tree's root to the leaf.  ``placements``
turns a spec into DTensor ``Shard``/``Replicate`` per mesh dim, and
``distribute`` builds the DTensors of a tree, each rank keeping only its
shard.  A mesh here is a ``DeviceMesh`` (``mesh_dim_names``) or a
``MeshDesc`` (``axes``), whichever the caller has.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable

import torch

if TYPE_CHECKING:
    from .plan import ShardingPlan


class Spec(tuple):
    """A PartitionSpec: ``Spec("data", None, ("pod", "model"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "Spec(" + ", ".join(map(repr, self)) + ")"


def _ax(axes: tuple[str, ...]):
    """() → None; (a,) → a; (a,b) → (a,b) for Spec entries."""
    if not axes:
        return None
    if len(axes) == 1:
        return axes[0]
    return tuple(axes)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``MeshDesc``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axes, mesh.shape))


def _axis_names(mesh) -> tuple[str, ...]:
    return tuple(axis_sizes(mesh))


# trailing-dims spec table: name → tuple of entries
def _param_rules(plan: ShardingPlan) -> dict[str, tuple]:
    tp = _ax(plan.tp_axes)
    fs = _ax(plan.fsdp_axes)
    return {
        # embeddings
        "embedding": (tp, fs),
        "head": (fs, tp),
        # attention
        "wq": (fs, tp), "wk": (fs, tp), "wv": (fs, tp), "wo": (tp, fs),
        # dense mlp
        "w_gate": (fs, tp), "w_up": (fs, tp), "w_down": (tp, fs),
        # moe (experts sharded over tp = expert parallelism); param_pspec
        # overrides these when E does not divide the tp axes
        "router": (fs, None),
        "moe/w_gate": (tp, fs, None), "moe/w_up": (tp, fs, None),
        "moe/w_down": (tp, None, fs),
        # mamba
        "w_in": (fs, tp), "w_out": (tp, fs), "conv": (None, tp),
        "A_log": (tp,), "D": (tp,), "dt_bias": (tp,), "norm": (tp,),
        # norms / gates
        "w": (None,), "b": (None,),
        "gate_attn": (), "gate_mlp": (),
        "ln1": (None,), "ln2": (None,), "lnx": (None,),
    }


def param_pspec(path: tuple[str, ...], leaf, plan: ShardingPlan) -> Spec:
    """The spec of the parameter at ``path`` (its dict keys) with ``leaf``'s
    shape, under ``plan``."""
    names = list(path)
    name = names[-1] if names else ""
    rules = _param_rules(plan)
    moe_ctx = any(n == "moe" for n in names)
    key = f"moe/{name}" if moe_ctx and f"moe/{name}" in rules else name
    ndim = len(leaf.shape)
    if key not in rules:
        return Spec()                               # replicate unknowns
    if moe_ctx and key.startswith("moe/"):
        # the expert count may not divide the tp axes (mixtral: 8 experts
        # over a 16-wide axis): shard the expert-FF dim instead, so that the
        # expert weights never replicate
        n_experts = leaf.shape[-3]
        tp_size = 1
        for a in plan.tp_axes:
            tp_size *= plan.mesh.size(a)
        if n_experts % max(tp_size, 1) != 0:
            tp = _ax(plan.tp_axes)
            fs = _ax(plan.fsdp_axes)
            rules = dict(rules)
            rules["moe/w_gate"] = (None, fs, tp)
            rules["moe/w_up"] = (None, fs, tp)
            rules["moe/w_down"] = (None, tp, fs)
    tail = rules[key]
    tail = tail[:ndim]
    pad = ndim - len(tail)
    return Spec(*([None] * pad + list(tail)))


def sanitize(mesh, spec: Spec, shape: tuple[int, ...]) -> Spec:
    """Every sharded dim must divide evenly: drop axes (largest first) from
    entries that do not divide."""
    sizes = axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        if e is None:
            out.append(None)
            continue
        axes = list(e) if isinstance(e, tuple) else [e]
        while axes:
            total = 1
            for a in axes:
                total *= sizes[a]
            if dim % total == 0:
                break
            axes.sort(key=lambda a: sizes[a])
            axes.pop()                       # drop the largest axis
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return Spec(*out)


# --------------------------------------------------------------------------
# Trees
# --------------------------------------------------------------------------

def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree of nested dicts (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def param_specs_tree(mesh, params: Any, plan: ShardingPlan) -> Any:
    """The sanitized spec of every parameter."""
    return tree_map_with_path(
        lambda path, leaf: sanitize(mesh, param_pspec(path, leaf, plan),
                                    tuple(leaf.shape)), params)


# --------------------------------------------------------------------------
# Batches
# --------------------------------------------------------------------------

def batch_pspec(name: str, leaf, plan: ShardingPlan) -> Spec:
    b = _ax(plan.batch_axes)
    s = _ax(plan.seq_axes)
    ndim = len(leaf.shape)
    if name in ("tokens", "targets"):
        return Spec(b, s) if ndim == 2 else Spec(b)
    if name == "lengths":
        return Spec(b)
    if name == "frames":            # (B, T_enc, d)
        return Spec(b, s, None)
    if name == "vision":            # (B, Nv, d)
        return Spec(b, None, None)
    return Spec()


def batch_specs_tree(mesh, batch: dict, plan: ShardingPlan) -> dict:
    return {k: sanitize(mesh, batch_pspec(k, v, plan), tuple(v.shape))
            for k, v in batch.items()}


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------

def cache_pspec(path: tuple[str, ...], leaf, plan: ShardingPlan) -> Spec:
    name = path[-1]
    b = _ax(plan.batch_axes)
    s = _ax(plan.seq_axes)
    tp = _ax(plan.tp_axes)
    ndim = len(leaf.shape)
    if name in ("k", "v"):          # (..., B, S, Hkv, hd)
        # KV-head counts often do not divide the tp axes (GQA kv ∈ {1,4,5,8}
        # against a 16-way model axis): those axes shard the cache's
        # sequence dim instead (context parallelism)
        hkv = leaf.shape[-2]
        head_axes, seq_extra = [], list(plan.seq_axes)
        acc = 1
        for a in plan.tp_axes:
            size = plan.mesh.size(a)
            if hkv % (acc * size) == 0:
                head_axes.append(a)
                acc *= size
            else:
                seq_extra.append(a)
        tail = (b, _ax(tuple(seq_extra)), _ax(tuple(head_axes)), None)
    elif name in ("xk", "xv"):      # (..., B, Nv, Hkv, hd)
        tail = (b, None, tp, None)
    elif name == "h":               # (..., B, nh, hd, n)
        tail = (b, tp, None, None)
    elif name == "conv":            # (..., B, cw-1, C)
        tail = (b, None, tp)
    else:
        return Spec()
    tail = tail[-ndim:] if len(tail) > ndim else tail
    pad = ndim - len(tail)
    return Spec(*([None] * pad + list(tail)))


def cache_specs_tree(mesh, cache: Any, plan: ShardingPlan) -> Any:
    return tree_map_with_path(
        lambda path, leaf: sanitize(mesh, cache_pspec(path, leaf, plan),
                                    tuple(leaf.shape)), cache)


# --------------------------------------------------------------------------
# Outputs
# --------------------------------------------------------------------------

def logits_pspec(mesh, plan: ShardingPlan,
                 shape: tuple[int, ...] | None = None) -> Spec:
    spec = Spec(_ax(plan.batch_axes), None, _ax(plan.tp_axes))
    if shape is not None:
        spec = sanitize(mesh, spec, shape)
    return spec


def replicated() -> Spec:
    return Spec()


# --------------------------------------------------------------------------
# DTensor placements
# --------------------------------------------------------------------------

def placements(mesh, spec: Spec) -> tuple:
    """One DTensor placement per mesh dim: ``Shard(d)`` where the spec's
    entry for tensor dim d names the axis, else ``Replicate()``.  An entry
    of several axes must list them in the mesh's order (DTensor splits a dim
    over mesh dims outermost first, as a PartitionSpec entry does)."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        axes = _entry_axes(e)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"spec entry {e!r} is not in the mesh's axis order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {names[i]!r} shards two dims of "
                                 f"{spec!r}")
            out[i] = Shard(d)
    return tuple(out)


def local_shape(mesh, spec: Spec, shape: tuple[int, ...]) -> tuple:
    """The shape of one rank's shard (sanitized specs divide evenly)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        for a in _entry_axes(e):
            if out[d] % sizes[a]:
                raise ValueError(f"dim {d} of {shape} does not divide over "
                                 f"{a!r}")
            out[d] //= sizes[a]
    return tuple(out)


def local_slice(mesh, spec: Spec, tensor: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a tensor every rank holds whole (a view)."""
    names = _axis_names(mesh)
    coord = mesh.get_coordinate()
    sizes = axis_sizes(mesh)
    out = tensor
    for d, e in enumerate(spec):
        for a in _entry_axes(e):            # outermost first
            n = out.shape[d] // sizes[a]
            out = out.narrow(d, coord[names.index(a)] * n, n)
    return out


def distribute(mesh, tree: Any, specs_tree: Any, device=None) -> Any:
    """A tree of DTensors on ``mesh`` placed by ``specs_tree``.  A leaf every
    rank holds whole keeps this rank's shard of it; a ``meta`` leaf (an
    abstract tree, ``Model.param_specs``) becomes an uninitialised local
    shard on ``device``, so that no rank ever holds a whole tensor."""
    from torch.distributed.tensor import DTensor

    flat_specs: dict = {}
    tree_map_with_path(lambda p, s: flat_specs.__setitem__(p, s),
                       specs_tree)

    def one(path, leaf):
        spec = flat_specs[path]
        if leaf.is_meta:
            local = torch.empty(local_shape(mesh, spec, tuple(leaf.shape)),
                                dtype=leaf.dtype, device=device)
        else:
            local = local_slice(mesh, spec, leaf.detach())
            if local.numel() < leaf.numel():
                local = local.clone()       # not a view of the whole
        return DTensor.from_local(local, mesh, placements(mesh, spec),
                                  run_check=False, shape=leaf.shape,
                                  stride=_contiguous_stride(leaf.shape))
    return tree_map_with_path(one, tree)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def param_shardings(mesh, params: Any, plan: ShardingPlan,
                    device=None) -> Any:
    """``params`` as DTensors placed by the plan's parameter rules."""
    return distribute(mesh, params, param_specs_tree(mesh, params, plan),
                      device)


def batch_shardings(mesh, batch: dict, plan: ShardingPlan,
                    device=None) -> dict:
    return distribute(mesh, batch, batch_specs_tree(mesh, batch, plan),
                      device)


def cache_shardings(mesh, cache: Any, plan: ShardingPlan,
                    device=None) -> Any:
    return distribute(mesh, cache, cache_specs_tree(mesh, cache, plan),
                      device)
