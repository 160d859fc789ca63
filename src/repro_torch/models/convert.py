"""Parameters and optimizer states between the JAX package (as numpy
arrays) and the port's tensors.

``from_jax(jax.tree.map(np.asarray, params))`` gives the port the very
weights a JAX model holds, so both packages compute the same function in the
tests.  The port's parameter tree has the JAX tree's keys and layouts
(stacked along L), so the conversion is a walk over nested dicts.
``opt_state_from_jax`` and ``to_numpy`` carry an AdamW state (``step``,
``m``, ``v``, ``master``) and parameters both ways, so that one train step
can be compared from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.training.optimizer import OptState


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":                  # ml_dtypes, not numpy's
        t = torch.from_numpy(np.array(a).view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)        # a copy: jax buffers are read-only


def from_jax(params_np: dict, device="cuda") -> dict:
    """Nested dicts of arrays → the same nesting of tensors on ``device``."""
    dev = _device.resolve(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _tensor(node, dev)

    return walk(params_np)


def opt_state_from_jax(state_np, device="cuda"):
    """A ``repro.training.optimizer.OptState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``) → the port's ``OptState``."""
    dev = _device.resolve(device)
    return OptState(
        step=_tensor(state_np.step, dev), m=from_jax(state_np.m, dev),
        v=from_jax(state_np.v, dev),
        master=(None if state_np.master is None
                else from_jax(state_np.master, dev)))


def to_numpy(tree):
    """A tree of tensors (nested dicts, tuples, an ``OptState``) → the same
    structure of numpy arrays, bf16 as ``ml_dtypes.bfloat16`` (the type of a
    numpy view of a JAX bf16 array)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        kids = [to_numpy(x) for x in tree]
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                    # a JAX dependency: tests only
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()
