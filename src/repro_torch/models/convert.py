"""Parameters of the JAX package, as numpy arrays, to the port's tensors.

``from_jax(jax.tree.map(np.asarray, params))`` gives the port the very
weights a JAX model holds, so both packages compute the same function in the
tests.  The port's parameter tree has the JAX tree's keys and layouts
(stacked along L), so the conversion is a walk over nested dicts.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device


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
