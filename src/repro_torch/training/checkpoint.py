"""Checkpoints, ported from ``repro.training.checkpoint``: the same
MessagePack payload, ``{"step", "leaves": [{"dtype", "shape", "data"}]}``
with the leaves in ``jax.tree.leaves`` order and bf16 stored as its uint16
bits under the tag ``bfloat16``, written atomically (tmp + fsync + rename).
A file either package writes restores in the other.  The encoding is the
port's own ``_msgpack`` (the GPU machine has no ``msgpack`` package)."""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from . import _msgpack, tree


def _pack_leaf(x: torch.Tensor) -> dict:
    x = x.detach().cpu().contiguous()
    tag = str(x.dtype).removeprefix("torch.")
    # msgpack has no bf16: store its bits as uint16 and tag the true dtype
    arr = (x.view(torch.int16).numpy().view(np.uint16) if tag == "bfloat16"
           else x.numpy())
    return {"dtype": tag, "shape": list(arr.shape), "data": arr.tobytes()}


def _unpack_leaf(d: dict, device: torch.device) -> torch.Tensor:
    if d["dtype"] == "bfloat16":
        arr = np.frombuffer(d["data"], np.int16).reshape(d["shape"])
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).to(device)
    arr = np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(d["shape"])
    return torch.from_numpy(arr.copy()).to(device)


def save(path: str, state: Any, step: int) -> str:
    """Atomic write of {step, state} → ``path`` (tmp + rename)."""
    payload = {"step": step,
               "leaves": [_pack_leaf(x) for x in tree.leaves(state)]}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_msgpack.packb(payload))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)           # atomic on POSIX
    return path


def restore(path: str, like: Any) -> tuple[Any, int]:
    """Restore into the structure of ``like``, each leaf on the device of
    ``like``'s leaf.  Returns (state, step)."""
    with open(path, "rb") as f:
        payload = _msgpack.unpackb(f.read())
    like_leaves = tree.leaves(like)
    if len(payload["leaves"]) != len(like_leaves):
        raise ValueError(f"checkpoint has {len(payload['leaves'])} leaves, "
                         f"expected {len(like_leaves)}")
    restored = [_unpack_leaf(d, x.device)
                for d, x in zip(payload["leaves"], like_leaves)]
    return tree.unflatten(like, restored), payload["step"]


def latest(directory: str, prefix: str = "ckpt_") -> str | None:
    """Most recent step-tagged checkpoint in a directory."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".msgpack"):
            try:
                step = int(name[len(prefix):-len(".msgpack")])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(directory, name), step
    return best


def step_path(directory: str, step: int, prefix: str = "ckpt_") -> str:
    os.makedirs(directory, exist_ok=True)
    return os.path.join(directory, f"{prefix}{step:08d}.msgpack")
