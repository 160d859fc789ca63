"""Mesh construction, ported from ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
device and no process group.  Each needs ``torch.distributed`` initialised
with the mesh's world size (``init_process_group`` with its address, rank
and world size: nothing on a GPU machine tells a program of its cluster).
"""

from __future__ import annotations

from repro_torch.sharding.plan import GPU_MULTI_NODE, GPU_NODE


def _require_pg(world: int) -> None:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group before making a mesh")
    if dist.get_world_size() != world:
        raise ValueError(f"the mesh needs {world} ranks, the process group "
                         f"has {dist.get_world_size()}")


def make_production_mesh(*, multi_node: bool = False,
                         device_type: str = "cuda"):
    """One HGX node: (1, 8) GPUs over ("data", "model") (``GPU_NODE``).
    Two nodes: (2, 1, 8) over ("pod", "data", "model")
    (``GPU_MULTI_NODE``)."""
    from torch.distributed.device_mesh import init_device_mesh

    desc = GPU_MULTI_NODE if multi_node else GPU_NODE
    _require_pg(desc.total_chips)
    return init_device_mesh(device_type, desc.shape,
                            mesh_dim_names=desc.axes)


def make_smoke_mesh(shape=(1, 1), axes=("data", "model"),
                    device_type: str = "cuda"):
    """A small mesh over the ranks there are: gloo ranks on the CPU in the
    tests (``device_type="cpu"``), one GPU at world 1 on the card."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    _require_pg(n)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
