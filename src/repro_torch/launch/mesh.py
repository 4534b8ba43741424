"""Mesh builders (the reference's ``launch/mesh.py``), one process a
device.

Each builds a ``torch.distributed.device_mesh.DeviceMesh`` over the
initialised world (``dist.compat.init_group`` / ``spawn``), its ranks laid
out row-major over the axes; a rank holds the card its group took (NCCL)
or the CPU (gloo).  Each raises where the world does not fit the mesh;
none shrinks it.  Functions, never module-level constants: importing this
module touches no process group.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs an initialised process group "
                           "(dist.compat.init_group, world1 or spawn)")
    return dist.get_world_size()


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    n = 1
    for s in shape:
        n *= s
    world = _world()
    if n != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks, "
                         f"the world has {world}")
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model"): 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(model: int = 1):
    """(world / model, model) over ("data", "model")."""
    world = _world()
    if model < 1 or world % model:
        raise ValueError(f"model axis {model} does not divide the world of "
                         f"{world} ranks")
    return _mesh((world // model, model), ("data", "model"))


def make_edge_mesh(num_devices: int | None = None, axis: str = "shard"):
    """1-D edge-shard mesh for the SPMD partitioner over the whole world,
    rank d owning edge shard d.  Its group is the default one, which the
    SPMD round (``dist.partitioner_sm``) and the driver take."""
    world = _world()
    d = world if num_devices is None else int(num_devices)
    if d != world:
        raise ValueError(f"an edge mesh of {d} devices needs a world of "
                         f"{d} ranks, the world has {world}")
    return _mesh((d,), (axis,))
