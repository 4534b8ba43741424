"""Thread-local mesh/axis registry (the reference's ``dist/context.py``).

Model code that takes *explicit* collectives (the MoE expert-parallel
branch, the row-sharded embedding lookup, split-KV decode) needs to know
which mesh axes carry the batch and which carry the model dimension.
``mesh_context`` registers that assignment for the current thread;
``get_mesh_ctx`` returns it (or ``None``, and callers take their
single-device path).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (one process a
device, the reference's axis names) or anything with its
``mesh_dim_names`` and ``shape``: the tables (``dist.sharding``,
``launch.steps._lm_rules``) read only those.  :meth:`MeshCtx.group` and
:meth:`MeshCtx.index` give the process group and this rank's coordinate
over a tuple of axes, for the collectives; an axis tuple whose size is 1
has no group (``None``), and every collective over it is the identity.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch.distributed as dist


def axis_size(mesh, name: str) -> int:
    """Size of mesh axis ``name``."""
    return int(mesh.shape[list(mesh.mesh_dim_names).index(name)])


def axes_size(mesh, axes) -> int:
    """Product of the sizes of ``axes`` (1 for none)."""
    return math.prod(axis_size(mesh, a) for a in axes)


# (id of the mesh, axes) → (the mesh, this rank's group over the axes);
# the mesh is kept so that its id is not reused while the entry lives
_GROUPS: dict = {}


def axes_group(mesh, axes):
    """This rank's process group over mesh ``axes`` (in mesh order): the
    ranks that share its coordinates on every other axis, in row-major
    order of their coordinates on ``axes`` (a ``jax.lax`` collective over
    the axis tuple).  ``None`` where the axes' size is 1.  Every rank
    makes every such group in the same order the first time any rank
    asks, as ``new_group`` requires; later calls read the cache."""
    axes = tuple(axes)
    if axes_size(mesh, axes) == 1:
        return None
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    if dims != sorted(dims):
        raise ValueError(f"axes {axes} are not in mesh order {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS or _GROUPS[key][0] is not mesh:
        ranks = mesh.mesh                        # (shape) global ranks
        keep = [i for i in range(ranks.dim()) if i not in dims]
        flat = ranks.permute(*keep, *dims).reshape(
            -1, axes_size(mesh, axes))
        me = dist.get_rank()
        for row in flat.tolist():
            g = dist.new_group(row)
            if me in row:
                _GROUPS[key] = (mesh, g)
    return _GROUPS[key][1]


def axes_index(mesh, axes) -> int:
    """This rank's row-major coordinate over ``axes`` (0 for none)."""
    coord = mesh.get_coordinate()
    names = list(mesh.mesh_dim_names)
    out = 0
    for a in axes:
        out = out * axis_size(mesh, a) + int(coord[names.index(a)])
    return out


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """Mesh plus the axis-role assignment the models need."""

    mesh: object
    batch_axes: tuple[str, ...]
    model_axis: str

    def __post_init__(self):
        names = set(self.mesh.mesh_dim_names)
        missing = (set(self.batch_axes) | {self.model_axis}) - names
        if missing:
            raise ValueError(f"axes {sorted(missing)} not in mesh axes "
                             f"{tuple(self.mesh.mesh_dim_names)}")

    @property
    def dp(self) -> int:
        """Total data-parallel degree (product of the batch axes)."""
        return axes_size(self.mesh, self.batch_axes)

    @property
    def tp(self) -> int:
        return axis_size(self.mesh, self.model_axis)

    def group(self, axes):
        return axes_group(self.mesh, axes)

    def index(self, axes) -> int:
        return axes_index(self.mesh, axes)

    # the reference's collectives over an axis tuple, differentiable; each
    # is the identity where the axes' size is 1
    def psum(self, x, axes):
        """``jax.lax.psum`` (backward: the identity)."""
        from repro_torch.dist import compat

        g = self.group(axes)
        return x if g is None else compat.all_reduce_sum(x, g)

    def all_gather(self, x, axes, dim: int):
        """``jax.lax.all_gather(tiled=True)`` (backward: reduce-scatter)."""
        from repro_torch.dist import compat

        g = self.group(axes)
        return x if g is None else compat.all_gather_tiled(x, g, dim)

    def copy_to(self, x, axes):
        """Megatron's *f* (backward: all-reduce)."""
        from repro_torch.dist import compat

        g = self.group(axes)
        return x if g is None else compat.copy_to_group(x, g)


_tls = threading.local()


def get_mesh_ctx() -> MeshCtx | None:
    """Current thread's mesh context, or None outside ``mesh_context``."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def mesh_context(mesh, batch_axes=("data",), model_axis: str = "model"):
    """Register (mesh, batch_axes, model_axis) for the current thread.

    Nests: the previous context is restored on exit, so an inner scope can
    re-assign axis roles for a while (e.g. a serve path reusing the train
    mesh with an empty batch).
    """
    prev = get_mesh_ctx()
    _tls.ctx = MeshCtx(mesh, tuple(batch_axes), model_axis)
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev
