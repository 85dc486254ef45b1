"""Device meshes over the ranks of the default process group.

Counterpart of ``acr_wsss_tpu/parallel/mesh.py`` (``:43-73``). A mesh
here is a ``torch.distributed.DeviceMesh`` of ranks, one GPU each, where
JAX's holds the devices of one controller. The port has the ``data`` and
``model`` axes: DDP (``sharding.wrap_ddp``) or FSDP
(``sharding.apply_fsdp``) over ``data``, and tensor parallelism over
``model`` (``sharding.apply_tensor_parallel``: each block's attention
heads and MLP hidden width cut over the ranks). A ``(D, M)`` mesh lays
the ranks out as JAX's ``make_mesh`` lays out its devices, row-major with
the model axis varying fastest: rank ``d * M + m`` is data coordinate
``d``, model coordinate ``m``. The ``seq`` and ``pipe`` axes (sequence
and pipeline parallelism) are refused by name.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from acr_wsss_tpu_torch.parallel.distributed import world_size

AXES = ("data", "model")


def check_axes(axis_names: Sequence[str]) -> None:
    """Refuse a mesh axis that the port does not have."""
    other = [a for a in axis_names if a not in AXES]
    if other:
        raise ValueError(
            f"mesh axes {other}: sequence and pipeline parallelism (the seq and pipe "
            "axes) are not ported; the mesh takes the data and model axes")


def resolve_shape(shape: Sequence[int], n: int) -> Tuple[int, ...]:
    """``shape`` over ``n`` devices, one ``-1`` absorbing the rest; the
    errors of JAX's ``make_mesh``."""
    shape = list(shape)
    if shape.count(-1) > 1:
        raise ValueError("at most one -1 in mesh shape")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        shape[shape.index(-1)] = n // known
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return tuple(shape)


def make_mesh(shape: Sequence[int] = (-1,), axis_names: Sequence[str] = ("data",),
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every rank; one ``-1`` entry absorbs the remaining ones."""
    check_axes(axis_names)
    return init_device_mesh(device_type, resolve_shape(shape, world_size()),
                            mesh_dim_names=tuple(axis_names))


def data_extent(batch_size: int, n: int) -> int:
    """The largest divisor of ``batch_size`` that does not exceed ``n``."""
    return max(d for d in range(1, min(n, batch_size) + 1) if batch_size % d == 0)


def make_data_mesh_for_batch(batch_size: int, device_type: str = "cuda") -> DeviceMesh:
    """1-D ``data`` mesh of the first ``data_extent(batch_size, world)``
    ranks; the rest idle, as the reference would simply run fewer DDP
    ranks. Every rank must call it (it builds a process group); a rank
    outside the mesh gets one whose ``get_coordinate()`` is None."""
    data = data_extent(batch_size, world_size())
    return DeviceMesh(device_type, list(range(data)), mesh_dim_names=("data",))


def in_mesh(mesh: Optional[DeviceMesh]) -> bool:
    return mesh is None or mesh.get_coordinate() is not None


def data_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The 1-D ``data`` sub-mesh of this rank (``mesh`` itself when it has
    no other axis): the ranks that hold the same model coordinate."""
    return mesh["data"] if mesh.ndim > 1 else mesh


def model_mesh(mesh: Optional[DeviceMesh]) -> Optional[DeviceMesh]:
    """The 1-D ``model`` sub-mesh of this rank, None without that axis."""
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return None
    return mesh["model"] if mesh.ndim > 1 else mesh


def mesh_group(mesh: DeviceMesh):
    """The process group of every rank of ``mesh``: its own for a 1-D mesh
    (which may leave ranks idle), the default group for a mesh of more
    axes, which ``make_mesh`` builds over every rank."""
    return mesh.get_group() if mesh.ndim == 1 else None
