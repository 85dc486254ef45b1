"""Placement of the model over the data axis: DDP, or FSDP (ZeRO-3).

Counterpart of the data-axis part of ``acr_wsss_tpu/parallel/sharding.py``.
On a 1-D ``data`` mesh JAX replicates every parameter (``param_shardings``,
``replicated``) and XLA all-reduces the gradients: here
:func:`wrap_ddp`, PyTorch's ``DistributedDataParallel``, the reference's
own strategy (``train_acr.py:99``). ``fsdp_shardings`` (``:60-90``)
shards every large parameter and its optimizer state over the data axis
on its largest dimension: here :func:`apply_fsdp`, FSDP2's
``fully_shard`` on each transformer block, the stem, the patch embed and
the root, whose parameters become ``DTensor`` shards (the optimizer
state follows, so both are sharded, as in JAX).

Checkpoints keep the one-device layout: :func:`full_tensors` gathers
sharded tensors (a collective) and :func:`shard_like` cuts a full tensor
back to a parameter's placement, with any world size on either side;
:func:`global_norm` is the norm over every rank's shards (the
optimizer's clipping).

FSDP2 and ``DTensor`` are imported where they are used: their modules
are slow to import, which every process of a one-device run (the
trainer, each ``--dp`` worker) would pay otherwise.
"""

from __future__ import annotations

import sys
from typing import Any, List

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh
from torch.nn.parallel import DistributedDataParallel


def wrap_ddp(model: nn.Module, device: torch.device, mesh: DeviceMesh
             ) -> DistributedDataParallel:
    """``model`` replicated over the mesh's ranks, gradients averaged in
    the backward. ACR's final LayerNorm (``trunk.norm``) is on no loss
    path of the train step (the head reads a tap taken before it), as in
    the reference's hooked ViT, hence ``find_unused_parameters``; its
    weight decay still applies, identically on every rank."""
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        process_group=mesh.get_group(), find_unused_parameters=True)


def is_dtensor(t: Any) -> bool:
    """Whether ``t`` is a ``DTensor``; none exists before its module is
    imported, so the check imports nothing."""
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(t, module.DTensor)


def _shard_dim(param: nn.Parameter, n: int) -> int:
    """JAX's rule, the largest dimension (the first of equal ones); FSDP2
    shards a dimension other than 0 only evenly, so such a dimension that
    ``n`` does not divide gives way to dimension 0."""
    dim = max(range(param.dim()), key=lambda d: (param.shape[d], -d)) if param.dim() else 0
    return dim if dim == 0 or param.shape[dim] % n == 0 else 0


def apply_fsdp(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """``fully_shard`` ``model`` (an ``ACR`` or its trunk's owner) in
    place: one group per transformer block, the hybrid stem and the patch
    embed, and the root for the rest (tokens, position embedding, final
    norm, head). Unlike JAX's ``min_elems`` rule, FSDP2 shards every
    parameter of a group, the small ones too; that changes memory and
    traffic, not the numbers."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = mesh.size()

    def place(p):
        return Shard(_shard_dim(p, n))

    trunk = model.trunk
    for module in [*trunk.blocks, trunk.backbone, trunk.patch_embed]:
        if module is not None:
            fully_shard(module, mesh=mesh, shard_placement_fn=place)
    fully_shard(model, mesh=mesh, shard_placement_fn=place)
    return model


def unwrap(model: nn.Module) -> nn.Module:
    """The model inside a DDP wrapper (an FSDP module is its own)."""
    return model.module if isinstance(model, DistributedDataParallel) else model


def full_tensors(obj: Any) -> Any:
    """``obj`` with every ``DTensor`` replaced by its full tensor. A
    collective for sharded ones: every rank of their mesh calls it with
    the same structure."""
    if is_dtensor(obj):
        return obj.full_tensor()
    if isinstance(obj, dict):
        return {k: full_tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(full_tensors(v) for v in obj)
    return obj


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` placed as ``like``: this rank's shard of it as a ``DTensor``
    when ``like`` is one (no communication: every rank holds ``full``),
    else ``full`` itself."""
    if not is_dtensor(like):
        return full
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(like.device), like.device_mesh, like.placements,
                             src_data_rank=None)


def global_norm(tensors: List[torch.Tensor]) -> float:
    """sqrt of the sum of squares of ``tensors``; over FSDP's shards, each
    rank's sum of squares of its shards, summed over the ranks (a
    collective)."""
    local = [t.to_local() if is_dtensor(t) else t for t in tensors]
    sq = sum((t.float() ** 2).sum() for t in local)
    if any(is_dtensor(t) for t in tensors):
        dist.all_reduce(sq, group=tensors[0].device_mesh.get_group())
    return float(torch.sqrt(sq))
