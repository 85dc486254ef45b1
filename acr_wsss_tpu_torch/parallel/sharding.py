"""Placement of the model over the mesh: DDP, FSDP (ZeRO-3) over ``data``,
tensor parallelism over ``model``.

Counterpart of ``acr_wsss_tpu/parallel/sharding.py``. On a 1-D ``data``
mesh JAX replicates every parameter (``param_shardings``, ``replicated``)
and XLA all-reduces the gradients: here :func:`wrap_ddp`, PyTorch's
``DistributedDataParallel``, the reference's own strategy
(``train_acr.py:99``). ``fsdp_shardings`` (``:60-90``) shards every large
parameter and its optimizer state over the data axis on its largest
dimension: here :func:`apply_fsdp`, FSDP2's ``fully_shard`` on each
transformer block, the stem, the patch embed and the root, whose
parameters become ``DTensor`` shards (the optimizer state follows, so
both are sharded, as in JAX). Under ``--fsdp`` a ``model`` axis is
ignored, as JAX ignores ``TP_RULES`` there: FSDP over each data sub-mesh,
the model ranks replicas of one another.

On a mesh with a ``model`` axis, :data:`TP_RULES` (JAX's ``TP_RULES``,
``:27-34``, over the port's parameter names) and
:func:`apply_tensor_parallel` cut each block's ``attn.qkv`` and
``mlp.fc1`` by output rows and its ``attn.proj`` and ``mlp.fc2`` by input
columns; everything else stays replicated (norms, tokens, position
embedding, the hybrid stem, the patch embed, the head). Megatron's pair
of autograd functions carries the block: :func:`copy_to_model` (identity,
gradient all-reduced) on the input of ``qkv`` and ``fc1``,
:func:`reduce_from_model` (all-reduce, identity gradient) on the outputs
of ``proj`` and ``fc2``, whose biases are added once, after it. One
difference of layout, not of numbers: JAX's ``P(None, "model")`` cuts the
(D, 3D) qkv kernel into contiguous column chunks, which puts all of q on
the first ranks, and GSPMD repairs that with collectives; the cut here is
per head, the rows of heads ``[m H/M, (m+1) H/M)`` of each of q, k and v,
so that each rank's ``qkv`` is the (B, N, 3 (H/M) D) layout the attention
kernels take with ``H/M`` heads. A cut parameter carries its
:class:`TPShard` as ``param.tp``.

Checkpoints keep the one-device layout: :func:`full_like` and
:func:`full_state_dict` gather FSDP's and the model axis's shards (a
collective) and :func:`shard_like` cuts a full tensor back to a
parameter's placement, with any mesh on either side; :func:`global_norm`
is the norm of the one-device model over every rank's shards (the
optimizer's clipping).

FSDP2 and ``DTensor`` are imported where they are used: their modules
are slow to import, which every process of a one-device run (the
trainer, each ``--dp`` worker) would pay otherwise.
"""

from __future__ import annotations

import dataclasses
import re
import sys
from typing import Any, List, Optional, Sequence

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
    when ``like`` is one, this rank's part of the model axis's cut when
    ``like`` carries a :class:`TPShard` (no communication: every rank
    holds ``full``), else ``full`` itself. ``like`` is the parameter (a
    ``state_dict(keep_vars=True)`` value): a detached copy has lost its
    ``tp``."""
    spec = getattr(like, "tp", None)
    if spec is not None:
        return spec.cut(full.to(like.device))
    if not is_dtensor(like):
        return full
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(like.device), like.device_mesh, like.placements,
                             src_data_rank=None)


def full_like(t: torch.Tensor, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``t`` (a parameter, or a tensor placed as the parameter ``like``) in
    the one-device layout: a ``DTensor``'s full tensor, the model axis's
    parts joined, or ``t`` itself. A collective for sharded ones."""
    spec = getattr(t if like is None else like, "tp", None)
    if spec is not None:
        return spec.gather(t.detach())
    return t.full_tensor() if is_dtensor(t) else t


def full_state_dict(model: nn.Module) -> dict:
    """``model``'s state dict in the one-device layout, detached (a
    collective under FSDP or a model axis: every rank calls it)."""
    return {k: full_like(v).detach() for k, v in unwrap(model).state_dict(keep_vars=True).items()}


def global_norm(tensors: List[torch.Tensor], params: Sequence[torch.Tensor]) -> float:
    """sqrt of the sum of squares of ``tensors`` (placed as ``params``), the
    norm of the one-device model: over FSDP's shards, each rank's sum of
    squares of its shards, summed over the ranks; a tensor cut over the
    model axis adds its parts' squares over the model ranks, a replicated
    one counts once (collectives)."""
    local = [t.to_local() if is_dtensor(t) else t for t in tensors]
    specs = [getattr(p, "tp", None) for p in params]
    zero = local[0].new_zeros((), dtype=torch.float32)
    sq = sum(((t.float() ** 2).sum() for t, s in zip(local, specs) if s is None), zero)
    cut = [(t, s) for t, s in zip(local, specs) if s is not None]
    if cut:
        cut_sq = sum((t.float() ** 2).sum() for t, _ in cut)
        dist.all_reduce(cut_sq, group=cut[0][1].group)
        sq = sq + cut_sq
    if any(is_dtensor(t) for t in tensors):
        dist.all_reduce(sq, group=tensors[0].device_mesh.get_group())
    return float(torch.sqrt(sq))


# --- tensor parallelism over the model axis ------------------------------------

# (parameter name, dimension cut, groups): JAX's TP_RULES (sharding.py:27-34)
# over the port's (out, in) weights. A dimension of ``groups`` equal blocks
# is cut within each block: qkv's rows are (q, k, v) x heads x head dim.
TP_RULES = (
    (r"^trunk\.blocks\.\d+\.attn\.qkv\.weight$", 0, 3),
    (r"^trunk\.blocks\.\d+\.attn\.qkv\.bias$", 0, 3),
    (r"^trunk\.blocks\.\d+\.attn\.proj\.weight$", 1, 1),
    (r"^trunk\.blocks\.\d+\.mlp\.fc1\.weight$", 0, 1),
    (r"^trunk\.blocks\.\d+\.mlp\.fc1\.bias$", 0, 1),
    (r"^trunk\.blocks\.\d+\.mlp\.fc2\.weight$", 1, 1),
)


@dataclasses.dataclass(frozen=True, eq=False)
class TPShard:
    """How a parameter is cut over the model axis: dimension ``dim``, seen
    as ``groups`` equal blocks, each cut into ``size`` contiguous parts;
    this rank (``rank`` on ``group``) holds part ``rank`` of every block."""

    dim: int
    groups: int
    group: Any
    rank: int
    size: int

    def _blocks(self, t: torch.Tensor) -> torch.Tensor:
        return t.unflatten(self.dim, (self.groups, t.shape[self.dim] // self.groups))

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the one-device tensor ``full``."""
        per = full.shape[self.dim] // self.groups // self.size
        part = self._blocks(full).narrow(self.dim + 1, self.rank * per, per)
        return part.flatten(self.dim, self.dim + 1).contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The one-device tensor from every rank's part (an all-reduce of
        the parts placed in zeros: gloo reduces CUDA tensors, and a sum
        with zeros is exact)."""
        shape = list(local.shape)
        shape[self.dim] *= self.size
        full = local.new_zeros(shape)
        per = local.shape[self.dim] // self.groups
        self._blocks(full).narrow(self.dim + 1, self.rank * per, per).copy_(self._blocks(local))
        dist.all_reduce(full, group=self.group)
        return full


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` in float32 (a new tensor)."""
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model ranks (each holds
    the part that its heads or hidden units sent back)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the model ranks' partial ``x``, in float32 (bf16 partial
    sums are reduced in float32; the caller adds its bias and rounds
    once); the gradient passes as it is, cast to ``x``'s dtype."""
    return _ReduceFromModel.apply(x, group)


def check_model_extent(size: int, heads: int, hidden: int) -> None:
    """Raise unless a model axis of ``size`` ranks divides ``heads`` and
    ``hidden``, naming both."""
    if heads % size or hidden % size:
        raise ValueError(f"a model axis of {size} ranks must divide the {heads} attention heads "
                         f"and the MLP's hidden width {hidden}")


def apply_tensor_parallel(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Cut ``model`` (an ``ACR``) in place over the 1-D ``model`` mesh
    ``mesh``: each parameter that :data:`TP_RULES` names becomes this
    rank's part of it (``param.tp`` its :class:`TPShard`), and each block
    runs its H / M heads and 4D / M hidden units with the model group's
    collectives. Call it on the one-device weights, before the optimizer
    is built. Raises unless M divides the head count and the hidden
    width."""
    group, rank, size = mesh.get_group(), mesh.get_local_rank(), mesh.size()
    trunk = model.trunk
    heads, hidden = trunk.num_heads, trunk.blocks[0].mlp.fc1.out_features
    check_model_extent(size, heads, hidden)
    for name, p in list(model.named_parameters()):
        rule = next((r for r in TP_RULES if re.match(r[0], name)), None)
        if rule is None:
            continue
        spec = TPShard(rule[1], rule[2], group, rank, size)
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        part = nn.Parameter(spec.cut(p.detach()), requires_grad=p.requires_grad)
        part.tp = spec
        setattr(owner, name.rsplit(".", 1)[1], part)
    for block in trunk.blocks:
        block.attn.num_heads = heads // size
        block.tp_group = block.attn.tp_group = group
        block.attn.tp_size = size
    return model
