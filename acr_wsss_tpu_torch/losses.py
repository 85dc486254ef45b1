"""ACR training losses: multilabel classification and attention consistency.

Counterpart of ``acr_wsss_tpu/losses.py`` (``:1-243``); reference semantics
``train_acr.py:137-168``:

* ``multilabel_soft_margin_loss`` on the CLS logits of both siamese views;
* L1 between view 1 and the un-flipped view 2 over the CLS-to-patch
  attention rows and over the patch-to-patch affinity blocks.

Un-flipping a row-major token axis reverses the column dimension of the
patch grid (``_unflip_token_axis``); the legacy gather path uses the
self-inverse permutation of :func:`hflip_token_permutation`. The fused path
takes per-pair sums of |p1 - p2| computed in the attention kernel
(``ops/attn_pair.py``) and normalizes them to the same losses.

The seg, Swin and prototype losses of the JAX module are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hflip_token_permutation(grid_h: int, grid_w: int) -> np.ndarray:
    """Permutation p with ``tokens_flipped[i] = tokens[p[i]]`` for a
    horizontally flipped image's patch grid, row-major; self-inverse."""
    idx = np.arange(grid_h * grid_w).reshape(grid_h, grid_w)
    return idx[:, ::-1].reshape(-1).copy()


def unflip_attention(attn: torch.Tensor, perm: torch.Tensor,
                     axes: Tuple[int, ...] = (-2, -1)) -> torch.Tensor:
    """Apply the flip permutation along the given token axes."""
    perm = torch.as_tensor(perm, device=attn.device, dtype=torch.long)
    for ax in axes:
        attn = torch.index_select(attn, ax, perm)
    return attn


def multilabel_soft_margin_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``mean_b(mean_c(-[y log sigmoid(x) + (1 - y) log sigmoid(-x)]))``
    with the stable log-sigmoid, in float32."""
    logits = logits.float()
    labels = labels.float()
    loss = -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))
    return loss.mean()


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean()


def _unflip_token_axis(x: torch.Tensor, grid: Tuple[int, int], axis: int) -> torch.Tensor:
    """Un-mirror a row-major token axis of length p*q by reversing its
    column dimension."""
    p, q = grid
    axis = axis % x.dim()
    shape = x.shape[:axis] + (p, q) + x.shape[axis + 1:]
    return torch.flip(x.reshape(shape), dims=(axis + 1,)).reshape(x.shape)


def acr_consistency_losses(attn1: torch.Tensor, attn2: torch.Tensor,
                           perm=None, grid: Tuple[int, int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cls_align, aff_align) over (B, L, N, N) head-mean stacks; view 2 is
    un-flipped (one axis for the CLS row, both for the affinity block), by
    reversal when ``grid`` is given, else by the permutation ``perm``."""
    attn1_cls = attn1[:, :, 0, 1:]
    attn1_aff = attn1[:, :, 1:, 1:]
    attn2_cls = attn2[:, :, 0, 1:]
    attn2_aff = attn2[:, :, 1:, 1:]
    if grid is not None:
        attn2_cls = _unflip_token_axis(attn2_cls, grid, -1)
        attn2_aff = _unflip_token_axis(_unflip_token_axis(attn2_aff, grid, -2), grid, -1)
    else:
        attn2_cls = unflip_attention(attn2_cls, perm, axes=(-1,))
        attn2_aff = unflip_attention(attn2_aff, perm, axes=(-2, -1))
    return l1_loss(attn1_cls, attn2_cls), l1_loss(attn1_aff, attn2_aff)


def acr_consistency_losses_layers(probs_layers: Sequence[torch.Tensor], b: int,
                                  grid: Tuple[int, int], aligned: bool = False
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same losses over per-layer (2b, N, N) exports, both views
    stacked on the batch axis; each layer contributes its mean and layers
    are averaged. ``aligned=True``: the trunk already un-mirrored view 2's
    tokens, so no un-flip here."""
    cls_sum = 0.0
    aff_sum = 0.0
    for probs in probs_layers:
        a1, a2 = probs[:b], probs[b:]
        a1_cls, a2_cls = a1[:, 0, 1:], a2[:, 0, 1:]
        a1_aff, a2_aff = a1[:, 1:, 1:], a2[:, 1:, 1:]
        if not aligned:
            a2_cls = _unflip_token_axis(a2_cls, grid, -1)
            a2_aff = _unflip_token_axis(_unflip_token_axis(a2_aff, grid, -2), grid, -1)
        cls_sum = cls_sum + l1_loss(a1_cls, a2_cls)
        aff_sum = aff_sum + l1_loss(a1_aff, a2_aff)
    n = len(probs_layers)
    return cls_sum / n, aff_sum / n


def _total(cls_loss_1, cls_loss_2, cls_align, aff_align, alpha
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    total = cls_loss_1 + cls_loss_2 + alpha * cls_align + alpha * aff_align
    return total, {
        "cls_loss_1": cls_loss_1,
        "cls_loss_2": cls_loss_2,
        "cls_align_loss": cls_align,
        "aff_align_loss": aff_align,
        "loss": total,
    }


def acr_total_loss_layers(logits1, logits2, probs_layers, labels, grid, alpha,
                          aligned: bool = False):
    """ACR objective over per-layer exports: (total, parts)."""
    b = labels.shape[0]
    cls_align, aff_align = acr_consistency_losses_layers(probs_layers, b, grid,
                                                         aligned=aligned)
    return _total(multilabel_soft_margin_loss(logits1, labels),
                  multilabel_soft_margin_loss(logits2, labels),
                  cls_align, aff_align, alpha)


def acr_total_loss_fused(logits1, logits2, consistency_sums, labels, n_tokens: int,
                         alpha: float):
    """ACR objective over in-kernel per-pair sums: each layer's
    (cls_sums, aff_sums) normalized by pairs*(N-1) and pairs*(N-1)^2, then
    averaged over layers; equals :func:`acr_total_loss_layers` (aligned)."""
    b = labels.shape[0]
    n1 = n_tokens - 1
    cls_align = 0.0
    aff_align = 0.0
    for cls_s, aff_s in consistency_sums:
        cls_align = cls_align + cls_s.sum() / (b * n1)
        aff_align = aff_align + aff_s.sum() / (b * n1 * n1)
    n = len(consistency_sums)
    return _total(multilabel_soft_margin_loss(logits1, labels),
                  multilabel_soft_margin_loss(logits2, labels),
                  cls_align / n, aff_align / n, alpha)


def acr_total_loss(logits1, logits2, attn1, attn2, labels, perm, alpha):
    """Full ACR objective over (B, L, N, N) stacks (reference
    ``train_acr.py:160-168``): (total, parts)."""
    n_patches = attn1.shape[-1] - 1
    p = int(round(n_patches ** 0.5))
    grid = (p, p) if p * p == n_patches else None
    cls_align, aff_align = acr_consistency_losses(attn1, attn2, perm, grid)
    return _total(multilabel_soft_margin_loss(logits1, labels),
                  multilabel_soft_margin_loss(logits2, labels),
                  cls_align, aff_align, alpha)
