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

The segmentation stage's losses (``:246-283``, ``:345-438``):
``softmax_cross_entropy_ignore`` and ``focal_loss_ignore`` (mean over the
pixels not labelled 255), ``compute_joint_ce`` (the bg/fg split of a
pseudo mask) and ``prototype_contrast_loss`` (class centroids, masked
over the classes present, no Python branch on the data).

The Swin consistency (``:284-336``): ``hflip_window_permutations`` and
``swin_window_consistency_loss``, the L1 between one block's window
probabilities and the mirrored view's, un-mirrored window by window
(shifted blocks by the roll-aware permutation where ``2*shift % ws == 0``).
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


def _window_offset(ws: int, shift: int) -> int:
    """Windows by which the mirror's shifted partition is displaced; raises
    where it straddles the original windows (``2*shift % ws != 0``)."""
    if shift and (2 * shift) % ws != 0:
        raise ValueError(
            f"shifted-window flip un-indexing needs 2*shift % ws == 0 "
            f"(got shift={shift}, ws={ws}); skip consistency on this block")
    return (2 * shift) // ws


def hflip_window_permutations(n_cols: int, ws: int, shift: int = 0
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """(window permutation over a row of ``n_cols`` windows, token
    permutation within a window) that un-mirror the window-attention export
    of a horizontally flipped view: window c shows the original window
    ``(n_cols - 1 - 2*shift//ws - c) mod n_cols`` with its columns reversed.
    The roll by -shift maps ws-aligned column blocks onto ws-aligned ones
    only when ``2*shift`` is a multiple of ``ws``; otherwise (an odd window
    with a shift) the mirrored windows straddle the original ones, and this
    raises."""
    offset = _window_offset(ws, shift)
    window_perm = (n_cols - 1 - offset - np.arange(n_cols)) % n_cols
    return window_perm, hflip_token_permutation(ws, ws)


def swin_window_consistency_loss(probs1: torch.Tensor, probs2: torch.Tensor, n_rows: int,
                                 n_cols: int, ws: int, shift: int = 0) -> torch.Tensor:
    """L1 between one block's (B, nW, ws^2, ws^2) head-mean window probs of
    a view (``probs1``) and those of its mirror (``probs2``) un-mirrored by
    the permutations of :func:`hflip_window_permutations`, nW = n_rows *
    n_cols; as flips and a roll on the device (no index upload)."""
    offset = _window_offset(ws, shift)
    b, n = probs2.shape[0], probs2.shape[-1]
    p2 = probs2.reshape(b, n_rows, n_cols, n, n)
    p2 = torch.roll(torch.flip(p2, dims=(2,)), -offset, dims=2).reshape(probs2.shape)
    p2 = _unflip_token_axis(_unflip_token_axis(p2, (ws, ws), 2), (ws, ws), 3)
    return l1_loss(probs1, p2)


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


def _picked_log_probs(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log softmax over the class axis of (B, C, H, W) logits at each
    pixel's label, in float32; the mask of pixels not ``ignore_index``)."""
    labels = torch.as_tensor(labels, device=logits.device)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    log_probs = F.log_softmax(logits.float(), dim=1)
    return torch.gather(log_probs, 1, safe[:, None])[:, 0], valid


def softmax_cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                                 ignore_index: int = 255) -> torch.Tensor:
    """Mean cross-entropy over the pixels not labelled ``ignore_index``
    (reference ``tool/loss.py:14-26``); 0 when every pixel is."""
    picked, valid = _picked_log_probs(logits, labels, ignore_index)
    loss = -torch.where(valid, picked, 0.0)
    return loss.sum() / valid.sum().clamp_min(1)


def focal_loss_ignore(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
                      alpha: float = 0.5, ignore_index: int = 255) -> torch.Tensor:
    """-alpha (1 - p_t)^gamma log p_t, mean over the pixels not ignored
    (reference ``tool/loss.py:28-51``)."""
    logpt, valid = _picked_log_probs(logits, labels, ignore_index)
    loss = -alpha * (1.0 - torch.exp(logpt)) ** gamma * logpt
    return torch.where(valid, loss, 0.0).sum() / valid.sum().clamp_min(1)


def compute_joint_ce(pred_logits: torch.Tensor, seg_label: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of the background-only view of a pseudo mask (every
    foreground pixel ignored) plus that of its foreground-only view
    (reference ``compute_joint_loss``, ``myTool.py:838-855``); 255 stays
    ignored in both."""
    seg_label = torch.as_tensor(seg_label, device=pred_logits.device)
    bg_label = torch.where(seg_label != 0, 255, seg_label)
    fg_label = torch.where(seg_label == 0, 255, seg_label)
    return (softmax_cross_entropy_ignore(pred_logits, bg_label)
            + softmax_cross_entropy_ignore(pred_logits, fg_label))


def _masked_cos(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Cosine similarity matrix between row sets a (N, D) and b (M, D)."""
    na = a.norm(dim=1, keepdim=True)
    nb = b.norm(dim=1, keepdim=True)
    return (a @ b.T) / (na @ nb.T + eps)


def prototype_contrast_loss(seg_logits: torch.Tensor, features: torch.Tensor,
                            num_classes: int = 21) -> torch.Tensor:
    """Prototype contrast regularizer (reference ``compute_dis_no_batch``,
    ``myTool.py:1624-1710``): the mean (1 - cos) distance of background
    pixels to their sample's background centroid and of each present
    foreground class's pixels to its batch-wide centroid, plus half the
    mean (1 + cos) between distinct foreground centroids and half that
    between foreground and background centroids. A class is present when
    it wins at least one pixel of ``seg_logits`` (B, C, N); ``features``
    is (B, D, N). The centroid of an absent class is a zero vector that
    every term masks out; its norm's gradient is taken as 0 there (JAX's
    is NaN)."""
    B = seg_logits.shape[0]
    D = features.shape[1]
    labels = seg_logits.argmax(dim=1)                           # (B, N)
    feats = features.transpose(1, 2)                            # (B, N, D)
    dtype = features.dtype

    bg_mask = (labels == 0).to(dtype)
    bg_num = bg_mask.sum(dim=1) + 1e-7
    bg_center = torch.einsum("bn,bnd->bd", bg_mask, feats) / bg_num[:, None]
    bg_cos = torch.einsum("bnd,bd->bn", feats, bg_center) / (
        feats.norm(dim=-1) * bg_center.norm(dim=-1)[:, None] + 1e-7)
    bg_pixel_dis = ((1.0 - bg_cos) * bg_mask).sum(dim=1) / bg_num
    bg_present = (bg_mask.sum(dim=1) >= 1).to(dtype)
    pixel_dis = torch.where(bg_present > 0, bg_pixel_dis, 2.0).sum()

    flat_feats = feats.reshape(-1, D)
    cls_ids = torch.arange(1, num_classes, device=labels.device)
    cls_mask = (labels.reshape(1, -1) == cls_ids[:, None]).to(dtype)   # (C - 1, B*N)
    cls_num = cls_mask.sum(dim=1)
    present = (cls_num >= 1).to(dtype)
    centers = (cls_mask @ flat_feats) / (cls_num[:, None] + 1e-7)
    fg_pix_dis = ((1.0 - _masked_cos(flat_feats, centers)).T * cls_mask).sum(dim=1) / (
        cls_num + 1e-7)
    pixel_dis = pixel_dis + (fg_pix_dis * present).sum()
    pixel_dis = pixel_dis / (present.sum() + B).clamp_min(1.0)

    off_eye = 1.0 - torch.eye(num_classes - 1, dtype=dtype, device=labels.device)
    pm = present[:, None] * present[None, :]
    n_pairs = (pm * off_eye).sum()
    fg_fg = (1.0 + _masked_cos(centers, centers)) * pm
    fg_fg_loss = torch.where(n_pairs > 0, (fg_fg * off_eye).sum() / n_pairs.clamp_min(1.0),
                             0.0)
    fg_bg = (1.0 + _masked_cos(centers, bg_center)) * present[:, None] * bg_present[None, :]
    n_fb = present.sum() * bg_present.sum()
    fg_bg_loss = torch.where(n_fb > 0, fg_bg.sum() / n_fb.clamp_min(1.0), 0.0)
    return pixel_dis + 0.5 * fg_fg_loss + 0.5 * fg_bg_loss
