"""GETAM: gradient-weighted attention CAMs.

Counterpart of ``acr_wsss_tpu/getam.py``. The trunk takes zero
``probs_offsets`` added after each tapped block's softmax, so
``d logit / d offsets == d logit / d probs``: the tensor the reference's
attention hook saves. The offsets are one zero leaf tensor that requires
grad; each class slot gets one ``torch.autograd.grad`` with
``retain_graph=True`` over the graph of a single forward.

Variants (``getam.py:37-59``), with g the per-head gradient and a the
per-head probs, ReLU per head before the head mean:

  grad:        mean_h(relu(g))
  grad_s:      mean_h(relu(g)) * mean_h(relu(g))
  cam_grad:    mean_h(relu(g * a))
  cam_grad_s:  mean_h(relu(g * a)) * mean_h(relu(g))
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

GETAM_FUNCS = ("grad", "grad_s", "cam_grad", "cam_grad_s")


def getam_reduce(grads: torch.Tensor, probs: Optional[torch.Tensor],
                 func: str) -> torch.Tensor:
    """(L, B, H, N, N) gradients [and probs] -> (L, B, N, N)."""
    if func == "grad":
        return F.relu(grads).mean(dim=2)
    if func == "grad_s":
        g = F.relu(grads).mean(dim=2)
        return g * g
    if func == "cam_grad":
        return F.relu(grads * probs).mean(dim=2)
    if func == "cam_grad_s":
        return F.relu(grads * probs).mean(dim=2) * F.relu(grads).mean(dim=2)
    raise ValueError(f"unknown getam func {func!r}; choose from {GETAM_FUNCS}")


def getam_cams(
    forward: Callable[[torch.Tensor], Tuple[torch.Tensor, ...]],
    offsets_shape: Tuple[int, ...],
    num_classes: int,
    start_layer: int,
    func: str = "grad",
    start_index: int = 1,
    use_aff: bool = False,
    class_ids: Optional[Sequence[int] | torch.Tensor] = None,
    offsets_start: int = 0,
    device: torch.device | str = "cuda",
):
    """GETAM CAMs from one forward and one backward per class slot.

    ``forward``: offsets (L', B, H, N, N) -> (logits (B, C), probs (L, B,
    H, N, N) or head mean (L, B, N, N)[, extra]); the offsets cover the
    last L' = L - ``offsets_start`` layers. Returns (cams (K, B, N - s),
    logits, patch_aff (B, N - s, N - s)[, extra]), all detached.
    """
    L, B, H, N, _ = offsets_shape
    if not 0 <= offsets_start <= start_layer:
        raise ValueError(f"offsets_start ({offsets_start}) must lie in "
                         f"[0, start_layer={start_layer}]")
    offsets = torch.zeros(offsets_shape, dtype=torch.float32, device=device,
                          requires_grad=True)
    outs = forward(offsets)
    logits, probs_full = outs[0], outs[1]
    extras = tuple(e.detach() for e in outs[2:])
    if probs_full.shape[0] - offsets_start != L:
        raise ValueError(f"offsets cover {L} layers from layer {offsets_start}, "
                         f"but the forward exports {probs_full.shape[0]} layers")
    per_head = probs_full.dim() == 5
    if not per_head and func in ("cam_grad", "cam_grad_s"):
        raise ValueError(f"getam func {func!r} needs per-head probs; run the "
                         "forward with export='full'")
    probs_full = probs_full.detach()
    probs_mean = probs_full.mean(dim=2) if per_head else probs_full
    patch_aff = probs_mean[:, :, start_index:, start_index:].sum(dim=0)

    if class_ids is None:
        class_ids = range(num_classes)
    # A tensor of ids stays a tensor, so that a traced program takes its
    # class ids as an input (serving.py).
    ids = torch.as_tensor(class_ids, dtype=torch.long, device=logits.device)
    cams = []
    for k in range(len(ids)):
        (grads,) = torch.autograd.grad(logits.index_select(1, ids[k:k + 1]).sum(), offsets,
                                       retain_graph=True)
        per_layer = getam_reduce(grads, probs_full[offsets_start:] if per_head else None,
                                 func)
        cam = F.relu(per_layer[start_layer - offsets_start:].sum(dim=0)[:, 0, start_index:])
        if use_aff:
            cam = torch.einsum("bnm,bm->bn", patch_aff, cam)
        cams.append(cam)
    return (torch.stack(cams), logits.detach(), patch_aff) + extras


def make_forward_for_getam(model, x: torch.Tensor, export: str = "full",
                           with_patch_cam: bool = False):
    """offsets -> (logits, probs layer-major[, patch_cam]) over an ACR."""
    method = model.forward_cam if with_patch_cam else model.forward_cls

    def forward(offsets):
        out = method(x, probs_offsets=offsets, export=export)
        probs = out["probs"].movedim(1, 0)
        if with_patch_cam:
            return out["logits"], probs, out["patch_cam"]
        return out["logits"], probs

    return forward


def tap_config(model, start_layer: int, func: str) -> Tuple[int, str]:
    """(first tapped layer, export mode), shared by ``infer_cam`` and
    ``serving``: taps only from ``start_layer`` (the lower gradients are
    never read), and per-head probs only for the ``cam_grad`` variants
    (``getam.py:209-226``)."""
    off_start = min(start_layer, model.spec.depth)
    export = "full" if func in ("cam_grad", "cam_grad_s") else "mean"
    return off_start, export


def grad_cam(features: torch.Tensor, head_fn: Callable[[torch.Tensor], torch.Tensor],
             class_index: int) -> torch.Tensor:
    """Classic Grad-CAM over a feature map (``getam.py:229-249``; the
    reference's legacy ``DPT/DPT.py:536-564``): the weights are the spatial
    mean of d logit_c / d features, the CAM ReLU(sum_k w_k A_k).

    ``features`` (B, K, H, W) are the tapped layer's maps (NCHW, as the
    port's models return them), ``head_fn`` maps them to (B, C) logits (the
    rest of the network). Returns the (B, H, W) CAM."""
    with torch.enable_grad():
        f = features if features.requires_grad else features.detach().requires_grad_(True)
        logits = head_fn(f)
        (grads,) = torch.autograd.grad(logits[:, class_index].sum(), f)
    weights = grads.mean(dim=(2, 3), keepdim=True)        # GAP over H, W
    return F.relu((weights * features).sum(dim=1))
