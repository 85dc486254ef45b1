"""ACR classifier: ViT trunk with attention export and one linear head.

Counterpart of ``acr_wsss_tpu/models/acr.py``: the ``BACKBONES`` table and
aliases (``:42-90``), the head on the CLS token and on the mean of the
patch tokens of the last tap taken before the final norm (``:147-152``),
and ``forward_cls`` / ``forward_cam`` / ``forward_mirror`` (``:159-216``);
the registry's five ``acr_*`` names (``:218-240``), an ``ACR`` on each
ACR backbone but the small ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from acr_wsss_tpu_torch.models.hybrid import ResNetV2Stem
from acr_wsss_tpu_torch.models.registry import register_model
from acr_wsss_tpu_torch.models.vit import VisionTransformer


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    embed_dim: int
    depth: int
    num_heads: int
    taps: Tuple[int, ...]
    hybrid: bool = False
    num_prefix_tokens: int = 1
    pretrain_grid: int = 24


BACKBONES: Dict[str, BackboneSpec] = {
    "vitb_hybrid": BackboneSpec(768, 12, 12, (8, 11), hybrid=True),
    "vitb": BackboneSpec(768, 12, 12, (2, 5, 8, 11)),
    "vitl": BackboneSpec(1024, 24, 16, (5, 11, 17, 23)),
    "deit": BackboneSpec(768, 12, 12, (2, 5, 8, 11)),
    "deit_distilled": BackboneSpec(768, 12, 12, (2, 5, 8, 11), num_prefix_tokens=2),
    "vit_small": BackboneSpec(384, 12, 6, (2, 5, 8, 11)),
    "deit_small": BackboneSpec(384, 12, 6, (2, 5, 8, 11)),
}
BACKBONE_ALIASES = {
    "vit_base_resnet50_384": "vitb_hybrid",
    "vit_base_r50_s16_384": "vitb_hybrid",
    "vitb_rn50_384": "vitb_hybrid",
    "vit_base_patch16_384": "vitb",
    "vitb16_384": "vitb",
    "vit_large_patch16_384": "vitl",
    "vitl16_384": "vitl",
    "vit_deit_base_patch16_384": "deit",
    "deitb16_384": "deit",
    "vit_deit_base_distilled_patch16_384": "deit_distilled",
    "deitb16_distil_384": "deit_distilled",
    "vit_deit_small_patch16_224": "deit_small",
    "vit_small_patch16_224": "vit_small",
}


def resolve_backbone(name: str) -> BackboneSpec:
    name = BACKBONE_ALIASES.get(name, name)
    if name not in BACKBONES:
        raise ValueError(f"unknown backbone {name!r}; known: {sorted(BACKBONES)}")
    return BACKBONES[name]


class ACR(nn.Module):
    """The ACR classifier. Inputs are NHWC images, as in the JAX package."""

    def __init__(self, num_classes: int = 20, backbone_name: str = "vitb_hybrid",
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "kernel",
                 probs_dtype: torch.dtype = torch.float32, s2d_stem: bool = False):
        super().__init__()
        self.backbone_name = backbone_name
        self.spec = spec = resolve_backbone(backbone_name)
        self.start_index = spec.num_prefix_tokens
        self.trunk = VisionTransformer(
            embed_dim=spec.embed_dim, depth=spec.depth, num_heads=spec.num_heads,
            pretrain_grid=spec.pretrain_grid,
            num_prefix_tokens=spec.num_prefix_tokens, taps=spec.taps,
            backbone=ResNetV2Stem(s2d_stem=s2d_stem) if spec.hybrid else None,
            dtype=dtype, attn_impl=attn_impl, probs_dtype=probs_dtype)
        self.cls_head = nn.Linear(spec.embed_dim, num_classes)

    def _heads(self, layer4: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        layer4 = layer4.float()
        return (self.cls_head(layer4[:, 0]),
                self.cls_head(layer4[:, self.start_index:].mean(dim=1)))

    def forward_cls(self, x: torch.Tensor, probs_offsets: Optional[torch.Tensor] = None,
                    export: str = "mean", mirror_second_half=False) -> Dict[str, Any]:
        """logits, patch_logits, probs, probs_layers, consistency_sums,
        n_tokens, taps, grid. ``mirror_second_half`` (training, both views
        on the batch axis) un-mirrors the flipped view's token order once
        after the pos-embed, so its probs come out aligned with view 1's."""
        out = self.trunk(x, probs_offsets=probs_offsets, export=export,
                         mirror_second_half=mirror_second_half)
        logits, patch_logits = self._heads(out["taps"][self.spec.taps[-1]])
        return {"logits": logits, "patch_logits": patch_logits,
                "probs": out.get("probs"), "probs_layers": out.get("probs_layers"),
                "consistency_sums": out.get("consistency_sums"),
                "n_tokens": out["n_tokens"], "taps": out["taps"], "grid": out["grid"]}

    def forward_cam(self, x: torch.Tensor, probs_offsets: Optional[torch.Tensor] = None,
                    export: str = "mean") -> Dict[str, Any]:
        """forward_cls + per-patch class scores ReLU(head(patch tokens))."""
        out = self.trunk(x, probs_offsets=probs_offsets, export=export)
        layer4 = out["taps"][self.spec.taps[-1]]
        logits, patch_logits = self._heads(layer4)
        patch_cam = F.relu(self.cls_head(layer4[:, self.start_index:].float()))
        return {"logits": logits, "patch_logits": patch_logits,
                "probs": out["probs"], "patch_cam": patch_cam, "grid": out["grid"]}

    def forward_mirror(self, x1: torch.Tensor, x2: torch.Tensor, export: str = "mean"
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Siamese forward on (view, flipped view) as one doubled batch;
        returns the two views' halves of ``forward_cls`` (taps left out).
        Only tensors and tuples of tensors are split: the JAX method also
        splits the ``grid`` tuple of ints, which raises."""
        b = x1.shape[0]
        out = self.forward_cls(torch.cat([x1, x2], dim=0), export=export)

        def view(v, sl):
            if isinstance(v, torch.Tensor):
                return v[sl]
            if isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
                return tuple(p[sl] for p in v)
            return v

        items = [(k, v) for k, v in out.items() if k != "taps"]
        return ({k: view(v, slice(None, b)) for k, v in items},
                {k: view(v, slice(b, None)) for k, v in items})

    forward = forward_cls


def _register_acr(name: str, backbone: str) -> None:
    def builder(**kwargs):
        return ACR(backbone_name=backbone, **kwargs)

    builder.__name__ = name
    register_model(builder)


for _backbone in ("vitb_hybrid", "vitb", "vitl", "deit", "deit_distilled"):
    _register_acr(f"acr_{_backbone}", _backbone)


@torch.no_grad()
def init_random_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded numpy init in place: fan-in normal weights, unit norm scales,
    zero biases and tokens, position embedding and Swin's relative-position
    bias tables N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith(("pos_embed", "relative_position_bias_table")):
            val = 0.02 * rng.standard_normal(p.shape)
        elif leaf == "weight" and p.dim() > 1:
            fan_in = int(np.prod(p.shape[1:]))
            val = rng.standard_normal(p.shape) / np.sqrt(fan_in)
        elif leaf == "weight":
            val = np.ones(p.shape)
        else:
            val = np.zeros(p.shape)
        p.copy_(torch.from_numpy(val.astype(np.float32)))
    return model
