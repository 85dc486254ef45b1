"""timm's ViT and DeiT classifiers over the port's ViT trunk.

Counterpart of ``acr_wsss_tpu/models/vit_classifier.py``: ``ViTClassifier``
(``:31``) is the trunk of ``models/vit.py`` (the one ACR runs, with
``export="none"``: on the card every block's attention is the forward
kernel without export, K1n, at the head dims the names use: 64, 80 for
``vit_huge_patch14_224_in21k``, 96 for ``vit_small_patch16_224``) ->
the final norm -> the cls token -> the optional tanh ``pre_logits``
(the ImageNet-21k releases) -> ``head``. The distilled DeiT names add
``head_dist`` on the dist token and return the average of the two logits
(inference, ``:111-118``), with ``head_logits`` and ``dist_logits``.

Hybrids: ``hybrid`` puts the R50 stem (``ResNetV2Stem``, (3, 4, 9)) under
the trunk; ``stem_layers`` any other plan (channels ``stem_channels`` or
the first of 256, 512, 1024, 2048), ``()`` the bare stem, with a
``hybrid_patch_size`` patchify over the stem's map. ``patch_size`` is the
total stride, the grid's divisor.

The forward takes an NHWC image and returns ``logits``, ``features`` (the
tokens before the final norm), ``taps`` ({0: the final-norm tokens,
float32}) and ``grid``. The registry holds 37 of JAX's 41 names; the four
on a ResNet-D stem wait for ``models/resnet_timm.py`` (``registry.UNPORTED``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from acr_wsss_tpu_torch.models.hybrid import ResNetV2Stem
from acr_wsss_tpu_torch.models.registry import register_model
from acr_wsss_tpu_torch.models.vit import VisionTransformer


class ViTClassifier(nn.Module):
    def __init__(self, num_classes: int = 1000, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 patch_size: int = 16, pretrain_grid: int = 14, distilled: bool = False,
                 representation_size: Optional[int] = None, hybrid: bool = False,
                 stem_layers: Optional[Sequence[int]] = None,
                 stem_channels: Optional[Sequence[int]] = None, hybrid_patch_size: int = 1,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "kernel"):
        super().__init__()
        backbone = None
        if stem_layers is not None:
            backbone = ResNetV2Stem(stem_layers, stem_channels
                                    or (256, 512, 1024, 2048)[:len(stem_layers)])
        elif hybrid:
            backbone = ResNetV2Stem()
        self.distilled = distilled
        self.trunk = VisionTransformer(
            embed_dim=embed_dim, depth=depth, num_heads=num_heads, mlp_ratio=mlp_ratio,
            patch_size=patch_size, pretrain_grid=pretrain_grid,
            num_prefix_tokens=2 if distilled else 1, taps=(), backbone=backbone, dtype=dtype,
            attn_impl=attn_impl, qkv_bias=qkv_bias, hybrid_patch_size=hybrid_patch_size)
        width = embed_dim
        if representation_size is not None:
            self.pre_logits = nn.Linear(embed_dim, representation_size)
            width = representation_size
        self.head = nn.Linear(width, num_classes)
        if distilled:
            self.head_dist = nn.Linear(embed_dim, num_classes)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        out = self.trunk(x, export="none")
        tokens = out["tokens"]
        cls = tokens[:, 0]
        if hasattr(self, "pre_logits"):
            cls = torch.tanh(self.pre_logits(cls))
        logits = self.head(cls)
        result: Dict[str, Any] = {"features": out["pre_norm_tokens"], "taps": {0: tokens},
                                  "grid": out["grid"]}
        if self.distilled:
            dist_logits = self.head_dist(tokens[:, 1])
            result["head_logits"], result["dist_logits"] = logits, dist_logits
            logits = (logits + dist_logits) / 2
        result["logits"] = logits
        return result


def _vit(name: str, **cfg) -> None:
    def builder(**kwargs):
        for k, v in cfg.items():
            kwargs.setdefault(k, v)
        return ViTClassifier(**kwargs)

    builder.__name__ = name
    register_model(builder)


# The pure ViTs (timm ``vision_transformer.py:632-881``); pretrain_grid is
# the training resolution over the patch size.
_B16 = dict(embed_dim=768, depth=12, num_heads=12, patch_size=16)
_B32 = dict(embed_dim=768, depth=12, num_heads=12, patch_size=32)
_L16 = dict(embed_dim=1024, depth=24, num_heads=16, patch_size=16)
_L32 = dict(embed_dim=1024, depth=24, num_heads=16, patch_size=32)

# timm's own "small": 768 wide, 8 blocks of 8 heads (head dim 96), mlp 3,
# no qkv bias.
_vit("vit_small_patch16_224", embed_dim=768, depth=8, num_heads=8, mlp_ratio=3.0,
     qkv_bias=False, patch_size=16, pretrain_grid=14)
_vit("vit_base_patch16_224", pretrain_grid=14, **_B16)
_vit("vit_base_patch32_224", pretrain_grid=7, **_B32)
_vit("vit_base_patch16_384", pretrain_grid=24, **_B16)
_vit("vit_base_patch32_384", pretrain_grid=12, **_B32)
_vit("vit_large_patch16_224", pretrain_grid=14, **_L16)
_vit("vit_large_patch32_224", pretrain_grid=7, **_L32)
_vit("vit_large_patch16_384", pretrain_grid=24, **_L16)
_vit("vit_large_patch32_384", pretrain_grid=12, **_L32)
# The ImageNet-21k releases keep the representation layer.
_vit("vit_base_patch16_224_in21k", num_classes=21843, representation_size=768,
     pretrain_grid=14, **_B16)
_vit("vit_base_patch32_224_in21k", num_classes=21843, representation_size=768,
     pretrain_grid=7, **_B32)
_vit("vit_large_patch16_224_in21k", num_classes=21843, representation_size=1024,
     pretrain_grid=14, **_L16)
_vit("vit_large_patch32_224_in21k", num_classes=21843, representation_size=1024,
     pretrain_grid=7, **_L32)
# 1280 wide, 16 heads: head dim 80.
_vit("vit_huge_patch14_224_in21k", num_classes=21843, embed_dim=1280, depth=32, num_heads=16,
     patch_size=14, representation_size=1280, pretrain_grid=16)
# DeiT.
_vit("vit_deit_tiny_patch16_224", embed_dim=192, depth=12, num_heads=3, patch_size=16,
     pretrain_grid=14)
_vit("vit_deit_small_patch16_224", embed_dim=384, depth=12, num_heads=6, patch_size=16,
     pretrain_grid=14)
_vit("vit_deit_base_patch16_224", pretrain_grid=14, **_B16)
_vit("vit_deit_base_patch16_384", pretrain_grid=24, **_B16)
_vit("vit_deit_tiny_distilled_patch16_224", embed_dim=192, depth=12, num_heads=3,
     patch_size=16, pretrain_grid=14, distilled=True)
_vit("vit_deit_small_distilled_patch16_224", embed_dim=384, depth=12, num_heads=6,
     patch_size=16, pretrain_grid=14, distilled=True)
_vit("vit_deit_base_distilled_patch16_224", pretrain_grid=14, distilled=True, **_B16)
_vit("vit_deit_base_distilled_patch16_384", pretrain_grid=24, distilled=True, **_B16)
# MIIL: B/16 without qkv bias.
_vit("vit_base_patch16_224_miil_in21k", num_classes=11221, qkv_bias=False, pretrain_grid=14,
     **_B16)
_vit("vit_base_patch16_224_miil", qkv_bias=False, pretrain_grid=14, **_B16)
# R50-stem hybrids (timm ``vision_transformer_hybrid.py:136-170``), the stem
# ACR runs, and their two aliases.
_vit("vit_base_r50_s16_224_in21k", num_classes=21843, representation_size=768, hybrid=True,
     pretrain_grid=14, **_B16)
_vit("vit_base_r50_s16_384", hybrid=True, pretrain_grid=24, **_B16)
_vit("vit_base_resnet50_224_in21k", num_classes=21843, representation_size=768, hybrid=True,
     pretrain_grid=14)
_vit("vit_base_resnet50_384", hybrid=True, pretrain_grid=24)
# Other stem plans (``:172-270``; no pretrained weights upstream): the stem
# gives stride 4 * 2^(stages - 1), the patchify the rest.
_vit("vit_tiny_r_s16_p8_224", embed_dim=192, depth=12, num_heads=3, stem_layers=(),
     hybrid_patch_size=8, patch_size=32, pretrain_grid=7)
_vit("vit_small_r_s16_p8_224", embed_dim=384, depth=12, num_heads=6, stem_layers=(),
     hybrid_patch_size=8, patch_size=32, pretrain_grid=7)
_vit("vit_small_r20_s16_p2_224", embed_dim=384, depth=12, num_heads=6, stem_layers=(2, 4),
     hybrid_patch_size=2, patch_size=16, pretrain_grid=14)
_vit("vit_small_r20_s16_224", embed_dim=384, depth=12, num_heads=6, stem_layers=(2, 2, 2),
     patch_size=16, pretrain_grid=14)
_vit("vit_small_r26_s32_224", embed_dim=384, depth=12, num_heads=6, stem_layers=(2, 2, 2, 2),
     patch_size=32, pretrain_grid=7)
_vit("vit_base_r20_s16_224", stem_layers=(2, 2, 2), patch_size=16, pretrain_grid=14,
     embed_dim=768, depth=12, num_heads=12)
_vit("vit_base_r26_s32_224", stem_layers=(2, 2, 2, 2), patch_size=32, pretrain_grid=7,
     embed_dim=768, depth=12, num_heads=12)
_vit("vit_base_r50_s16_224", hybrid=True, patch_size=16, pretrain_grid=14, embed_dim=768,
     depth=12, num_heads=12)
# 768 wide with 12 heads, as timm defines it.
_vit("vit_large_r50_s32_224", stem_layers=(3, 4, 6, 3), patch_size=32, pretrain_grid=7,
     embed_dim=768, depth=12, num_heads=12)
