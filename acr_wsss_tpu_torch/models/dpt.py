"""DPT decoder and the segmentation model of the second training stage.

Counterpart of ``acr_wsss_tpu/models/dpt.py`` (reference ``DPT/blocks.py``
and ``DPT/DPT.py``), with its module and parameter names, so that
``models/convert.py`` maps the flax paths one to one:

* ``Reassemble`` (``:126``): per-tap 1x1 projection of the patch tokens and
  a resample to a 4-level pyramid: level 0 a 4x4/4 transposed conv, level 1
  a 2x2/2 one, level 2 as is, level 3 a 3x3/2 conv; the readout tokens
  dropped (``ignore``), added (``add``) or concatenated and projected
  (``project``);
* ``Scratch`` (``:184``), ``ResidualConvUnit`` (``:39``),
  ``FeatureFusionBlock`` (``:61``) and ``DPTDecoder`` (``:199``): 3x3 convs
  to ``features`` channels, then top-down fusion with a 2x bilinear
  upsample (corner-aligned) per level;
* ``SELayer`` (``:80``) and ``CBAM`` (``:97``);
* ``DPTSegmentationModel`` (``:221-295``): the ViT trunk, the pyramid (the
  hybrid's first two levels are its stem's stage maps), the decoder, SE,
  the seg head and the class head on the final-norm CLS token;
* ``attention_rollout`` (``:298``).

Activations are NCHW; the model takes the JAX package's NHWC image and
returns NCHW float32 ``seg_logits``. Parameters are float32; each conv and
dense layer runs in ``dtype`` as a flax layer of that dtype does, and the
GroupNorms (eps 1e-6, flax's default), the last conv of the seg head, the
upsamples and the class head in float32, as in JAX. ``attn_impl="plain"``
is JAX's ``"xla"``, ``"kernel"`` its ``"pallas"``: the CUDA kernels, which
take bfloat16 only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from acr_wsss_tpu_torch.models.acr import resolve_backbone
from acr_wsss_tpu_torch.models.hybrid import ResNetV2Stem
from acr_wsss_tpu_torch.models.vit import VisionTransformer

READOUTS = ("ignore", "add", "project")


def apply_in(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A ``Linear``, ``Conv2d`` or ``ConvTranspose2d`` with input, weight and
    bias cast to ``dtype``, as a flax layer with that ``dtype``."""
    w = layer.weight.to(dtype)
    b = None if layer.bias is None else layer.bias.to(dtype)
    x = x.to(dtype)
    if isinstance(layer, nn.Linear):
        return F.linear(x, w, b)
    if isinstance(layer, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, layer.stride)
    return F.conv2d(x, w, b, layer.stride, layer.padding)


def _resize_matrix(n_in: int, n_out: int, like: torch.Tensor) -> torch.Tensor:
    """(n_out, n_in) weights of a corner-aligned linear resize, built on
    ``like``'s device by comparisons: neither a host copy nor
    ``F.one_hot``'s range check, which would wait for the device."""
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    src = torch.arange(n_out, dtype=torch.float32, device=like.device) * scale
    i0 = src.floor().long().clamp(max=n_in - 1)[:, None]
    w1 = src[:, None] - i0
    cols = torch.arange(n_in, device=like.device)
    return (1 - w1) * (cols == i0) + w1 * (cols == (i0 + 1).clamp(max=n_in - 1))


class _Upsample(torch.autograd.Function):
    """``F.interpolate(bilinear, align_corners=True)``, with its backward as
    two products with the resize matrices: CUDA's own backward adds into
    the input's gradient with atomics, so two runs of a step differ, and
    the weight-standardized stem amplifies that in its updates; these sums
    run in a fixed order."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.in_size = x.shape[-2:]
        return F.interpolate(x, size=size, mode="bilinear", align_corners=True)

    @staticmethod
    def backward(ctx, g):
        (h, w), g = ctx.in_size, g.float()
        a_h = _resize_matrix(h, g.shape[-2], g)
        a_w = _resize_matrix(w, g.shape[-1], g)
        return torch.matmul(torch.matmul(a_h.T, g), a_w), None


def upsample(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Corner-aligned bilinear resize in float32 (``resize_bilinear(...,
    align_corners=True)``, whose float32 weights promote a bf16 input),
    with a backward that gives the same bits on every run."""
    return _Upsample.apply(x.float(), tuple(size))


class ResidualConvUnit(nn.Module):
    """relu-conv-GroupNorm twice, plus the input (``DPT/blocks.py:277-330``)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.norm1 = nn.GroupNorm(32, features, eps=1e-6)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.norm2 = nn.GroupNorm(32, features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(apply_in(self.conv1, F.relu(x), self.dtype).float())
        h = self.norm2(apply_in(self.conv2, F.relu(h), self.dtype).float())
        return h + x


class FeatureFusionBlock(nn.Module):
    """x (+ res1(skip)) -> res2 -> 2x upsample -> 1x1 conv
    (``DPT/blocks.py:333-413``); ``with_skip=False`` for the top level,
    whose flax module never creates ``res1``."""

    def __init__(self, features: int, with_skip: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if with_skip:
            self.res1 = ResidualConvUnit(features, dtype)
        self.res2 = ResidualConvUnit(features, dtype)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.res1(skip)
        x = self.res2(x)
        x = upsample(x, (x.shape[-2] * 2, x.shape[-1] * 2))
        return apply_in(self.out_conv, x, self.dtype)


class SELayer(nn.Module):
    """Squeeze-and-excitation (``DPT/DPT.py:99-128``)."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(channels, channels // reduction)
        self.fc2 = nn.Linear(channels // reduction, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(apply_in(self.fc1, x.mean(dim=(2, 3)), self.dtype))
        s = torch.sigmoid(apply_in(self.fc2, s, self.dtype))
        return x * s[:, :, None, None]


class CBAM(nn.Module):
    """Channel attention (a shared MLP over the average and the max of each
    channel), then spatial attention (a 7x7 conv over the channel mean and
    max) (``DPT/DPT.py:49-96``). ``Dense_0`` and ``Dense_1``, the MLP's
    layers, carry the names flax gives them."""

    def __init__(self, channels: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = nn.Linear(channels, channels // reduction)
        self.Dense_1 = nn.Linear(channels // reduction, channels)
        self.spatial = nn.Conv2d(2, 1, 7, padding=3)

    def _mlp(self, v: torch.Tensor) -> torch.Tensor:
        return apply_in(self.Dense_1, F.relu(apply_in(self.Dense_0, v, self.dtype)), self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ch = self._mlp(x.mean(dim=(2, 3))) + self._mlp(x.amax(dim=(2, 3)))
        x = x * torch.sigmoid(ch)[:, :, None, None]
        sa = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(apply_in(self.spatial, sa, self.dtype))


class Reassemble(nn.Module):
    """Token taps (B, N, embed_dim) -> NCHW pyramid levels
    ``level_offset``.. (``DPT/vit.py:262-341``): level 0 4x up, 1 2x up,
    2 the patch grid, 3 2x down; ``readout`` as the module docstring says."""

    def __init__(self, embed_dim: int, out_channels: Sequence[int] = (96, 192, 384, 768),
                 level_offset: int = 0, readout: str = "ignore",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if readout not in READOUTS:
            raise ValueError(f"readout must be one of {READOUTS}, got {readout!r}")
        self.level_offset = level_offset
        self.readout = readout
        self.dtype = dtype
        for i, ch in enumerate(out_channels):
            level = i + level_offset
            if readout == "project":
                self.add_module(f"readout_proj_{level}", nn.Linear(2 * embed_dim, embed_dim))
            self.add_module(f"project_{level}", nn.Conv2d(embed_dim, ch, 1))
            if level == 0:
                self.up4 = nn.ConvTranspose2d(ch, ch, 4, stride=4)
            elif level == 1:
                self.up2 = nn.ConvTranspose2d(ch, ch, 2, stride=2)
            elif level == 3:
                self.down2 = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, taps: Sequence[torch.Tensor], grid: Tuple[int, int],
                start_index: int = 1) -> list:
        gh, gw = grid
        outs = []
        for i, tokens in enumerate(taps):
            level = i + self.level_offset
            x = tokens[:, start_index:]
            if self.readout == "add":
                x = x + tokens[:, :1]
            elif self.readout == "project":
                x = torch.cat([x, tokens[:, :1].expand_as(x)], dim=-1)
                x = F.gelu(apply_in(getattr(self, f"readout_proj_{level}"), x, self.dtype),
                           approximate="none")
            x = x.reshape(x.shape[0], gh, gw, -1).permute(0, 3, 1, 2)
            x = apply_in(getattr(self, f"project_{level}"), x, self.dtype)
            if level == 0:
                x = apply_in(self.up4, x, self.dtype)
            elif level == 1:
                x = apply_in(self.up2, x, self.dtype)
            elif level == 3:
                x = apply_in(self.down2, x, self.dtype)
            outs.append(x)
        return outs


class Scratch(nn.Module):
    """3x3 convs (no bias) of each level to ``features`` channels
    (``DPT/blocks.py:97-147``)."""

    def __init__(self, in_channels: Sequence[int], features: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for i, ch in enumerate(in_channels):
            self.add_module(f"layer{i + 1}_rn", nn.Conv2d(ch, features, 3, padding=1,
                                                          bias=False))

    def forward(self, pyramid: Sequence[torch.Tensor]) -> list:
        return [apply_in(getattr(self, f"layer{i + 1}_rn"), x, self.dtype)
                for i, x in enumerate(pyramid)]


class DPTDecoder(nn.Module):
    """Scratch and four fusion blocks over a 4-level pyramid."""

    def __init__(self, in_channels: Sequence[int], features: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scratch = Scratch(in_channels, features, dtype)
        self.refinenet4 = FeatureFusionBlock(features, with_skip=False, dtype=dtype)
        self.refinenet3 = FeatureFusionBlock(features, dtype=dtype)
        self.refinenet2 = FeatureFusionBlock(features, dtype=dtype)
        self.refinenet1 = FeatureFusionBlock(features, dtype=dtype)

    def forward(self, pyramid: Sequence[torch.Tensor]) -> torch.Tensor:
        l1, l2, l3, l4 = self.scratch(pyramid)
        p = self.refinenet4(l4)
        p = self.refinenet3(p, l3)
        p = self.refinenet2(p, l2)
        return self.refinenet1(p, l1)


class DPTSegmentationModel(nn.Module):
    """ViT trunk -> DPT decoder -> seg head, and the class head
    (reference ``DPT/DPT.py:367``). Inputs are NHWC images."""

    def __init__(self, num_classes: int = 21, backbone_name: str = "vitb",
                 features: int = 256, use_se: bool = True,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "plain"):
        super().__init__()
        self.spec = spec = resolve_backbone(backbone_name)
        self.dtype = dtype
        e = spec.embed_dim
        self.trunk = VisionTransformer(
            embed_dim=e, depth=spec.depth, num_heads=spec.num_heads,
            pretrain_grid=spec.pretrain_grid, num_prefix_tokens=spec.num_prefix_tokens,
            taps=spec.taps, backbone=ResNetV2Stem() if spec.hybrid else None,
            dtype=dtype, attn_impl=attn_impl)
        if spec.hybrid:
            # Levels 1-2 are the stem's stage0 (256 channels, stride 4) and
            # stage1 (512, stride 8); the two token taps make levels 3-4.
            self.reassemble = Reassemble(e, (e, e), level_offset=2, dtype=dtype)
            in_channels = (256, 512, e, e)
        else:
            self.reassemble = Reassemble(e, (96, 192, 384, e), dtype=dtype)
            in_channels = (96, 192, 384, e)
        self.decoder = DPTDecoder(in_channels, features, dtype)
        self.se = SELayer(features, dtype=dtype) if use_se else None
        self.seg_head = nn.Sequential(nn.Conv2d(features, features, 3, padding=1), nn.ReLU(),
                                      nn.Conv2d(features, num_classes, 1))
        self.cls_head = nn.Linear(e, num_classes - 1)

    def forward(self, x: torch.Tensor, export: str = "mean") -> Dict[str, Any]:
        """x (B, H, W, 3) -> seg_logits (B, C, H, W) float32, cls_logits
        (B, C - 1) and the trunk's probs (None for export "none")."""
        H, W = x.shape[1:3]
        out = self.trunk(x, export=export)
        spec = self.spec
        if spec.hybrid:
            toks = self.reassemble([out["taps"][t] for t in spec.taps[:2]], out["grid"],
                                   spec.num_prefix_tokens)
            stem = out["stem_features"]
            pyramid = [stem["stage0"], stem["stage1"], *toks]
        else:
            pyramid = self.reassemble([out["taps"][t] for t in spec.taps], out["grid"],
                                      spec.num_prefix_tokens)
        feats = self.decoder(pyramid)
        if self.se is not None:
            feats = self.se(feats)
        h = F.relu(apply_in(self.seg_head[0], feats, self.dtype))
        logits = upsample(apply_in(self.seg_head[2], h, torch.float32), (H, W))
        return {"seg_logits": logits,
                "cls_logits": self.cls_head(out["tokens"][:, 0].float()),
                "probs": out.get("probs")}


def attention_rollout(attn_stack: torch.Tensor, start_layer: int = 0) -> torch.Tensor:
    """Joint attention by rollout (reference ``compute_rollout_attention``,
    ``DPT/DPT.py:8-21``): per layer A' = 0.5 A + 0.5 I, rows normalized,
    chained by matrix products from ``start_layer``. (B, L, N, N) head-mean
    probabilities -> (B, N, N)."""
    n = attn_stack.shape[-1]
    eye = torch.eye(n, dtype=attn_stack.dtype, device=attn_stack.device)
    mats = 0.5 * attn_stack + 0.5 * eye
    mats = mats / mats.sum(dim=-1, keepdim=True)
    joint = mats[:, start_layer]
    for i in range(start_layer + 1, attn_stack.shape[1]):
        joint = torch.matmul(mats[:, i], joint)
    return joint
