"""A backbone reduced to its feature pyramid (``features_only``).

Counterpart of ``acr_wsss_tpu/models/features.py``: the registry's CNN
classifiers return their stage maps as ``taps``, so ``FeatureExtractor``
(``:52``) selects and orders them (deepest last): a list, or with
``as_dict`` a dict keyed by tap index or by the ``out_map`` names.
Token-sequence models refuse with JAX's ``RuntimeError`` (``:40-49``), as
the reference's ViT and Swin families do: their taps are not spatial maps.
The maps are NCHW, PyTorch's layout (JAX's are NHWC).

``feature_info`` gives (reduction, channels) per selected tap, like
timm's ``FeatureInfo``; JAX traces the model abstractly
(``jax.eval_shape``), the port runs it on the meta device: no arithmetic,
no memory for activations.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn as nn


def _ordered_taps(out: Any, name: str) -> List[torch.Tensor]:
    """The taps of one model output, deepest last; raises for a model
    without spatial ones."""
    if not isinstance(out, dict) or "taps" not in out:
        raise RuntimeError(
            f"features_only not implemented for {name!r}: the model does not export "
            "pyramid taps (the reference raises the same for its ViT/Swin families)")
    taps = out["taps"]
    vals = [taps[k] for k in sorted(taps)] if isinstance(taps, dict) else list(taps)
    if not vals or any(v.dim() != 4 for v in vals):
        raise RuntimeError(
            f"features_only not implemented for {name!r}: taps are not spatial pyramid "
            "maps (token-sequence backbones refuse features_only, as in the reference)")
    return vals


class FeatureExtractor(nn.Module):
    """``model`` whose forward returns the selected taps (``FeatureListNet``,
    or ``FeatureDictNet`` with ``as_dict`` or an ``out_map``). The model
    keeps its parameters: its state dict is the wrapper's under ``model.``."""

    def __init__(self, model: nn.Module, out_indices: Optional[Sequence[int]] = None,
                 name: str = "?", as_dict: bool = False,
                 out_map: Optional[Sequence[Any]] = None):
        super().__init__()
        self.model = model
        self.out_indices = tuple(out_indices) if out_indices is not None else None
        self.name = name
        self.as_dict = as_dict or out_map is not None
        self.out_map = tuple(out_map) if out_map is not None else None

    def forward(self, x: torch.Tensor, **kwargs):
        return self._select(self.model(x, **kwargs))

    def _select(self, out):
        vals = _ordered_taps(out, self.name)
        idx = list(self.out_indices if self.out_indices is not None else range(len(vals)))
        picked = [vals[i] for i in idx]
        if not self.as_dict:
            return picked
        keys = self.out_map if self.out_map is not None else idx
        if len(keys) != len(picked):
            raise ValueError(f"out_map has {len(keys)} names for {len(picked)} taps")
        return dict(zip(keys, picked))

    def feature_info(self, input_size: int = 224) -> List[Dict[str, int]]:
        """(reduction, num_chs) of each selected tap at an ``input_size``
        square input, from a forward on the meta device (with the plain
        attention: the kernels take no meta tensors)."""
        meta = {k: torch.empty_like(v, device="meta")
                for k, v in [*self.model.named_parameters(), *self.model.named_buffers()]}
        x = torch.zeros((1, input_size, input_size, 3), device="meta")
        impls = {m: m.attn_impl for m in self.model.modules() if hasattr(m, "attn_impl")}
        try:
            for m in impls:
                m.attn_impl = "plain"
            with torch.no_grad():
                feats = self._select(torch.func.functional_call(self.model, meta, (x,)))
        finally:
            for m, impl in impls.items():
                m.attn_impl = impl
        if isinstance(feats, dict):
            feats = list(feats.values())
        return [{"reduction": input_size // int(f.shape[2]), "num_chs": int(f.shape[1])}
                for f in feats]
