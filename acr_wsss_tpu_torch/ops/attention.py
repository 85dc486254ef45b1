"""Plain attention with probability export and a post-softmax gradient tap.

Counterpart of ``acr_wsss_tpu/ops/attention.py::_attention_xla``
(``:69-93``). Dtype policy as there: the products take the caller's dtype
(bf16 on the card) with float32 accumulation, the logits, the softmax and
the exported probabilities are float32, and the probabilities are rounded
to the dtype of v before ``p @ v``.

``probs_offset`` (zeros in practice) is added right after the softmax, so
``d loss / d probs_offset == d loss / d probs``: the tensor GETAM reads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

EXPORTS = ("mean", "full", "none")


def attention_with_probs(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    probs_offset: Optional[torch.Tensor] = None,
    export: str = "mean",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """q, k, v: (B, H, N, D). Returns (out (B, H, N, D) in v's dtype,
    probs: (B, N, N) head mean for 'mean', (B, H, N, N) for 'full', None
    for 'none')."""
    if export not in EXPORTS:
        raise ValueError(f"unknown export mode {export!r}")
    # bf16 x bf16 products are exact in float32, so float32 operands give
    # the float32-accumulated product of the bf16 inputs.
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    if probs_offset is not None:
        probs = probs + probs_offset.float()
    out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)
    if export == "mean":
        return out, probs.mean(dim=1)
    if export == "full":
        return out, probs
    return out, None
