"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need a CUDA card and ``nvcc`` and skip elsewhere.
On the card's machine: ``python -m pytest tests/test_torch_cuda.py``.
Tolerances are those of ``chip_smoke.py``, with the reasons given there.
"""

import pytest
import torch

from acr_wsss_tpu_torch.ops.attn_cuda import (attention_qkv_cols_plain,
                                              fused_attention_qkv_cols)

pytestmark = pytest.mark.cuda

H, D = 12, 64
OUT_RTOL, OUT_ATOL, PROBS_ATOL = 2.0 ** -7, 2.0 ** -8, 1e-6


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("export", ["mean", "none"])
@pytest.mark.parametrize("batch,n", [(2, 577), (3, 37), (1, 1), (2, 9)])
def test_attn_fwd_headmean_matches_plain(device, batch, n, export):
    gen = torch.Generator(device=device).manual_seed(n)
    qkv = torch.randn((batch, n, 3 * H * D), generator=gen, device=device).bfloat16()
    before = fused_attention_qkv_cols.launches
    out, probs = fused_attention_qkv_cols(qkv, D ** -0.5, H, export)
    ref_out, ref_probs = attention_qkv_cols_plain(qkv, D ** -0.5, H, export)
    torch.cuda.synchronize()
    assert fused_attention_qkv_cols.launches == before + 1
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=OUT_RTOL, atol=OUT_ATOL)
    if export == "mean":
        torch.testing.assert_close(probs, ref_probs, rtol=0, atol=PROBS_ATOL)
    else:
        assert probs is None


def test_attn_fwd_headmean_raises_on_what_it_does_not_take(device):
    qkv = torch.zeros((1, 5, 3 * H * D), device=device, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_attention_qkv_cols(qkv.float(), D ** -0.5, H)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention_qkv_cols(torch.zeros((1, 5, 6 * H * D), device=device,
                                             dtype=torch.bfloat16)[..., ::2], D ** -0.5, H)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention_qkv_cols(qkv, D ** -0.5, 2 * H)
    with pytest.raises(ValueError, match="shared-memory"):
        fused_attention_qkv_cols(torch.zeros((1, 8192, 3 * H * D), device=device,
                                             dtype=torch.bfloat16), D ** -0.5, H)
