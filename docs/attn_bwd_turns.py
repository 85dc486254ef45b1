"""Device times of the attention backward kernels at the training shape, for
timing two versions of the port in turns.

Times K1b (``attn_cuda.attention_qkv_cols_backward``) with a float32, a
bfloat16 and no de, and K2b (``attn_pair.pair_consistency_backward``) at
B = 8, N = 577, H = 12, D = 64 (the per-layer train step's and the pair
step's shape), with CUDA events over launches enqueued while the device is
held busy (``chip_smoke.time_call``), median of three rounds of 20. It
imports whichever ``chip_smoke`` and ``acr_wsss_tpu_torch`` come first on
``sys.path``, and builds the kernels into that tree's ``build/``; it prints the ptxas lines
of a build it makes, the card, and one JSON line of microseconds. Compare
two trees by running it in turns in one call on one card, e.g.

    PYTHONPATH=old python docs/attn_bwd_turns.py; PYTHONPATH=. python docs/attn_bwd_turns.py
    PYTHONPATH=. python docs/attn_bwd_turns.py; PYTHONPATH=old python docs/attn_bwd_turns.py

Needs a CUDA card and nvcc.
"""

import json
import os
import statistics
import subprocess

import torch

from chip_smoke import time_call
from acr_wsss_tpu_torch.ops import _build
from acr_wsss_tpu_torch.ops.attn_cuda import attention_qkv_cols_backward
from acr_wsss_tpu_torch.ops.attn_pair import (pair_consistency_backward,
                                              pair_consistency_forward)

B, N, H, D = 8, 577, 12, 64


def main() -> None:
    report = _build.build(["attn_bwd", "attn_pair_fwd", "attn_fwd_headmean"]).get("attn_bwd", "")
    for line in report.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(line.strip())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    qkv = torch.randn((B, N, 3 * H * D), generator=gen, device=device).bfloat16()
    g = torch.randn((B, N, H * D), generator=gen, device=device).bfloat16()
    de = torch.randn((B, N, N), generator=gen, device=device)
    de16 = de.bfloat16()
    g_cls, g_aff = (torch.rand(B // 2, generator=gen, device=device) for _ in range(2))
    sign = pair_consistency_forward(qkv, D ** -0.5, H)[3]
    calls = {
        "K1b_f32_de": lambda: attention_qkv_cols_backward(qkv, g, de, D ** -0.5, H),
        "K1b_bf16_de": lambda: attention_qkv_cols_backward(qkv, g, de16, D ** -0.5, H),
        "K1b_no_de": lambda: attention_qkv_cols_backward(qkv, g, None, D ** -0.5, H),
        "K2b": lambda: pair_consistency_backward(qkv, g, sign, g_cls, g_aff, D ** -0.5, H),
    }
    us = {k: statistics.median(time_call(fn, 20) for _ in range(3)) * 1e3
          for k, fn in calls.items()}
    tree = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(_build.__file__))))
    print(card.strip())
    print(json.dumps({"tree": os.path.relpath(tree), "us": us}))


if __name__ == "__main__":
    main()
