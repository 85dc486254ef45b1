#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``acr_wsss_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and exits
non-zero without one. Imports nothing of JAX and nothing of the JAX
package. Phases, each of which fails the run when it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds every kernel into build/torch_kernels/, all at
   once, with the ``-Xptxas -v`` lines printed;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and at ragged ones (N = 17, 37, and 1025, crop
   512, which is not a multiple of the attention kernels' 64-token tiles):
   K1f/K1n (export "mean" in float32 and bfloat16, and "none"), K2f, K2b
   (fed K2f's own sign tile), K1b (a float32 or bfloat16 dense de, or
   none), K3 and K4 chained over 10 iterations (at B=2 and B=8 views of
   384x384 with the default dilations, and 17x13 with a dilation beyond
   the image); K1f and K1b at N = 4001 (B=1), above the 3.4k-token limit
   of the earlier attention kernels; and the attention kernels twice on
   the same inputs, which must give the same bits, for every export mode
   and every source of de;
4. inference path: GETAM CAM inference as a user runs it (vitb_hybrid,
   crop 384, ``grad`` from layer 10, affinity refinement, flip TTA, 4
   class slots) on two seeded VOC-sized images, with the weights of
   bench_artifacts/stability_r3/stability_r3_last.npz when present, else
   seeded random ones; launches counted; CAM dicts written to a temporary
   directory and scored by the port's ``evaluate``; CAMs checked against
   the same run with plain attention; then the same with ``--pamr 10``
   (K3 once and K4 10 times per image), PAMR alone checked against its
   plain version on the same CAMs, and the whole path against plain
   attention with plain PAMR;
5. training path: ``train.train`` as a user runs it (vitb_hybrid, crop
   384, batch 4, the recipe: lr 0.05, alpha 125, fused consistency) from
   seeded random weights on a seeded synthetic VOC fixture of 375x500
   JPEGs, a few steps and a validation pass; launches counted; every loss
   part finite; the final npz read by the port's ``infer_cam``;
6. one train step of the kernel path against the plain path from the same
   weights and batch, for the fused branch and the per-layer branch (which
   launches K1f and K1b): step-0 loss parts and parameters after the
   update;
7. attention entries: K5a (``attention_with_probs(impl="kernel")``), K5b
   (``fused_attention_nhd``) and K5c (``fused_attention_qkv``), forward
   and backward, against their plain versions at the training shape (B=8,
   N=577) with a float32 and a bfloat16 export; then each entry through
   autograd as a user calls it, launches counted, gradients against the
   plain backward; then the per-layer branch with ``probs_dtype=
   "bfloat16"`` (K1f exporting bf16, K1b reading a bf16 de): one step
   against the plain path, and ``train.train`` for a few steps, launches
   counted;
8. pipeline: ``pipeline.main`` as a user runs it, train -> infer with
   ``--pamr 10`` -> 100-threshold eval (vitb_hybrid, crop 384, the
   recipe) on the training fixture with seeded label PNGs; launches
   counted; the npz, one CAM dict per name and the evallog checked;
9. timing: per-image latency with and without PAMR, the PAMR step's device
   time, train step time and images/s, device time breakdowns, each
   kernel's device time (CUDA events around launches enqueued while the
   device is held busy) beside its plain version, a library call where one
   computes the same function, and its bound.

The second-to-last lines are the card's name and power limit and a JSON
object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

sys.dont_write_bytecode = True
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from PIL import Image  # noqa: E402

from acr_wsss_tpu_torch import evaluate  # noqa: E402
from acr_wsss_tpu_torch import infer_cam  # noqa: E402
from acr_wsss_tpu_torch import pipeline  # noqa: E402
from acr_wsss_tpu_torch import train as train_mod  # noqa: E402
from acr_wsss_tpu_torch.configs import InferConfig, ModelConfig, TrainConfig  # noqa: E402
from acr_wsss_tpu_torch.data import voc as voc_data  # noqa: E402
from acr_wsss_tpu_torch.infer_cam import build_infer_fn, process_image  # noqa: E402
from acr_wsss_tpu_torch.models.acr import ACR, init_random_  # noqa: E402
from acr_wsss_tpu_torch.models import vit as vit_mod  # noqa: E402
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from acr_wsss_tpu_torch.ops import _build, attn_pair  # noqa: E402
from acr_wsss_tpu_torch.ops import pamr as pamr_ops  # noqa: E402
from acr_wsss_tpu_torch.ops.attention import attention_with_probs  # noqa: E402
from acr_wsss_tpu_torch.ops.attn_cuda import (BWD_KERNEL, KERNEL,  # noqa: E402
                                              attention_qkv_cols_backward,
                                              attention_qkv_cols_backward_plain,
                                              attention_qkv_cols_forward,
                                              attention_qkv_cols_plain,
                                              backward_plain, fused_attention_nhd,
                                              fused_attention_qkv,
                                              fused_attention_qkv_cols,
                                              fused_attention_with_probs)
from acr_wsss_tpu_torch.ops.attn_cuda import backward as attn_backward  # noqa: E402
from acr_wsss_tpu_torch.ops.attn_cuda import forward as attn_forward  # noqa: E402
from acr_wsss_tpu_torch.ops.attn_cuda import forward_plain  # noqa: E402
from acr_wsss_tpu_torch.ops.attn_pair import (pair_consistency_backward,  # noqa: E402
                                              pair_consistency_backward_plain,
                                              pair_consistency_forward,
                                              pair_consistency_forward_plain)
from acr_wsss_tpu_torch.ops.pamr import (make_pamr_fn, pamr_affinity,  # noqa: E402
                                         pamr_affinity_plain, pamr_plain, pamr_update,
                                         pamr_update_plain)
from acr_wsss_tpu_torch.utils.checkpoint import load_params_npz  # noqa: E402

WEIGHTS = os.path.join(ROOT, "bench_artifacts", "stability_r3", "stability_r3_last.npz")
CROP, START_LAYER, CLASS_SLOTS, HEADS, HEAD_DIM, DEPTH = 384, 10, 4, 12, 64, 12
N_TOKENS = (CROP // 16) ** 2 + 1
IMAGE_SIZES = ((375, 500), (333, 500))
# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W): bf16
# on the tensor cores, fp32 on the CUDA cores, device memory.
PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
# Kernel against its plain version, both bf16 in / bf16 out on the card.
# probs: float32 on both sides, logits summed in another order -> ~1e-7
# relative on p <= 1. out: p is rounded to bf16 before p @ v on both sides,
# so a last-bit difference in p can flip one term's rounding (2^-8 * p *
# |v|, absolute) and the final bf16 rounding adds one ulp (2^-8 relative).
PROBS_ATOL = 1e-6
OUT_RTOL, OUT_ATOL = 2.0 ** -7, 2.0 ** -8
# bf16 export: kernel and plain version each round a float32 head mean once,
# and the means agree within PROBS_ATOL, so the two bf16 values are at most
# one bf16 ulp apart: 2^-7 of the value at most (values just above a power
# of two), plus PROBS_ATOL where a mean is near 0.
BF16_PROBS_RTOL = 2.0 ** -7
# CAMs (min-max normalized to [0, 1]) of the kernel path against the plain
# path, both bf16 through 12 blocks: the rounding differences above, carried
# through blocks 0-9 and the GETAM backward of blocks 10-11.
CAM_MAX_ABS, CAM_MEAN_ABS = 0.05, 0.005
# K2f sums of |delta|: float32 over up to N^2 terms in another order ->
# rtol 1e-5. Sign tile: equal wherever the plain |delta| exceeds SIGN_EPS,
# above the float32 error of two 12-term head means of probabilities <= 1
# (24 roundings of at most 2^-24 each). K2b and K1b dqkv: float32
# arithmetic in another order, then one bf16 rounding on each side -> one
# bf16 ulp (2^-7 relative), plus 1e-4 of the tensor's largest value for
# entries that cancel to near zero (sums of up to N terms).
SUM_RTOL, SIGN_EPS = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL_FRAC = 2.0 ** -7, 1e-4
# Training path: the recipe at batch 4, 16 training and 4 validation
# images, one epoch: 4 updates, so 5 train steps (range(0, max_step + 1)).
TRAIN_BATCH, TRAIN_IMAGES, VAL_IMAGES = 4, 16, 4
TRAIN_SIZES = ((375, 500), (500, 375), (333, 500), (375, 500))
# One train step, kernel path against plain path, both bf16 through the
# stem and 12 blocks: bf16 rounding (2^-8 relative) of each block's output
# carried to the logits and the probabilities -> step-0 loss parts within
# 2e-2 relative. After the update, each parameter tensor's update p1 - p0
# within 5e-2 of the plain path's in L2 norm (the relative tolerance of
# the hybrid's one-step test against the reference, tests/
# test_train_parity.py): the two backward formulations round to bf16 at
# other places (the kernels' backward is float32 on a recomputed p), and
# weight standardization in the stem amplifies gradients about 12x, so
# an element-wise bound on parameters would be set by the largest
# updates, not by the error.
LOSS_RTOL, UPDATE_REL = 2e-2, 5e-2
# PAMR as ``--pamr 10`` runs it: 10 iterations over the default dilations
# (P = 48 neighbours), 20 class rows, guidance 3 x 384 x 384 per view.
# K3 and K4 against their plain versions, float32 on both sides: the taps
# and the neighbours are summed in the same order, so only the softmax's
# sum and the scalar divisions may round otherwise -> the JAX package's
# own tolerance between its Pallas kernels and its XLA formulation
# (tests/test_pamr.py), also after 10 chained K4 steps (each step is a
# convex combination, which does not grow an error).
PAMR_ITERS, PAMR_DILATIONS, NUM_CLASSES = 10, (1, 2, 4, 8, 12, 24), 20
PAMR_RTOL, PAMR_ATOL = 2e-5, 2e-6
# Pipeline phase: 8 of the training fixture's images (2 updates, 3 train
# steps) and its 4 validation images as the inference and eval list.
PIPE_TRAIN_IMAGES = 8
KERNELS = (KERNEL, attn_pair.KERNEL, BWD_KERNEL, pamr_ops.KERNEL)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def check_close(name, got, ref, rtol, atol) -> float:
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    max_err = err.max().item()
    log(f"  {name}: max abs err {max_err:.3g} (tolerance {atol:.3g} + {rtol:.3g}*|ref|)")
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of tolerance, "
                             f"max abs err {max_err:.3g}")
    return max_err


def check_k1(device, errs) -> None:
    gen = torch.Generator(device=device).manual_seed(0)
    for B, N in ((2, N_TOKENS), (4, N_TOKENS), (3, 37), (3, 17), (2, 1025)):
        qkv = torch.randn((B, N, 3 * HEADS * HEAD_DIM), generator=gen, device=device,
                          dtype=torch.float32).to(torch.bfloat16)
        for export in ("mean", "none"):
            out, probs = fused_attention_qkv_cols(qkv, HEAD_DIM ** -0.5, HEADS, export)
            ref_out, ref_probs = attention_qkv_cols_plain(qkv, HEAD_DIM ** -0.5, HEADS, export)
            torch.cuda.synchronize()
            log(f"  K1 forward B={B} N={N} export={export}")
            err = check_close("out", out, ref_out, OUT_RTOL, OUT_ATOL)
            if export == "mean":
                err = max(err, check_close("probs", probs, ref_probs, 0.0, PROBS_ATOL))
            elif probs is not None:
                raise AssertionError("export='none' returned probs")
            errs[("K1", B, N, export)] = err
        out, probs = fused_attention_qkv_cols(qkv, HEAD_DIM ** -0.5, HEADS, "mean",
                                              torch.bfloat16)
        ref_out, ref_probs = attention_qkv_cols_plain(qkv, HEAD_DIM ** -0.5, HEADS, "mean",
                                                      torch.bfloat16)
        torch.cuda.synchronize()
        log(f"  K1 forward B={B} N={N} export=mean, probs bfloat16")
        if probs.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 export came back as {probs.dtype}")
        errs[("K1", B, N, "mean_bf16")] = max(
            check_close("out", out, ref_out, OUT_RTOL, OUT_ATOL),
            check_close("probs", probs, ref_probs, BF16_PROBS_RTOL, PROBS_ATOL))


def check_grad(name, got, ref) -> float:
    atol = GRAD_ATOL_FRAC * ref.float().abs().max().item()
    return check_close(name, got, ref, GRAD_RTOL, atol)


def check_k2_k1b(device, errs) -> None:
    gen = torch.Generator(device=device).manual_seed(1)
    scale = HEAD_DIM ** -0.5
    for B, N in ((2 * TRAIN_BATCH, N_TOKENS), (2, 37), (2, 17), (2, 1025)):
        qkv = torch.randn((B, N, 3 * HEADS * HEAD_DIM), generator=gen,
                          device=device).to(torch.bfloat16)
        g = torch.randn((B, N, HEADS * HEAD_DIM), generator=gen,
                        device=device).to(torch.bfloat16)
        log(f"  K2f B={B} N={N}")
        out, cls_s, aff_s, sign = pair_consistency_forward(qkv, scale, HEADS)
        ref_out, ref_cls, ref_aff, ref_sign = pair_consistency_forward_plain(qkv, scale, HEADS)
        _, probs = attention_qkv_cols_plain(qkv, scale, HEADS, "mean")
        torch.cuda.synchronize()
        err = check_close("out", out, ref_out, OUT_RTOL, OUT_ATOL)
        err = max(err, check_close("cls_sums", cls_s, ref_cls, SUM_RTOL, 0.0))
        err = max(err, check_close("aff_sums", aff_s, ref_aff, SUM_RTOL, 0.0))
        clear = (probs[0::2] - probs[1::2]).abs() > SIGN_EPS
        flips = int((sign != ref_sign).sum())
        bad = int((sign != ref_sign)[clear].sum())
        log(f"  sign tile: {flips} of {sign.numel()} entries differ from the plain "
            f"version, {bad} of them where |delta| > {SIGN_EPS}")
        if bad or sign.dtype != torch.int8:
            raise AssertionError("K2f sign tile disagrees with the plain version")
        errs[("K2f", B, N)] = err

        log(f"  K2b B={B} N={N} (plain version fed the kernel's sign tile)")
        g_cls = torch.rand(B // 2, generator=gen, device=device) * 100
        g_aff = torch.rand(B // 2, generator=gen, device=device) * 100
        got = pair_consistency_backward(qkv, g, sign, g_cls, g_aff, scale, HEADS)
        ref = pair_consistency_backward_plain(qkv, g, sign, g_cls, g_aff, scale, HEADS)
        torch.cuda.synchronize()
        errs[("K2b", B, N)] = check_grad("dqkv", got, ref)

        for with_de in (True, False, "bf16"):
            de = torch.randn((B, N, N), generator=gen, device=device) if with_de else None
            if with_de == "bf16":
                de = de.to(torch.bfloat16)
            log(f"  K1b B={B} N={N} de={'none' if de is None else de.dtype}")
            got = attention_qkv_cols_backward(qkv, g, de, scale, HEADS)
            ref = attention_qkv_cols_backward_plain(qkv, g, de, scale, HEADS)
            torch.cuda.synchronize()
            errs[("K1b", B, N, with_de)] = check_grad("dqkv", got, ref)


def check_many_tokens(device, errs, n=4001) -> None:
    """K1f and K1b at B=1 and more tokens than the earlier kernels'
    shared-memory limit (about 3.4k): the tensor-core kernels have none."""
    gen = torch.Generator(device=device).manual_seed(6)
    scale = HEAD_DIM ** -0.5
    qkv = torch.randn((1, n, 3 * HEADS * HEAD_DIM), generator=gen,
                      device=device).to(torch.bfloat16)
    log(f"  K1 forward B=1 N={n}, export mean")
    out, probs = attention_qkv_cols_forward(qkv, scale, HEADS, "mean")
    ref_out, ref_probs = attention_qkv_cols_plain(qkv, scale, HEADS, "mean")
    torch.cuda.synchronize()
    errs[("K1", 1, n, "mean")] = max(check_close("out", out, ref_out, OUT_RTOL, OUT_ATOL),
                                     check_close("probs", probs, ref_probs, 0.0, PROBS_ATOL))
    del out, probs, ref_out, ref_probs
    g = torch.randn((1, n, HEADS * HEAD_DIM), generator=gen, device=device).to(torch.bfloat16)
    de = torch.randn((1, n, n), generator=gen, device=device)
    log(f"  K1b B=1 N={n} de float32")
    got = attention_qkv_cols_backward(qkv, g, de, scale, HEADS)
    ref = attention_qkv_cols_backward_plain(qkv, g, de, scale, HEADS)
    torch.cuda.synchronize()
    errs[("K1b", 1, n, True)] = check_grad("dqkv", got, ref)


def check_same_bits(device) -> None:
    """The forward kernel (export fp32, bf16, none) and the backward kernel
    (de none, fp32, bf16 and the sign tile) twice on the same inputs at the
    training shape: the outputs must be equal to the bit (no atomics, sums
    in a fixed order)."""
    gen = torch.Generator(device=device).manual_seed(7)
    B, N, scale = 2 * TRAIN_BATCH, N_TOKENS, HEAD_DIM ** -0.5
    qkv = torch.randn((B, N, 3 * HEADS * HEAD_DIM), generator=gen,
                      device=device).to(torch.bfloat16)
    g = torch.randn((B, N, HEADS * HEAD_DIM), generator=gen, device=device).to(torch.bfloat16)
    de = torch.randn((B, N, N), generator=gen, device=device)
    g_cls, g_aff = (torch.rand(B // 2, generator=gen, device=device) * 100 for _ in range(2))
    sign = pair_consistency_forward(qkv, scale, HEADS)[3]
    runs = {f"forward, export {export} {str(dtype)[6:]}":
            lambda export=export, dtype=dtype: attention_qkv_cols_forward(qkv, scale, HEADS,
                                                                          export, dtype)
            for export, dtype in (("mean", torch.float32), ("mean", torch.bfloat16),
                                  ("none", torch.float32))}
    runs.update({f"backward, de {name}":
                 lambda d=d: (attention_qkv_cols_backward(qkv, g, d, scale, HEADS),)
                 for name, d in (("none", None), ("float32", de),
                                 ("bfloat16", de.to(torch.bfloat16)))})
    runs["backward, sign tile"] = lambda: (pair_consistency_backward(
        qkv, g, sign, g_cls, g_aff, scale, HEADS),)
    for name, run in runs.items():
        first, second = run(), run()
        torch.cuda.synchronize()
        same = all((a is None and b is None) or torch.equal(a, b) for a, b in zip(first, second))
        log(f"  {name}: two launches {'equal to the bit' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{name}: two launches on the same inputs differ")


def check_pamr(device, errs) -> None:
    """K3, and K4 chained over PAMR_ITERS launches on the same affinity,
    against their plain versions: B=2 and B=8 views of 384x384 with the
    default dilations, and a ragged 17x13 image with dilation 24."""
    gen = torch.Generator(device=device).manual_seed(2)
    for B, H, W, dils in ((2, CROP, CROP, PAMR_DILATIONS), (8, CROP, CROP, PAMR_DILATIONS),
                          (1, 17, 13, (1, 24))):
        x = torch.randn((B, 3, H, W), generator=gen, device=device)
        m = torch.rand((B, NUM_CLASSES, H, W), generator=gen, device=device)
        log(f"  K3 B={B} {H}x{W} dilations {dils}")
        aff = pamr_affinity(x, dils)
        ref = pamr_affinity_plain(x, dils)
        torch.cuda.synchronize()
        errs[("K3", B, H, W)] = check_close("aff", aff, ref, PAMR_RTOL, PAMR_ATOL)
        log(f"  K4 B={B} C={NUM_CLASSES} {H}x{W}, {PAMR_ITERS} chained launches")
        got = pamr_update(m, aff, dils, PAMR_ITERS)
        ref = m
        for _ in range(PAMR_ITERS):
            ref = pamr_update_plain(ref, aff, dils)
        torch.cuda.synchronize()
        errs[("K4", B, H, W)] = check_close("mask", got, ref, PAMR_RTOL, PAMR_ATOL)


def phase_kernels(device) -> dict:
    """Kernel against plain version; returns max abs errs by case."""
    errs: dict = {}
    check_k1(device, errs)
    check_k2_k1b(device, errs)
    check_many_tokens(device, errs)
    check_same_bits(device)
    check_pamr(device, errs)
    return errs


ENTRIES = {"K5a": fused_attention_with_probs, "K5b": fused_attention_nhd,
           "K5c": fused_attention_qkv}
ENTRY_LAYOUTS = {"K5a": "bhnd", "K5b": "nhd", "K5c": "cols"}
# The export dtypes each entry takes (JAX's K5a exports float32 only).
ENTRY_DTYPES = {"K5a": (torch.float32,), "K5b": (torch.float32, torch.bfloat16),
                "K5c": (torch.float32, torch.bfloat16)}


def zero_counts() -> dict:
    return {"K1f": 0, "K1n": 0, "K1b": 0, "K2f": 0, "K2b": 0, "K3": 0, "K4": 0,
            **{f"{e}{d}": 0 for e in ENTRIES for d in "fb"}}


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    fused_attention_qkv_cols.launches = 0
    fused_attention_qkv_cols.launches_noexport = 0
    attention_qkv_cols_backward.launches = 0
    pair_consistency_forward.launches = 0
    pair_consistency_backward.launches = 0
    pamr_affinity.launches = 0
    pamr_update.launches = 0
    for fn in ENTRIES.values():
        fn.launches = fn.launches_noexport = fn.backward_launches = 0


def read_counts() -> dict:
    noexport = fused_attention_qkv_cols.launches_noexport
    return {"K1f": fused_attention_qkv_cols.launches - noexport, "K1n": noexport,
            "K1b": attention_qkv_cols_backward.launches,
            "K2f": pair_consistency_forward.launches,
            "K2b": pair_consistency_backward.launches,
            "K3": pamr_affinity.launches, "K4": pamr_update.launches,
            **{f"{e}f": fn.launches for e, fn in ENTRIES.items()},
            **{f"{e}b": fn.backward_launches for e, fn in ENTRIES.items()}}


def make_images(tmp: str, seed: int):
    """Seeded VOC-sized JPEGs, 1-3 labels each, and label PNGs."""
    rng = np.random.default_rng(seed)
    names, paths, labels = [], [], []
    os.makedirs(os.path.join(tmp, "gt"))
    for i, (h, w) in enumerate(IMAGE_SIZES):
        name = f"smoke_{i}"
        coarse = rng.integers(0, 256, (h // 25, w // 25, 3), dtype=np.uint8)
        img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
        img.save(os.path.join(tmp, f"{name}.jpg"), quality=90)
        classes = rng.choice(20, size=int(rng.integers(1, 4)), replace=False)
        label = np.zeros(20, np.float32)
        label[classes] = 1.0
        gt = rng.choice(np.concatenate([[0], classes + 1]), size=(h // 25, w // 25))
        Image.fromarray(gt.astype(np.uint8)).resize((w, h), Image.NEAREST).save(
            os.path.join(tmp, "gt", f"{name}.png"))
        names.append(name)
        paths.append(os.path.join(tmp, f"{name}.jpg"))
        labels.append(label)
    return names, paths, labels


def load_model(device, attn_impl, state=None) -> ACR:
    model = ACR(backbone_name="vitb_hybrid", dtype=torch.bfloat16, attn_impl=attn_impl)
    if state is not None:
        model.load_state_dict(state)
    elif os.path.exists(WEIGHTS):
        model.load_state_dict(flax_to_state_dict(load_params_npz(WEIGHTS),
                                                 model.state_dict()))
        log(f"  weights: {os.path.relpath(WEIGHTS, ROOT)} (flax npz through the converter)")
    else:
        init_random_(model, seed=0)
        log("  weights: seeded random init (seed 0); the tracked npz is absent")
    return model.to(device)


def check_cams(names, labels, cams, sizes) -> None:
    """One CAM per present class, finite, in [0, 1], at native size."""
    for name, lab, cam, (h, w) in zip(names, labels, cams, sizes):
        present = sorted(np.flatnonzero(lab).tolist())
        if sorted(cam) != present:
            raise AssertionError(f"{name}: CAM classes {sorted(cam)} != labels {present}")
        for c, m in cam.items():
            if m.shape != (h, w) or not np.isfinite(m).all() or m.min() < 0 or m.max() > 1:
                raise AssertionError(f"{name} class {c}: shape {m.shape}, range "
                                     f"[{m.min()}, {m.max()}]")


def compare_cams(what, cams, refs) -> None:
    diffs = [np.abs(cam[c] - ref[c]) for cam, ref in zip(cams, refs) for c in cam]
    max_abs = max(d.max() for d in diffs)
    mean_abs = float(np.mean([d.mean() for d in diffs]))
    log(f"  {what}: max abs {max_abs:.4g} (tolerance {CAM_MAX_ABS}), mean abs "
        f"{mean_abs:.4g} (tolerance {CAM_MEAN_ABS})")
    if max_abs > CAM_MAX_ABS or mean_abs > CAM_MEAN_ABS:
        raise AssertionError(f"{what}: the kernel and plain paths disagree")


def phase_main_path(device, tmp):
    """The inference path without and with ``--pamr 10``. Returns (infer
    fn, image paths, labels, launches, launches with PAMR, PAMR fn, PAMR's
    first input (guidance, CAMs))."""
    model = load_model(device, "kernel")
    names, paths, labels = make_images(tmp, seed=0)
    infer = build_infer_fn(model, CROP, START_LAYER, "grad", True, NUM_CLASSES,
                           class_slots=CLASS_SLOTS)
    passes = sum(math.ceil(int((lab > 0).sum()) / CLASS_SLOTS) for lab in labels)

    reset_counts()
    cams = [process_image(infer, p, lab, CROP)[0] for p, lab in zip(paths, labels)]
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"  launches: {launches} over {passes} trunk passes "
        f"({launches['K1f'] / passes:g} K1f per pass, blocks 0-{START_LAYER - 1})")
    if launches != {**zero_counts(), "K1f": START_LAYER * passes}:
        raise AssertionError(f"expected {START_LAYER} K1f launches per pass and no other")
    check_cams(names, labels, cams, IMAGE_SIZES)
    for name, cam in zip(names, cams):
        np.save(os.path.join(tmp, f"{name}.npy"), cam)
    log(f"  CAMs: {sum(len(c) for c in cams)} maps, finite, in [0, 1], native size")
    curve = evaluate.do_python_eval_curve(tmp, os.path.join(tmp, "gt"), names, num_workers=1)
    best = max(range(len(curve)), key=lambda i: curve[i]["mIoU"])
    log(f"  evaluate: mIoU curve of {len(curve)} thresholds on seeded labels, "
        f"best {curve[best]['mIoU']:.3f}% at {best / 100:.2f}")

    pamr_fn = make_pamr_fn(PAMR_ITERS, PAMR_DILATIONS)
    inputs = []

    def keep_inputs(x, mask):
        inputs.append((x.clone(), mask.clone()))
        return pamr_fn(x, mask)

    reset_counts()
    cams_pamr = [process_image(infer, p, lab, CROP, pamr_fn=keep_inputs)[0]
                 for p, lab in zip(paths, labels)]
    torch.cuda.synchronize()
    pamr_launches = read_counts()
    log(f"  with --pamr {PAMR_ITERS} (dilations {PAMR_DILATIONS}): launches {pamr_launches} "
        f"over {len(paths)} images, one scale")
    if pamr_launches != {**zero_counts(), "K1f": START_LAYER * passes, "K3": len(paths),
                         "K4": PAMR_ITERS * len(paths)}:
        raise AssertionError(f"expected {START_LAYER} K1f per pass, 1 K3 and {PAMR_ITERS} "
                             f"K4 per image, and no other")
    check_cams(names, labels, cams_pamr, IMAGE_SIZES)
    log(f"  CAMs with PAMR: {sum(len(c) for c in cams_pamr)} maps, finite, in [0, 1], "
        f"native size")
    # PAMR alone, kernels against plain on the same CAMs; the CAMs are not
    # in [0, 1], so the absolute part of the tolerance scales with them.
    for x, mask in inputs:
        ref = pamr_plain(x, mask, PAMR_ITERS, PAMR_DILATIONS)
        got = pamr_fn(x, mask)
        torch.cuda.synchronize()
        log(f"  PAMR alone on the inference path's CAMs {tuple(mask.shape)} -> "
            f"{tuple(ref.shape)}, |CAM| <= {ref.abs().max().item():.4g}")
        check_close("refined CAMs", got, ref, PAMR_RTOL, PAMR_ATOL * ref.abs().max().item())

    plain = load_model(device, "plain", state=model.state_dict())
    plain_infer = build_infer_fn(plain, CROP, START_LAYER, "grad", True, NUM_CLASSES,
                                 class_slots=CLASS_SLOTS)
    plain_pamr = functools.partial(pamr_plain, num_iter=PAMR_ITERS, dilations=PAMR_DILATIONS)
    refs = [process_image(plain_infer, p, lab, CROP)[0] for p, lab in zip(paths, labels)]
    refs_pamr = [process_image(plain_infer, p, lab, CROP, pamr_fn=plain_pamr)[0]
                 for p, lab in zip(paths, labels)]
    compare_cams("kernel path vs plain path CAMs", cams, refs)
    compare_cams(f"with --pamr {PAMR_ITERS}, kernel path vs plain attention and plain PAMR",
                 cams_pamr, refs_pamr)
    del plain, plain_infer
    return infer, paths, labels, launches, pamr_launches, pamr_fn, inputs[0]


def make_train_fixture(root: str, seed: int) -> TrainConfig:
    """A seeded synthetic VOC fixture (375x500-class JPEGs, 1-3 labels each,
    cls_labels.npy, train and val lists) and the recipe's config over it."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "JPEGImages")
    os.makedirs(img_dir)
    names, labels = [], {}
    for i in range(TRAIN_IMAGES + VAL_IMAGES):
        h, w = TRAIN_SIZES[i % len(TRAIN_SIZES)]
        name = f"2007_{i:06d}"
        coarse = rng.integers(0, 256, (h // 25, w // 25, 3), dtype=np.uint8)
        Image.fromarray(coarse).resize((w, h), Image.BILINEAR).save(
            os.path.join(img_dir, f"{name}.jpg"), quality=90)
        label = np.zeros(20, np.float32)
        label[rng.choice(20, size=int(rng.integers(1, 4)), replace=False)] = 1.0
        names.append(name)
        labels[name] = label
    np.save(os.path.join(root, "cls_labels.npy"), labels)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names[:TRAIN_IMAGES]) + "\n")
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(names[TRAIN_IMAGES:]) + "\n")
    return TrainConfig(
        model=ModelConfig(backbone="vitb_hybrid", attn_impl="kernel", fuse_consistency=True),
        crop_size=CROP, batch_size=TRAIN_BATCH, max_epochs=1, log_every=1,
        val_every=TRAIN_IMAGES // TRAIN_BATCH, checkpoint_dir=os.path.join(root, "weight"),
        session_name="smoke", image_dir=img_dir,
        train_list=os.path.join(root, "train.txt"), val_list=os.path.join(root, "val.txt"),
        cls_labels_path=os.path.join(root, "cls_labels.npy"), num_workers=4,
        device="cuda")


def phase_train_path(device, root):
    """train.train as a user runs it; returns (config, launches, state)."""
    cfg = make_train_fixture(root, seed=0)
    log(f"  recipe: {cfg.model.backbone}, crop {cfg.crop_size}, batch {cfg.batch_size} "
        f"({2 * cfg.batch_size} images through the trunk), lr {cfg.lr}, alpha {cfg.alpha}, "
        f"wd {cfg.weight_decay}, momentum {cfg.momentum}, fused consistency; "
        f"weights: seeded random init (seed {cfg.seed}); {TRAIN_IMAGES} training and "
        f"{VAL_IMAGES} validation images")
    reset_counts()
    state = train_mod.train(cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    depth = state.model.spec.depth
    val_passes = math.ceil(VAL_IMAGES / cfg.batch_size)
    expected = {**zero_counts(), "K2f": depth * state.steps, "K2b": depth * state.steps,
                "K1n": depth * val_passes}
    log(f"  launches: {launches} over {state.steps} train steps and {val_passes} "
        f"validation batch (expected {expected})")
    if launches != expected:
        raise AssertionError("the training path did not launch the kernels as expected")
    for step, parts in enumerate(state.history):
        log(f"  step {step}: " + ", ".join(f"{k} {v:.6g}" for k, v in parts.items()))
        if not all(math.isfinite(v) for v in parts.values()):
            raise AssertionError(f"step {step}: a loss part is not finite")
    npz = os.path.join(cfg.checkpoint_dir, f"{cfg.session_name}_last.npz")
    model = infer_cam.load_model(InferConfig(weights=npz, device="cuda"))
    infer = build_infer_fn(model, CROP, START_LAYER, "grad", True, 20, class_slots=CLASS_SLOTS)
    name = voc_data.read_file(cfg.val_list)[0]
    labels = voc_data.load_cls_labels(cfg.cls_labels_path)
    cam, _, rgb = process_image(infer, os.path.join(cfg.image_dir, f"{name}.jpg"),
                                labels[name], CROP)
    if not cam or not all(np.isfinite(m).all() and m.shape == rgb.shape[:2]
                          for m in cam.values()):
        raise AssertionError("infer_cam on the trained npz gave no or non-finite CAMs")
    log(f"  {os.path.basename(npz)} ({os.path.getsize(npz) / 1e6:.1f} MB) read by the "
        f"port's infer_cam: {len(cam)} finite CAMs at {rgb.shape[0]}x{rgb.shape[1]}")
    del model, infer
    return cfg, launches, state


def _attn_inputs(model):
    """Forward hooks that keep each block's attention input."""
    inputs, handles = [], []
    for block in model.trunk.blocks:
        handles.append(block.attn.register_forward_hook(
            lambda mod, args, out: inputs.append((mod, args[0].detach()))))
    return inputs, handles


@torch.no_grad()
def kernel_signs(model, x):
    """The K2f sign tiles of the fused forward of ``model`` on the
    interleaved pairs of ``x`` and its flip, one per layer."""
    xi = torch.stack([x, torch.flip(x, dims=(2,))], dim=1).reshape((-1,) + x.shape[1:])
    inputs, handles = _attn_inputs(model)
    try:
        model.forward_cls(xi, export="pair_l1", mirror_second_half="interleaved")
    finally:
        for h in handles:
            h.remove()
    return [pair_consistency_forward(F.linear(a, m.qkv.weight.to(a.dtype),
                                              m.qkv.bias.to(a.dtype)),
                                     m.scale, m.num_heads)[3] for m, a in inputs]


@torch.no_grad()
def plain_signs(model, x):
    """sign(mean_h p1 - mean_h p2) of the plain per-layer aligned forward."""
    b = x.shape[0]
    out = model.forward_cls(torch.cat([x, torch.flip(x, dims=(2,))]), mirror_second_half=True)
    cls_mask, aff_mask = attn_pair.pair_masks(out["n_tokens"], x.device)
    return [torch.where(cls_mask | aff_mask, torch.sign(p[:b] - p[b:]), 0.0).to(torch.int8)
            for p in out["probs_layers"]]


def one_step(cfg, attn_impl, fuse, state_dict, batch, grid):
    """(model, optimizer, step-0 parts, parameters before, after) of one
    train step from ``state_dict`` on ``batch``."""
    tcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, attn_impl=attn_impl, fuse_consistency=fuse))
    model = train_mod.build_model(tcfg.model)
    model.load_state_dict(state_dict)
    model.to(cfg.device)
    opt = train_mod.make_optimizer(model.parameters(), tcfg.lr, TRAIN_IMAGES // TRAIN_BATCH,
                                   tcfg.weight_decay, tcfg.momentum, tcfg.poly_power)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    parts = train_mod.make_train_step(model, opt, tcfg, grid)(batch)
    parts = {k: float(v) for k, v in parts.items()}
    after = {k: v.detach().clone() for k, v in model.named_parameters()}
    return model, opt, parts, before, after


def compare_steps(name, got, ref) -> None:
    """Step-0 loss parts and parameters after one update, against the
    plain path's."""
    _, _, parts, p0, p1 = got
    _, _, ref_parts, _, ref_p1 = ref
    for k in ref_parts:
        rel = abs(parts[k] - ref_parts[k]) / max(abs(ref_parts[k]), 1e-30)
        log(f"    {k}: {parts[k]:.7g} vs plain {ref_parts[k]:.7g} (rel {rel:.3g}, "
            f"tolerance {LOSS_RTOL})")
        if rel > LOSS_RTOL:
            raise AssertionError(f"{name}: step-0 {k} disagrees with the plain path")
    rel = {}
    for k in ref_p1:
        ref_u = ref_p1[k] - p0[k]
        rel[k] = float((p1[k] - p0[k] - ref_u).norm() / ref_u.norm().clamp_min(1e-30))
    worst = sorted(rel, key=rel.get, reverse=True)
    attn = [k for k in rel if ".attn.qkv." in k]
    log(f"    update p1 - p0 against the plain path's, relative L2 per tensor: worst "
        + ", ".join(f"{k} {rel[k]:.3g}" for k in worst[:3])
        + f"; attention qkv weights at most {max(rel[k] for k in attn):.3g} "
        f"(tolerance {UPDATE_REL})")
    if rel[worst[0]] > UPDATE_REL:
        raise AssertionError(f"{name}: parameter updates disagree with the plain path")


def phase_step_compare(device, cfg):
    """One train step, kernel path against plain path, from the same seeded
    weights and the first training batch. Returns (fused kernel step's
    model, optimizer, batch, per-layer launches, (weights, grid, batch,
    the plain step))."""
    grid = (cfg.crop_size // 16, cfg.crop_size // 16)
    weights = init_random_(train_mod.build_model(cfg.model), seed=cfg.seed).state_dict()
    labels = voc_data.load_cls_labels(cfg.cls_labels_path)
    it = voc_data.TrainIterator(
        voc_data.VOCClassificationSource(cfg.image_dir, labels, cfg.crop_size),
        voc_data.read_file(cfg.train_list), cfg.batch_size, seed=cfg.seed, num_workers=4)
    batch = next(it)
    it.close()

    plain = one_step(cfg, "plain", False, weights, batch, grid)
    fused = one_step(cfg, "kernel", True, weights, batch, grid)
    log("  fused branch (K2f, K2b) against the plain per-layer path:")
    compare_steps("fused branch", fused, plain)
    x = torch.as_tensor(batch["image"]).to(device)
    model_k = train_mod.build_model(cfg.model).to(device)
    model_k.load_state_dict(weights)
    model_p = train_mod.build_model(dataclasses.replace(cfg.model, attn_impl="plain")).to(device)
    model_p.load_state_dict(weights)
    ks, ps = kernel_signs(model_k, x), plain_signs(model_p, x)
    differ = sum(int((a != b).sum()) for a, b in zip(ks, ps))
    total = sum(a.numel() for a in ks)
    log(f"  sign-tile entries that differ between the kernel and the plain path at step 0: "
        f"{differ} of {total} ({100 * differ / total:.4f}%), over {len(ks)} layers")
    del model_k, model_p

    reset_counts()
    per_layer = one_step(cfg, "kernel", False, weights, batch, grid)
    torch.cuda.synchronize()
    launches = read_counts()
    depth = per_layer[0].spec.depth
    log(f"  per-layer branch (K1f, K1b) against the plain per-layer path; launches "
        f"{launches}")
    if launches != {**zero_counts(), "K1f": depth, "K1b": depth}:
        raise AssertionError(f"expected {depth} K1f and {depth} K1b launches, no other")
    compare_steps("per-layer branch", per_layer, plain)
    del per_layer
    return fused[0], fused[1], batch, launches, (weights, grid, batch, plain)


class _PlainK1(torch.autograd.Function):
    """K1 and its VJP as their plain versions, on any device."""

    @staticmethod
    def forward(ctx, qkv, scale, num_heads, export, probs_dtype):
        ctx.save_for_backward(qkv)
        ctx.scale, ctx.num_heads = scale, num_heads
        ctx.set_materialize_grads(False)
        return attention_qkv_cols_plain(qkv, scale, num_heads, export, probs_dtype)

    @staticmethod
    def backward(ctx, g_out, g_probs):
        (qkv,) = ctx.saved_tensors
        if g_out is None:
            g_out = qkv.new_zeros(qkv.shape[:-1] + (qkv.shape[-1] // 3,))
        return (attention_qkv_cols_backward_plain(qkv, g_out.to(qkv.dtype), g_probs,
                                                  ctx.scale, ctx.num_heads),
                None, None, None, None)


@contextlib.contextmanager
def k1_as_plain():
    """The model's kernel branch with K1 replaced by its plain versions, the
    bf16 export included: the reference that isolates the kernels in a bf16
    step. (The plain path exports float32; the L1 terms' gradient, alpha
    times the sign of a difference of two views' probs, changes wherever
    the bf16 rounding makes that difference 0 or flips it.)"""
    kernel = vit_mod.fused_attention_qkv_cols
    vit_mod.fused_attention_qkv_cols = (
        lambda qkv, scale, num_heads, export="mean", probs_dtype=torch.float32:
        _PlainK1.apply(qkv, scale, num_heads, export, probs_dtype))
    try:
        yield
    finally:
        vit_mod.fused_attention_qkv_cols = kernel


def entry_inputs(qkv, entry):
    """An entry's inputs as a projection gives them: K5a the (B, H, N, D)
    permute views of qkv (as the model's plain branch makes them), K5b its
    three column chunks, K5c qkv itself."""
    if entry == "K5a":
        return list(qkv.unflatten(-1, (3, HEADS, HEAD_DIM)).permute(2, 0, 3, 1, 4))
    if entry == "K5b":
        return [t.contiguous() for t in qkv.chunk(3, dim=-1)]
    return [qkv]


def call_entry(entry, xs, probs_dtype, export="mean"):
    """The entry as a user calls it: K5a through ``attention_with_probs``."""
    if entry == "K5a":
        return attention_with_probs(*xs, HEAD_DIM ** -0.5, export=export, impl="kernel")
    return ENTRIES[entry](*xs, HEAD_DIM ** -0.5, HEADS, export, probs_dtype)


def check_entries(device, errs) -> None:
    """K5a, K5b and K5c, forward and backward, against their plain versions
    at the training shape, with each export dtype; export "none" gives the
    same out and no probs."""
    gen = torch.Generator(device=device).manual_seed(4)
    B, N, scale = 2 * TRAIN_BATCH, N_TOKENS, HEAD_DIM ** -0.5
    qkv = torch.randn((B, N, 3 * HEADS * HEAD_DIM), generator=gen,
                      device=device).to(torch.bfloat16)
    for entry, layout in ENTRY_LAYOUTS.items():
        xs = entry_inputs(qkv, entry)
        for probs_dtype in ENTRY_DTYPES[entry]:
            name = f"{entry} ({layout}) B={B} N={N} probs {str(probs_dtype)[6:]}"
            log(f"  {name} forward")
            out, probs = attn_forward(layout, xs, scale, HEADS, "mean", probs_dtype,
                                      ENTRIES[entry])
            out_none, probs_none = attn_forward(layout, xs, scale, HEADS, "none", probs_dtype,
                                                ENTRIES[entry])
            ref_out, ref_probs = forward_plain(layout, xs, scale, HEADS, "mean", probs_dtype)
            torch.cuda.synchronize()
            if probs.dtype != probs_dtype or probs_none is not None \
                    or not torch.equal(out_none, out):
                raise AssertionError(f"{name}: probs dtype {probs.dtype}, or export 'none' "
                                     f"differs from 'mean'")
            rtol = 0.0 if probs_dtype == torch.float32 else BF16_PROBS_RTOL
            errs[(entry, "fwd", probs_dtype)] = max(
                check_close("out", out, ref_out, OUT_RTOL, OUT_ATOL),
                check_close("probs", probs, ref_probs, rtol, PROBS_ATOL))
            log(f"  {name} backward, de {str(probs_dtype)[6:]}")
            g = torch.randn(out.shape, generator=gen, device=device).to(torch.bfloat16)
            de = torch.randn((B, N, N), generator=gen, device=device).to(probs_dtype)
            got = attn_backward(layout, xs, g, de, scale, HEADS, ENTRIES[entry])
            ref = backward_plain(layout, xs, g, de, scale, HEADS)
            torch.cuda.synchronize()
            errs[(entry, "bwd", probs_dtype)] = max(
                check_grad(f"d{i}", a, b) for i, a, b in zip("qkv" if len(got) == 3 else "x",
                                                             got, ref))


def phase_attention_entries(device, cfg, step_ctx):
    """The three K5 entries against their plain versions, then through
    autograd as a user calls them (launches counted), then the per-layer
    branch with a bf16 export: one step against the plain path and a few
    steps of ``train.train``. Returns the max abs errs and the launches
    of the entry run and of the bf16 training run."""
    errs: dict = {}
    check_entries(device, errs)

    gen = torch.Generator(device=device).manual_seed(5)
    B, N, scale = 2 * TRAIN_BATCH, N_TOKENS, HEAD_DIM ** -0.5
    qkv = torch.randn((B, N, 3 * HEADS * HEAD_DIM), generator=gen,
                      device=device).to(torch.bfloat16)
    w_probs = torch.randn((B, N, N), generator=gen, device=device)
    runs = []
    reset_counts()
    for entry, layout in ENTRY_LAYOUTS.items():
        for probs_dtype in ENTRY_DTYPES[entry]:
            xs = [t.detach().requires_grad_(True) for t in entry_inputs(qkv, entry)]
            out, probs = call_entry(entry, xs, probs_dtype)
            w_out = torch.randn(out.shape, generator=gen, device=device)
            ((out.float() * w_out).sum() + (probs.float() * w_probs).sum()).backward()
            runs.append((entry, layout, probs_dtype, xs, w_out))
    torch.cuda.synchronize()
    launches = read_counts()
    expected = {**zero_counts(), **{f"{e}{d}": len(ENTRY_DTYPES[e]) for e in ENTRIES
                                   for d in "fb"}}
    log(f"  entries through autograd (K5a as attention_with_probs(impl='kernel')), each "
        f"export dtype once: launches {launches}")
    if launches != expected:
        raise AssertionError(f"expected {expected}")
    for entry, layout, probs_dtype, xs, w_out in runs:
        log(f"  {entry} gradients through autograd, probs {str(probs_dtype)[6:]}, against "
            f"the plain backward")
        refs = backward_plain(layout, [x.detach() for x in xs], w_out.to(torch.bfloat16),
                              w_probs.to(probs_dtype), scale, HEADS)
        for x, ref in zip(xs, refs):
            if x.grad is None or x.grad.shape != x.shape:
                raise AssertionError(f"{entry}: no gradient of the input's shape")
            check_grad("grad", x.grad, ref)
    del runs

    weights, grid, batch, plain = step_ctx
    cfg16 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, fuse_consistency=False, probs_dtype="bfloat16"),
        session_name="smoke_bf16")
    reset_counts()
    step = one_step(cfg16, "kernel", False, weights, batch, grid)
    torch.cuda.synchronize()
    step_launches = read_counts()
    depth = step[0].spec.depth
    log(f"  per-layer branch, probs_dtype bfloat16 (K1f bf16 export, K1b bf16 de), against "
        f"the plain per-layer path; launches {step_launches}")
    if step_launches != {**zero_counts(), "K1f": depth, "K1b": depth}:
        raise AssertionError(f"expected {depth} K1f and {depth} K1b launches, no other")
    with torch.no_grad():
        dtypes = {p.dtype for p in step[0].forward_cls(
            torch.zeros((1, CROP, CROP, 3), device=device))["probs_layers"]}
    if dtypes != {torch.bfloat16}:
        raise AssertionError(f"the bf16 model exported {dtypes}")
    reset_counts()
    with k1_as_plain():
        ref = one_step(cfg16, "kernel", False, weights, batch, grid)
    torch.cuda.synchronize()
    if read_counts() != zero_counts():
        raise AssertionError("the plain reference launched a kernel")
    log("  against the same step with K1's plain versions (bf16 export, bf16 de):")
    compare_steps("per-layer branch, bf16 export", step, ref)
    log("  against the plain per-layer path, which exports float32:")
    compare_steps("per-layer branch, bf16 against float32 export", step, plain)
    del step, ref, plain

    log(f"  train.train, per-layer branch, probs_dtype bfloat16, {TRAIN_IMAGES} images, "
        f"batch {cfg16.batch_size}")
    reset_counts()
    state = train_mod.train(cfg16)
    torch.cuda.synchronize()
    train_launches = read_counts()
    val_passes = math.ceil(VAL_IMAGES / cfg16.batch_size)
    expected = {**zero_counts(), "K1f": depth * state.steps, "K1b": depth * state.steps,
                "K1n": depth * val_passes}
    log(f"  launches: {train_launches} over {state.steps} train steps and {val_passes} "
        f"validation batch (expected {expected})")
    if train_launches != expected:
        raise AssertionError("the bf16 per-layer training did not launch the kernels as "
                             "expected")
    for i, parts in enumerate(state.history):
        log(f"  step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in parts.items()))
        if not all(math.isfinite(v) for v in parts.values()):
            raise AssertionError(f"step {i}: a loss part is not finite")
    del state
    return errs, launches, train_launches


def phase_pipeline(cfg: TrainConfig, root: str) -> dict:
    """``pipeline.main`` on the training fixture of ``cfg``: train on its
    first PIPE_TRAIN_IMAGES images, infer with ``--pamr 10`` and evaluate
    on its validation images, whose seeded label PNGs are written here.
    Returns the launches."""
    names = voc_data.read_file(cfg.train_list)[:PIPE_TRAIN_IMAGES]
    train_list = os.path.join(root, "pipe_train.txt")
    with open(train_list, "w") as f:
        f.write("\n".join(names) + "\n")
    val_names = voc_data.read_file(cfg.val_list)
    labels = voc_data.load_cls_labels(cfg.cls_labels_path)
    gt_dir = os.path.join(root, "gt")
    os.makedirs(gt_dir)
    rng = np.random.default_rng(1)
    sizes = []
    for name in val_names:
        h, w = Image.open(os.path.join(cfg.image_dir, f"{name}.jpg")).size[::-1]
        sizes.append((h, w))
        gt = rng.choice(np.concatenate([[0], np.flatnonzero(labels[name]) + 1]),
                        size=(h // 25, w // 25))
        Image.fromarray(gt.astype(np.uint8)).resize((w, h), Image.NEAREST).save(
            os.path.join(gt_dir, f"{name}.png"))
    out_cam, logfile = os.path.join(root, "pipe_cams"), os.path.join(root, "evallog.txt")
    argv = ["--session_name", "smoke_pipe", "--IMpath", cfg.image_dir, "--gt_dir", gt_dir,
            "--cls_labels", cfg.cls_labels_path, "--train_list", train_list,
            "--val_list", cfg.val_list, "--infer_list", cfg.val_list, "--max_epoches", "1",
            "--pamr", str(PAMR_ITERS), "--weight_dir", os.path.join(root, "pipe_weight"),
            "--out_cam", out_cam, "--logfile", logfile]
    log("  python -m acr_wsss_tpu_torch.pipeline " + " ".join(argv))
    reset_counts()
    pipeline.main(argv)
    torch.cuda.synchronize()
    launches = read_counts()
    steps = len(names) // cfg.batch_size + 1
    union = sorted(set().union(*(np.flatnonzero(labels[n]).tolist() for n in val_names)))
    passes = math.ceil(len(union) / CLASS_SLOTS)
    expected = {**zero_counts(), "K2f": DEPTH * steps, "K2b": DEPTH * steps,
                "K1f": START_LAYER * passes, "K3": 1, "K4": PAMR_ITERS}
    log(f"  launches: {launches} (expected {expected}: {steps} train steps, no validation "
        f"at the default val_every; {len(val_names)} images in one inference pass of "
        f"{2 * len(val_names)} views, {passes} class-slot passes)")
    if launches != expected:
        raise AssertionError("the pipeline did not launch the kernels as expected")

    npz = os.path.join(root, "pipe_weight", "smoke_pipe_last.npz")
    flat = load_params_npz(npz)
    if not all(np.isfinite(v).all() for v in flat.values()):
        raise AssertionError(f"{npz}: non-finite weights")
    check_cams(val_names, [labels[n] for n in val_names],
               [np.load(os.path.join(out_cam, f"{n}.npy"), allow_pickle=True).item()
                for n in val_names], sizes)
    with open(logfile) as f:
        text = f.read()
    record = text.split("mIoU:[")[1].split("]")[0].split(",") if "mIoU:[" in text else []
    if "smoke_pipe" not in text or len(record) != 100:
        raise AssertionError(f"{logfile}: no 100-threshold mIoU record of the session")
    log(f"  {os.path.basename(npz)}: {len(flat)} finite arrays; {len(val_names)} CAM dicts, "
        f"finite, in [0, 1], native size; evallog: 100-threshold mIoU record, best "
        f"{max(float(v) for v in record):.3f}%")
    return launches


def time_train_step(model, opt, cfg, batch, card, reps=6) -> dict:
    """Host-clock step time (synchronized) of the fused kernel step: median
    of ``reps`` after a warm-up; then a profiler window of 2 steps."""
    from torch.profiler import ProfilerActivity, profile

    grid = (cfg.crop_size // 16, cfg.crop_size // 16)
    step = train_mod.make_train_step(model, opt, cfg, grid)
    step(batch)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(times))
    log(f"  train step (fused branch, batch {cfg.batch_size}, crop {cfg.crop_size}), "
        f"median of {reps} after a warm-up: {step_ms:.2f} ms (all: "
        f"{', '.join(f'{t:.2f}' for t in times)}), {cfg.batch_size / step_ms * 1e3:.2f} "
        f"images/s [{card}]")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
            and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / 2 if rows else float("nan")
    if rows:
        log(f"  device busy per step (sum of kernel times, profiler, 2 steps): "
            f"{busy_ms:.2f} ms of {window_ms / 2:.2f} ms under the profiler "
            f"({100 * busy_ms / (window_ms / 2):.1f}%) [{card}]; top kernels per step:")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
            log(f"    {e.self_device_time_total / 2e3:9.3f} ms  {e.count // 2:5d} x  "
                f"{e.key[:90]}")
    else:
        log("  device busy per step: not measured (profiler saw no device activity)")
    return {"step_ms": step_ms, "images_per_s": cfg.batch_size / step_ms * 1e3,
            "busy_ms": busy_ms}


def time_image(infer, path, label, pamr_fn=None, reps=5) -> float:
    process_image(infer, path, label, CROP, pamr_fn=pamr_fn)          # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        process_image(infer, path, label, CROP, pamr_fn=pamr_fn)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def time_getam_pass(infer, path, label, reps=5) -> float:
    """The device pass alone (both views, present classes in one slot
    group), from host arrays to host arrays: median ms."""
    from acr_wsss_tpu_torch.data import transforms

    x = transforms.val_transform(transforms.load_image_rgb(path), CROP)
    batch = np.stack([x, x[:, ::-1]])
    present = np.flatnonzero(label).tolist()[:CLASS_SLOTS]
    ids = present + [present[-1]] * (CLASS_SLOTS - len(present))
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = infer(batch, ids)
        out["cams"].cpu(), out["patch_cam"].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def device_breakdown(infer, path, label, image_ms, card, pamr_fn=None, top=12) -> None:
    """Device time of one image by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        process_image(infer, path, label, CROP, pamr_fn=pamr_fn)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
            and e.self_device_time_total > 0]
    if not rows:
        log("  device time by kernel: not measured (profiler saw no device activity)")
        return
    total_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"  device busy per image (sum of kernel times, profiler): {total_ms:.2f} ms, "
        f"{100 * total_ms / image_ms:.1f}% of the per-image latency [{card}]; top kernels:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} x  {e.key[:90]}")


def time_call(fn, reps=50) -> float:
    """Device ms per call: CUDA events around ``reps`` calls that the host
    enqueues while the device is held busy, so that a call which takes the
    host longer than the device is timed on the device, not at the host's
    enqueue rate."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # Device cycles to cover the enqueue of `reps` calls (at most 2 GHz).
    torch.cuda._sleep(int(2 * (time.perf_counter() - t0) * reps * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_kernel(label, kernel, plain, library, nbytes, flops, reps, card,
                library_name, peak_flops=PEAK_BF16_FLOPS) -> dict:
    """plain, kernel, kernel, plain in turns on one card (CUDA events over
    ``reps`` launches each), then the library call where there is one; the
    bound from the bytes moved once and the operations at ``peak_flops``."""
    plain_ms = [time_call(plain, reps)]
    kernel_ms = [time_call(kernel, reps), time_call(kernel, reps)]
    plain_ms.append(time_call(plain, reps))
    library_ms = None if library is None else time_call(library, reps)
    bytes_ms, flops_ms = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    res = {"ms": float(np.mean(kernel_ms)), "plain_ms": float(np.mean(plain_ms)),
           "library_ms": library_ms, "bound_ms": max(bytes_ms, flops_ms),
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
    library_text = (f"{library_name} {library_ms*1e3:.1f} us" if library is not None
                    else f"library: {library_name}")
    log(f"  {label} (CUDA events, {reps} launches each): kernel "
        f"{kernel_ms[0]*1e3:.1f} / {kernel_ms[1]*1e3:.1f} us, plain "
        f"{plain_ms[0]*1e3:.1f} / {plain_ms[1]*1e3:.1f} us, {library_text}; bound "
        f"{res['bound_ms']*1e3:.2f} us by {res['bound_by']} "
        f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP) [{card}]")
    return res


def phase_kernel_timing(device, card) -> dict:
    """Each kernel's time at its main path's shape: K1f at B=2 (inference),
    K1n at B=2 and B=4 (validation), K2f, K2b, K1b and K1f with either
    export dtype at B=8 (training), and K5a, K5b and K5c forward and
    backward at B=8."""
    H, D, N = HEADS, HEAD_DIM, N_TOKENS
    scale = D ** -0.5
    gen = torch.Generator(device=device).manual_seed(1)
    out = {}

    def inputs(B):
        qkv = torch.randn((B, N, 3 * H * D), generator=gen, device=device).to(torch.bfloat16)
        q, k, v = (t.contiguous() for t in qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4))
        return qkv, q, k, v

    def sdpa(q, k, v):
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)

    def sdpa_fwd_bwd(q, k, v, g):
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))

        def run():
            F.scaled_dot_product_attention(q, k, v, scale=scale).backward(g)
        return run

    qkv, q, k, v = inputs(2)
    io = qkv.numel() * 2 + 2 * N * H * D * 2
    out["K1f"] = time_kernel(
        f"{KERNEL} (K1f) at B=2 N={N} H={H} D={D} bf16, export mean",
        lambda: attention_qkv_cols_forward(qkv, scale, H, "mean"),
        lambda: attention_qkv_cols_plain(qkv, scale, H, "mean"), sdpa(q, k, v),
        io + 2 * N * N * 4, 4 * 2 * H * N * N * D, 50, card, "SDPA (output only)")
    for B in (2, 4):
        qkv, q, k, v = inputs(B)
        out[f"K1n_B{B}"] = time_kernel(
            f"{KERNEL} (K1n) at B={B}, export none",
            lambda: attention_qkv_cols_forward(qkv, scale, H, "none"),
            lambda: attention_qkv_cols_plain(qkv, scale, H, "none"), sdpa(q, k, v),
            qkv.numel() * 2 + B * N * H * D * 2, 4 * B * H * N * N * D, 20, card,
            "SDPA (the same function)")

    B = 2 * TRAIN_BATCH
    pairs = B // 2
    qkv, q, k, v = inputs(B)
    g = torch.randn((B, N, H * D), generator=gen, device=device).to(torch.bfloat16)
    g_heads = g.reshape(B, N, H, D).transpose(1, 2).contiguous()
    g_cls = torch.rand(pairs, generator=gen, device=device)
    g_aff = torch.rand(pairs, generator=gen, device=device)
    de = torch.randn((B, N, N), generator=gen, device=device)
    sign = pair_consistency_forward(qkv, scale, H)[3]
    fwd_flops, bwd_flops = 4 * B * H * N * N * D, 10 * B * H * N * N * D
    out["K2f"] = time_kernel(
        f"{attn_pair.KERNEL} (K2f) at B={B} ({pairs} pairs)",
        lambda: pair_consistency_forward(qkv, scale, H),
        lambda: pair_consistency_forward_plain(qkv, scale, H), sdpa(q, k, v),
        qkv.numel() * 2 + B * N * H * D * 2 + sign.numel() + 2 * pairs * 4, fwd_flops, 10,
        card, "SDPA (output only)")
    out["K2b"] = time_kernel(
        f"{BWD_KERNEL} (K2b, sign tile) at B={B}",
        lambda: pair_consistency_backward(qkv, g, sign, g_cls, g_aff, scale, H),
        lambda: pair_consistency_backward_plain(qkv, g, sign, g_cls, g_aff, scale, H),
        sdpa_fwd_bwd(q, k, v, g_heads),
        2 * qkv.numel() * 2 + g.numel() * 2 + sign.numel() + 2 * pairs * 4, bwd_flops, 10,
        card, "SDPA forward+backward (no de)")
    out["K1b"] = time_kernel(
        f"{BWD_KERNEL} (K1b, dense de) at B={B}",
        lambda: attention_qkv_cols_backward(qkv, g, de, scale, H),
        lambda: attention_qkv_cols_backward_plain(qkv, g, de, scale, H),
        sdpa_fwd_bwd(q, k, v, g_heads),
        2 * qkv.numel() * 2 + g.numel() * 2 + de.numel() * 4, bwd_flops, 10,
        card, "SDPA forward+backward (no de)")
    de16 = de.to(torch.bfloat16)
    out["K1b_bf16"] = time_kernel(
        f"{BWD_KERNEL} (K1b, dense bf16 de) at B={B}",
        lambda: attention_qkv_cols_backward(qkv, g, de16, scale, H),
        lambda: attention_qkv_cols_backward_plain(qkv, g, de16, scale, H),
        sdpa_fwd_bwd(q, k, v, g_heads),
        2 * qkv.numel() * 2 + g.numel() * 2 + de16.numel() * 2, bwd_flops, 10,
        card, "SDPA forward+backward (no de)")
    io = qkv.numel() * 2 + B * N * H * D * 2
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        out[f"K1f_B{B}_{str(dtype)[6:]}"] = time_kernel(
            f"{KERNEL} (K1f) at B={B}, export mean, probs {str(dtype)[6:]}",
            lambda: attention_qkv_cols_forward(qkv, scale, H, "mean", dtype),
            lambda: attention_qkv_cols_plain(qkv, scale, H, "mean", dtype), sdpa(q, k, v),
            io + B * N * N * size, fwd_flops, 10, card, "SDPA (output only)")
    # K5: K5a on contiguous (B, H, N, D) q, k, v, K5b on split (B, N, H*D)
    # tensors, K5c on the joint projection; float32 export and de.
    operands = {"K5a": ([q, k, v], g_heads), "K5b": ([t.contiguous() for t in qkv.chunk(3, -1)],
                                                      g), "K5c": ([qkv], g)}
    for entry, layout in ENTRY_LAYOUTS.items():
        xs, g_out = operands[entry]
        out[f"{entry}f"] = time_kernel(
            f"{KERNEL} ({entry}, {layout} layout) at B={B}, export mean, probs float32",
            lambda: call_entry(entry, xs, torch.float32),
            lambda: forward_plain(layout, xs, scale, H, "mean", torch.float32), sdpa(q, k, v),
            io + B * N * N * 4, fwd_flops, 10, card, "SDPA (output only)")
        out[f"{entry}b"] = time_kernel(
            f"{BWD_KERNEL} ({entry}, {layout} layout, dense float32 de) at B={B}",
            lambda: attn_backward(layout, xs, g_out, de, scale, H, ENTRIES[entry]),
            lambda: backward_plain(layout, xs, g_out, de, scale, H),
            sdpa_fwd_bwd(q, k, v, g_heads),
            2 * qkv.numel() * 2 + g.numel() * 2 + de.numel() * 4, bwd_flops, 10,
            card, "SDPA forward+backward (no de)")
    del qkv, q, k, v, g, g_heads, de, de16, sign, operands
    out.update(pamr_kernel_timing(device, card))
    return out


def pamr_kernel_timing(device, card) -> dict:
    """K3 and one K4 launch at B=2 views (one image, ``--pamr``) and B=8
    (four images per pass, the pipeline's ``--infer_batch_images 4``),
    384x384, the default dilations, 20 class rows."""
    gen = torch.Generator(device=device).manual_seed(3)
    dils, P, C = PAMR_DILATIONS, 8 * len(PAMR_DILATIONS), NUM_CLASSES
    n = 9 * len(dils)
    out = {}
    for B in (2, 8):
        x = torch.randn((B, 3, CROP, CROP), generator=gen, device=device)
        m = torch.rand((B, C, CROP, CROP), generator=gen, device=device)
        aff = pamr_affinity(x, dils)
        pixels = B * CROP * CROP
        # per pixel and channel: the 9n-tap sum, the variance (sub, mul,
        # add per tap), sqrt and the divisions, 4 operations per neighbour;
        # then the softmax over P (6 operations each)
        k3_flops = pixels * (3 * (n + 3 * n + 4 * P + 5) + 6 * P)
        out[f"K3_B{B}"] = time_kernel(
            f"{pamr_ops.KERNEL} affinity (K3) at B={B} K=3 {CROP}x{CROP} P={P} fp32",
            lambda: pamr_affinity(x, dils), lambda: pamr_affinity_plain(x, dils), None,
            (x.numel() + aff.numel()) * 4, k3_flops, 20, card,
            "none (a dilated 48-tap stencil with replicated edges)", PEAK_FP32_FLOPS)
        out[f"K4_B{B}"] = time_kernel(
            f"{pamr_ops.KERNEL} update (K4), one step, at B={B} C={C} {CROP}x{CROP} P={P} fp32",
            lambda: pamr_update(m, aff, dils), lambda: pamr_update_plain(m, aff, dils), None,
            (2 * m.numel() + aff.numel()) * 4, 2 * P * pixels * C, 20, card,
            "none (per-pixel weights over a dilated 48-tap stencil)", PEAK_FP32_FLOPS)
        del x, m, aff
    return out


def time_pamr_step(pamr_fn, x, mask, card, reps=20) -> float:
    """Device time of ``pamr_fn`` on one image's views (CUDA events): the
    mask's resize to crop resolution, one K3 and PAMR_ITERS K4 launches."""
    ms = time_call(lambda: pamr_fn(x, mask), reps)
    log(f"  PAMR step (resize + K3 + {PAMR_ITERS} K4) on {tuple(x.shape)} guidance and "
        f"{tuple(mask.shape)} CAMs, CUDA events over {reps} calls: {ms * 1e3:.1f} us "
        f"[{card}]")
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this run needs one GPU",
              file=sys.stderr, flush=True)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain attention: full fp32 logits
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"[1/9] device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = _build.build(list(KERNELS))
    log(f"[2/9] build: {time.perf_counter() - t0:.1f} s with nvcc into "
        f"{os.path.relpath(_build.BUILD_DIR, ROOT)}/, one process per source")
    for name, report in reports.items():
        kernel = ""
        for line in report.splitlines():
            entry = re.search(r"Compiling entry function '\S*?(\d+[a-z_]+_kernel)(I\S*?E)?E",
                              line)
            if entry:   # the mangled name: length, name, template arguments
                kernel = entry.group(1).lstrip("0123456789") + (
                    "<" + entry.group(2)[3:-1] + ">" if entry.group(2) else "")
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {kernel}: {line.strip()}")

    log("[3/9] kernels against their plain versions on the card")
    errs = phase_kernels(device)

    with tempfile.TemporaryDirectory() as tmp:
        log("[4/9] inference path: GETAM CAM inference, vitb_hybrid, crop 384, 2 images, "
            f"without and with --pamr {PAMR_ITERS}")
        t0 = time.perf_counter()
        (infer, paths, labels, infer_launches, pamr_launches, pamr_fn,
         pamr_input) = phase_main_path(device, tmp)
        log(f"  inference path phase: {time.perf_counter() - t0:.1f} s")

        log("[5/9] training path: train.train, vitb_hybrid, crop 384, batch 4, the recipe")
        t0 = time.perf_counter()
        cfg, train_launches, state = phase_train_path(device, os.path.join(tmp, "train"))
        del state
        log(f"  training path phase: {time.perf_counter() - t0:.1f} s")

        log("[6/9] one train step, kernel path against plain path, same weights and batch")
        t0 = time.perf_counter()
        model, opt, batch, layer_launches, step_ctx = phase_step_compare(device, cfg)
        log(f"  step comparison phase: {time.perf_counter() - t0:.1f} s")

        log("[7/9] attention entries: K5a, K5b, K5c against their plain versions and "
            "through autograd; the per-layer branch with a bf16 export")
        t0 = time.perf_counter()
        entry_errs, entry_launches, bf16_launches = phase_attention_entries(
            device, cfg, step_ctx)
        del step_ctx
        log(f"  attention entries phase: {time.perf_counter() - t0:.1f} s")

        log(f"[8/9] pipeline: train -> infer --pamr {PAMR_ITERS} -> eval, vitb_hybrid, "
            f"crop 384, the recipe")
        t0 = time.perf_counter()
        phase_pipeline(cfg, os.path.join(tmp, "train"))
        log(f"  pipeline phase: {time.perf_counter() - t0:.1f} s")

        log(f"[9/9] timing on {card}")
        image_ms = time_image(infer, paths[0], labels[0])
        log(f"  per-image latency (process_image, {IMAGE_SIZES[0][0]}x{IMAGE_SIZES[0][1]}, "
            f"{int(labels[0].sum())} labels, median of 5 after a warm-up): {image_ms:.2f} ms "
            f"[{card}]")
        pamr_image_ms = time_image(infer, paths[0], labels[0], pamr_fn)
        log(f"  per-image latency with --pamr {PAMR_ITERS}, the same image: "
            f"{pamr_image_ms:.2f} ms (+{pamr_image_ms - image_ms:.2f} ms) [{card}]")
        time_pamr_step(pamr_fn, *pamr_input, card)
        pass_ms = time_getam_pass(infer, paths[0], labels[0])
        log(f"  of which the GETAM pass (infer_fn on the 2 views, host arrays in and out): "
            f"{pass_ms:.2f} ms; host decode, resize and normalization: "
            f"{image_ms - pass_ms:.2f} ms [{card}]")
        device_breakdown(infer, paths[0], labels[0], image_ms, card)
        log(f"  with --pamr {PAMR_ITERS}:")
        device_breakdown(infer, paths[0], labels[0], pamr_image_ms, card, pamr_fn)
        del infer, pamr_input
        time_train_step(model, opt, cfg, batch, card)
        del model, opt
    torch.cuda.empty_cache()
    timing = phase_kernel_timing(device, card)

    src, tpu = "acr_wsss_tpu_torch/csrc/", "acr_wsss_tpu/ops/attn_pallas.py:"
    tpu_pamr = "acr_wsss_tpu/ops/pamr_pallas.py:"
    n = N_TOKENS
    b_train = 2 * TRAIN_BATCH
    kernels = [
        {"name": KERNEL, "route": "cuda", "source": src + "attn_fwd_headmean.cu",
         "replaces": tpu + "380", "launches": infer_launches["K1f"],
         "max_abs_err": errs[("K1", 2, n, "mean")], **timing["K1f"]},
        {"name": KERNEL + " (export none)", "route": "cuda",
         "source": src + "attn_fwd_headmean.cu", "replaces": tpu + "873",
         "launches": train_launches["K1n"], "max_abs_err": errs[("K1", 4, n, "none")],
         **timing["K1n_B4"]},
        {"name": BWD_KERNEL + " (dense de)", "route": "cuda", "source": src + "attn_bwd.cu",
         "replaces": tpu + "421", "launches": layer_launches["K1b"],
         "max_abs_err": errs[("K1b", b_train, n, True)], **timing["K1b"]},
        {"name": attn_pair.KERNEL, "route": "cuda", "source": src + "attn_pair_fwd.cu",
         "replaces": tpu + "1028", "launches": train_launches["K2f"],
         "max_abs_err": errs[("K2f", b_train, n)], **timing["K2f"]},
        {"name": BWD_KERNEL + " (sign tile)", "route": "cuda", "source": src + "attn_bwd.cu",
         "replaces": tpu + "1075", "launches": train_launches["K2b"],
         "max_abs_err": errs[("K2b", b_train, n)], **timing["K2b"]},
        {"name": pamr_ops.KERNEL + " (affinity)", "route": "cuda", "source": src + "pamr.cu",
         "replaces": tpu_pamr + "85", "launches": pamr_launches["K3"],
         "max_abs_err": errs[("K3", 2, CROP, CROP)], **timing["K3_B2"]},
        {"name": pamr_ops.KERNEL + " (update)", "route": "cuda", "source": src + "pamr.cu",
         "replaces": tpu_pamr + "125", "launches": pamr_launches["K4"],
         "max_abs_err": errs[("K4", 2, CROP, CROP)], **timing["K4_B2"]},
        {"name": KERNEL + " (bf16 export)", "route": "cuda",
         "source": src + "attn_fwd_headmean.cu", "replaces": tpu + "380",
         "launches": bf16_launches["K1f"], "max_abs_err": errs[("K1", 4, n, "mean_bf16")],
         **timing[f"K1f_B{b_train}_bfloat16"]},
        {"name": BWD_KERNEL + " (dense bf16 de)", "route": "cuda",
         "source": src + "attn_bwd.cu", "replaces": tpu + "421",
         "launches": bf16_launches["K1b"], "max_abs_err": errs[("K1b", b_train, n, "bf16")],
         **timing["K1b_bf16"]},
    ]
    # K5: the kernel bodies each entry's pallas_calls run (fwd, bwd).
    for entry, fwd_line, bwd_line in (("K5a", "71", "152"), ("K5b", "380", "421"),
                                      ("K5c", "597", "633")):
        layout = ENTRY_LAYOUTS[entry]
        kernels += [
            {"name": f"{KERNEL} ({entry}, {layout} layout)", "route": "cuda",
             "source": src + "attn_fwd_headmean.cu", "replaces": tpu + fwd_line,
             "launches": entry_launches[entry + "f"],
             "max_abs_err": max(v for (e, d, _), v in entry_errs.items()
                                if e == entry and d == "fwd"), **timing[entry + "f"]},
            {"name": f"{BWD_KERNEL} ({entry}, {layout} layout)", "route": "cuda",
             "source": src + "attn_bwd.cu", "replaces": tpu + bwd_line,
             "launches": entry_launches[entry + "b"],
             "max_abs_err": max(v for (e, d, _), v in entry_errs.items()
                                if e == entry and d == "bwd"), **timing[entry + "b"]}]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
