#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``acr_wsss_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and exits
non-zero without one. Imports nothing of JAX and nothing of the JAX
package. Phases, each of which fails the run when it fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds every kernel of the path into build/torch_kernels/;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shape and at a ragged one, with and without export;
4. main path: GETAM CAM inference as a user runs it (vitb_hybrid, crop 384,
   ``grad`` from layer 10, affinity refinement, flip TTA, 4 class slots)
   on two seeded VOC-sized images, with the weights of
   bench_artifacts/stability_r3/stability_r3_last.npz when present, else
   seeded random ones; launches counted; CAM dicts written to a temporary
   directory and scored by the port's ``evaluate``; CAMs checked against
   the same run with plain attention;
5. timing: per-image latency, a device-time breakdown, each kernel's time
   beside its plain version, one library call and its bound.

The second-to-last lines are the card's name and power limit and a JSON
object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
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
from acr_wsss_tpu_torch.infer_cam import build_infer_fn, process_image  # noqa: E402
from acr_wsss_tpu_torch.models.acr import ACR, init_random_  # noqa: E402
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict  # noqa: E402
from acr_wsss_tpu_torch.ops import _build  # noqa: E402
from acr_wsss_tpu_torch.ops.attn_cuda import (KERNEL, attention_qkv_cols_plain,  # noqa: E402
                                              fused_attention_qkv_cols)
from acr_wsss_tpu_torch.utils.checkpoint import load_params_npz  # noqa: E402

WEIGHTS = os.path.join(ROOT, "bench_artifacts", "stability_r3", "stability_r3_last.npz")
CROP, START_LAYER, CLASS_SLOTS, HEADS, HEAD_DIM = 384, 10, 4, 12, 64
N_TOKENS = (CROP // 16) ** 2 + 1
IMAGE_SIZES = ((375, 500), (333, 500))
# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W).
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# Kernel against its plain version, both bf16 in / bf16 out on the card.
# probs: float32 on both sides, logits summed in another order -> ~1e-7
# relative on p <= 1. out: p is rounded to bf16 before p @ v on both sides,
# so a last-bit difference in p can flip one term's rounding (2^-8 * p *
# |v|, absolute) and the final bf16 rounding adds one ulp (2^-8 relative).
PROBS_ATOL = 1e-6
OUT_RTOL, OUT_ATOL = 2.0 ** -7, 2.0 ** -8
# CAMs (min-max normalized to [0, 1]) of the kernel path against the plain
# path, both bf16 through 12 blocks: the rounding differences above, carried
# through blocks 0-9 and the GETAM backward of blocks 10-11.
CAM_MAX_ABS, CAM_MEAN_ABS = 0.05, 0.005


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


def phase_kernels(device) -> dict:
    """Kernel against plain version; returns max abs err at the main shape."""
    gen = torch.Generator(device=device).manual_seed(0)
    errs = {}
    for B, N in ((2, N_TOKENS), (3, 37)):
        qkv = torch.randn((B, N, 3 * HEADS * HEAD_DIM), generator=gen, device=device,
                          dtype=torch.float32).to(torch.bfloat16)
        for export in ("mean", "none"):
            out, probs = fused_attention_qkv_cols(qkv, HEAD_DIM ** -0.5, HEADS, export)
            ref_out, ref_probs = attention_qkv_cols_plain(qkv, HEAD_DIM ** -0.5, HEADS, export)
            torch.cuda.synchronize()
            log(f"  B={B} N={N} export={export}")
            err = check_close("out", out, ref_out, OUT_RTOL, OUT_ATOL)
            if export == "mean":
                err = max(err, check_close("probs", probs, ref_probs, 0.0, PROBS_ATOL))
            elif probs is not None:
                raise AssertionError("export='none' returned probs")
            errs[(B, N, export)] = err
    return errs


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


def phase_main_path(device, tmp):
    model = load_model(device, "kernel")
    names, paths, labels = make_images(tmp, seed=0)
    infer = build_infer_fn(model, CROP, START_LAYER, "grad", True, 20, class_slots=CLASS_SLOTS)
    passes = sum(math.ceil(int((lab > 0).sum()) / CLASS_SLOTS) for lab in labels)

    fused_attention_qkv_cols.launches = 0
    cams = [process_image(infer, p, lab, CROP)[0] for p, lab in zip(paths, labels)]
    torch.cuda.synchronize()
    launches = {KERNEL: fused_attention_qkv_cols.launches}
    log(f"  launches: {launches} over {passes} trunk passes "
        f"({launches[KERNEL] / passes:g} per pass, blocks 0-{START_LAYER - 1})")
    if launches[KERNEL] != START_LAYER * passes:
        raise AssertionError(f"expected {START_LAYER} launches per pass")

    for name, lab, cam, (h, w) in zip(names, labels, cams, IMAGE_SIZES):
        present = sorted(np.flatnonzero(lab).tolist())
        if sorted(cam) != present:
            raise AssertionError(f"{name}: CAM classes {sorted(cam)} != labels {present}")
        for c, m in cam.items():
            if m.shape != (h, w) or not np.isfinite(m).all() or m.min() < 0 or m.max() > 1:
                raise AssertionError(f"{name} class {c}: shape {m.shape}, range "
                                     f"[{m.min()}, {m.max()}]")
        np.save(os.path.join(tmp, f"{name}.npy"), cam)
    log(f"  CAMs: {sum(len(c) for c in cams)} maps, finite, in [0, 1], native size")
    curve = evaluate.do_python_eval_curve(tmp, os.path.join(tmp, "gt"), names, num_workers=1)
    best = max(range(len(curve)), key=lambda i: curve[i]["mIoU"])
    log(f"  evaluate: mIoU curve of {len(curve)} thresholds on seeded labels, "
        f"best {curve[best]['mIoU']:.3f}% at {best / 100:.2f}")

    plain = load_model(device, "plain", state=model.state_dict())
    plain_infer = build_infer_fn(plain, CROP, START_LAYER, "grad", True, 20,
                                 class_slots=CLASS_SLOTS)
    diffs = []
    for p, lab, cam in zip(paths, labels, cams):
        ref = process_image(plain_infer, p, lab, CROP)[0]
        diffs += [np.abs(cam[c] - ref[c]) for c in cam]
    max_abs = max(d.max() for d in diffs)
    mean_abs = float(np.mean([d.mean() for d in diffs]))
    log(f"  kernel path vs plain path CAMs: max abs {max_abs:.4g} (tolerance "
        f"{CAM_MAX_ABS}), mean abs {mean_abs:.4g} (tolerance {CAM_MEAN_ABS})")
    if max_abs > CAM_MAX_ABS or mean_abs > CAM_MEAN_ABS:
        raise AssertionError("kernel and plain paths disagree")
    del plain, plain_infer
    return infer, paths, labels, launches


def time_image(infer, path, label, reps=5) -> float:
    process_image(infer, path, label, CROP)          # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        process_image(infer, path, label, CROP)
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


def device_breakdown(infer, path, label, image_ms, card, top=12) -> None:
    """Device time of one image by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        process_image(infer, path, label, CROP)
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
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_timing(device, card) -> dict:
    B, N, H, D = 2, N_TOKENS, HEADS, HEAD_DIM
    gen = torch.Generator(device=device).manual_seed(1)
    qkv = torch.randn((B, N, 3 * H * D), generator=gen, device=device).to(torch.bfloat16)
    q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale = D ** -0.5
    kernel = lambda: fused_attention_qkv_cols(qkv, scale, H, "mean")  # noqa: E731
    plain = lambda: attention_qkv_cols_plain(qkv, scale, H, "mean")  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)  # noqa: E731
    # plain, kernel, kernel, plain: one card, in turns.
    plain_ms = [time_call(plain)]
    kernel_ms = [time_call(kernel), time_call(kernel)]
    plain_ms.append(time_call(plain))
    library_ms = time_call(sdpa)
    nbytes = qkv.numel() * 2 + B * N * H * D * 2 + B * N * N * 4
    flops = 4 * B * H * N * N * D
    bytes_ms, flops_ms = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    res = {"ms": float(np.mean(kernel_ms)), "plain_ms": float(np.mean(plain_ms)),
           "library_ms": library_ms, "bound_ms": max(bytes_ms, flops_ms),
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
    log(f"  {KERNEL} at B={B} N={N} H={H} D={D} bf16 (CUDA events, 50 launches each): "
        f"kernel {kernel_ms[0]*1e3:.1f} / {kernel_ms[1]*1e3:.1f} us, plain "
        f"{plain_ms[0]*1e3:.1f} / {plain_ms[1]*1e3:.1f} us, SDPA (output only) "
        f"{library_ms*1e3:.1f} us; bound {res['bound_ms']*1e3:.2f} us by {res['bound_by']} "
        f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP) [{card}]")
    return res


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
    log(f"[1/5] device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = _build.build([KERNEL])
    log(f"[2/5] build: {time.perf_counter() - t0:.1f} s with nvcc into "
        f"{os.path.relpath(_build.BUILD_DIR, ROOT)}/")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")

    log("[3/5] kernels against their plain versions on the card")
    errs = phase_kernels(device)

    log("[4/5] main path: GETAM CAM inference, vitb_hybrid, crop 384, 2 images")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        infer, paths, labels, launches = phase_main_path(device, tmp)
        log(f"  main path phase: {time.perf_counter() - t0:.1f} s")

        log(f"[5/5] timing on {card}")
        image_ms = time_image(infer, paths[0], labels[0])
        log(f"  per-image latency (process_image, {IMAGE_SIZES[0][0]}x{IMAGE_SIZES[0][1]}, "
            f"{int(labels[0].sum())} labels, median of 5 after a warm-up): {image_ms:.2f} ms "
            f"[{card}]")
        pass_ms = time_getam_pass(infer, paths[0], labels[0])
        log(f"  of which the GETAM pass (infer_fn on the 2 views, host arrays in and out): "
            f"{pass_ms:.2f} ms; host decode, resize and normalization: "
            f"{image_ms - pass_ms:.2f} ms [{card}]")
        device_breakdown(infer, paths[0], labels[0], image_ms, card)
    timing = phase_kernel_timing(device, card)

    kernels = [{
        "name": KERNEL, "route": "cuda",
        "source": "acr_wsss_tpu_torch/csrc/attn_fwd_headmean.cu",
        "replaces": "acr_wsss_tpu/ops/attn_pallas.py:380",
        "launches": launches[KERNEL],
        "max_abs_err": errs[(2, N_TOKENS, "mean")],
        **timing,
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
