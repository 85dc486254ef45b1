"""How far rounding moves one train step's parameter updates on the card.

The question behind ``chip_smoke.py`` phase 13 (b): two ranks of 2 images
and one device on all 4 compute the same update (the loss is a mean of
per-image terms), but their bf16 steps read up to 0.98 apart in the
hybrid stem's updates. This script runs one step of the recipe
(vitb_hybrid, crop 384, batch 4, the fused kernel branch, ``chip_smoke``'s
fixture and seeded weights) in several forms on one GPU and prints, for
pairs of them, the relative L2 distance of each tensor's update
p1 - p0, as its largest value over the stem's norms, the stem's
convolutions, the rest of the model and the qkv weights:

* bf16 kernel step: on the 4 images (twice: determinism), as 2 + 2
  accumulated micro-steps (what the ranks compute), on the 4 images twice
  in one batch of 8 (the same update, another batch shape), on the 4
  images permuted;
* float32 on the plain path with TF32 off, and with cuDNN's TF32 on
  (PyTorch's default for convolutions): on the 4 images and as 2 + 2.

With ``--swin``, the question behind phase 18 (a) instead: ``train_swin``'s
float32 step (swin_base_384, crop 384, batch 4, TF32 off, from
``chip_smoke``'s seeded trained-like zoo npz) on the 4 images (twice), as
2 + 2 accumulated micro-steps, on the 4 permuted, and in float64 (the
model's parameters and every operation, its float32 casts kept at float64)
on the 4 and as 2 + 2; the distances as above, over the relative-position
bias tables and the rest, and the worst tables' update norms.

    python docs/dp_split_probe.py [--swin]   # from the repository's root, one GPU
"""

import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from acr_wsss_tpu_torch import train as train_mod  # noqa: E402
from acr_wsss_tpu_torch.models.acr import init_random_  # noqa: E402
from acr_wsss_tpu_torch.ops import _build  # noqa: E402

GATE = cs.UPDATE_REL
GROUPS = {
    "stem norms": lambda k: ".backbone." in k and "norm" in k,
    "stem convs": lambda k: ".backbone." in k and "norm" not in k,
    "the rest": lambda k: ".backbone." not in k,
    "qkv": lambda k: ".attn.qkv." in k,
}
PAIRS = [("bf16 4 again", "bf16 4"), ("bf16 2+2", "bf16 4"), ("bf16 4 twice", "bf16 4"),
         ("bf16 4 permuted", "bf16 4"), ("fp32 2+2", "fp32 4"), ("fp32 4 twice", "fp32 4"),
         ("tf32 2+2", "tf32 4"), ("tf32 4", "fp32 4"), ("bf16 4", "fp32 4"),
         ("bf16 2+2", "fp32 2+2")]


SWIN_GROUPS = {
    "bias tables": lambda k: "relative_position_bias_table" in k,
    "the rest": lambda k: "relative_position_bias_table" not in k,
}
SWIN_PAIRS = [("fp32 4 again", "fp32 4"), ("fp32 2+2", "fp32 4"), ("fp32 4 permuted", "fp32 4"),
              ("fp32 4", "fp64 4"), ("fp32 2+2", "fp64 4"), ("fp64 2+2", "fp64 4")]


def report(after, p0, pairs, groups, gate=GATE) -> None:
    """For each pair (a, b): per group the largest relative L2 distance of a
    tensor's update in ``a`` from its update in ``b``, the tensors over
    ``gate``, and the worst three."""
    for a, b in pairs:
        rel = {}
        for k, ref in after[b].items():
            u = ref - p0[k]
            rel[k] = float((after[a][k] - p0[k] - u).norm() / u.norm().clamp_min(1e-30))
        over = [k for k in rel if rel[k] > gate]
        print(f"{a} against {b}: "
              + ", ".join(f"{g} {max(v for k, v in rel.items() if f(k)):.3g}"
                          for g, f in groups.items())
              + f"; {len(over)} of {len(rel)} tensors over {gate} "
              f"({sum('.backbone.' in k for k in over)} in the stem); worst "
              + ", ".join(f"{k} {rel[k]:.3g}" for k in sorted(rel, key=rel.get)[::-1][:3]),
              flush=True)


def swin_main() -> int:
    """The Swin probe (``--swin``)."""
    from acr_wsss_tpu_torch import train_swin

    tmp = tempfile.mkdtemp()
    root = os.path.join(tmp, "train")
    cfg = cs.make_train_fixture(root, seed=0)
    os.environ["ACR_WSSS_ZOO"] = cs.swin_zoo(root, cfg.seed + 11)
    scfg = cs.swin_dp_config(cfg)
    batch = {k: np.asarray(v) for k, v in cs.first_batch(cfg).items() if k in ("image", "label")}
    halves = [slice(0, 2), slice(2, 4)]
    permuted = {k: v[[1, 0, 3, 2]] for k, v in batch.items()}
    as_float = torch.Tensor.float

    def step(dtype, rows, data):
        ccfg = dataclasses.replace(scfg, accum_steps=len(rows), model=dataclasses.replace(
            scfg.model, compute_dtype=dtype))
        model, opt = train_swin.create_swin_train_state(ccfg, 4, cs.SWIN_MODEL, pretrained=True)
        opt = cs.make_optimizer(model.parameters(), ccfg.lr, 4, ccfg.weight_decay,
                                ccfg.momentum, ccfg.poly_power, accum_steps=len(rows))
        if dtype == "float64":
            model.double()
            torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else \
                as_float(t, *a, **k)
        try:
            p0 = {k: v.detach().to("cpu", torch.float64, copy=True)
                  for k, v in model.named_parameters()}
            fn = train_swin.make_swin_train_step(model, opt, ccfg, cs.CROP, torch.device(
                ccfg.device))
            for r in rows:
                fn({k: v[r] for k, v in data.items()})
            torch.cuda.synchronize()
        finally:
            torch.Tensor.float = as_float
        return p0, {k: v.detach().to("cpu", torch.float64, copy=True)
                    for k, v in model.named_parameters()}

    runs = {"fp32 4": ("float32", [slice(None)], batch),
            "fp32 4 again": ("float32", [slice(None)], batch),
            "fp32 2+2": ("float32", halves, batch),
            "fp32 4 permuted": ("float32", [slice(None)], permuted),
            "fp64 4": ("float64", [slice(None)], batch),
            "fp64 2+2": ("float64", halves, batch)}
    after = {}
    for name, (dtype, rows, data) in runs.items():
        t0 = time.perf_counter()
        p0, after[name] = step(dtype, rows, data)
        print(f"{name}: {time.perf_counter() - t0:.2f} s", flush=True)
    p0 = {k: v.float().double() for k, v in p0.items()}   # the float32 weights, exactly
    report(after, p0, SWIN_PAIRS, SWIN_GROUPS)
    tables = [k for k in p0 if "relative_position_bias_table" in k]
    u64 = {k: after["fp64 4"][k] - p0[k] for k in tables}
    ranked = sorted(tables, key=lambda k: float(
        (after["fp32 2+2"][k] - after["fp32 4"][k]).norm() / u64[k].norm()), reverse=True)
    for k in ranked[:3]:
        # One float32 ulp of every stored value: how far two correct float32
        # steps' p1 may lie apart, over the update's norm.
        ulp = torch.from_numpy(np.spacing(after["fp32 4"][k].float().numpy())).double()
        print(f"{k}: one float32 ulp of p1 over |update|: "
              f"{float(ulp.norm() / u64[k].norm()):.3g}; |update| {float(u64[k].norm()):.4g} "
              f"(float64), |p0| "
              f"{float(p0[k].norm()):.4g}; |fp32 2+2 - fp32 4| "
              f"{float((after['fp32 2+2'][k] - after['fp32 4'][k]).norm()):.4g}, "
              f"|fp32 4 - fp64 4| {float((after['fp32 4'][k] - after['fp64 4'][k]).norm()):.4g}, "
              f"|fp64 2+2 - fp64 4| "
              f"{float((after['fp64 2+2'][k] - after['fp64 4'][k]).norm()):.4g}", flush=True)
    print(cs.card_line(), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("dp_split_probe: needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--swin" in sys.argv[1:]:
        return swin_main()
    _build.build(list(cs.KERNELS))
    tmp = tempfile.mkdtemp()
    cfg = cs.make_train_fixture(os.path.join(tmp, "train"), seed=0)
    weights = init_random_(train_mod.build_model(cfg.model), seed=cfg.seed).state_dict()
    batch = cs.first_batch(cfg)
    img, lab = np.asarray(batch["image"]), np.asarray(batch["label"])
    whole = {"image": img, "label": lab}
    halves = [{"image": img[r], "label": lab[r]} for r in (slice(0, 2), slice(2, 4))]
    twice = {"image": np.concatenate([img, img]), "label": np.concatenate([lab, lab])}
    perm = [2, 3, 0, 1]
    permuted = {"image": img[perm], "label": lab[perm]}
    fp32 = cs.fp32_plain(cfg)

    def accum(c):
        return dataclasses.replace(c, accum_steps=2)

    def batch8(c):
        return dataclasses.replace(c, batch_size=8)

    runs = {"bf16 4": (cfg, [whole], False), "bf16 4 again": (cfg, [whole], False),
            "bf16 2+2": (accum(cfg), halves, False), "bf16 4 twice": (batch8(cfg), [twice], False),
            "bf16 4 permuted": (cfg, [permuted], False), "fp32 4": (fp32, [whole], False),
            "fp32 2+2": (accum(fp32), halves, False),
            "fp32 4 twice": (batch8(fp32), [twice], False), "tf32 4": (fp32, [whole], True),
            "tf32 2+2": (accum(fp32), halves, True)}
    after = {}
    for name, (ccfg, batches, tf32) in runs.items():
        torch.backends.cudnn.allow_tf32 = tf32
        t0 = time.perf_counter()
        model, opt, step = cs.dp_model(ccfg, weights, None)
        for b in batches:
            step(b)
        torch.cuda.synchronize()
        after[name] = {k: v.detach().float().cpu() for k, v in model.named_parameters()}
        torch.backends.cudnn.allow_tf32 = False
        print(f"{name}: {time.perf_counter() - t0:.2f} s", flush=True)
        del model, opt
    p0 = {k: v.float() for k, v in weights.items()}
    report(after, p0, PAIRS, GROUPS)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
