"""Pseudo-label construction toolbox: CAM dicts -> pseudo-mask PNGs.

Own copy of ``acr_wsss_tpu/pseudo_label.py``, the reference's ``myTool.py``
pseudo-mask machinery with the hardcoded user paths removed (output
locations are arguments). Host numpy and the native CRF engine
(``ops/bilateral.py``); nothing here runs on the card:

* :func:`crf_with_alpha` — background-power CRF fusion over a CAM dict
  (``myTool.py:43-54``).
* :func:`compute_seg_label` — the main recipe (``compute_seg_label_3``,
  ``myTool.py:188-264``): power-background argmax, saliency gating,
  per-class confidence-percentile "sure region" mining with conflict->255,
  morphological-opening denoise.
* :func:`compute_seg_label_two_step` — variant with bg power 32 and
  native-size nearest resize (``myTool.py:313-385``).
* :func:`compute_seg_label_rrm` — low/high-alpha CRF fusion
  (``myTool.py:674-744``).
* :func:`dense_energy_loss` — the RRM DenseEnergyLoss slot
  (``compute_joint_loss``'s ``DenseEnergyLosslayer``, ``myTool.py:825-836``)
  on the first-party bilateral filter.
* :func:`generate_pseudo_masks` and :func:`main`: the CLI,

    python -m acr_wsss_tpu_torch.pseudo_label --cam_dir out/cam_npy \
        --IMpath JPEGs --list L.txt --out_dir out/pseudo [--recipe rrm]

JAX's ``compute_joint_loss`` (the bg/fg split cross-entropy,
``myTool.py:838-857``) is one call of ``losses.compute_joint_ce``; the port's
callers use that directly.

The recipes no ``--recipe`` reaches (``compute_seg_label_coco``,
``_crf_sure``, ``_2``, ``_old``, ``_no_saliency``, ``_4``, ``_5`` and
``_two_step_coco``) are not ported; they come with a caller that needs
them.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from acr_wsss_tpu_torch.ops import bilateral as bilateral_ops
from acr_wsss_tpu_torch.ops import crf as crf_ops
from acr_wsss_tpu_torch.ops.imops import resize_bilinear_np
from acr_wsss_tpu_torch.utils.visualization import decode_segmap


def crf_with_alpha(ori_img: np.ndarray, cam_dict: Dict[int, np.ndarray],
                   alpha: float) -> np.ndarray:
    """CRF over [bg^alpha, cams]; returns a dense 21-channel score map."""
    v = np.array(list(cam_dict.values()))
    bg_score = np.power(1 - np.max(v, axis=0, keepdims=True), alpha)
    bgcam_score = np.concatenate((bg_score, v), axis=0).astype(np.float32)
    crf_score = crf_ops.crf_inference(ori_img, bgcam_score,
                                      labels=bgcam_score.shape[0])
    out = np.zeros((21, bg_score.shape[1], bg_score.shape[2]), np.float32)
    out[0] = crf_score[0]
    for i, key in enumerate(cam_dict.keys()):
        out[key + 1] = crf_score[i + 1]
    return out


def _morph_open(mask_u8: np.ndarray, ksize: int = 10) -> np.ndarray:
    """Binary opening with a ksize x ksize all-ones structuring element
    (cv2.MORPH_OPEN semantics: erode then dilate)."""
    from scipy import ndimage

    structure = np.ones((ksize, ksize), bool)
    opened = ndimage.binary_opening(mask_u8 > 0, structure=structure)
    return (opened * 255).astype(np.uint8)


def _mine_sure_regions(crf_label: np.ndarray, norm_cam: np.ndarray,
                       cam_label: np.ndarray, saliency: Optional[np.ndarray],
                       cut_threshold: float) -> np.ndarray:
    """Per-class confidence-percentile mining over background pixels
    (reference ``myTool.py:229-246``): pixels above the cut_threshold
    percentile of a present class's positive CAM values reclaim background;
    overlaps between classes become 255 (conflict)."""
    h, w = crf_label.shape
    high_conf_area = np.zeros((h, w), bool)
    for class_i in range(norm_cam.shape[0]):
        if cam_label[class_i] <= 1e-5:
            continue
        cam_class = norm_cam[class_i]
        positives = np.sort(cam_class[cam_class > 0])
        confidence_pos = int(positives.shape[0] * cut_threshold)
        if confidence_pos <= 0:
            continue
        confidence_value = positives[confidence_pos]
        high_conf_cls = (cam_class > confidence_value) & (crf_label == 0)
        crf_label[high_conf_cls] = class_i + 1
        if saliency is not None:
            saliency[high_conf_cls] = 255
        conflict = high_conf_cls & high_conf_area
        crf_label[conflict] = 255
        high_conf_area[high_conf_cls] = True
    return crf_label


def compute_seg_label(
    ori_img: np.ndarray,
    cam_label: np.ndarray,
    norm_cam: np.ndarray,
    saliency: np.ndarray,
    cut_threshold: float = 0.9,
    bg_power: float = 12.0,
    out_dir: Optional[str] = None,
    name: str = "",
) -> Tuple[np.ndarray, np.ndarray]:
    """Main pseudo-label recipe (reference ``compute_seg_label_3``).

    Args:
      ori_img: (H, W, 3) RGB uint8.
      cam_label: (20,) multi-hot image labels.
      norm_cam: (20, H, W) normalized CAMs.
      saliency: (H, W) saliency map (0 = background evidence).
    Returns:
      (crf_label (H, W) uint8 pseudo mask with 255=ignore, updated saliency)
    """
    cam_label = cam_label.astype(np.uint8)
    cam_np = np.where(cam_label[:, None, None] > 0, norm_cam, 0.0)

    bg_score = np.power(1 - np.max(cam_np, 0), bg_power)[None]
    cam_all = np.concatenate((bg_score, cam_np))
    crf_label = np.argmax(cam_all, 0).astype(np.int32)

    crf_label[crf_label == 0] = 255
    crf_label[saliency == 0] = 0

    crf_label = _mine_sure_regions(crf_label, norm_cam, cam_label, saliency,
                                   cut_threshold)

    frg = ((crf_label != 0) * 255).astype(np.uint8)
    frg_open = _morph_open(frg, 10)
    crf_label[frg_open != 255] = 0

    crf_label = crf_label.astype(np.uint8)
    if out_dir:
        from PIL import Image

        os.makedirs(out_dir, exist_ok=True)
        Image.fromarray(crf_label).save(os.path.join(out_dir, f"{name}.png"))
        rgb = decode_segmap(crf_label)
        blend = ((rgb * 255).astype(np.uint8) * 0.7 + ori_img * 0.3)
        Image.fromarray(blend.astype(np.uint8)).save(
            os.path.join(out_dir, f"{name}_color.png"))
    return crf_label, saliency


def compute_seg_label_two_step(
    ori_img: np.ndarray,
    cam_label: np.ndarray,
    norm_cam: np.ndarray,
    saliency: np.ndarray,
    native_size: Optional[Tuple[int, int]] = None,
    cut: float = 0.9,
    bg_power: float = 32.0,
    out_dir: Optional[str] = None,
    name: str = "",
) -> np.ndarray:
    """Two-step variant (reference ``compute_seg_label_two_step``): bg
    power 32, then nearest-neighbor resize to the native image size."""
    crf_label, _ = compute_seg_label(
        ori_img, cam_label, norm_cam, saliency, cut_threshold=cut,
        bg_power=bg_power, out_dir=None, name=name)
    if native_size is not None:
        from PIL import Image

        H, W = native_size
        crf_label = np.asarray(
            Image.fromarray(crf_label).resize((W, H), Image.NEAREST))
    if out_dir:
        from PIL import Image

        os.makedirs(out_dir, exist_ok=True)
        Image.fromarray(crf_label).save(os.path.join(out_dir, f"{name}.png"))
    return crf_label


# ---------------------------------------------------------------------------
# Losses over pseudo labels
# ---------------------------------------------------------------------------

def dense_energy_loss(images: np.ndarray, probs, croppings: np.ndarray,
                      sigma_xy: float = 15.0, sigma_rgb: float = 100.0):
    """RRM dense-energy (CRF) loss: sum_c <p_c, B(1 - p_c)> with B the
    bilateral affinity, evaluated with the native lattice.

    Host-side (numpy in / float out) — the loss value feeds training as a
    scalar; its gradient path in the reference flows through a custom
    autograd Function wrapping the same filter. Returns the value and
    d loss / d probs, from which such a Function can be built.
    """
    probs = np.asarray(probs, np.float32)
    n, c = probs.shape[:2]
    inv = bilateral_ops.bilateral_filter_batch(
        images.astype(np.float32), (1.0 - probs) * croppings[:, None],
        sigma_xy, sigma_rgb)
    value = float(np.sum(probs * croppings[:, None] * inv) / max(n, 1))
    grad = inv / max(n, 1)  # d/dp <p, B(1-p)> = B(1-p) - B^T p; B symmetric
    grad = grad - bilateral_ops.bilateral_filter_batch(
        images.astype(np.float32), probs * croppings[:, None],
        sigma_xy, sigma_rgb) / max(n, 1)
    return value, grad


def compute_seg_label_rrm(
    ori_img: np.ndarray,
    cam_label: np.ndarray,
    norm_cam: np.ndarray,
    low_alpha: float = 2.0,
    high_alpha: float = 14.0,
    bg_power: float = 36.0,
) -> np.ndarray:
    """RRM-style pseudo labels via low/high-alpha CRF fusion (reference
    ``compute_seg_label_rrm``, ``myTool.py:674-744``): low-alpha CRF argmax
    as candidates, its background demoted to ignore, high-alpha CRF
    background forced to background."""
    cam_label = cam_label.astype(np.uint8)
    cam_dict = {i: norm_cam[i] for i in range(norm_cam.shape[0])
                if cam_label[i] > 1e-5}
    cam_np = np.where(cam_label[:, None, None] > 0, norm_cam, 0.0)

    bg_score = np.power(1 - np.max(cam_np, 0), bg_power)[None]
    del bg_score  # retained for parity with the recipe; fusion is CRF-driven

    crf_la = crf_with_alpha(ori_img, cam_dict, low_alpha)
    crf_ha = crf_with_alpha(ori_img, cam_dict, high_alpha)
    la_label = np.argmax(crf_la, 0)
    ha_label = np.argmax(crf_ha, 0)
    crf_label = la_label.copy()
    crf_label[la_label == 0] = 255
    crf_label[ha_label == 0] = 0
    return crf_label.astype(np.uint8)


# ---------------------------------------------------------------------------
# CLI: CAM npy dicts -> pseudo-mask PNGs (the missing link between
# infer_cam --out_cam and train_seg --pseudo_dir)
# ---------------------------------------------------------------------------

def generate_pseudo_masks(cam_dir: str, image_dir: str, names, out_dir: str,
                          num_classes: int = 20, recipe: str = "default",
                          saliency_dir: Optional[str] = None,
                          cut_threshold: float = 0.9) -> None:
    """Materialize pseudo-mask PNGs for every name.

    Inputs are ``infer_cam --out_cam`` artifacts ({class_id: (H, W) cam}
    npy dicts). ``saliency_dir`` holds (H, W) PNGs where 0 = background
    evidence (the reference consumes precomputed saliency maps via
    hardcoded paths, ``myTool.py:203``); when absent, an all-foreground
    map is used — the recipe then relies on the power-background score
    and sure-region mining alone.
    """
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for name in names:
        img = np.asarray(
            Image.open(os.path.join(image_dir, f"{name}.jpg")).convert("RGB"))
        cam_dict = np.load(os.path.join(cam_dir, f"{name}.npy"),
                           allow_pickle=True).item()
        H, W = img.shape[:2]
        norm_cam = np.zeros((num_classes, H, W), np.float32)
        cam_label = np.zeros(num_classes, np.float32)
        for c, cam in cam_dict.items():
            if cam.shape != (H, W):
                cam = resize_bilinear_np(cam[None], (H, W))[0]
            norm_cam[int(c)] = cam
            cam_label[int(c)] = 1.0
        if saliency_dir:
            sal = np.asarray(
                Image.open(os.path.join(saliency_dir, f"{name}.png")))
            sal = (sal > 0).astype(np.uint8)
        else:
            sal = np.ones((H, W), np.uint8)
        if recipe == "two_step":
            compute_seg_label_two_step(img, cam_label, norm_cam, sal,
                                       cut=cut_threshold, out_dir=out_dir,
                                       name=name)
        elif recipe == "rrm":
            mask = compute_seg_label_rrm(img, cam_label, norm_cam)
            Image.fromarray(mask).save(os.path.join(out_dir, f"{name}.png"))
        else:
            compute_seg_label(img, cam_label, norm_cam, sal,
                              cut_threshold=cut_threshold, out_dir=out_dir,
                              name=name)


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="CAM npy dicts -> pseudo-mask PNGs (feed train_seg)")
    parser.add_argument("--cam_dir", required=True,
                        help="infer_cam --out_cam directory")
    parser.add_argument("--IMpath", required=True)
    parser.add_argument("--list", dest="name_list", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--num_classes", default=20, type=int)
    parser.add_argument("--recipe", default="default",
                        choices=["default", "two_step", "rrm"])
    parser.add_argument("--saliency_dir", default=None)
    parser.add_argument("--cut_threshold", default=0.9, type=float)
    args = parser.parse_args(argv)

    from acr_wsss_tpu_torch.data.voc import read_file

    generate_pseudo_masks(args.cam_dir, args.IMpath,
                          read_file(args.name_list), args.out_dir,
                          args.num_classes, args.recipe, args.saliency_dir,
                          args.cut_threshold)


if __name__ == "__main__":
    main()
