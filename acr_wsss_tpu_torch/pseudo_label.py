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

The long-tail recipes, which no ``--recipe`` reaches (``myTool.py:57-670``,
JAX's ``pseudo_label.py:284-451``): :func:`compute_seg_label_coco` (the
80-class recipe, bg power 32), :func:`compute_seg_label_crf_sure` (the
base recipe; the reference's own ``compute_seg_label`` crashes on its
``for class_i in 20`` loop), :func:`compute_seg_label_2` (la=4),
:func:`compute_seg_label_old` (bg power 8, no saliency),
:func:`compute_seg_label_no_saliency`, :func:`compute_seg_label_4` (a
dilated-saliency "safe background" gate), :func:`compute_seg_label_5`
(and the dilated foreground mask) and
:func:`compute_seg_label_two_step_coco` (80 classes), with their helpers
``_dilate`` and ``_sure_region_la_ha``, on the same host CRF.
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


def _dilate(mask_u8: np.ndarray, ksize: int) -> np.ndarray:
    """Binary dilation with a ksize x ksize all-ones structuring element
    (cv2.dilate semantics on a 0/255 mask)."""
    from scipy import ndimage

    dilated = ndimage.binary_dilation(mask_u8 > 0,
                                      structure=np.ones((ksize, ksize), bool))
    return (dilated * 255).astype(np.uint8)


def _mine_sure_regions(crf_label: np.ndarray, norm_cam: np.ndarray,
                       cam_label: np.ndarray, saliency: Optional[np.ndarray],
                       cut_threshold: float,
                       claimable: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-class confidence-percentile mining over background pixels
    (reference ``myTool.py:229-246``): pixels above the cut_threshold
    percentile of a present class's positive CAM values reclaim background;
    overlaps between classes become 255 (conflict).

    ``claimable`` overrides which pixels a class may claim (default: the
    current background ``crf_label == 0``; ``compute_seg_label_4`` uses the
    complement of the dilated saliency instead, ``myTool.py:497-513``)."""
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
        gate = (crf_label == 0) if claimable is None else claimable
        high_conf_cls = (cam_class > confidence_value) & gate
        crf_label[high_conf_cls] = class_i + 1
        if saliency is not None:
            saliency[high_conf_cls] = 255
        conflict = high_conf_cls & high_conf_area
        crf_label[conflict] = 255
        high_conf_area[high_conf_cls] = True
    return crf_label


def _sure_region_la_ha(
    ori_img: np.ndarray,
    cam_label: np.ndarray,
    norm_cam: np.ndarray,
    la_alpha: float,
    ha_alpha: float,
    bg_power: float,
    fg_floor: float = 0.1,
    fg_percentile: float = 0.6,
    bg_sure: float = 0.8,
    crf_sure: float = 0.8,
) -> np.ndarray:
    """Shared low/high-alpha CRF fusion with CAM sure-region mining — the
    structure common to the reference's ``compute_seg_label`` (base, which
    crashes on its ``for class_i in 20`` loop; intended semantics taken
    from the fixed loop in ``compute_seg_label_2``, ``myTool.py:151-170``),
    ``compute_seg_label_2`` and ``compute_seg_label_old``:

    * candidates = low-alpha CRF argmax, background demoted to 255;
    * per class present in the candidates: sure = CAM above the
      ``fg_percentile`` percentile of its > ``fg_floor`` values inside its
      own CAM-argmax region (background: fixed ``bg_sure`` threshold);
    * high-alpha CRF background forced to 0;
    * pixels with fused CRF confidence (ha bg channel + la fg channels)
      below ``crf_sure`` OR outside the sure region -> 255.
    """
    cam_label = cam_label.astype(np.uint8)
    cam_dict = {i: norm_cam[i] for i in range(norm_cam.shape[0])
                if cam_label[i] > 1e-5}
    cam_np = np.where(cam_label[:, None, None] > 0, norm_cam, 0.0)
    bg_score = np.power(1 - np.max(cam_np, 0), bg_power)[None]
    cam_all = np.concatenate((bg_score, cam_np))
    cam_img = np.argmax(cam_all, 0)

    crf_la = crf_with_alpha(ori_img, cam_dict, la_alpha)
    crf_ha = crf_with_alpha(ori_img, cam_dict, ha_alpha)
    la_label = np.argmax(crf_la, 0)
    ha_label = np.argmax(crf_ha, 0)
    crf_label = la_label.astype(np.int32).copy()
    crf_label[la_label == 0] = 255

    sure = np.zeros(cam_img.shape, bool)
    for class_i in np.unique(la_label):
        cam_class = cam_all[class_i].copy()
        cam_class[cam_img != class_i] = 0
        if class_i != 0:
            order = np.sort(cam_class[cam_class > fg_floor])
            pos = int(order.shape[0] * fg_percentile)
            if pos <= 0:
                continue
            sure |= cam_class > order[pos]
        else:
            sure |= cam_class > bg_sure
    crf_label[ha_label == 0] = 0
    fused_conf = np.concatenate([crf_ha[:1], crf_la[1:]])
    not_sure = (np.max(fused_conf, 0) < crf_sure) | ~sure
    crf_label[not_sure] = 255
    return crf_label


def _power_background_labels(cam_label: np.ndarray, norm_cam: np.ndarray,
                             saliency: np.ndarray, bg_power: float) -> np.ndarray:
    """The mining recipes' start (``myTool.py:188-226``): the argmax over
    [(1 - max present CAM)^bg_power, the present classes' CAMs], its
    background demoted to 255 and the saliency's background (0) forced to
    0; int32."""
    cam_np = np.where(cam_label[:, None, None] > 0, norm_cam, 0.0)
    bg_score = np.power(1 - np.max(cam_np, 0), bg_power)[None]
    crf_label = np.argmax(np.concatenate((bg_score, cam_np)), 0).astype(np.int32)
    crf_label[crf_label == 0] = 255
    crf_label[saliency == 0] = 0
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
    crf_label = _power_background_labels(cam_label, norm_cam, saliency, bg_power)
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


def compute_seg_label_coco(
    ori_img: np.ndarray,
    cam_label: np.ndarray,
    norm_cam: np.ndarray,
    saliency: np.ndarray,
    cut_threshold: float = 0.9,
    out_dir: Optional[str] = None,
    name: str = "",
) -> Tuple[np.ndarray, np.ndarray]:
    """80-class COCO pseudo-label recipe (reference
    ``compute_seg_label_coco``, ``myTool.py:748-821``): same structure as
    the VOC recipe with bg power 32."""
    return compute_seg_label(ori_img, cam_label, norm_cam, saliency,
                             cut_threshold=cut_threshold, bg_power=32.0,
                             out_dir=out_dir, name=name)


def compute_seg_label_crf_sure(
    ori_img: np.ndarray,
    cam_label: np.ndarray,
    norm_cam: np.ndarray,
    saliency: Optional[np.ndarray] = None,
    la_alpha: float = 8.0,
    ha_alpha: float = 32.0,
    bg_power: float = 32.0,
) -> np.ndarray:
    """Reference ``compute_seg_label`` (base variant, ``myTool.py:57-124``):
    la=8/ha=32 CRF fusion + CAM sure-region mining + saliency gate. The
    reference function crashes on its ``for class_i in 20`` loop; intended
    semantics implemented per ``compute_seg_label_2``'s fixed loop."""
    crf_label = _sure_region_la_ha(ori_img, cam_label, norm_cam,
                                   la_alpha, ha_alpha, bg_power)
    if saliency is not None:
        crf_label[saliency == 0] = 0
    return crf_label.astype(np.uint8)


def compute_seg_label_2(
    ori_img: np.ndarray,
    cam_label: np.ndarray,
    norm_cam: np.ndarray,
    saliency: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference ``compute_seg_label_2`` (``myTool.py:126-186``): the base
    recipe with a tighter low alpha (4)."""
    crf_label = _sure_region_la_ha(ori_img, cam_label, norm_cam,
                                   la_alpha=4.0, ha_alpha=32.0, bg_power=32.0)
    crf_label[saliency == 0] = 0
    return crf_label.astype(np.uint8), saliency


def compute_seg_label_old(
    ori_img: np.ndarray,
    cam_label: np.ndarray,
    norm_cam: np.ndarray,
) -> np.ndarray:
    """Reference ``compute_seg_label_old`` (``myTool.py:612-670``): base
    recipe with bg power 8 and NO saliency gate."""
    return _sure_region_la_ha(ori_img, cam_label, norm_cam, la_alpha=8.0,
                              ha_alpha=32.0, bg_power=8.0).astype(np.uint8)


def compute_seg_label_no_saliency(
    ori_img: np.ndarray,
    cam_label: np.ndarray,
    norm_cam: np.ndarray,
    la_alpha: float = 8.0,
) -> np.ndarray:
    """Reference ``compute_seg_label_no_saliency`` (``myTool.py:266-311``):
    single low-alpha CRF; its argmax with background demoted to ignore."""
    cam_label = cam_label.astype(np.uint8)
    cam_dict = {i: norm_cam[i] for i in range(norm_cam.shape[0])
                if cam_label[i] > 1e-5}
    crf_la = crf_with_alpha(ori_img, cam_dict, la_alpha)
    crf_label = np.argmax(crf_la, 0).astype(np.int32)
    crf_label[crf_label == 0] = 255
    return crf_label.astype(np.uint8)


def compute_seg_label_4(
    ori_img: np.ndarray,
    cam_label: np.ndarray,
    norm_cam: np.ndarray,
    saliency: np.ndarray,
    cut_threshold: float = 0.95,
    bg_power: float = 32.0,
    saliency_dilate_ksize: int = 40,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference ``compute_seg_label_4`` (``myTool.py:456-525``): "safe
    background" mining — classes may only claim pixels OUTSIDE the 40x40-
    dilated saliency (a margin away from known objects), percentile 0.95,
    no morphological cleanup."""
    cam_label = cam_label.astype(np.uint8)
    crf_label = _power_background_labels(cam_label, norm_cam, saliency, bg_power)
    claimable = _dilate(saliency.astype(np.uint8), saliency_dilate_ksize) == 0
    crf_label = _mine_sure_regions(crf_label, norm_cam, cam_label, saliency,
                                   cut_threshold, claimable=claimable)
    return crf_label.astype(np.uint8), saliency


def compute_seg_label_5(
    ori_img: np.ndarray,
    cam_label: np.ndarray,
    norm_cam: np.ndarray,
    saliency: np.ndarray,
    cut_threshold: float = 0.95,
    bg_power: float = 32.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference ``compute_seg_label_5`` (``myTool.py:534-609``): the
    two-step mining recipe (percentile 0.95) + morphological-open denoise,
    additionally returning the 40x40-dilated (opened) foreground mask."""
    cam_label = cam_label.astype(np.uint8)
    crf_label = _power_background_labels(cam_label, norm_cam, saliency, bg_power)
    crf_label = _mine_sure_regions(crf_label, norm_cam, cam_label, saliency,
                                   cut_threshold)
    frg_open = _morph_open(((crf_label != 0) * 255).astype(np.uint8), 10)
    crf_label[frg_open != 255] = 0
    frg_dilate = _dilate(frg_open, 40)
    return crf_label.astype(np.uint8), saliency, frg_dilate


def compute_seg_label_two_step_coco(
    ori_img: np.ndarray,
    cam_label: np.ndarray,
    norm_cam: np.ndarray,
    saliency: np.ndarray,
    native_size: Optional[Tuple[int, int]] = None,
    cut_threshold: float = 0.95,
    bg_power: float = 32.0,
    out_dir: Optional[str] = None,
    name: str = "",
) -> np.ndarray:
    """Reference ``compute_seg_label_two_step_coco`` (``myTool.py:388-453``):
    80-class mining at percentile 0.95, no morphological cleanup,
    nearest-neighbor resize to the native image size."""
    cam_label = cam_label.astype(np.uint8)
    crf_label = _power_background_labels(cam_label, norm_cam, saliency, bg_power)
    crf_label = _mine_sure_regions(crf_label, norm_cam, cam_label, saliency,
                                   cut_threshold)
    crf_label = crf_label.astype(np.uint8)
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
