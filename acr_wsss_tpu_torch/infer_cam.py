"""CAM/GETAM inference: flip TTA, class slots, npy CAM dicts.

Counterpart of ``acr_wsss_tpu/infer_cam.py`` (``build_infer_fn``
``:43-110``, ``process_image`` / ``process_images_batched`` ``:113-310``).
Both TTA views (identity, hflip) run as one batch, uploaded once; one
forward serves GETAM and the per-patch CAM head; the present classes are
backpropagated in slots; with ``--pamr N`` each view's CAM is refined on
the device at crop resolution (``ops/pamr.py``); the per-image native-size
resize and min-max normalization run on the host. With
``InferConfig.dataset="coco"`` the labels come from bbox txts
(``data/coco.py``), as the pipeline's ``--dataset coco`` sets it.

``--out_crf D`` writes each CAM dict fused with a background score at
both alphas through the dense CRF into ``D_<alpha>/`` (``crf_with_alpha``,
JAX ``:306-371``): on the host's native engine, or with ``--crf_device``
on the device at one (``--crf_pad``)^2 bucket, where an image larger than
the bucket takes the host engine and is counted. ``--heatmap H`` writes
JET overlays of the CAMs.

    python -m acr_wsss_tpu_torch.infer_cam --weights W.npz \
        --LISTpath L.txt --IMpath JPEGs --cls_labels labels.npy \
        --out_cam out/cam_npy [--pamr 10] [--out_crf out/crf --crf_device] \
        [--heatmap out/heat]

The data-parallel mesh and the scanned trunk of the JAX CLI are not part
of this module yet.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from acr_wsss_tpu_torch.configs import VOC_CLASSES, InferConfig, ModelConfig, parse_bool
from acr_wsss_tpu_torch.data import coco as coco_data
from acr_wsss_tpu_torch.data import transforms
from acr_wsss_tpu_torch.data import voc as voc_data
from acr_wsss_tpu_torch.getam import getam_cams, make_forward_for_getam, tap_config
from acr_wsss_tpu_torch.models.acr import ACR
from acr_wsss_tpu_torch.models.convert import flax_to_state_dict
from acr_wsss_tpu_torch.ops import crf as crf_ops
from acr_wsss_tpu_torch.ops import imops
from acr_wsss_tpu_torch.ops.pamr import make_pamr_fn
from acr_wsss_tpu_torch.utils.checkpoint import load_params_npz


def build_infer_fn(model: ACR, crop_size: int, start_layer: int, getam_func: str,
                   use_aff: bool, num_classes: int, class_slots: int = 0):
    """(B, crop, crop, 3) views, a host array or a tensor[, class ids] ->
    dict of tensors on the model's device (``infer.device``): cams (K, B,
    grid*grid), patch_cam (B, grid*grid, C) and logits (B, C)."""
    spec = model.spec
    n_tokens = (crop_size // 16) ** 2 + spec.num_prefix_tokens
    off_start, export = tap_config(model, start_layer, getam_func)
    model.requires_grad_(False).eval()
    device = next(model.parameters()).device

    def infer(x, class_ids=None):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        if class_ids is None:
            class_ids = range(class_slots or num_classes)
        forward = make_forward_for_getam(model, x, export=export, with_patch_cam=True)
        cams, logits, _, patch_cam = getam_cams(
            forward, (spec.depth - off_start, x.shape[0], spec.num_heads,
                      n_tokens, n_tokens),
            num_classes=num_classes, start_layer=start_layer, func=getam_func,
            start_index=spec.num_prefix_tokens, use_aff=use_aff,
            class_ids=class_ids, offsets_start=off_start, device=device)
        return {"cams": cams, "patch_cam": patch_cam, "logits": logits}

    infer.class_slots = class_slots
    infer.device = device
    return infer


def _run_views(fn, batch: torch.Tensor, present: Sequence[int], num_classes: int,
               grid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cams (C, V, grid*grid), patch_cam (V, grid*grid, C)) on the device
    for the views, sweeping only ``present`` in slots of ``fn.class_slots``
    when set; the rows of the other classes are zero."""
    slots = fn.class_slots
    if not slots:
        out = fn(batch)
        return out["cams"], out["patch_cam"]
    cams = torch.zeros((num_classes, len(batch), grid * grid), dtype=torch.float32,
                       device=batch.device)
    for pos in range(0, len(present), slots):
        chunk = list(present[pos:pos + slots])
        ids = chunk + [chunk[-1]] * (slots - len(chunk))
        out = fn(batch, ids)
        cams[chunk] = out["cams"][:len(chunk)].float()
    return cams, out["patch_cam"]


def process_images_batched(infer_fn, img_paths: Sequence[str],
                           labels_list: Sequence[np.ndarray], crop_size: int,
                           flip_tta: bool = True, scales: Sequence[float] = (1.0,),
                           infer_fns_by_scale: Optional[Dict[float, object]] = None,
                           pamr_fn=None):
    """V images per pass; returns [(cam_dict, patch_cam_dict, rgb)] per image.
    Class slots sweep the union of the group's present classes.
    ``pamr_fn`` (``ops.pamr.make_pamr_fn``) refines every view's CAM rows
    at crop resolution, guided by the normalized views already on the
    device, before the flip and the TTA sum."""
    V = len(img_paths)
    rgbs = [transforms.load_image_rgb(p) for p in img_paths]
    num_classes = labels_list[0].shape[0]
    present_sets = [[c for c in range(num_classes) if lab[c] > 1e-5]
                    for lab in labels_list]
    union_present = sorted(set().union(*map(set, present_sets)))
    if not union_present:
        return [({}, {}, rgb) for rgb in rgbs]

    cam_accs: list = [None] * V
    patch_accs: list = [None] * V
    for scale in scales:
        size = int(crop_size * scale)
        fn = (infer_fns_by_scale or {}).get(scale, infer_fn)
        xs = [transforms.val_transform(rgb, size) for rgb in rgbs]
        views = xs + ([x[:, ::-1] for x in xs] if flip_tta else [])
        grid = size // 16
        batch = torch.as_tensor(np.stack(views), device=fn.device)
        cams, patch = _run_views(fn, batch, union_present, num_classes, grid)
        cams = cams.reshape(num_classes, len(views), grid, grid)
        if pamr_fn is not None:
            refined = pamr_fn(batch.permute(0, 3, 1, 2), cams.transpose(0, 1))
            cams = refined.transpose(0, 1)
        cams = cams.cpu().numpy()
        patch = patch.cpu().numpy().transpose(0, 2, 1).reshape(
            len(views), num_classes, grid, grid)
        for v in range(V):
            cam_v, patch_v = cams[:, v], patch[v]
            if flip_tta:
                cam_v = cam_v + cams[:, V + v, :, ::-1]
                patch_v = patch_v + patch[V + v, :, :, ::-1]
            H, W = rgbs[v].shape[:2]
            cam_up = imops.resize_bilinear_np(cam_v, (H, W), align_corners=True)
            patch_up = imops.resize_bilinear_np(patch_v, (H, W), align_corners=False)
            cam_accs[v] = cam_up if cam_accs[v] is None else cam_accs[v] + cam_up
            patch_accs[v] = patch_up if patch_accs[v] is None else patch_accs[v] + patch_up

    results = []
    for v in range(V):
        if not present_sets[v]:
            results.append(({}, {}, rgbs[v]))
            continue
        mask = (labels_list[v] > 1e-5)[:, None, None]
        norm_cam = imops.minmax_normalize(cam_accs[v] * mask)
        patch_norm = imops.minmax_normalize(patch_accs[v] * mask, eps=1e-5)
        results.append((
            {c: norm_cam[c].astype(np.float32) for c in present_sets[v]},
            {c: patch_norm[c].astype(np.float32) for c in present_sets[v]},
            rgbs[v],
        ))
    return results


def process_image(infer_fn, img_path: str, label: np.ndarray, crop_size: int,
                  flip_tta: bool = True, scales: Sequence[float] = (1.0,),
                  infer_fns_by_scale: Optional[Dict[float, object]] = None,
                  pamr_fn=None):
    """(getam cam_dict, patch cam_dict, RGB image) of one image."""
    return process_images_batched(infer_fn, [img_path], [label], crop_size,
                                  flip_tta, scales, infer_fns_by_scale, pamr_fn)[0]


def crf_with_alpha(cam_dict: Dict[int, np.ndarray], alpha: float,
                   orig_img: np.ndarray) -> Dict[int, np.ndarray]:
    """Background-power CRF fusion on the host engine (reference
    ``infer_cam.py:27-40``): {0: background, c + 1: class c} marginals."""
    if not cam_dict:
        # No present class: background with certainty 1.
        return {0: np.ones(orig_img.shape[:2], np.float32)}
    v = np.array(list(cam_dict.values()))
    bg_score = np.power(1 - np.max(v, axis=0, keepdims=True), alpha)
    bgcam_score = np.concatenate((bg_score, v), axis=0)
    crf_score = crf_ops.crf_inference(orig_img, bgcam_score, labels=bgcam_score.shape[0])
    out = {0: crf_score[0]}
    for i, key in enumerate(cam_dict.keys()):
        out[key + 1] = crf_score[i + 1]
    return out


def fits_crf_bucket(shape: Sequence[int], pad: int) -> bool:
    """Whether an (H, W, ...) image fits the (pad, pad) bucket of the
    device route; a larger one takes the host engine."""
    return shape[0] <= pad and shape[1] <= pad


def crf_with_alpha_device(cam_dict: Dict[int, np.ndarray], alpha: float,
                          orig_img: np.ndarray, device, num_classes: int = 20,
                          pad: int = 512) -> Dict[int, np.ndarray]:
    """``--crf_device``: :func:`crf_with_alpha` on ``device`` (JAX
    ``:341-371``), ``crf_inference_torch`` with the ``crf_inference``
    recipe. The label axis is the full (num_classes + 1) slab, the absent
    classes at 1e-7; image and probabilities are edge-replicated to one
    (pad, pad) bucket for every image, as JAX compiles one program for it,
    and the marginals cropped back. An image larger than the bucket takes
    the host engine."""
    H, W = orig_img.shape[:2]
    if not cam_dict:
        return {0: np.ones((H, W), np.float32)}
    if not fits_crf_bucket(orig_img.shape, pad):
        return crf_with_alpha(cam_dict, alpha, orig_img)
    v = np.array(list(cam_dict.values()))
    probs = np.full((num_classes + 1, H, W), 1e-7, np.float32)
    probs[0] = np.power(1 - np.max(v, axis=0), alpha)
    for i, key in enumerate(cam_dict):
        probs[key + 1] = v[i]
    edge = (0, pad - W, 0, pad - H)
    probs_p = F.pad(torch.from_numpy(probs).to(device)[None], edge, mode="replicate")[0]
    img = torch.from_numpy(orig_img.astype(np.float32)).to(device)
    img_p = F.pad(img.permute(2, 0, 1)[None], edge, mode="replicate")[0].permute(1, 2, 0)
    out = crf_ops.crf_inference_torch(img_p, probs_p, device=device)[:, :H, :W].cpu().numpy()
    result = {0: out[0]}
    for key in cam_dict:
        result[key + 1] = out[key + 1]
    return result


def save_heatmaps(heatmap_dir: str, name: str, rgb: np.ndarray,
                  cam_dict: Dict[int, np.ndarray]) -> None:
    """JET overlays (50/50 with the image) of each CAM as
    ``<name>_<class>_getam.jpg`` (reference ``infer_cam.py:232-247``)."""
    os.makedirs(heatmap_dir, exist_ok=True)
    for c, mask in cam_dict.items():
        heat = imops.apply_colormap_jet(np.uint8(255 * mask))[..., ::-1]  # RGB
        blend = (heat * 0.5 + rgb * 0.5).astype(np.uint8)
        cls = VOC_CLASSES[c] if c < len(VOC_CLASSES) else f"class{c}"
        Image.fromarray(blend).save(os.path.join(heatmap_dir, f"{name}_{cls}_getam.jpg"))


def load_model(cfg: InferConfig) -> ACR:
    """The ACR of ``cfg.model`` on ``cfg.device`` with the npz weights.
    Built without ``cfg.model.probs_dtype``, as JAX's ``run`` builds it
    (``acr_wsss_tpu/infer_cam.py:385-392``): inference exports float32. A
    checkpoint of the scanned trunk loads too (``:395-411``;
    ``flax_to_state_dict`` unrolls it)."""
    model = ACR(num_classes=cfg.model.num_classes, backbone_name=cfg.model.backbone,
                dtype=getattr(torch, cfg.model.compute_dtype),
                attn_impl=cfg.model.attn_impl)
    path = cfg.weights if cfg.weights.endswith(".npz") else cfg.weights + ".npz"
    model.load_state_dict(flax_to_state_dict(load_params_npz(path), model.state_dict()))
    return model.to(cfg.device)


def run(cfg: InferConfig) -> Dict[str, int]:
    """The CAM pass over ``cfg.infer_list`` and what ``cfg`` asks to be
    written. Returns how many images the --out_crf stage ran on each
    route, {"device": n, "host": m}."""
    model = load_model(cfg)
    infer_fns = {
        scale: build_infer_fn(model, int(cfg.crop_size * scale), cfg.start_layer,
                              cfg.getam_func, cfg.use_aff, cfg.model.num_classes,
                              class_slots=cfg.class_slots)
        for scale in cfg.scales
    }
    # One function serves every scale: the kernels take any (H, W).
    pamr_fn = (make_pamr_fn(cfg.pamr_iters, cfg.pamr_dilations) if cfg.pamr_iters
               else None)
    if cfg.dataset == "coco":
        # names from infer_list or the image directory, labels from the
        # bbox txts in cls_labels_path (``acr_wsss_tpu/infer_cam.py:460-465``)
        names = (voc_data.read_file(cfg.infer_list) if cfg.infer_list
                 else coco_data.list_image_names(cfg.image_dir))
        labels = coco_data.CocoLabelStore(cfg.cls_labels_path, names)
    else:
        # Bare-id lists, or VOC path-pair lines whose id is chars 12:23.
        with open(cfg.infer_list) as f:
            first_line = f.readline()
        names = (voc_data.read_file_2(cfg.infer_list) if first_line.startswith("/")
                 else voc_data.read_file(cfg.infer_list))
        labels = voc_data.load_cls_labels(cfg.cls_labels_path)
    if cfg.out_cam:
        os.makedirs(cfg.out_cam, exist_ok=True)
    routes = {"device": 0, "host": 0}
    V = max(1, cfg.batch_images)
    print("generating cam...", flush=True)
    for gi in range(0, len(names), V):
        group = names[gi:gi + V]
        results = process_images_batched(
            infer_fns[cfg.scales[0]],
            [os.path.join(cfg.image_dir, f"{n}.jpg") for n in group],
            [labels[n] for n in group], cfg.crop_size, cfg.flip_tta,
            scales=cfg.scales, infer_fns_by_scale=infer_fns, pamr_fn=pamr_fn)
        for name, (cam_dict, _, rgb) in zip(group, results):
            if cfg.out_cam:
                np.save(os.path.join(cfg.out_cam, f"{name}.npy"), cam_dict)
            if cfg.out_crf:
                on_device = cfg.crf_device and fits_crf_bucket(rgb.shape, cfg.crf_pad)
                routes["device" if on_device else "host"] += 1
                for alpha in (cfg.low_alpha, cfg.high_alpha):
                    crf = (crf_with_alpha_device(cam_dict, alpha, rgb, cfg.device,
                                                 num_classes=cfg.model.num_classes,
                                                 pad=cfg.crf_pad)
                           if on_device else crf_with_alpha(cam_dict, alpha, rgb))
                    folder = f"{cfg.out_crf}_{alpha}"
                    os.makedirs(folder, exist_ok=True)
                    np.save(os.path.join(folder, f"{name}.npy"), crf)
            if cfg.heatmap:
                save_heatmaps(cfg.heatmap, name, rgb, cam_dict)
        if gi % 50 < V:
            print(gi, flush=True)
    if cfg.out_crf and cfg.crf_device:
        print(f"crf: {routes['device']} on {cfg.device}, {routes['host']} on host "
              f"(larger than pad {cfg.crf_pad})", flush=True)
    elif cfg.out_crf:
        print(f"crf: {routes['host']} on host", flush=True)
    return routes


def parse_args(argv=None) -> InferConfig:
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", required=True)
    parser.add_argument("--backbone", default="vitb_hybrid")
    parser.add_argument("--LISTpath", default="voc12/train_id.txt")
    parser.add_argument("--IMpath", default="voc/image/path")
    parser.add_argument("--cls_labels", default="voc12/cls_labels.npy")
    parser.add_argument("--out_cam", default="")
    parser.add_argument("--out_crf", default=None,
                        help="also write the CRF-fused CAMs at --low_alpha and "
                             "--high_alpha under <out_crf>_<alpha>/")
    parser.add_argument("--heatmap", default=None,
                        help="directory of JET heatmap JPEGs of the CAMs")
    parser.add_argument("--low_alpha", default=1, type=int)
    parser.add_argument("--high_alpha", default=12, type=int)
    parser.add_argument("--crf_device", action="store_true",
                        help="run the --out_crf stage on --device (a bilateral-grid "
                             "mean-field at one padded bucket) instead of the host "
                             "engine")
    parser.add_argument("--crf_pad", default=512, type=int,
                        help="the bucket of --crf_device; larger images take the host "
                             "engine")
    parser.add_argument("--start_layer", default=10, type=int)
    parser.add_argument("--getam_func", default="grad",
                        choices=["grad", "grad_s", "cam_grad", "cam_grad_s"])
    parser.add_argument("--aff", default=True, type=parse_bool)
    parser.add_argument("--crop_size", default=384, type=int)
    parser.add_argument("--attn_impl", default="kernel", choices=["kernel", "plain"])
    parser.add_argument("--class_slots", default=4, type=int,
                        help="present-class backprop slots per pass (0 = all classes)")
    parser.add_argument("--batch_images", default=4, type=int,
                        help="images per pass")
    parser.add_argument("--pamr", default=0, type=int, metavar="ITERS",
                        help="PAMR refinement iterations (0 = off, the "
                             "reference behavior; it imports PAMR but "
                             "never calls it). 10 is the usual setting.")
    parser.add_argument("--pamr_dilations", default="1,2,4,8,12,24",
                        help="comma-separated PAMR dilation list")
    parser.add_argument("--scales", default="1.0",
                        help="comma-separated multi-scale TTA factors; each "
                             "crop_size*scale must be a multiple of 16")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    scales = tuple(float(s) for s in args.scales.split(",") if s.strip())
    for s in scales:
        if int(args.crop_size * s) % 16:
            parser.error(f"--scales {s}: crop_size*scale is not a multiple of 16")
    return InferConfig(
        model=ModelConfig(backbone=args.backbone, attn_impl=args.attn_impl),
        weights=args.weights, crop_size=args.crop_size,
        start_layer=args.start_layer, getam_func=args.getam_func,
        use_aff=args.aff, scales=scales, out_cam=args.out_cam, out_crf=args.out_crf,
        heatmap=args.heatmap, low_alpha=args.low_alpha, high_alpha=args.high_alpha,
        crf_device=args.crf_device, crf_pad=args.crf_pad,
        image_dir=args.IMpath, infer_list=args.LISTpath,
        cls_labels_path=args.cls_labels, class_slots=args.class_slots,
        batch_images=args.batch_images, pamr_iters=args.pamr,
        pamr_dilations=tuple(int(d) for d in args.pamr_dilations.split(",") if d.strip()),
        device=args.device)


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
