"""One-command pipeline: train -> CAM inference -> threshold-curve eval.

Counterpart of ``acr_wsss_tpu/pipeline.py`` (``run_pipeline`` ``:31-76``,
``parse_args`` / ``main`` ``:79-281``) for VOC, the reference's config of
record (``train_acr.sh:1-49``: vitb_hybrid, lr 0.05, alpha 125, crop 384,
10 epochs, global batch 4; then GETAM ``grad`` from layer 10 with affinity
refinement; then the 100-threshold mIoU curve):

    python -m acr_wsss_tpu_torch.pipeline \\
        --IMpath <VOC JPEGImages> --gt_dir <SegmentationClassAug> \\
        --session_name acr_001 [--pamr 10]

Stages can be skipped (``--stages infer,eval``) to rerun inference and
evaluation on the saved weights. Everything runs on ``--device`` (default
``cuda``). ``--dataset coco`` switches the chain to MS-COCO (reference
``train_acr_coco.sh``): 80 classes, names from the image directory, labels
from ``--bbox_dir`` txts, validation images from ``--valpath``, 81-class
eval. ``--train_relaunches N`` runs the train stage under the relaunch
supervisor (``utils/supervisor.py``; pair it with ``--step_timeout_s``).
``--out_crf D [--crf_device]`` and ``--heatmap H`` add the infer stage's
CRF-fused CAMs and heatmaps (``infer_cam.py``). ``--infer_dp N`` runs
the infer stage in N worker processes, one per GPU. Launched by
``torchrun``, the train stage runs data-parallel on every rank (``train.py``)
and rank 0 alone then runs infer and eval. ``--infer_scan`` (the scanned
trunk) is refused.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from acr_wsss_tpu_torch.configs import EvalConfig, InferConfig, ModelConfig, TrainConfig
from acr_wsss_tpu_torch.parallel import distributed

STAGES = ("train", "infer", "eval")


def run_pipeline(train_cfg: TrainConfig, infer_cfg: InferConfig, eval_cfg: EvalConfig,
                 stages: Sequence[str] = STAGES, train_relaunches: int = 0) -> None:
    if "train" in stages:
        if train_relaunches > 0:
            from acr_wsss_tpu_torch.utils.supervisor import run_train_supervised

            run_train_supervised(train_cfg, max_relaunches=train_relaunches)
        else:
            from acr_wsss_tpu_torch.train import train

            # Every rank returns once rank 0 has written the npz.
            train(train_cfg)
    if distributed.rank() != 0:
        return
    if "infer" in stages:
        from acr_wsss_tpu_torch.infer_cam import run as infer_run

        infer_run(infer_cfg)
    if "eval" in stages:
        from acr_wsss_tpu_torch import evaluate

        names = evaluate.read_name_list(eval_cfg.name_list)
        if eval_cfg.curve:
            curves = evaluate.do_python_eval_curve(
                eval_cfg.predict_dir, eval_cfg.gt_dir, names, eval_cfg.num_classes,
                eval_cfg.input_type, num_workers=eval_cfg.num_workers)
            mious = [c["mIoU"] for c in curves]
            for i, miou in enumerate(mious):
                print("%d/60 background score: %.3f\tmIoU: %.3f%%" % (i, i / 100.0, miou))
            evaluate.writelog(eval_cfg.logfile, {"mIoU": mious}, eval_cfg.comment)
            best = max(range(len(mious)), key=lambda i: mious[i])
            print("best threshold %.2f -> mIoU %.3f%%" % (best / 100.0, mious[best]))
        else:
            loglist = evaluate.do_python_eval(
                eval_cfg.predict_dir, eval_cfg.gt_dir, names, eval_cfg.num_classes,
                eval_cfg.input_type, eval_cfg.threshold,
                num_workers=eval_cfg.num_workers, printlog=True)
            evaluate.writelog(eval_cfg.logfile, loglist, eval_cfg.comment)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="ACR WSSS pipeline (train_acr.sh config of record)")
    # shared
    parser.add_argument("--session_name", default="acr_001")
    parser.add_argument("--backbone", default="vitb_hybrid")
    parser.add_argument("--dataset", default="voc12", choices=["voc12", "coco"],
                        help="coco: 80 classes, names from the image directory, labels "
                             "from --bbox_dir txts (reference train_acr_coco.sh)")
    parser.add_argument("--IMpath", required=True,
                        help="VOC JPEGImages / COCO train2014 directory")
    parser.add_argument("--gt_dir", required=True,
                        help="segmentation ground-truth directory")
    parser.add_argument("--cls_labels", default="voc12/cls_labels.npy")
    parser.add_argument("--bbox_dir", default=None,
                        help="COCO per-image bbox txt directory (labels)")
    parser.add_argument("--valpath", default=None,
                        help="COCO val image directory (reference train_acr_coco.py "
                             "--valpath)")
    parser.add_argument("--crop_size", default=384, type=int)
    parser.add_argument("--attn_impl", default="kernel", choices=["kernel", "plain"])
    parser.add_argument("--stages", default="train,infer,eval",
                        help="comma-separated subset of train,infer,eval")
    parser.add_argument("--device", default="cuda")
    # train (train_acr.sh:8-19)
    parser.add_argument("--train_list", default="voc12/train_aug_id.txt")
    parser.add_argument("--val_list", default="voc12/val_id.txt")
    parser.add_argument("--lr", default=0.05, type=float)
    parser.add_argument("--batch_size", default=4, type=int,
                        help="global batch (reference: 1/GPU x 4 GPUs)")
    parser.add_argument("--alpha", default=125.0, type=float)
    parser.add_argument("--max_epoches", default=10, type=int)
    parser.add_argument("--weight_dir", default="weight")
    parser.add_argument("--pretrained", action="store_true",
                        help="init the trunk from the zoo npz (the reference's default "
                             "initialization)")
    parser.add_argument("--device_aug", action="store_true",
                        help="resize, flip, normalize and crop on the device from uint8 "
                             "rasters (data/device_aug.py)")
    parser.add_argument("--aug_pad", default=None, type=int,
                        help="static pad square for --device_aug; default 512 (VOC) / "
                             "640 (COCO)")
    parser.add_argument("--cache_decoded", action="store_true",
                        help="cache decoded uint8 rasters in RAM")
    parser.add_argument("--step_timeout_s", default=0.0, type=float,
                        help="hung-step watchdog budget of the train stage "
                             "(utils/watchdog.py); 0 = off")
    parser.add_argument("--train_relaunches", default=0, type=int,
                        help="run the train stage under the relaunch supervisor: a "
                             "watchdog exit relaunches it up to N times, resuming from "
                             "the latest checkpoint")
    parser.add_argument("--clip_grad_norm", default=0.0, type=float,
                        help="global-norm gradient clipping (0 = off, the "
                             "reference behavior; for from-scratch runs)")
    parser.add_argument("--seed", default=0, type=int,
                        help="training seed (init + data order + aug draws)")
    parser.add_argument("--reference_optimizer_quirk", action="store_true",
                        help="reproduce the reference PolyOptimizer's SGD-"
                             "argument mixup (weight_decay lands in the "
                             "momentum slot: effectively momentum=5e-4, no "
                             "decay — tool/torchutils.py:12)")
    # infer (train_acr.sh:26-37)
    parser.add_argument("--infer_list", default=None,
                        help="default: voc12/train_id.txt (VOC) or the image directory "
                             "listing, written to <weight_dir>/<session>_infer_list.txt "
                             "(COCO)")
    parser.add_argument("--pamr", default=0, type=int, metavar="ITERS",
                        help="PAMR CAM refinement iterations in the infer "
                             "stage (0 = off, the reference behavior)")
    parser.add_argument("--infer_batch_images", default=4, type=int,
                        help="images per inference pass (identical outputs "
                             "to one-at-a-time)")
    parser.add_argument("--infer_dp", default=0, type=int,
                        help="infer stage: worker processes, one per GPU (0/1 = one "
                             "process)")
    parser.add_argument("--infer_scan", action="store_true",
                        help="refused: the scanned trunk is not ported")
    parser.add_argument("--infer_scales", default="1.0",
                        help="infer stage: comma-separated multi-scale TTA "
                             "factors; each crop_size*scale must be a "
                             "multiple of 16")
    parser.add_argument("--start_layer", default=10, type=int)
    parser.add_argument("--getam_func", default="grad",
                        choices=["grad", "grad_s", "cam_grad", "cam_grad_s"])
    parser.add_argument("--out_cam", default="output/cam_npy")
    parser.add_argument("--out_crf", default=None,
                        help="also write background-power CRF-fused CAMs (reference "
                             "infer_cam.py:218-225) under <out_crf>_<low/high alpha>/")
    parser.add_argument("--crf_device", action="store_true",
                        help="run the --out_crf stage on --device (ops/crf.py) instead "
                             "of the host engine")
    parser.add_argument("--heatmap", default=None,
                        help="infer stage: directory of JET heatmap JPEGs of the CAMs")
    # eval (train_acr.sh:40-47)
    parser.add_argument("--logfile", default="evallog.txt")
    parser.add_argument("--comment", default=None)
    parser.add_argument("--eval_threshold", default=None, type=float,
                        help="single threshold instead of the 100-pt curve")
    args = parser.parse_args(argv)
    stages = tuple(s.strip() for s in args.stages.split(",") if s.strip())
    if not set(stages) <= set(STAGES):
        parser.error(f"--stages takes a subset of {','.join(STAGES)}, got {args.stages}")
    args.stages = stages
    if args.infer_scan:
        parser.error("--infer_scan: the scanned trunk (and the pipeline parallelism it "
                     "serves) is not ported; the unrolled trunk reads a scanned "
                     "checkpoint")
    if args.train_relaunches and distributed.launched():
        parser.error("--train_relaunches under a launcher: use the launcher's restarts "
                     "(torchrun --max-restarts)")
    if args.dataset == "coco" and not args.bbox_dir:
        parser.error("--dataset coco requires --bbox_dir")
    args.infer_scales = tuple(float(s) for s in args.infer_scales.split(",") if s.strip())
    for s in args.infer_scales:
        if int(args.crop_size * s) % 16:
            parser.error(f"--infer_scales {s}: crop_size*scale is not a multiple of 16")
    return args


def _infer_list(args: argparse.Namespace) -> str:
    """``--infer_list``, or its default: VOC's train ids, or for COCO the
    image directory's listing, written into ``weight_dir`` so that the
    infer and eval stages (and a rerun) read the same names."""
    if args.infer_list:
        return args.infer_list
    if args.dataset != "coco":
        return "voc12/train_id.txt"
    from acr_wsss_tpu_torch.data import coco as coco_data

    os.makedirs(args.weight_dir, exist_ok=True)
    path = os.path.join(args.weight_dir, f"{args.session_name}_infer_list.txt")
    with open(path, "w") as f:
        f.write("\n".join(coco_data.list_image_names(args.IMpath)) + "\n")
    return path


def configs(args: argparse.Namespace):
    """(TrainConfig, InferConfig, EvalConfig) of the parsed flags."""
    coco = args.dataset == "coco"
    num_classes = 80 if coco else 20
    labels_path = args.bbox_dir if coco else args.cls_labels
    infer_list = _infer_list(args)
    model_cfg = ModelConfig(backbone=args.backbone, attn_impl=args.attn_impl,
                            num_classes=num_classes)
    train_cfg = TrainConfig(
        model=model_cfg, dataset=args.dataset, crop_size=args.crop_size,
        batch_size=args.batch_size, max_epochs=args.max_epoches, lr=args.lr, alpha=args.alpha,
        session_name=args.session_name, checkpoint_dir=args.weight_dir,
        image_dir=args.IMpath, train_list=args.train_list, val_list=args.val_list,
        val_image_dir=args.valpath, cls_labels_path=labels_path,
        pretrained=args.pretrained, device_aug=args.device_aug,
        aug_pad=args.aug_pad or (640 if coco else 512), cache_decoded=args.cache_decoded,
        clip_grad_norm=args.clip_grad_norm,
        reference_optimizer_quirk=args.reference_optimizer_quirk,
        step_timeout_s=args.step_timeout_s, seed=args.seed, device=args.device)
    infer_cfg = InferConfig(
        model=model_cfg, dataset=args.dataset,
        weights=os.path.join(args.weight_dir, f"{args.session_name}_last.npz"),
        crop_size=args.crop_size, start_layer=args.start_layer,
        getam_func=args.getam_func, use_aff=True, scales=args.infer_scales,
        out_cam=args.out_cam, out_crf=args.out_crf, crf_device=args.crf_device,
        heatmap=args.heatmap, image_dir=args.IMpath, infer_list=infer_list,
        cls_labels_path=labels_path, batch_images=args.infer_batch_images,
        pamr_iters=args.pamr, dp=args.infer_dp, device=args.device)
    eval_cfg = EvalConfig(
        predict_dir=args.out_cam, gt_dir=args.gt_dir, name_list=infer_list,
        logfile=args.logfile,
        comment=args.comment if args.comment is not None else args.session_name,
        input_type="npy", threshold=args.eval_threshold,
        curve=args.eval_threshold is None, num_classes=num_classes + 1)
    return train_cfg, infer_cfg, eval_cfg


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    try:
        run_pipeline(*configs(args), stages=args.stages,
                     train_relaunches=args.train_relaunches)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
