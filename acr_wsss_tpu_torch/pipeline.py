"""One-command VOC pipeline: train -> CAM inference -> threshold-curve eval.

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
``cuda``). Flags of parts not yet ported (COCO, ``--pretrained``,
``--device_aug``, the watchdog and relaunch supervisor, ``--infer_scan``,
``--infer_dp``, the CRF and heatmap outputs) are not defined, so argparse
refuses them.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from acr_wsss_tpu_torch.configs import EvalConfig, InferConfig, ModelConfig, TrainConfig

STAGES = ("train", "infer", "eval")


def run_pipeline(train_cfg: TrainConfig, infer_cfg: InferConfig, eval_cfg: EvalConfig,
                 stages: Sequence[str] = STAGES) -> None:
    if "train" in stages:
        from acr_wsss_tpu_torch.train import train

        train(train_cfg)
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
    parser.add_argument("--IMpath", required=True, help="VOC JPEGImages directory")
    parser.add_argument("--gt_dir", required=True,
                        help="segmentation ground-truth directory")
    parser.add_argument("--cls_labels", default="voc12/cls_labels.npy")
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
    parser.add_argument("--cache_decoded", action="store_true",
                        help="cache decoded uint8 rasters in RAM")
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
    parser.add_argument("--infer_list", default="voc12/train_id.txt")
    parser.add_argument("--pamr", default=0, type=int, metavar="ITERS",
                        help="PAMR CAM refinement iterations in the infer "
                             "stage (0 = off, the reference behavior)")
    parser.add_argument("--infer_batch_images", default=4, type=int,
                        help="images per inference pass (identical outputs "
                             "to one-at-a-time)")
    parser.add_argument("--infer_scales", default="1.0",
                        help="infer stage: comma-separated multi-scale TTA "
                             "factors; each crop_size*scale must be a "
                             "multiple of 16")
    parser.add_argument("--start_layer", default=10, type=int)
    parser.add_argument("--getam_func", default="grad",
                        choices=["grad", "grad_s", "cam_grad", "cam_grad_s"])
    parser.add_argument("--out_cam", default="output/cam_npy")
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
    args.infer_scales = tuple(float(s) for s in args.infer_scales.split(",") if s.strip())
    for s in args.infer_scales:
        if int(args.crop_size * s) % 16:
            parser.error(f"--infer_scales {s}: crop_size*scale is not a multiple of 16")
    return args


def configs(args: argparse.Namespace):
    """(TrainConfig, InferConfig, EvalConfig) of the parsed flags."""
    model_cfg = ModelConfig(backbone=args.backbone, attn_impl=args.attn_impl)
    train_cfg = TrainConfig(
        model=model_cfg, crop_size=args.crop_size, batch_size=args.batch_size,
        max_epochs=args.max_epoches, lr=args.lr, alpha=args.alpha,
        session_name=args.session_name, checkpoint_dir=args.weight_dir,
        image_dir=args.IMpath, train_list=args.train_list, val_list=args.val_list,
        cls_labels_path=args.cls_labels, cache_decoded=args.cache_decoded,
        clip_grad_norm=args.clip_grad_norm,
        reference_optimizer_quirk=args.reference_optimizer_quirk, seed=args.seed,
        device=args.device)
    infer_cfg = InferConfig(
        model=model_cfg,
        weights=os.path.join(args.weight_dir, f"{args.session_name}_last.npz"),
        crop_size=args.crop_size, start_layer=args.start_layer,
        getam_func=args.getam_func, use_aff=True, scales=args.infer_scales,
        out_cam=args.out_cam, image_dir=args.IMpath, infer_list=args.infer_list,
        cls_labels_path=args.cls_labels, batch_images=args.infer_batch_images,
        pamr_iters=args.pamr, device=args.device)
    eval_cfg = EvalConfig(
        predict_dir=args.out_cam, gt_dir=args.gt_dir, name_list=args.infer_list,
        logfile=args.logfile,
        comment=args.comment if args.comment is not None else args.session_name,
        input_type="npy", threshold=args.eval_threshold,
        curve=args.eval_threshold is None, num_classes=model_cfg.num_classes + 1)
    return train_cfg, infer_cfg, eval_cfg


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    run_pipeline(*configs(args), stages=args.stages)


if __name__ == "__main__":
    main()
