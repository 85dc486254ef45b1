"""Pseudo-mask mIoU evaluation with the 100-point background-threshold curve.

Own copy of ``acr_wsss_tpu/evaluate.py`` (reference ``evaluation.py``), so
that the port's CAM dicts are scored without the JAX package. A CAM
``.npy`` file holds ``{class_id: HxW float}``; the background channel is
the threshold; prediction = argmax (ties to background); ground-truth
pixels of value 255 are ignored. Each image is decoded once and every
threshold is scored from its per-pixel (best class, best score).

    python -m acr_wsss_tpu_torch.evaluate --list L.txt --predict_dir P \
        --gt_dir G --comment x --type npy --curve True
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from acr_wsss_tpu_torch.configs import VOC_CATEGORIES, parse_bool


def _decode_npy(path: str) -> tuple:
    """CAM dict -> per-pixel (best foreground class + 1, best score)."""
    cam_dict = np.load(path, allow_pickle=True).item()
    first = next(iter(cam_dict.values()))
    stack = np.zeros((len(cam_dict),) + first.shape, dtype=np.float32)
    keys = np.fromiter(cam_dict.keys(), dtype=np.int64)
    for i, key in enumerate(cam_dict.keys()):
        stack[i] = cam_dict[key]
    best_class = keys[np.argmax(stack, axis=0)] + 1
    return best_class.astype(np.uint8), np.max(stack, axis=0)


def _eval_chunk(args) -> np.ndarray:
    """[n_thresh, 3, num_cls] (TP, P, T) over a slice of images."""
    (predict_folder, gt_folder, names, input_type, thresholds, num_cls) = args
    out = np.zeros((len(thresholds), 3, num_cls), dtype=np.int64)
    for name in names:
        gt = np.asarray(Image.open(os.path.join(gt_folder, f"{name}.png")))
        valid = gt < 255
        gt_v = gt[valid].astype(np.int64)
        t_count = np.bincount(gt_v, minlength=num_cls)
        if input_type == "png":
            pred = np.asarray(
                Image.open(os.path.join(predict_folder, f"{name}.png")))
            preds = [pred[valid].astype(np.int64)] * len(thresholds)
        else:
            best_class, best_score = _decode_npy(
                os.path.join(predict_folder, f"{name}.npy"))
            bc_v = best_class[valid].astype(np.int64)
            bs_v = best_score[valid]
            preds = [np.where(bs_v > t, bc_v, 0) for t in thresholds]
        for ti, pred_v in enumerate(preds):
            out[ti, 1] += np.bincount(pred_v, minlength=num_cls)
            out[ti, 2] += t_count
            out[ti, 0] += np.bincount(pred_v[pred_v == gt_v], minlength=num_cls)
    return out


def _metrics_from_counts(counts: np.ndarray, num_cls: int) -> Dict[str, float]:
    """Per-class IoU (in %) and mIoU (reference ``evaluation.py:60-76``)."""
    TP, P, T = (counts[i].astype(np.float64) for i in range(3))
    iou = TP / (T + P - TP + 1e-10)
    loglist = {VOC_CATEGORIES[i] if num_cls == 21 else str(i): iou[i] * 100
               for i in range(num_cls)}
    loglist["mIoU"] = float(np.mean(iou) * 100)
    return loglist


def do_python_eval_curve(
    predict_folder: str,
    gt_folder: str,
    name_list: Sequence[str],
    num_cls: int = 21,
    input_type: str = "npy",
    thresholds: Optional[Sequence[float]] = None,
    num_workers: int = 8,
) -> List[Dict[str, float]]:
    """Evaluate every threshold (default 0.00 .. 0.99) in one pass."""
    if thresholds is None:
        thresholds = [i / 100.0 for i in range(100)]
    name_list = list(name_list)
    num_workers = max(1, min(num_workers, len(name_list)))
    chunks = [(predict_folder, gt_folder, name_list[i::num_workers],
               input_type, list(thresholds), num_cls)
              for i in range(num_workers)]
    if num_workers == 1:
        partials = [_eval_chunk(chunks[0])]
    else:
        with multiprocessing.get_context("spawn").Pool(num_workers) as pool:
            partials = pool.map(_eval_chunk, chunks)
    total = np.sum(partials, axis=0)
    return [_metrics_from_counts(total[ti], num_cls)
            for ti in range(len(thresholds))]


def do_python_eval(predict_folder: str, gt_folder: str,
                   name_list: Sequence[str], num_cls: int = 21,
                   input_type: str = "png", threshold: float = 1.0,
                   num_workers: int = 8, printlog: bool = False) -> Dict[str, float]:
    """Single-threshold evaluation; ``printlog`` prints the per-class IoU
    table (reference ``evaluation.py:78-93``)."""
    loglist = do_python_eval_curve(predict_folder, gt_folder, name_list, num_cls,
                                   input_type, [threshold], num_workers)[0]
    if printlog:
        cats = VOC_CATEGORIES if num_cls == 21 else [str(i) for i in range(num_cls)]
        for i in range(num_cls):
            end = "\t" if i % 2 != 1 else "\n"
            print("%11s:%7.3f%%" % (cats[i], loglist[cats[i]]), end=end)
        print("\n======================================================")
        print("%11s:%7.3f%%" % ("mIoU", loglist["mIoU"]))
    return loglist


def writelog(filepath: str, metric: Dict, comment: str) -> None:
    """Append a timestamped record in the reference ``evallog.txt`` format."""
    with open(filepath, "a") as logfile:
        logfile.write(time.strftime("%Y-%m-%d %H:%M:%S", time.localtime()))
        logfile.write("\t%s\n" % comment)
        logfile.write("".join("%s:%s  " % kv for kv in metric.items()) + "\n")
        logfile.write("=====================================\n")


def read_name_list(path: str) -> List[str]:
    """The non-empty, stripped lines of a name list."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--list", default="voc12/train_id.txt")
    parser.add_argument("--predict_dir", default="./out_rw")
    parser.add_argument("--gt_dir", default="./VOC2012/SegmentationClass")
    parser.add_argument("--logfile", default="./evallog.txt")
    parser.add_argument("--comment", required=True)
    parser.add_argument("--type", default="png", choices=["npy", "png"])
    parser.add_argument("--t", default=None, type=float)
    parser.add_argument("--curve", default=False, type=parse_bool)
    parser.add_argument("--num_workers", default=8, type=int)
    args = parser.parse_args(argv)
    if args.type == "npy" and args.t is None and not args.curve:
        parser.error("--type npy needs --t or --curve True")
    names = read_name_list(args.list)
    if not args.curve:
        loglist = do_python_eval(args.predict_dir, args.gt_dir, names, 21,
                                 args.type, args.t, args.num_workers)
        print("%11s:%7.3f%%" % ("mIoU", loglist["mIoU"]))
        writelog(args.logfile, loglist, args.comment)
    else:
        curves = do_python_eval_curve(args.predict_dir, args.gt_dir, names, 21,
                                      args.type, num_workers=args.num_workers)
        mious = [c["mIoU"] for c in curves]
        for i, miou in enumerate(mious):
            print("%d/60 background score: %.3f\tmIoU: %.3f%%"
                  % (i, i / 100.0, miou))
        writelog(args.logfile, {"mIoU": mious}, args.comment)


if __name__ == "__main__":
    main()
