"""Segmentation metrics from a confusion matrix, in numpy.

Own copy of ``acr_wsss_tpu/utils/metrics.py`` (reference
``tool/metrics.py``): ``Evaluator`` accumulates the confusion matrix with
one ``bincount`` of ``num_class * gt + pred`` per batch, ignoring ground
truth outside [0, num_class) (VOC's 255), and reads pixel accuracy, mIoU
and frequency-weighted IoU from it; ``pred_acc`` is the top-k multi-label
accuracy of ``myTool.py:35-41``.
"""

from __future__ import annotations

import numpy as np


class Evaluator:
    def __init__(self, num_class: int):
        self.num_class = num_class
        self.confusion_matrix = np.zeros((num_class, num_class), dtype=np.int64)

    def Pixel_Accuracy(self) -> float:
        cm = self.confusion_matrix
        return np.diag(cm).sum() / max(cm.sum(), 1)

    def Pixel_Accuracy_Class(self) -> float:
        cm = self.confusion_matrix
        acc = np.diag(cm) / np.maximum(cm.sum(axis=1), 1e-10)
        return float(np.nanmean(acc))

    def Intersection_over_Union(self) -> np.ndarray:
        cm = self.confusion_matrix
        inter = np.diag(cm)
        union = cm.sum(axis=1) + cm.sum(axis=0) - inter
        return inter / np.maximum(union, 1e-10)

    def Mean_Intersection_over_Union(self) -> float:
        return float(np.nanmean(self.Intersection_over_Union()))

    def Frequency_Weighted_Intersection_over_Union(self) -> float:
        cm = self.confusion_matrix
        freq = cm.sum(axis=1) / max(cm.sum(), 1)
        iu = self.Intersection_over_Union()
        return float((freq[freq > 0] * iu[freq > 0]).sum())

    def _generate_matrix(self, gt_image: np.ndarray, pre_image: np.ndarray) -> np.ndarray:
        mask = (gt_image >= 0) & (gt_image < self.num_class)
        code = self.num_class * gt_image[mask].astype(np.int64) + pre_image[mask]
        count = np.bincount(code, minlength=self.num_class ** 2)
        return count.reshape(self.num_class, self.num_class)

    def add_batch(self, gt_image: np.ndarray, pre_image: np.ndarray) -> None:
        if gt_image.shape != pre_image.shape:
            raise ValueError(f"ground truth {gt_image.shape} and prediction "
                             f"{pre_image.shape} differ in shape")
        self.confusion_matrix += self._generate_matrix(gt_image, pre_image)

    def reset(self) -> None:
        self.confusion_matrix = np.zeros((self.num_class, self.num_class), dtype=np.int64)


def pred_acc(target_multi_hot, scores) -> float:
    """Take as many top-scoring classes as there are true labels and
    return the share of classes where that prediction agrees."""
    target = np.asarray(target_multi_hot)
    scores = np.asarray(scores).reshape(-1)
    k = int(target.sum())
    pred = np.zeros_like(target)
    if k > 0:
        pred[np.argpartition(scores, -k)[-k:]] = 1
    return float((pred == target).sum() / target.size)
