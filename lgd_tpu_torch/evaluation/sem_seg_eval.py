"""Semantic segmentation evaluation, the mIoU family (port of
lgd_tpu/evaluation/sem_seg_eval.py).

detectron2's ``SemSegEvaluator`` as the reference's ``get_evaluator`` routes
evaluator_type 'sem_seg' to it (reference train.py:89-98): an N x N
confusion matrix of predicted against ground-truth label maps with an
ignore label, reporting mIoU, fwIoU, mACC, pACC and each class's IoU, the
metrics detectron2 prints."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SemSegEvaluator:
    def __init__(self, dataset_name: Optional[str] = None,
                 num_classes: int = 54, ignore_label: int = 255,
                 output_dir: Optional[str] = None):
        self.dataset_name = dataset_name
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.output_dir = output_dir
        self.reset()

    def reset(self):
        n = self.num_classes
        self._conf = np.zeros((n, n), np.int64)

    def process(self, pred: np.ndarray, gt: np.ndarray):
        """pred/gt: (H, W) int label maps in the same frame."""
        pred = np.asarray(pred).reshape(-1)
        gt = np.asarray(gt).reshape(-1)
        keep = gt != self.ignore_label
        pred, gt = pred[keep], gt[keep]
        keep = (gt >= 0) & (gt < self.num_classes)
        pred = np.clip(pred[keep], 0, self.num_classes - 1)
        gt = gt[keep]
        idx = gt * self.num_classes + pred
        self._conf += np.bincount(
            idx, minlength=self.num_classes ** 2
        ).reshape(self.num_classes, self.num_classes)

    def evaluate(self) -> Dict[str, float]:
        conf = self._conf.astype(np.float64)
        gt_total = conf.sum(axis=1)       # per-class GT pixels
        pred_total = conf.sum(axis=0)
        tp = np.diag(conf)
        union = gt_total + pred_total - tp
        present = gt_total > 0
        iou = np.where(union > 0, tp / np.maximum(union, 1), 0.0)
        acc = np.where(gt_total > 0, tp / np.maximum(gt_total, 1), 0.0)
        res = {
            "mIoU": float(100 * iou[present].mean()) if present.any() else 0.0,
            "fwIoU": float(
                100 * (iou * gt_total).sum() / max(gt_total.sum(), 1)),
            "mACC": float(100 * acc[present].mean()) if present.any() else 0.0,
            "pACC": float(100 * tp.sum() / max(conf.sum(), 1)),
        }
        for c in np.nonzero(present)[0]:
            res[f"IoU-{c}"] = float(100 * iou[c])
        return {"sem_seg": res}
