"""Pascal VOC detection evaluation, the devkit's protocol (port of
lgd_tpu/evaluation/voc_eval.py).

detectron2's ``PascalVOCDetectionEvaluator`` as the reference's
``get_evaluator`` routes evaluator_type 'pascal_voc' to it (reference
train.py:116-117). The devkit's ``voc_eval``: per class, detections ranked
by score are matched at IoU > t against the ground truth, 'difficult' boxes
ignored; AP by 11-point interpolation (the VOC2007 metric) or as the area
under the every-point precision envelope (VOC2012); reported as AP (mean
over t = 0.50:0.05:0.95), AP50 and AP75, as detectron2 does."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool) -> float:
    """Official devkit AP computation."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = prec[rec >= t].max() if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    i = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


class PascalVOCDetectionEvaluator:
    """GT from dataset dicts (XYXY 'bbox' + 'difficult' flag honored);
    detections via process(image_id, boxes_xyxy, scores, classes)."""

    def __init__(self, dataset_name: Optional[str] = None,
                 gt_dataset: Optional[List[dict]] = None,
                 num_classes: int = 20, use_07_metric: bool = True):
        self.num_classes = num_classes
        self.use_07_metric = use_07_metric
        self._gt = defaultdict(lambda: defaultdict(list))
        if gt_dataset is None and dataset_name is not None:
            from ..data.catalog import DatasetCatalog

            gt_dataset = DatasetCatalog.get(dataset_name)
        for d in gt_dataset or []:
            for a in d.get("annotations", []):
                box = np.asarray(a["bbox"], np.float64)
                if a.get("bbox_mode", "XYXY_ABS") == "XYWH_ABS":
                    box = np.concatenate([box[:2], box[:2] + box[2:]])
                self._gt[d["image_id"]][a["category_id"]].append(
                    (box, bool(a.get("difficult", False))))
        self.reset()

    def reset(self):
        self._dets = defaultdict(list)  # cat -> [(img, score, box)]

    def process(self, image_id, boxes_xyxy, scores, classes):
        for box, s, c in zip(boxes_xyxy, scores, classes):
            self._dets[int(c)].append(
                (image_id, float(s), np.asarray(box, np.float64)))

    def _eval_class(self, cat: int, iou_thr: float) -> float:
        gts = {}
        npos = 0
        for img, cats in self._gt.items():
            entries = cats.get(cat, [])
            boxes = np.asarray([e[0] for e in entries]).reshape(-1, 4)
            difficult = np.asarray([e[1] for e in entries], bool)
            gts[img] = {"boxes": boxes, "difficult": difficult,
                        "used": np.zeros(len(entries), bool)}
            npos += int((~difficult).sum())
        dets = sorted(self._dets.get(cat, []), key=lambda d: -d[1])
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for i, (img, _, box) in enumerate(dets):
            g = gts.get(img)
            best, best_j = -np.inf, -1
            if g is not None and len(g["boxes"]):
                gb = g["boxes"]
                ix1 = np.maximum(gb[:, 0], box[0])
                iy1 = np.maximum(gb[:, 1], box[1])
                ix2 = np.minimum(gb[:, 2], box[2])
                iy2 = np.minimum(gb[:, 3], box[3])
                # devkit uses inclusive pixel coordinates (+1)
                iw = np.maximum(ix2 - ix1 + 1.0, 0.0)
                ih = np.maximum(iy2 - iy1 + 1.0, 0.0)
                inter = iw * ih
                uni = ((box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
                       + (gb[:, 2] - gb[:, 0] + 1.0)
                       * (gb[:, 3] - gb[:, 1] + 1.0) - inter)
                overlaps = inter / np.maximum(uni, 1e-10)
                best_j = int(np.argmax(overlaps))
                best = float(overlaps[best_j])
            if best > iou_thr:
                if g["difficult"][best_j]:
                    continue  # neither TP nor FP
                if not g["used"][best_j]:
                    g["used"][best_j] = True
                    tp[i] = 1.0
                else:
                    fp[i] = 1.0
            else:
                fp[i] = 1.0
        if npos == 0:
            return float("nan")
        tp_c = np.cumsum(tp)
        fp_c = np.cumsum(fp)
        rec = tp_c / npos
        prec = tp_c / np.maximum(tp_c + fp_c, np.finfo(np.float64).eps)
        return voc_ap(rec, prec, self.use_07_metric) * 100

    def evaluate(self, *_args, **_kw) -> Dict[str, Dict[str, float]]:
        # detectron2 runs thresholds 50..95 and reports AP (mean), AP50, AP75
        aps = {t: [] for t in range(50, 100, 5)}
        for cat in range(self.num_classes):
            for t in aps:
                aps[t].append(self._eval_class(cat, t / 100.0))
        mean = lambda xs: float(np.nanmean(xs)) if len(xs) else 0.0
        return {"bbox": {
            "AP": mean([mean(aps[t]) for t in aps]),
            "AP50": mean(aps[50]),
            "AP75": mean(aps[75]),
        }}
