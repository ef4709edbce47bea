"""LVIS detection evaluation (port of lgd_tpu/evaluation/lvis_eval.py).

detectron2's ``LVISEvaluator`` as the reference's ``get_evaluator`` routes
evaluator_type 'lvis' to it (reference train.py:119-120), on the COCO
evaluator's matching and accumulation (coco_eval.py), with LVIS's
differences from COCO:

- at most 300 detections per image and category (no AR@1/10 rows);
- *federated* evaluation: a category is scored on an image only where the
  dataset marks it positively (it has ground truth there) or negatively
  (the image's ``neg_category_ids``); elsewhere its detections are
  dropped, neither TP nor FP;
- APr/APc/APf over the categories' 'frequency' field where the metadata
  has it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .coco_eval import COCOEvaluator


class LVISEvaluator(COCOEvaluator):
    def __init__(self, dataset_name: Optional[str] = None,
                 gt_dataset: Optional[List[dict]] = None,
                 num_classes: int = 1203):
        self._pos = {}
        self._neg = {}
        self._freq = None  # contiguous id -> 'r' | 'c' | 'f'
        if dataset_name is not None:
            from ..data.catalog import MetadataCatalog

            self._freq = MetadataCatalog.get(dataset_name).get(
                "class_frequencies")
        super().__init__(dataset_name, gt_dataset, num_classes,
                         max_dets=300, ar_dets=())

    def add_gt_dataset(self, dataset_dicts):
        super().add_gt_dataset(dataset_dicts)
        for d in dataset_dicts:
            img = d["image_id"]
            self._pos[img] = {a["category_id"]
                              for a in d.get("annotations", [])}
            self._neg[img] = set(d.get("neg_category_ids", []))

    def _img_eligible(self, img_id, cat) -> bool:
        if not self._pos and not self._neg:
            return True  # no federation info -> plain COCO-style scoring
        return (cat in self._pos.get(img_id, ())
                or cat in self._neg.get(img_id, ()))

    def _evaluate_type(self, iou_type: str) -> Dict[str, float]:
        results = super()._evaluate_type(iou_type)
        if self._freq:
            per_cat = {c: results.get(f"AP-{(self._class_names[c] if self._class_names else str(c))}")
                       for c in range(self.num_classes)}
            for bucket, name in (("r", "APr"), ("c", "APc"), ("f", "APf")):
                vals = [v for c, v in per_cat.items()
                        if v is not None and self._freq.get(c) == bucket]
                results[name] = float(np.mean(vals)) if vals else float("nan")
        return results
