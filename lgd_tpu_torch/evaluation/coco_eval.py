"""COCO-protocol detection evaluation — self-contained numpy implementation.

Replaces pycocotools' COCOeval C core (absent from this image) for the
bbox task the reference evaluates with ``COCOEvaluator`` (train.py:101,
utils/build.py:426-487). Implements the official protocol: greedy per-image
per-category matching at IoU 0.50:0.05:0.95 with crowd-ignore semantics,
area-range filtering, maxDets truncation, and 101-point interpolated AP.

Host-side and offline by design (the reference's evaluation is too); the
hot path stays on device.

The port's copy of lgd_tpu/evaluation/coco_eval.py, for the bbox and segm
tasks: the greedy matching is the numpy loop (the JAX package's optional
g++ core is not carried over). The ground truth comes from the catalog by
``dataset_name``, or as dataset dicts (``gt_dataset``). For segm a
detection carries its box's mask probability grid, and its IoU against
each polygon GT is the exact one of ``mask_utils.mask_iou_det_gt``; a GT's
area is its polygons', or its box's where it has none.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from .mask_utils import mask_iou_det_gt, polygon_area

logger = logging.getLogger(__name__)

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 100


def box_iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray
                 ) -> np.ndarray:
    """(D, 4) x (G, 4) XYWH -> (D, G) IoU; crowd GT uses IoA (pycocotools
    semantics: union = det area for crowd)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.clip(
        np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]),
        0, None,
    )
    ih = np.clip(
        np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]),
        0, None,
    )
    inter = iw * ih
    da = (dets[:, 2] * dets[:, 3])[:, None]
    ga = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), da, da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


class COCOEvaluator:
    """Accumulates (image_id, category, bbox XYWH, score) detections and GT,
    then computes AP/AR. API mirrors the reference evaluator's
    reset/process/evaluate flow (utils/build.py:435-482)."""

    def __init__(self, dataset_name: Optional[str] = None,
                 gt_dataset: Optional[List[dict]] = None,
                 num_classes: int = 80, max_dets: int = MAX_DETS,
                 ar_dets=(1, 10)):
        self.num_classes = num_classes
        self.max_dets = max_dets      # per image-category cap (COCO: 100)
        self.ar_dets = tuple(ar_dets)  # extra AR@k rows (besides max_dets)
        self._gt = defaultdict(lambda: defaultdict(list))  # img -> cat -> list
        self._img_ids = set()
        self._class_names = None
        self._contig_to_cat_id = None  # contiguous idx -> COCO category_id
        if dataset_name is not None:
            from ..data.catalog import MetadataCatalog

            meta = MetadataCatalog.get(dataset_name)
            self._class_names = meta.get("thing_classes")
            id_map = meta.get("thing_dataset_id_to_contiguous_id")
            if id_map:
                self._contig_to_cat_id = {v: k for k, v in id_map.items()}
        if gt_dataset is None and dataset_name is not None:
            from ..data.catalog import DatasetCatalog

            gt_dataset = DatasetCatalog.get(dataset_name)
        if gt_dataset is not None:
            self.add_gt_dataset(gt_dataset)
        self.reset()

    def add_gt_dataset(self, dataset_dicts: List[dict]):
        for d in dataset_dicts:
            img_id = d["image_id"]
            self._img_ids.add(img_id)
            for a in d.get("annotations", []):
                x1, y1, w, h = a["bbox"]
                self._gt[img_id][a["category_id"]].append(
                    (np.asarray([x1, y1, w, h], np.float64),
                     a.get("iscrowd", 0), a.get("segmentation")))

    def reset(self):
        self._dets = defaultdict(lambda: defaultdict(list))
        self._match_cache = {}

    def process(self, image_id, boxes_xyxy, scores, classes, masks=None):
        """Add one image's detections (in original-image coordinates);
        masks: optional (D, m, m) probability grids over the boxes, for
        segm."""
        for i, (box, score, cls) in enumerate(zip(boxes_xyxy, scores,
                                                  classes)):
            x1, y1, x2, y2 = [float(v) for v in box]
            self._dets[image_id][int(cls)].append(
                (np.asarray([x1, y1, x2 - x1, y2 - y1], np.float64),
                 float(score), None if masks is None else np.asarray(masks[i])))

    # -- core protocol ------------------------------------------------------

    def _evaluate_img_cat(self, img_id, cat, area_rng, iou_type="bbox"):
        """Returns (det_scores, det_matched, det_ignored, num_valid_gt) with
        det_* of shape (T, D) for the 10 IoU thresholds."""
        gts = self._gt[img_id].get(cat, [])
        dets = self._dets[img_id].get(cat, [])
        dets = sorted(dets, key=lambda d: -d[1])[: self.max_dets]
        D, G = len(dets), len(gts)
        T = len(IOU_THRS)
        scores = np.asarray([d[1] for d in dets])
        if D == 0:
            n_valid = sum(
                1 for b, c, _ in gts
                if not c and area_rng[0] <= b[2] * b[3] < area_rng[1]
            )
            return scores, np.zeros((T, 0)), np.zeros((T, 0), bool), n_valid

        gt_boxes = np.stack([g[0] for g in gts]) if G else np.zeros((0, 4))
        gt_crowd = (np.asarray([g[1] for g in gts], np.int64)
                    if G else np.zeros(0, np.int64))
        gt_polys = [g[2] for g in gts]
        if iou_type == "segm":
            gt_area = np.asarray([polygon_area(p) if p else b[2] * b[3]
                                  for (b, _, p) in gts]) if G else np.zeros(0)
        else:
            gt_area = gt_boxes[:, 2] * gt_boxes[:, 3] if G else np.zeros(0)
        gt_ignore = gt_crowd.astype(bool) | (gt_area < area_rng[0]) | (
            gt_area >= area_rng[1]
        )
        # sort GT: valid first (pycocotools evaluates in ignore order)
        order = np.argsort(gt_ignore, kind="stable")
        gt_boxes, gt_crowd, gt_ignore = (
            gt_boxes[order], gt_crowd[order], gt_ignore[order]
        )
        gt_polys = [gt_polys[i] for i in order]

        det_boxes = np.stack([d[0] for d in dets])
        if iou_type == "segm":
            iou = np.zeros((D, G))
            for di, (bx, _, mk) in enumerate(dets):
                dbox = [bx[0], bx[1], bx[0] + bx[2], bx[1] + bx[3]]
                for gi in range(G):
                    if gt_polys[gi] and mk is not None:
                        iou[di, gi] = mask_iou_det_gt(
                            dbox, mk, gt_polys[gi], bool(gt_crowd[gi]))
        else:
            iou = box_iou_xywh(det_boxes, gt_boxes, gt_crowd)

        # greedy matching
        det_matched = np.zeros((T, D), np.int64)
        det_ignored = np.zeros((T, D), bool)
        for ti, t in enumerate(IOU_THRS):
            gt_used = np.zeros(G, bool)
            for di in range(D):
                best, best_g = min(t, 1 - 1e-10), -1
                for gi in range(G):
                    if gt_used[gi] and not gt_crowd[gi]:
                        continue
                    if (best_g > -1 and not gt_ignore[best_g]
                            and gt_ignore[gi]):
                        break
                    if iou[di, gi] < best:
                        continue
                    best = iou[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                gt_used[best_g] = True
                det_ignored[ti, di] = gt_ignore[best_g]
                det_matched[ti, di] = 0 if gt_ignore[best_g] else 1
        # unmatched dets outside the area range are ignored
        d_area = det_boxes[:, 2] * det_boxes[:, 3]
        out_of_rng = (d_area < area_rng[0]) | (d_area >= area_rng[1])
        for ti in range(T):
            unmatched = det_matched[ti] == 0
            det_ignored[ti] |= unmatched & ~det_ignored[ti] & out_of_rng

        n_valid = int((~gt_ignore).sum())
        return scores, det_matched, det_ignored, n_valid

    def _img_eligible(self, img_id, cat) -> bool:
        """Hook: LVIS federated evaluation skips (image, category) pairs the
        dataset neither positively nor negatively annotates."""
        return True

    def _accumulate(self, area_rng_name="all", iou_type="bbox",
                    max_dets: Optional[int] = None):
        """AP/AR per (IoU thr, category). ``max_dets`` truncates each
        image-category's score-sorted detections post-matching — identical
        to matching only the top-k (greedy matching of det i never depends
        on det j>i), exactly pycocotools' accumulate() maxDets handling."""
        if max_dets is None:
            max_dets = self.max_dets
        area_rng = AREA_RANGES[area_rng_name]
        T = len(IOU_THRS)
        ap_per_cat = np.full((T, self.num_classes), np.nan)
        ar_per_cat = np.full((T, self.num_classes), np.nan)
        img_ids = self._img_ids or set(self._dets.keys())
        for cat in range(self.num_classes):
            all_scores, all_matched, all_ignored = [], [], []
            n_gt = 0
            for img_id in img_ids:
                if cat not in self._gt[img_id] and cat not in self._dets[img_id]:
                    continue
                if not self._img_eligible(img_id, cat):
                    continue
                key = (img_id, cat, area_rng_name, iou_type)
                if key in self._match_cache:
                    s, m, ig, nv = self._match_cache[key]
                else:
                    s, m, ig, nv = self._evaluate_img_cat(
                        img_id, cat, area_rng, iou_type)
                    self._match_cache[key] = (s, m, ig, nv)
                if max_dets < len(s):
                    s, m, ig = s[:max_dets], m[:, :max_dets], ig[:, :max_dets]
                all_scores.append(s)
                all_matched.append(m)
                all_ignored.append(ig)
                n_gt += nv
            if n_gt == 0:
                continue
            scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
            matched = (np.concatenate(all_matched, axis=1)
                       if all_matched else np.zeros((T, 0)))
            ignored = (np.concatenate(all_ignored, axis=1)
                       if all_ignored else np.zeros((T, 0), bool))
            order = np.argsort(-scores, kind="mergesort")
            matched, ignored = matched[:, order], ignored[:, order]
            for ti in range(T):
                keep = ~ignored[ti]
                tp = np.cumsum(matched[ti][keep])
                fp = np.cumsum((matched[ti][keep] == 0))
                rec = tp / n_gt
                prec = tp / np.maximum(tp + fp, 1e-10)
                # monotone precision envelope
                for i in range(len(prec) - 1, 0, -1):
                    prec[i - 1] = max(prec[i - 1], prec[i])
                inds = np.searchsorted(rec, REC_THRS, side="left")
                q = np.zeros(len(REC_THRS))
                valid = inds < len(prec)
                q[valid] = prec[inds[valid]]
                ap_per_cat[ti, cat] = q.mean()
                ar_per_cat[ti, cat] = rec[-1] if len(rec) else 0.0
        return ap_per_cat, ar_per_cat

    def _evaluate_type(self, iou_type: str) -> Dict[str, float]:
        """Full COCO summarize() metric family: AP/AP50/AP75/APs/m/l,
        AR@{1,10,100} and ARs/m/l (at maxDets=100), plus per-category AP
        ('AP-<class>' keys, detectron2 COCOEvaluator behavior)."""
        ap_all, ar_all = self._accumulate("all", iou_type)
        nan = lambda a: np.all(np.isnan(a))
        mean = lambda a: float(np.nanmean(a) * 100) if not nan(a) else 0.0
        results = {
            "AP": mean(ap_all),
            "AP50": mean(ap_all[0]),
            "AP75": mean(ap_all[5]),
            f"AR@{self.max_dets}": mean(ar_all),
            "AR": mean(ar_all),  # back-compat alias of AR@max_dets
        }
        for k in self.ar_dets:
            _, ar_k = self._accumulate("all", iou_type, max_dets=k)
            results[f"AR@{k}"] = mean(ar_k)
        for name in ("small", "medium", "large"):
            ap, ar = self._accumulate(name, iou_type)
            results["AP" + name[0]] = (
                float(np.nanmean(ap) * 100) if not nan(ap) else float("nan")
            )
            results["AR" + name[0]] = (
                float(np.nanmean(ar) * 100) if not nan(ar) else float("nan")
            )
        import warnings

        with warnings.catch_warnings():
            # all-NaN columns (categories absent from GT and dets) are
            # expected and skipped below
            warnings.simplefilter("ignore", RuntimeWarning)
            per_cat = np.nanmean(ap_all, axis=0)  # (num_classes,)
        for c in range(self.num_classes):
            if np.isnan(per_cat[c]):
                continue
            cname = (self._class_names[c]
                     if self._class_names and c < len(self._class_names)
                     else str(c))
            results[f"AP-{cname}"] = float(per_cat[c] * 100)
        return results

    def coco_results_list(self) -> List[dict]:
        """Detections in official COCO results-json schema (XYWH boxes,
        dataset category ids) — the reference COCOEvaluator's
        coco_instances_results.json payload, re-scorable by pycocotools."""
        out = []
        for img_id, cats in self._dets.items():
            for cat, dets in cats.items():
                cat_id = (self._contig_to_cat_id.get(cat, cat)
                          if self._contig_to_cat_id else cat)
                for box, score, _ in dets:
                    rec = {
                        "image_id": img_id,
                        "category_id": int(cat_id),
                        "bbox": [round(float(v), 3) for v in box],
                        "score": round(float(score), 5),
                    }
                    out.append(rec)
        out.sort(key=lambda r: (str(r["image_id"]), -r["score"]))
        return out

    def evaluate(self, iou_types=("bbox",),
                 output_dir: Optional[str] = None
                 ) -> Dict[str, Dict[str, float]]:
        self._match_cache = {}
        out = {}
        for t in iou_types:
            if t not in ("bbox", "segm"):
                raise NotImplementedError(f"no COCO {t!r} scoring")
            out[t] = self._evaluate_type(t)
            logger.info("COCO %s results: %s", t,
                        {k: round(v, 3) for k, v in out[t].items()
                         if not k.startswith("AP-")})
        if output_dir:
            import json
            import os

            os.makedirs(output_dir, exist_ok=True)
            with open(os.path.join(output_dir,
                                   "coco_instances_results.json"), "w") as f:
                json.dump(self.coco_results_list(), f)
            with open(os.path.join(output_dir, "metrics.json"), "w") as f:
                json.dump(out, f, indent=2)
        return out
