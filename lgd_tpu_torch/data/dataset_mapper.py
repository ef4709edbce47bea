"""Per-sample mapper: dataset dict -> numpy sample ready to pack (port of
lgd_tpu/data/dataset_mapper.py:127-213): read, augment, transform the
boxes (and, for masks, the polygons), drop degenerate boxes and, in
training, images left without GT. With LOAD_LABELMAP each instance also
gets its 7x7 in-box mask descriptor; with MASK_ON, in training, its exact
polygon raster in its box's frame at TPU.MASK_CROP_SIZE. Box maps, box
masks and strong augmentation are not ported and raise.

Output sample dict (numpy):
    image: (h', w', 3) float32 BGR, resized, not yet padded
    height/width: original size (for rescaling detections)
    image_id, boxes (N, 4) x1y1x2y2 float32, classes (N,) int64
    masks49 (N, 49) float32 and polygons (list) [LOAD_LABELMAP]
    mask_crops (N, G, G) uint8 [MASK_ON, training]
"""

from __future__ import annotations

from typing import Dict, List, Optional

import cv2
import numpy as np

from .transforms import (
    apply_augmentations,
    build_augmentation,
    transform_boxes,
    transform_polygons,
)


def read_image_bgr(file_name: str) -> np.ndarray:
    img = cv2.imread(file_name, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(file_name)
    return img


def rasterize_polygons(polygons: List[np.ndarray], h: int,
                       w: int) -> np.ndarray:
    """Polygons (flattened xy) -> (h, w) uint8 bitmask: vertices rounded to
    the pixel grid and filled by cv2.fillPoly; a polygon of fewer than
    three points is skipped (lgd_tpu/data/dataset_mapper.py:44-56)."""
    mask = np.zeros((h, w), np.uint8)
    pts = [np.round(np.asarray(p, np.float64).reshape(-1, 2)).astype(np.int32)
           for p in polygons if len(p) >= 6]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask


def crop_and_resize_mask(polygons, box, size: int = 7,
                         flatten: bool = True) -> np.ndarray:
    """The polygons moved into ``box``'s frame, scaled to size x size and
    rasterized (detectron2 PolygonMasks.crop_and_resize): the 49-wide
    descriptor tail at 7, the mask head's target source at
    TPU.MASK_CROP_SIZE (lgd_tpu/data/dataset_mapper.py:59-77)."""
    x1, y1, x2, y2 = box
    w = max(x2 - x1, 1e-2)
    h = max(y2 - y1, 1e-2)
    scaled = []
    for p in polygons:
        q = np.asarray(p, np.float64).reshape(-1, 2).copy()
        q[:, 0] = (q[:, 0] - x1) * (size / w)
        q[:, 1] = (q[:, 1] - y1) * (size / h)
        scaled.append(q.reshape(-1))
    m = rasterize_polygons(scaled, size, size).astype(np.float32)
    return m.reshape(-1) if flatten else m


class DatasetMapper:
    def __init__(self, cfg, is_train: bool = True):
        extras = {"MODEL.STRONGER_AUGS": cfg.MODEL.STRONGER_AUGS,
                  "MODEL.LOAD_BOXMAP": cfg.MODEL.LOAD_BOXMAP,
                  "MODEL.LOAD_BOX_MASK": cfg.MODEL.LOAD_BOX_MASK}
        asked = [k for k, v in extras.items() if v]
        if asked:
            raise NotImplementedError(
                f"not ported to the data path: {asked} (ROADMAP.md, port "
                "queue item 15)")
        self.is_train = is_train
        self.filter_empty = cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS
        self.augmentations = build_augmentation(cfg, is_train)
        self.use_instance_mask = cfg.MODEL.MASK_ON
        self.load_labelmap = cfg.MODEL.DISTILLATOR.LABEL_ENCODER.LOAD_LABELMAP
        self.mask_crop_size = cfg.TPU.MASK_CROP_SIZE

    def __call__(self, dataset_dict: Dict,
                 rng: np.random.RandomState) -> Optional[Dict]:
        """The sample, or None for a training image left without GT."""
        d = dataset_dict
        image = read_image_bgr(d["file_name"]) if "file_name" in d else d["image"]
        image, tfms = apply_augmentations(self.augmentations, image, rng)
        h, w = image.shape[:2]

        annos = [a for a in d.get("annotations", [])
                 if a.get("iscrowd", 0) == 0]
        boxes = np.zeros((0, 4), np.float32)
        classes = np.zeros((0,), np.int64)
        polygons: List[List[np.ndarray]] = []
        if annos:
            raw = np.asarray([a["bbox"] for a in annos], np.float32)
            boxes = np.concatenate([raw[:, :2], raw[:, :2] + raw[:, 2:]],
                                   axis=1)  # XYWH -> XYXY
            boxes = transform_boxes(tfms, boxes)
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
            classes = np.asarray([a["category_id"] for a in annos], np.int64)
            if self.load_labelmap or self.use_instance_mask:
                polygons = [transform_polygons(tfms, a.get("segmentation", []))
                            for a in annos]
            # filter degenerate boxes (detectron2 filter_empty_instances)
            keep = ((boxes[:, 2] > boxes[:, 0] + 1e-3)
                    & (boxes[:, 3] > boxes[:, 1] + 1e-3))
            boxes, classes = boxes[keep], classes[keep]
            polygons = [p for p, k in zip(polygons, keep) if k]

        if self.is_train and self.filter_empty and len(boxes) == 0:
            return None  # the loader draws the next image

        sample = {
            "image": image.astype(np.float32),
            "height": d.get("height", h),
            "width": d.get("width", w),
            "image_id": d.get("image_id", -1),
            "boxes": boxes,
            "classes": classes,
        }
        if self.load_labelmap:
            sample["masks49"] = (
                np.stack([crop_and_resize_mask(p, b)
                          for p, b in zip(polygons, boxes)])
                if len(boxes) else np.zeros((0, 49), np.float32))
            sample["polygons"] = polygons
        if self.use_instance_mask and self.is_train:
            G = self.mask_crop_size
            sample["mask_crops"] = (
                np.stack([crop_and_resize_mask(p, b, size=G, flatten=False)
                          for p, b in zip(polygons, boxes)]).astype(np.uint8)
                if len(boxes) else np.zeros((0, G, G), np.uint8))
        return sample
