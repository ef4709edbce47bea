"""Per-sample eval mapper: dataset dict -> numpy sample ready to pack.
The eval branch of lgd_tpu/data/dataset_mapper.py:127-213 (no crop, flip,
label maps or mask crops: those serve training and the teacher).

Output sample dict (numpy):
    image: (h', w', 3) float32 BGR, resized, not yet padded
    height/width: original size (for rescaling detections)
    image_id, boxes (N, 4) x1y1x2y2 float32, classes (N,) int64
"""

from __future__ import annotations

from typing import Dict, Optional

import cv2
import numpy as np

from .transforms import (
    apply_augmentations,
    build_test_augmentation,
    transform_boxes,
)


def read_image_bgr(file_name: str) -> np.ndarray:
    img = cv2.imread(file_name, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(file_name)
    return img


class DatasetMapper:
    def __init__(self, cfg):
        self.augmentations = build_test_augmentation(cfg)

    def __call__(self, dataset_dict: Dict,
                 rng: np.random.RandomState) -> Optional[Dict]:
        d = dataset_dict
        image = read_image_bgr(d["file_name"]) if "file_name" in d else d["image"]
        image, tfms = apply_augmentations(self.augmentations, image, rng)
        h, w = image.shape[:2]

        annos = [a for a in d.get("annotations", [])
                 if a.get("iscrowd", 0) == 0]
        boxes = np.zeros((0, 4), np.float32)
        classes = np.zeros((0,), np.int64)
        if annos:
            raw = np.asarray([a["bbox"] for a in annos], np.float32)
            boxes = np.concatenate([raw[:, :2], raw[:, :2] + raw[:, 2:]],
                                   axis=1)  # XYWH -> XYXY
            boxes = transform_boxes(tfms, boxes)
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
            classes = np.asarray([a["category_id"] for a in annos], np.int64)
            # filter degenerate boxes (detectron2 filter_empty_instances)
            keep = ((boxes[:, 2] > boxes[:, 0] + 1e-3)
                    & (boxes[:, 3] > boxes[:, 1] + 1e-3))
            boxes, classes = boxes[keep], classes[keep]

        return {
            "image": image.astype(np.float32),
            "height": d.get("height", h),
            "width": d.get("width", w),
            "image_id": d.get("image_id", -1),
            "boxes": boxes,
            "classes": classes,
        }
