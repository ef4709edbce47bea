"""Synthetic mini-COCO split (BASELINE.json config #1): deterministic random
images with painted rectangles and matching GT. A copy of
lgd_tpu/data/synthetic.py:17-69 that draws the same RNG sequence, so both
packages see identical images and annotations for the same seed."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_synthetic_dataset_dicts(num_images: int = 16, seed: int = 0,
                                 num_classes: int = 80,
                                 max_hw: Tuple[int, int] = (480, 640)):
    """In-memory dataset dicts (the load_coco_json schema)."""
    rng = np.random.RandomState(seed)
    dicts = []
    for i in range(num_images):
        h = int(rng.randint(max_hw[0] // 2, max_hw[0] + 1))
        w = int(rng.randint(max_hw[1] // 2, max_hw[1] + 1))
        img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        n = int(rng.randint(1, 7))
        annos = []
        for _ in range(n):
            bw = rng.uniform(0.1, 0.5) * w
            bh = rng.uniform(0.1, 0.5) * h
            x1 = rng.uniform(0, w - bw)
            y1 = rng.uniform(0, h - bh)
            c = int(rng.randint(0, num_classes))
            img[int(y1): int(y1 + bh), int(x1): int(x1 + bw)] = (
                (c * 37) % 255, (c * 91) % 255, (c * 13) % 255)
            annos.append({
                "bbox": [float(x1), float(y1), float(bw), float(bh)],
                "bbox_mode": "XYWH_ABS",
                "category_id": c,
                "iscrowd": 0,
                "segmentation": [[x1, y1, x1 + bw, y1, x1 + bw, y1 + bh,
                                  x1, y1 + bh]],
            })
        dicts.append({
            "image": img,
            "height": h,
            "width": w,
            "image_id": i + 1,
            "annotations": annos,
        })
    return dicts


def register_synthetic(name: str = "synthetic_mini", num_images: int = 16,
                       seed: int = 0, num_classes: int = 80):
    """Register the split in the DatasetCatalog, with COCO evaluation
    (lgd_tpu/data/synthetic.py:56-69); a name already registered is left
    as it is."""
    from .catalog import DatasetCatalog, MetadataCatalog

    try:
        DatasetCatalog.register(
            name, lambda: make_synthetic_dataset_dicts(
                num_images, seed, num_classes=num_classes))
    except KeyError:
        return name
    MetadataCatalog.get(name).update(evaluator_type="coco")
    return name
