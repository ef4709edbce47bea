"""COCO instances JSON loading, plain JSON with no pycocotools (port of
lgd_tpu/data/coco.py).

detectron2's ``load_coco_json`` as the reference's
``get_detection_dataset_dicts`` uses it (utils/build.py:212-259): one dict
per image (file_name, height, width, image_id, annotations with the XYWH
bbox, the contiguous category_id, iscrowd and the segmentation polygons),
and the id -> contiguous mapping recorded in the metadata catalog.
"""

from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from typing import List

logger = logging.getLogger(__name__)


def load_coco_json(json_file: str, image_root: str, dataset_name: str = None
                   ) -> List[dict]:
    with open(json_file, "r") as f:
        coco = json.load(f)

    cats = sorted(coco["categories"], key=lambda c: c["id"])
    cat_ids = [c["id"] for c in cats]
    id_map = {cid: i for i, cid in enumerate(cat_ids)}
    thing_classes = [c["name"] for c in cats]

    if dataset_name is not None:
        from .catalog import MetadataCatalog

        meta = MetadataCatalog.get(dataset_name)
        meta.update(
            thing_classes=thing_classes,
            thing_dataset_id_to_contiguous_id=id_map,
        )

    anns_by_image = defaultdict(list)
    for ann in coco.get("annotations", []):
        anns_by_image[ann["image_id"]].append(ann)

    dataset_dicts = []
    for img in coco["images"]:
        record = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "height": img["height"],
            "width": img["width"],
            "image_id": img["id"],
        }
        objs = []
        for ann in anns_by_image.get(img["id"], []):
            if ann.get("ignore", 0):
                continue
            obj = {
                "bbox": ann["bbox"],  # XYWH
                "bbox_mode": "XYWH_ABS",
                "category_id": id_map[ann["category_id"]],
                "iscrowd": ann.get("iscrowd", 0),
            }
            seg = ann.get("segmentation")
            if seg and isinstance(seg, list):
                # polygons; RLE crowd regions are dropped like detectron2
                obj["segmentation"] = [
                    p for p in seg if len(p) % 2 == 0 and len(p) >= 6
                ]
            objs.append(obj)
        record["annotations"] = objs
        dataset_dicts.append(record)

    logger.info("Loaded %d images from %s", len(dataset_dicts), json_file)
    return dataset_dicts


def filter_images_with_only_crowd_annotations(dataset_dicts):
    """Keep images with >=1 non-crowd annotation (utils/build.py:48-76)."""
    before = len(dataset_dicts)
    out = [
        d for d in dataset_dicts
        if any(a.get("iscrowd", 0) == 0 for a in d.get("annotations", []))
    ]
    logger.info("Filtered crowd-only images: %d -> %d", before, len(out))
    return out


def get_detection_dataset_dicts(names, filter_empty: bool = True):
    """Concat + filter, mirroring the reference's loader entry
    (utils/build.py:212-259; class histogram logging omitted)."""
    from .catalog import DatasetCatalog

    if isinstance(names, str):
        names = [names]
    dicts = []
    for name in names:
        dicts.extend(DatasetCatalog.get(name))
    if filter_empty:
        dicts = filter_images_with_only_crowd_annotations(dicts)
    return dicts
