"""LVIS v1 dataset loading, JSON to dataset dicts with no lvis-api (port of
lgd_tpu/data/lvis.py).

detectron2's ``load_lvis_json``, which the reference's evaluator routing
for evaluator_type 'lvis' needs (reference train.py:119-120). It keeps the
federated evaluation's fields (``neg_category_ids``,
``not_exhaustive_category_ids``) and records each category's frequency
bucket ('r', 'c' or 'f') in the metadata for APr/APc/APf."""

from __future__ import annotations

import json
import os
from typing import List, Optional


def load_lvis_json(json_file: str, image_root: str,
                   dataset_name: Optional[str] = None) -> List[dict]:
    with open(json_file) as f:
        data = json.load(f)
    cats = sorted(data["categories"], key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    if dataset_name is not None:
        from .catalog import MetadataCatalog

        MetadataCatalog.get(dataset_name).update(
            thing_classes=[c["name"] for c in cats],
            thing_dataset_id_to_contiguous_id=id_map,
            class_frequencies={
                id_map[c["id"]]: c.get("frequency", "f") for c in cats},
        )
    anns_per_img = {}
    for a in data["annotations"]:
        anns_per_img.setdefault(a["image_id"], []).append(a)
    dicts = []
    for img in data["images"]:
        # LVIS v1 stores the split-prefixed path in coco_url
        url = img.get("coco_url", "")
        file_name = "/".join(url.split("/")[-2:]) if url else img.get(
            "file_name", "")
        record = {
            "file_name": os.path.join(image_root, file_name),
            "image_id": img["id"],
            "height": img["height"],
            "width": img["width"],
            "neg_category_ids": [id_map[c]
                                 for c in img.get("neg_category_ids", [])],
            "not_exhaustive_category_ids": [
                id_map[c]
                for c in img.get("not_exhaustive_category_ids", [])],
        }
        annos = []
        for a in anns_per_img.get(img["id"], []):
            annos.append({
                "bbox": a["bbox"],
                "bbox_mode": "XYWH_ABS",
                "category_id": id_map[a["category_id"]],
                "segmentation": a.get("segmentation", []),
                "iscrowd": 0,  # LVIS has no crowd annotations
            })
        record["annotations"] = annos
        dicts.append(record)
    return dicts


def register_lvis(root: str):
    from .catalog import DatasetCatalog, MetadataCatalog

    splits = {
        "lvis_v1_train": ("coco/", "lvis/lvis_v1_train.json"),
        "lvis_v1_val": ("coco/", "lvis/lvis_v1_val.json"),
    }
    for name, (image_root, json_file) in splits.items():
        jf = os.path.join(root, json_file)
        ir = os.path.join(root, image_root)
        DatasetCatalog.register(
            name, (lambda jf=jf, ir=ir, n=name: load_lvis_json(jf, ir, n)))
        MetadataCatalog.get(name).update(
            evaluator_type="lvis", json_file=jf, image_root=ir)
