"""Pascal VOC dataset loading, XML annotations to dataset dicts (port of
lgd_tpu/data/voc.py).

detectron2's built-in ``register_pascal_voc``/``load_voc_instances``, which
the reference's evaluator routing for evaluator_type 'pascal_voc' needs
(reference train.py:116-117). Layout:
$DETECTRON2_DATASETS/VOC20{07,12}/{Annotations,ImageSets,JPEGImages}.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def load_voc_instances(dirname: str, split: str) -> List[dict]:
    """dirname: e.g. datasets/VOC2007. Returns detectron2-schema dicts with
    XYXY boxes (devkit 1-based, converted to 0-based like detectron2) and
    the 'difficult' flag preserved for the VOC AP protocol."""
    with open(os.path.join(dirname, "ImageSets", "Main",
                           split + ".txt")) as f:
        fileids = [line.strip() for line in f if line.strip()]
    class_to_idx = {c: i for i, c in enumerate(VOC_CLASSES)}
    dicts = []
    for fileid in fileids:
        anno_file = os.path.join(dirname, "Annotations", fileid + ".xml")
        jpeg_file = os.path.join(dirname, "JPEGImages", fileid + ".jpg")
        tree = ET.parse(anno_file)
        r = {
            "file_name": jpeg_file,
            "image_id": fileid,
            "height": int(tree.findall("./size/height")[0].text),
            "width": int(tree.findall("./size/width")[0].text),
        }
        instances = []
        for obj in tree.findall("object"):
            cls = obj.find("name").text
            if cls not in class_to_idx:
                continue
            bbox = obj.find("bndbox")
            box = [float(bbox.find(k).text)
                   for k in ("xmin", "ymin", "xmax", "ymax")]
            # devkit coordinates are 1-based inclusive
            box[0] -= 1.0
            box[1] -= 1.0
            instances.append({
                "category_id": class_to_idx[cls],
                "bbox": box,
                "bbox_mode": "XYXY_ABS",
                "difficult": int(obj.find("difficult").text) == 1
                if obj.find("difficult") is not None else False,
                "iscrowd": 0,
            })
        r["annotations"] = instances
        dicts.append(r)
    return dicts


def register_pascal_voc(root: str):
    """Register the builtin VOC splits when the directories exist."""
    from .catalog import DatasetCatalog, MetadataCatalog

    splits = [
        ("voc_2007_trainval", "VOC2007", "trainval", 2007),
        ("voc_2007_test", "VOC2007", "test", 2007),
        ("voc_2012_trainval", "VOC2012", "trainval", 2012),
    ]
    for name, dirname, split, year in splits:
        d = os.path.join(root, dirname)
        DatasetCatalog.register(
            name, (lambda d=d, s=split: load_voc_instances(d, s)))
        MetadataCatalog.get(name).update(
            evaluator_type="pascal_voc", dirname=d, split=split, year=year,
            thing_classes=list(VOC_CLASSES),
        )
