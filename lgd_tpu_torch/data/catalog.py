"""Dataset and metadata catalogs with the built-in splits (port of
lgd_tpu/data/catalog.py).

detectron2's ``DatasetCatalog``/``MetadataCatalog`` and its built-in
registrations, which the reference's data loading reads
(utils/build.py:22,212-259). The on-disk datasets resolve under
$DETECTRON2_DATASETS (default ``datasets``), in the reference's layout:
COCO 2017 (``coco/{train,val}2017``, ``coco/annotations``), Pascal VOC
(``VOC2007``, ``VOC2012``) and LVIS v1 (``lvis/``). The synthetic split
``synthetic_mini`` is always there. ``get_dataset_dicts(name)`` is the one
call the loaders use.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, fn: Callable[[], List[dict]]):
        if name in self._registry:
            raise KeyError(f"Dataset '{name}' already registered")
        self._registry[name] = fn

    def get(self, name: str) -> List[dict]:
        if name not in self._registry:
            raise KeyError(
                f"Dataset '{name}' not registered; have {sorted(self._registry)}"
            )
        return self._registry[name]()

    def list(self):
        return sorted(self._registry)

    def remove(self, name):
        self._registry.pop(name)


class _Metadata(dict):
    """A dict whose keys also read and write as attributes."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


class _MetadataCatalog:
    def __init__(self):
        self._registry: Dict[str, _Metadata] = {}

    def get(self, name: str) -> _Metadata:
        if name not in self._registry:
            self._registry[name] = _Metadata(name=name)
        return self._registry[name]


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()


def get_dataset_dicts(name: str) -> List[Dict]:
    return DatasetCatalog.get(name)


def _register_builtin_coco(root: str):
    """COCO 2017 train and val; the category id mapping comes from the
    JSON when it is loaded."""
    from .coco import load_coco_json

    splits = {
        "coco_2017_train": ("coco/train2017",
                            "coco/annotations/instances_train2017.json"),
        "coco_2017_val": ("coco/val2017",
                          "coco/annotations/instances_val2017.json"),
    }
    for name, (image_dir, json_file) in splits.items():
        jf = os.path.join(root, json_file)
        idir = os.path.join(root, image_dir)
        DatasetCatalog.register(
            name, (lambda jf=jf, idir=idir, name=name:
                   load_coco_json(jf, idir, name)))
        MetadataCatalog.get(name).update(
            evaluator_type="coco", json_file=jf, image_root=idir)


def _register_builtin():
    from .lvis import register_lvis
    from .synthetic import register_synthetic
    from .voc import register_pascal_voc

    root = os.environ.get("DETECTRON2_DATASETS", "datasets")
    _register_builtin_coco(root)
    register_pascal_voc(root)
    register_lvis(root)
    # the 16-image synthetic split (BASELINE.json config #1)
    register_synthetic("synthetic_mini")


_register_builtin()
