"""Evaluator routing (port of lgd_tpu/evaluation/evaluator.py: the
reference's get_evaluator, train.py:78-127).

It routes on the dataset's ``evaluator_type`` metadata as the reference
does: 'coco' and 'crowdHuman' -> COCOEvaluator, 'coco_panoptic_seg' ->
SemSeg and COCO together, 'sem_seg' and 'cityscapes_sem_seg' -> SemSeg,
'pascal_voc' -> Pascal VOC (the 11-point metric for the 2007 splits), 'lvis'
-> LVIS, 'cityscapes_instance' -> COCO-protocol scoring of the Cityscapes
dicts (the reference calls cityscapesscripts, which is not here: the same AP
family by the shared matching, a deviation the README states). Any other
type raises."""

from __future__ import annotations

from typing import List, Optional

from .coco_eval import COCOEvaluator
from .lvis_eval import LVISEvaluator
from .sem_seg_eval import SemSegEvaluator
from .voc_eval import PascalVOCDetectionEvaluator


class CityscapesInstanceEvaluator(COCOEvaluator):
    """Cityscapes instance AP over dataset dicts via the COCO-protocol
    matching core (8 thing classes). cityscapesscripts is not a dependency;
    AP/AP50 here use COCO's 101-point protocol rather than the cityscapes
    devkit's — a documented deviation (README 'deviations')."""

    def __init__(self, dataset_name=None, gt_dataset=None, num_classes=8):
        super().__init__(dataset_name, gt_dataset, num_classes)


class DatasetEvaluators:
    """Runs several evaluators over the same outputs (detectron2
    DatasetEvaluators)."""

    def __init__(self, evaluators: List):
        self._evaluators = evaluators

    def reset(self):
        for e in self._evaluators:
            e.reset()

    def process(self, *args, **kwargs):
        for e in self._evaluators:
            e.process(*args, **kwargs)

    def evaluate(self, *args, **kwargs):
        out = {}
        for e in self._evaluators:
            r = e.evaluate(*args, **kwargs)
            if r:
                for k, v in r.items():
                    assert k not in out, f"duplicate eval key {k}"
                    out[k] = v
        return out


def get_evaluator(cfg, dataset_name: str,
                  output_folder: Optional[str] = None):
    from ..data.catalog import MetadataCatalog

    meta = MetadataCatalog.get(dataset_name)
    evaluator_type = meta.get("evaluator_type", "coco")
    evaluators = []
    if evaluator_type in ("sem_seg", "coco_panoptic_seg"):
        evaluators.append(SemSegEvaluator(
            dataset_name,
            num_classes=cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
            if hasattr(cfg.MODEL, "SEM_SEG_HEAD") else 54,
            output_dir=output_folder))
    if evaluator_type in ("coco", "coco_panoptic_seg", "crowdHuman"):
        evaluators.append(COCOEvaluator(dataset_name,
                                        num_classes=cfg.NUM_CLASSES))
    if evaluator_type == "cityscapes_instance":
        return CityscapesInstanceEvaluator(dataset_name)
    if evaluator_type == "cityscapes_sem_seg":
        return SemSegEvaluator(dataset_name, output_dir=output_folder)
    if evaluator_type == "pascal_voc":
        # detectron2 scores 2007 splits with the 11-point metric, 2012 with
        # the every-point metric (pascal_voc_evaluation.py: is_2007 from
        # metadata year)
        return PascalVOCDetectionEvaluator(
            dataset_name, use_07_metric=(meta.get("year", 2007) == 2007))
    if evaluator_type == "lvis":
        return LVISEvaluator(dataset_name)
    if not evaluators:
        raise NotImplementedError(
            f"no Evaluator for dataset {dataset_name} "
            f"with type {evaluator_type}")
    if len(evaluators) == 1:
        return evaluators[0]
    return DatasetEvaluators(evaluators)
