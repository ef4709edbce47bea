from .coco_eval import COCOEvaluator
from .evaluator import (
    CityscapesInstanceEvaluator,
    DatasetEvaluators,
    get_evaluator,
)
from .lvis_eval import LVISEvaluator
from .sem_seg_eval import SemSegEvaluator
from .voc_eval import PascalVOCDetectionEvaluator

__all__ = [
    "COCOEvaluator",
    "CityscapesInstanceEvaluator",
    "DatasetEvaluators",
    "LVISEvaluator",
    "PascalVOCDetectionEvaluator",
    "SemSegEvaluator",
    "get_evaluator",
]
