from .coco_eval import COCOEvaluator

__all__ = ["COCOEvaluator"]
