from . import boxes
from .boxes import (
    Box2BoxTransform,
    area,
    clip,
    nonempty,
    pairwise_intersection,
    pairwise_iou,
)
from .instances import BatchedDetections, BatchedInstances

__all__ = [
    "boxes",
    "Box2BoxTransform",
    "area",
    "clip",
    "nonempty",
    "pairwise_intersection",
    "pairwise_iou",
    "BatchedDetections",
    "BatchedInstances",
]
