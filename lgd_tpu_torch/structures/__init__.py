from . import boxes
from .boxes import (
    Box2BoxTransform,
    Shift2BoxTransform,
    area,
    centers,
    clip,
    nonempty,
    pairwise_intersection,
    pairwise_iou,
)
from .instances import BatchedDetections, BatchedInstances

__all__ = [
    "boxes",
    "Box2BoxTransform",
    "Shift2BoxTransform",
    "area",
    "centers",
    "clip",
    "nonempty",
    "pairwise_intersection",
    "pairwise_iou",
    "BatchedDetections",
    "BatchedInstances",
]
