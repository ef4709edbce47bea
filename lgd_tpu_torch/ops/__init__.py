from .nms import (
    batched_nms_mask,
    greedy_keep_sorted,
    greedy_keep_sorted_reference,
    nms_mask,
    topk_detections,
)
from .topk import topk_flat_pairs, topk_stable

__all__ = [
    "batched_nms_mask",
    "greedy_keep_sorted",
    "greedy_keep_sorted_reference",
    "nms_mask",
    "topk_detections",
    "topk_flat_pairs",
    "topk_stable",
]
