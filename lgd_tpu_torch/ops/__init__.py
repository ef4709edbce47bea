from .deform_conv import (
    deform_conv2d,
    deform_sample_bwd,
    deform_sample_bwd_reference,
    deform_sample_fwd,
    deform_sample_reference,
)
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
    "deform_conv2d",
    "deform_sample_bwd",
    "deform_sample_bwd_reference",
    "deform_sample_fwd",
    "deform_sample_reference",
    "greedy_keep_sorted",
    "greedy_keep_sorted_reference",
    "nms_mask",
    "topk_detections",
    "topk_flat_pairs",
    "topk_stable",
]
