"""Anchor-to-GT matcher with detectron2 ``Matcher`` semantics (port of
lgd_tpu/ops/matcher.py), on a padded IoU matrix whose invalid GT rows are
masked to -1 so that they never win the argmax against a real GT."""

from __future__ import annotations

import torch


class Matcher:
    def __init__(self, thresholds, labels,
                 allow_low_quality_matches: bool = False):
        thresholds = list(thresholds)
        if any(lo > hi for lo, hi in zip(thresholds[:-1], thresholds[1:])):
            raise ValueError(f"thresholds must be sorted: {thresholds}")
        if len(labels) != len(thresholds) + 1:
            raise ValueError(f"{len(labels)} labels for {len(thresholds)} "
                             f"thresholds")
        self.thresholds = [-float("inf")] + thresholds + [float("inf")]
        self.labels = list(labels)
        self.allow_low_quality_matches = allow_low_quality_matches

    def __call__(self, match_quality_matrix: torch.Tensor,
                 gt_valid: torch.Tensor):
        """match_quality_matrix (..., M, R) IoU of M padded GT rows against
        R anchors; gt_valid (..., M) bool. Returns matches (..., R) int64,
        the argmax GT row (0 when no GT is valid: gate on the labels), and
        match_labels (..., R) int8 in {-1, 0, 1}."""
        quality = torch.where(gt_valid[..., :, None], match_quality_matrix,
                              -1.0)
        matched_vals = quality.amax(dim=-2)
        matches = quality.argmax(dim=-2)

        match_labels = torch.zeros(matched_vals.shape, dtype=torch.int8,
                                   device=quality.device)
        for label, low, high in zip(self.labels, self.thresholds[:-1],
                                    self.thresholds[1:]):
            in_range = (matched_vals >= low) & (matched_vals < high)
            match_labels = torch.where(in_range, label, match_labels)

        if self.allow_low_quality_matches:
            # anchors reaching a valid GT's best quality become foreground
            # and keep their own argmax (detectron2 set_low_quality_matches_)
            highest_per_gt = quality.amax(dim=-1, keepdim=True)
            is_best = ((quality >= highest_per_gt) & (quality > 0)
                       & gt_valid[..., :, None])
            match_labels = torch.where(is_best.any(dim=-2), 1, match_labels)
        return matches, match_labels
