"""Top-k helpers.

The JAX package's ``topk_flat_pairs`` preselected anchors to dodge a
relayout of the TPU's lane-padded class axis (lgd_tpu/ops/topk.py:1-18).
Nothing on this card needs that, so the port is one ``torch.topk``.
``topk_stable`` breaks ties by index, as ``jax.lax.top_k`` does, for pools
whose padding fills many slots with one value.
"""

from __future__ import annotations

import torch


def topk_flat_pairs(scores: torch.Tensor, k: int):
    """scores (B, R, K) -> (values (B, k'), flat_idx (B, k')) with
    k' = min(k, R * K), values descending and flat_idx = anchor * K + cls."""
    B, R, K = scores.shape
    return torch.topk(scores.reshape(B, R * K), min(k, R * K), dim=1)


def topk_stable(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, equal values
    in index order (``torch.topk`` leaves their order open)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]
