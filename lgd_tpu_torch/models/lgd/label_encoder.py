"""Sparse label-appearance encoding, LGD module 1 (port of
lgd_tpu/models/lgd/label_encoder.py), padded and batched.

Ragged per-image descriptor lists become (B, M', k) tensors with a token
validity mask; M' = TPU.MAX_INSTANCES (+1 context slot with
ADD_CONTEXT_BOX). The reference's 1x1 Conv1d stacks over a point cloud of
one point are per-token MLPs (``TokenMLP``: Linear, affine-free channel
LayerNorm, ReLU), and each STN is a per-token MLP producing a (k, k)
transform. Hierarchical pooling is a masked max over the valid tokens.

Descriptor layout: [x1/W, y1/H, x2/W, y2/H, one_hot(num_classes)
[, masks49]] scaled from (0, 1) to (-1, 1), W and H the padded canvas; the
49-wide 7x7 in-box mask tail comes with LOAD_LABELMAP (``parse_mask``). An
image without GT gets a fallback (0, 0, 1, 1) box with an all-zero one-hot
and mask in slot 0; the context slot holds the whole-image box with an
all-zero one-hot and an all-ones mask, and is valid only when the image
has GT.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.normalization import layer_norm
from ...structures import BatchedInstances


@torch.no_grad()
def encode_descriptors(gt: BatchedInstances, padded_hw: Tuple[int, int],
                       num_classes: int = 80, add_context_box: bool = False,
                       parse_mask: bool = False):
    """Padded descriptors and token metadata, without gradient.

    Returns desc (B, M', 4 + num_classes [+ 49]) float32 in (-1, 1),
    token_valid
    (B, M') bool (fallback and context slots included), and boxes (B, M', 4)
    clamped to the padded canvas (what the inside-GT masks consume)."""
    H, W = padded_hw
    B, M = gt.valid.shape
    dev = gt.boxes.device

    any_valid = gt.valid.any(dim=1)
    fallback = torch.zeros_like(gt.boxes)
    fallback[:, 0] = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    boxes = torch.where(any_valid[:, None, None], gt.boxes, fallback)
    fallback_valid = torch.zeros_like(gt.valid)
    fallback_valid[:, 0] = True
    valid = torch.where(any_valid[:, None], gt.valid, fallback_valid)
    onehot = (F.one_hot(gt.classes, num_classes).float()
              * gt.valid[..., None])
    # the fallback token keeps an all-zero one-hot
    onehot = torch.where(any_valid[:, None, None], onehot, 0.0)
    parts = [onehot]
    if parse_mask:
        if gt.masks49 is None:
            raise ValueError("LOAD_LABELMAP needs gt.masks49")
        parts.append(torch.where(any_valid[:, None, None], gt.masks49, 0.0))

    if add_context_box:
        ctx = torch.tensor([0.0, 0.0, float(W), float(H)], device=dev)
        boxes = torch.cat([boxes, ctx.expand(B, 1, 4)], dim=1)
        valid = torch.cat([valid, any_valid[:, None]], dim=1)
        ctx_parts = [onehot.new_zeros(B, 1, num_classes),
                     onehot.new_ones(B, 1, 49)]
        parts = [torch.cat([p, c], dim=1) for p, c in zip(parts, ctx_parts)]

    boxes = torch.stack([boxes[..., 0].clamp(0, W - 1),
                         boxes[..., 1].clamp(0, H - 1),
                         boxes[..., 2].clamp(0, W - 1),
                         boxes[..., 3].clamp(0, H - 1)], dim=-1)
    norm = boxes / torch.tensor([W, H, W, H], dtype=torch.float32,
                                device=dev)
    desc = torch.cat([norm, *parts], dim=-1) * 2.0 - 1.0
    desc = desc * valid[..., None]  # zero the padded tokens
    return desc, valid, boxes


class TokenMLP(nn.Module):
    """Linear + affine-free channel LayerNorm + ReLU per token."""

    def __init__(self, in_features: int, features: int,
                 use_norm: bool = True, use_relu: bool = True):
        super().__init__()
        self.linear = nn.Linear(in_features, features)
        self.use_norm = use_norm
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.linear(x)
        if self.use_norm:
            x = layer_norm(x)
        return F.relu(x) if self.use_relu else x


class STN(nn.Module):
    """Per-token transform predictor: k -> 64 -> 128 -> 1024 -> 512 -> 256
    (LayerNorm + ReLU each) -> k * k."""

    def __init__(self, k: int):
        super().__init__()
        self.k = k
        self.conv1 = TokenMLP(k, 64)
        self.conv2 = TokenMLP(64, 128)
        self.conv3 = TokenMLP(128, 1024)
        self.fc1 = TokenMLP(1024, 512)
        self.fc2 = TokenMLP(512, 256)
        self.fc3 = nn.Linear(256, k * k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc2(self.fc1(self.conv3(self.conv2(self.conv1(x)))))
        return self.fc3(h).reshape(*x.shape[:-1], self.k, self.k)


class LabelEncoder(nn.Module):
    """(B, M', k) descriptors -> (B, M', 256) label embeddings; k = 4 +
    num_classes, + 49 with ``parse_mask``."""

    def __init__(self, num_classes: int = 80, parse_mask: bool = False):
        super().__init__()
        k = 4 + num_classes + (49 if parse_mask else 0)
        self.inp = k
        self.stn_desc = STN(k)
        self.conv1 = TokenMLP(k, 64)
        self.stn_feat = STN(64)
        self.conv2 = TokenMLP(64, 128)
        self.conv3 = TokenMLP(128, 1024)
        self.conv4 = TokenMLP(64 + 1024, 256)

    def forward(self, desc: torch.Tensor,
                token_valid: torch.Tensor) -> torch.Tensor:
        if desc.shape[-1] != self.inp:
            raise ValueError(f"descriptors of width {desc.shape[-1]}, "
                             f"expected {self.inp}")
        x = torch.einsum("bmk,bmkl->bml", desc, self.stn_desc(desc))
        x = self.conv1(x)
        x_feat = torch.einsum("bmk,bmkl->bml", x, self.stn_feat(x))
        x = self.conv3(self.conv2(x_feat))
        # hierarchical pooling: masked max over the valid tokens per image
        x_g = torch.where(token_valid[..., None], x, -1e9).amax(dim=1)
        x_cat = torch.cat([x_feat, x_g[:, None].expand(-1, x.shape[1], -1)],
                          dim=-1)
        return self.conv4(x_cat) * token_valid[..., None]
