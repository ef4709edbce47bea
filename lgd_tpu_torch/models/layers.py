"""Shared layers (port of lgd_tpu/models/layers.py), NCHW.

Parameters are kept in float32 and each convolution runs in the model's
compute dtype, as flax's ``nn.Conv(dtype=...)`` does: input, kernel and
bias are cast to that dtype and the output stays in it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` with float32
    parameters."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with constant affine and statistics (detectron2
    ``FrozenBatchNorm2d``), kept as buffers and folded into one
    ``x * w + b`` in float32 before the cast to the input's dtype
    (lgd_tpu/models/layers.py:36-38)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.scale / torch.sqrt(self.var + self.eps)
        b = self.bias - self.mean * w
        return x * w.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


def get_norm(norm: str, num_features: int) -> Optional[nn.Module]:
    if norm in (None, "", "none"):
        return None
    if norm == "FrozenBN":
        return FrozenBatchNorm(num_features)
    if norm == "GN":
        raise NotImplementedError(
            "GroupNorm comes with the FCOS/ATSS/POTO slice (ROADMAP.md, queue "
            "item 6)")
    raise ValueError(f"Unknown norm: {norm}")
