"""Affine-free normalizations of the distill loss and the teacher (port of
lgd_tpu/ops/normalization.py), NCHW where the JAX package is NHWC."""

from __future__ import annotations

import torch


def _normalize(x: torch.Tensor, dims, eps: float) -> torch.Tensor:
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def instance_norm_2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``nn.InstanceNorm2d(C, affine=False)``: each (H, W) slice per sample
    and channel of an (N, C, H, W) tensor."""
    return _normalize(x, (2, 3), eps)


def layer_norm(x: torch.Tensor, dim: int = -1,
               eps: float = 1e-5) -> torch.Tensor:
    """Affine-free LayerNorm over one dimension (the label encoder's
    per-token channel normalization)."""
    return _normalize(x, (dim,), eps)


def group_norm(x: torch.Tensor, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """Affine-free GroupNorm over (N, C, H, W); ``num_groups=1`` is the
    teacher's LayerNorm over (C, H, W)."""
    n, c, h, w = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    xg = _normalize(x.reshape(n, num_groups, c // num_groups, h, w),
                    (2, 3, 4), eps)
    return xg.reshape(n, c, h, w)
