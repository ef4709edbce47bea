"""DynamicTeacher: label-guided teacher feature pyramid, the LGD core (port
of lgd_tpu/models/lgd/dynamic_teacher.py), NCHW.

Tokens stay batched as (B, M', C) with a key-validity mask, which is the
reference's block-diagonal attention over the flattened instances of all
images. Inside-GT masks are (B, M', Hi*Wi) per level: the boxes', or with
LOAD_LABELMAP (``use_seg_map``) each instance's stride-aligned bitmask
resampled nearest to the level; mask pooling and the
rendering scatter are batched einsums; the context token sits in the fixed
last slot. The attention is ``ops.attention.masked_attention``: kernels K1a
and K1b on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import masked_attention
from ...ops.normalization import group_norm
from ...structures import BatchedInstances
from ..layers import Conv2d
from .label_encoder import LabelEncoder, TokenMLP, encode_descriptors


def inside_gt_masks(boxes: torch.Tensor, padded_hw: Tuple[int, int],
                    level_hw: Tuple[int, int]) -> torch.Tensor:
    """boxes (B, M', 4) clamped x1y1x2y2 in the padded (H, W) frame ->
    (B, M', hi*wi) float 0/1: cell (y, x) is inside iff |center - (y, x)| /
    size <= 0.5 in both dimensions, boxes scaled by (hi/H, wi/W)."""
    H, W = padded_hw
    hi, wi = level_hw
    ry, rx = hi / H, wi / W
    x1, y1 = boxes[..., 0] * rx, boxes[..., 1] * ry
    x2, y2 = boxes[..., 2] * rx, boxes[..., 3] * ry
    xc, yc = (x1 + x2) * 0.5, (y1 + y2) * 0.5
    w = (x2 - x1).clamp(min=1e-6)
    h = (y2 - y1).clamp(min=1e-6)
    ys = torch.arange(hi, dtype=torch.float32, device=boxes.device)
    xs = torch.arange(wi, dtype=torch.float32, device=boxes.device)
    in_y = (yc[..., None] - ys).abs() / h[..., None] <= 0.5
    in_x = (xc[..., None] - xs).abs() / w[..., None] <= 0.5
    mask = in_y[..., :, None] & in_x[..., None, :]
    return mask.reshape(*mask.shape[:-2], hi * wi).float()


def segmask_inside_masks(bitmasks: torch.Tensor, num_tokens: int,
                         level_hw: Tuple[int, int]) -> torch.Tensor:
    """The LOAD_LABELMAP inside masks: bitmasks (B, M, Hs, Ws) uint8 on the
    padded canvas, resampled nearest to the (hi, wi) level by integer
    floor division, -> (B, num_tokens, hi*wi) float; a context slot (when
    num_tokens is M + 1) is all ones (lgd_tpu/models/lgd/
    dynamic_teacher.py:70-88)."""
    B, M, Hs, Ws = bitmasks.shape
    hi, wi = level_hw
    dev = bitmasks.device
    ys = ((torch.arange(hi, device=dev) * Hs) // hi).clamp(0, Hs - 1)
    xs = ((torch.arange(wi, device=dev) * Ws) // wi).clamp(0, Ws - 1)
    m = bitmasks[:, :, ys][:, :, :, xs].float().reshape(B, M, hi * wi)
    if num_tokens == M + 1:
        m = torch.cat([m, m.new_ones(B, 1, hi * wi)], dim=1)
    return m


class MultiHeadAttention(nn.Module):
    """``nn.MultiheadAttention(C, heads)`` semantics on padded tokens:
    q/k/v in-projections with bias, masked scaled dot-product attention,
    out-projection with bias. Padded query rows are zeroed by the caller."""

    def __init__(self, channels: int = 256, num_heads: int = 8):
        super().__init__()
        self.channels, self.num_heads = channels, num_heads
        self.q_proj = nn.Linear(channels, channels)
        self.k_proj = nn.Linear(channels, channels)
        self.v_proj = nn.Linear(channels, channels)
        self.out_proj = nn.Linear(channels, channels)

    def forward(self, q, k, v, key_valid):
        C, H = self.channels, self.num_heads
        Dh = C // H
        B, Mq, _ = q.shape
        Mk = k.shape[1]
        qh = self.q_proj(q).reshape(B, Mq, H, Dh).transpose(1, 2)
        kh = self.k_proj(k).reshape(B, Mk, H, Dh).transpose(1, 2)
        vh = self.v_proj(v).reshape(B, Mk, H, Dh).transpose(1, 2)
        out = masked_attention(qh, kh, vh, key_valid, scale=1.0 / Dh ** 0.5)
        return self.out_proj(out.transpose(1, 2).reshape(B, Mq, C))


class SharedConvGN(nn.Module):
    """conv3x3 + affine-free GroupNorm(1) + optional ReLU, shared across the
    FPN levels."""

    def __init__(self, channels: int = 256, use_relu: bool = True):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = group_norm(self.conv(x), num_groups=1)
        return F.relu(x) if self.use_relu else x


class DynamicTeacher(nn.Module):
    """(GT, student FPN features) -> a teacher feature pyramid of the same
    shapes, in float32. It has no backbone."""

    def __init__(self, num_classes: int = 80, channels: int = 256,
                 num_heads: int = 8, interact_pattern: str = "stuGuided",
                 add_context_box: bool = False,
                 detach_appearance_embed: bool = False,
                 use_seg_map: bool = False):
        super().__init__()
        if interact_pattern not in ("stuGuided", "labelGuided",
                                    "student_fill", "teacher_fill"):
            raise ValueError(f"unknown INTERACT_PATTERN {interact_pattern!r}")
        self.num_classes = num_classes
        self.interact_pattern = interact_pattern
        self.add_context_box = add_context_box
        self.detach_appearance_embed = detach_appearance_embed
        self.use_seg_map = use_seg_map
        self.label_encoder_ = LabelEncoder(num_classes, parse_mask=use_seg_map)
        self.canoni_proj_1D = TokenMLP(256, channels)
        self.student_proj_2D = SharedConvGN(channels)
        self.local_inst_proj_2D = Conv2d(channels, channels, 3, padding=1)
        self.local_inst_proj_1D = nn.Linear(channels, channels)
        self.refine_1 = SharedConvGN(channels)
        self.refine_2 = SharedConvGN(channels)
        self.refine_3 = SharedConvGN(channels, use_relu=False)
        # as in the flax module, layers exist only where the config uses
        # them, so both packages hold the same parameters
        if add_context_box:
            self.global_ctx_proj_1D = nn.Linear(channels, channels)
        if interact_pattern in ("stuGuided", "labelGuided"):
            self.multi_head_attn = MultiHeadAttention(channels, num_heads)

    def forward(self, gt: BatchedInstances,
                stu_fpn_feats: Dict[str, torch.Tensor],
                padded_hw: Tuple[int, int]):
        """Returns (teacher feats {level: (B, C, Hi, Wi)}, inside masks
        {level: (B, M', Hi*Wi)}, token_valid (B, M'))."""
        keys = sorted(stu_fpn_feats)
        desc, token_valid, boxes = encode_descriptors(
            gt, padded_hw, self.num_classes, self.add_context_box,
            self.use_seg_map)
        canoni = self.canoni_proj_1D(self.label_encoder_(desc, token_valid))
        tok = token_valid[..., None].float()

        feats = stu_fpn_feats
        if self.detach_appearance_embed:
            feats = {k: v.detach() for k, v in feats.items()}
        if self.use_seg_map:
            masks = {k: segmask_inside_masks(gt.bitmasks, tok.shape[1],
                                             feats[k].shape[-2:]) * tok
                     for k in keys}
        else:
            masks = {k: inside_gt_masks(boxes, padded_hw, feats[k].shape[-2:])
                     * tok for k in keys}

        tea_feats = {}
        for k in keys:
            # appearance embeddings: project the student map, mask-pool it
            f = self.student_proj_2D(feats[k].float())
            B, C, hi, wi = f.shape
            m = masks[k]
            pooled = torch.einsum("bmh,bch->bmc", m, f.reshape(B, C, hi * wi))
            pooled = pooled / m.sum(dim=-1, keepdim=True).clamp(min=1.0)
            if self.interact_pattern == "student_fill":
                out = pooled
            elif self.interact_pattern == "teacher_fill":
                out = canoni
            elif self.interact_pattern == "stuGuided":
                # Q = appearance embeddings, K = V = label embeddings
                out = self.multi_head_attn(pooled, canoni, canoni,
                                           token_valid)
            else:  # labelGuided
                out = self.multi_head_attn(canoni, pooled, pooled,
                                           token_valid)
            out = out * tok

            # rendering with the context token, then refinement
            if self.add_context_box:
                inst, inst_masks, inst_valid = out[:, :-1], m[:, :-1], \
                    tok[:, :-1]
            else:
                inst, inst_masks, inst_valid = out, m, tok
            proj = self.local_inst_proj_1D(inst) * inst_valid
            fmap = torch.einsum("bmc,bmh->bch", proj, inst_masks)
            fmap = self.local_inst_proj_2D(fmap.reshape(B, C, hi, wi))
            if self.add_context_box:
                fmap = fmap + self.global_ctx_proj_1D(out[:, -1])[..., None,
                                                                    None]
            fmap = F.relu(fmap)
            tea_feats[k] = self.refine_3(self.refine_2(self.refine_1(fmap)))
        return tea_feats, masks, token_valid
