"""Swin Transformer backbone (Swin-Tiny), port of
lgd_tpu/models/backbones/swin.py.

The same architecture and submodule names as the flax module, so the
weight bridge maps names one to one: the 4x4 stride-4 patch embed
(``patch_embed``, VALID padding) and its LayerNorm (``patch_norm``), the
optional absolute position embedding, stages ``stage2``..``stage5`` of
``stage<s>_block<i>`` blocks (W-MSA, then SW-MSA with the cyclic shift),
a LayerNorm per output stage (``stage<s>_norm``) and patch merging between
stages (``stage<s>_downsample``).

As in the JAX package each stage runs in window layout, (B, nW, N, C):
the ws-padded canvas is window-partitioned once per stage, the shift is
a static gather by a permutation, and the padding tokens are re-zeroed
after each ``norm1``. The tables this needs (the relative-position index,
the shifted-window mask, the shift's permutations and the pad mask)
depend only on the stage's canvas: they are computed in numpy, as the JAX
package computes them at trace time, and kept on the device per canvas.

Numerics kept from the JAX package on purpose: LayerNorms in float32 with
flax's epsilon 1e-6, the MLP's GELU in its tanh form (flax's ``nn.gelu``
default), and the window logits, their bias and the -100 mask in the
compute dtype with only the softmax in float32. Window attention is plain
torch: the JAX package has no TPU kernel for it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2d, DropPath, LayerNorm32, Linear


def _rel_pos_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2*ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))  # (2, ws, ws)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # (N, N)


def _shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """Static SW-MSA mask: (nW, N, N) with 0 for same-region pairs, -100
    otherwise (reference swin_transformer.py:310-334)."""
    img_mask = np.zeros((hp, wp), np.int32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[h, w] = cnt
            cnt += 1
    m = img_mask.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    m = m.reshape(-1, ws * ws)  # (nW, N)
    return (m[:, None, :] != m[:, :, None]).astype(np.float32) * -100.0


def _shift_perms(hp: int, wp: int, ws: int, shift: int):
    """Static permutations so the cyclic shift runs in window layout: with
    the stage's tokens flat in window-major order, ``x[perm]`` equals the
    window partition of the canvas rolled by (-shift, -shift), and ``inv``
    undoes it."""
    canvas = np.arange(hp * wp).reshape(hp, wp)
    win = canvas.reshape(hp // ws, ws, wp // ws, ws).transpose(
        0, 2, 1, 3).reshape(-1)  # window slot -> canvas pixel
    rolled = np.roll(canvas, (-shift, -shift), axis=(0, 1))
    win_rolled = rolled.reshape(hp // ws, ws, wp // ws, ws).transpose(
        0, 2, 1, 3).reshape(-1)
    slot_of = np.empty(hp * wp, np.int32)
    slot_of[win] = np.arange(hp * wp, dtype=np.int32)
    perm = slot_of[win_rolled]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(hp * wp, dtype=np.int32)
    return perm, inv


def _pad_keep_mask(h: int, w: int, hp: int, wp: int, ws: int) -> np.ndarray:
    """(nW, N): 1.0 for the canvas's tokens, 0.0 for the ws-padding ones
    (the reference pads zeros after norm1 in every block,
    swin_transformer.py:219-223)."""
    m = np.zeros((hp, wp), np.float32)
    m[:h, :w] = 1.0
    return m.reshape(hp // ws, ws, wp // ws, ws).transpose(
        0, 2, 1, 3).reshape(-1, ws * ws)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5, in float32."""
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 weights of ``jax.image.resize(...,
    "bicubic")`` along one axis: Keys' cubic with a = -0.5 at half-pixel
    centres, widened by the scale when downsampling (antialias), each
    row normalized to sum to 1 and zero where the sample falls outside
    the input. torch's bicubic uses a = -0.75 and no antialias."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
              * np.float32(inv_scale) - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, 0.0)
                                .astype(np.float32).T)


class WindowAttention(nn.Module):
    """W-MSA with the relative-position bias (reference
    swin_transformer.py:76-154). ``q`` is scaled before the product; the
    logits, the bias and the mask stay in the compute dtype and only the
    softmax runs in float32 (lgd_tpu/models/backbones/swin.py:150-162)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        # flax multiplies by the scale in the compute dtype
        self.scale = float(torch.tensor((dim // num_heads) ** -0.5,
                                        dtype=dtype))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, compute_dtype=dtype)
        self.proj = Linear(dim, dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, rel_index: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B*nW, N, C); rel_index (N*N,) into the bias table; mask (nW,
        N, N) or None."""
        Bn, N, C = x.shape
        H = self.num_heads
        bias = self.relative_position_bias_table[rel_index].view(
            N, N, H).permute(2, 0, 1)
        qkv = self.qkv(x).view(Bn, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = q @ k.transpose(-2, -1)  # (Bn, H, N, N), compute dtype
        attn = attn + bias.to(attn.dtype)
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.view(Bn // nW, nW, H, N, N)
                    + mask[None, :, None].to(attn.dtype)).view(Bn, H, N, N)
        attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
        out = (attn @ v).transpose(1, 2).reshape(Bn, N, C)
        return self.proj(out)


class SwinBlock(nn.Module):
    """One W-MSA or SW-MSA block on (B, nW, N, C) window-layout tokens
    (reference swin_transformer.py:157-254)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.shift_size = shift_size
        self.norm1 = LayerNorm32(dim)
        self.attn = WindowAttention(dim, num_heads, window_size, dtype=dtype)
        self.norm2 = LayerNorm32(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = Linear(dim, hidden, compute_dtype=dtype)
        self.mlp_fc2 = Linear(hidden, dim, compute_dtype=dtype)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, tables: Dict[str, torch.Tensor],
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``tables``: the stage's ``rel_index``, ``keep`` (the pad mask or
        None) and, for a shifted block, ``perm``, ``inv`` and ``mask``; ``u``
        (2, B) uniforms of the two drop-paths, or None."""
        B, nW, N, C = x.shape
        shortcut = x
        x = self.norm1(x)
        if tables["keep"] is not None:
            x = x * tables["keep"].to(x.dtype)[None, :, :, None]
        mask = None
        if self.shift_size > 0:
            x = x.reshape(B, nW * N, C).index_select(
                1, tables["perm"]).view(B, nW, N, C)
            mask = tables["mask"]
        x = self.attn(x.reshape(B * nW, N, C), tables["rel_index"], mask)
        if self.shift_size > 0:
            x = x.view(B, nW * N, C).index_select(1, tables["inv"])
        x = x.view(B, nW, N, C)
        x = shortcut + self.drop_path1(x, None if u is None else u[0])
        y = self.mlp_fc1(self.norm2(x))
        y = self.mlp_fc2(F.gelu(y, approximate="tanh"))
        return x + self.drop_path2(y, None if u is None else u[1])


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated as x0, x1, x2, x3 (rows then columns,
    lgd_tpu/models/backbones/swin.py:243-247), a zero pad on an odd side,
    LayerNorm, and a bias-free linear map to 2 * dim."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.norm = LayerNorm32(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False,
                                compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> (B, ceil(H/2), ceil(W/2), 2C)."""
        H, W = x.shape[1:3]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """Swin backbone returning {'stage2'..'stage5'} NCHW maps (reference
    swin_transformer.py:442-631) at strides 4-32 with EMBED_DIM * 2**i
    channels. ``forward(x, drop_path)`` takes the normalized NCHW images
    and, in training, the drop-paths' uniforms: (2 * sum(depths), B), two
    rows per block in block order."""

    def __init__(self, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.2, patch_norm: bool = True,
                 ape: bool = False, pretrain_img_size: int = 224,
                 patch_size: int = 4,
                 out_features: Sequence[str] = ("stage2", "stage3", "stage4",
                                                "stage5"),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depths = tuple(depths)
        self.window_size = window_size
        self.out_features = tuple(out_features)
        self.drop_path_rate = float(drop_path_rate)
        self.patch_embed = Conv2d(3, embed_dim, patch_size, stride=patch_size,
                                  compute_dtype=dtype)
        self.patch_norm = LayerNorm32(embed_dim) if patch_norm else None
        if ape:
            pr = pretrain_img_size // patch_size
            self.absolute_pos_embed = nn.Parameter(
                torch.zeros(1, embed_dim, pr, pr))
        else:
            self.absolute_pos_embed = None
        dpr = np.linspace(0, drop_path_rate, sum(self.depths))
        self.block_names = []
        dim, block = embed_dim, 0
        for stage, depth in enumerate(self.depths):
            names = []
            for i in range(depth):
                name = f"stage{stage + 2}_block{i}"
                self.add_module(name, SwinBlock(
                    dim, num_heads[stage], window_size,
                    shift_size=0 if i % 2 == 0 else window_size // 2,
                    mlp_ratio=mlp_ratio, drop_path=float(dpr[block]),
                    dtype=dtype))
                names.append(name)
                block += 1
            self.block_names.append(names)
            if f"stage{stage + 2}" in self.out_features:
                self.add_module(f"stage{stage + 2}_norm", LayerNorm32(dim))
            if stage < len(self.depths) - 1:
                self.add_module(f"stage{stage + 2}_downsample",
                                PatchMerging(dim, dtype=dtype))
                dim *= 2
        self._tables: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self._ape_weights: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def num_drop_path_draws(self) -> int:
        """Rows of the uniforms ``forward`` takes: two per block."""
        return 2 * sum(self.depths)

    def init_weights_(self, generator: torch.Generator):
        """flax's initializers: lecun-normal linear and patch-embed
        kernels, zero biases, truncated-normal(0.02) bias tables and
        position embedding, LayerNorms at ones and zeros."""
        for m in self.modules():
            if isinstance(m, (Conv2d, Linear)):
                nn.init.normal_(m.weight, 0.0, 1.0 / math.sqrt(
                    m.weight[0].numel()), generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, LayerNorm32):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table, 0.0,
                                      0.02, -0.04, 0.04, generator=generator)
        if self.absolute_pos_embed is not None:
            nn.init.trunc_normal_(self.absolute_pos_embed, 0.0, 0.02, -0.04,
                                  0.04, generator=generator)

    def _stage_tables(self, h: int, w: int, device) -> Dict:
        """The static tables of a stage on an h x w canvas, on ``device``."""
        key = (h, w, str(device))
        if key not in self._tables:
            ws = self.window_size
            hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
            shift = ws // 2
            perm, inv = _shift_perms(hp, wp, ws, shift)

            def dev(a, dtype):
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    device=device, dtype=dtype)

            self._tables[key] = {
                "rel_index": dev(_rel_pos_index(ws).reshape(-1), torch.long),
                "keep": (dev(_pad_keep_mask(h, w, hp, wp, ws), torch.float32)
                         if (hp, wp) != (h, w) else None),
                "perm": dev(perm, torch.long), "inv": dev(inv, torch.long),
                "mask": dev(_shift_attn_mask(hp, wp, ws, shift),
                            torch.float32)}
        return self._tables[key]

    def _position_embedding(self, h: int, w: int) -> torch.Tensor:
        """The (1, C, pr, pr) embedding resized to (h, w) as
        ``jax.image.resize(..., "bicubic")`` does, in float32; -> (h, w, C)."""
        pe = self.absolute_pos_embed.float()[0]
        pr_h, pr_w = pe.shape[-2:]
        key = (h, w, str(pe.device))
        if key not in self._ape_weights:
            self._ape_weights[key] = tuple(
                None if n == p else torch.from_numpy(
                    bicubic_weights(p, n)).to(pe.device)
                for p, n in ((pr_h, h), (pr_w, w)))
        wh, ww = self._ape_weights[key]
        if wh is not None:
            pe = torch.matmul(wh, pe)
        if ww is not None:
            pe = torch.matmul(pe, ww.T)
        return pe.permute(1, 2, 0)

    def forward(self, x: torch.Tensor,
                drop_path: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        x = self.patch_embed(x).permute(0, 2, 3, 1)  # (B, H, W, C)
        if self.patch_norm is not None:
            x = self.patch_norm(x)
        if self.absolute_pos_embed is not None:
            x = x + self._position_embedding(*x.shape[1:3]).to(x.dtype)
        ws = self.window_size
        outputs, block = {}, 0
        for stage, names in enumerate(self.block_names):
            B, H, W, C = x.shape
            hp, wp = -(-H // ws) * ws, -(-W // ws) * ws
            if (hp, wp) != (H, W):
                x = F.pad(x, (0, 0, 0, wp - W, 0, hp - H))
            x = x.reshape(B, hp // ws, ws, wp // ws, ws, C).permute(
                0, 1, 3, 2, 4, 5).reshape(B, -1, ws * ws, C)
            tables = self._stage_tables(H, W, x.device)
            for name in names:
                u = (None if drop_path is None
                     else drop_path[2 * block:2 * block + 2])
                x = getattr(self, name)(x, tables, u)
                block += 1
            x = x.reshape(B, hp // ws, wp // ws, ws, ws, C).permute(
                0, 1, 3, 2, 4, 5).reshape(B, hp, wp, C)[:, :H, :W]
            name = f"stage{stage + 2}"
            if name in self.out_features:
                outputs[name] = getattr(self, f"{name}_norm")(x).permute(
                    0, 3, 1, 2)
            if stage < len(self.depths) - 1:
                x = getattr(self, f"{name}_downsample")(x)
        return outputs


def build_swint(cfg, dtype: torch.dtype = torch.bfloat16) -> SwinTransformer:
    s = cfg.MODEL.SWINT
    return SwinTransformer(
        embed_dim=s.EMBED_DIM,
        depths=tuple(s.DEPTHS),
        num_heads=tuple(s.NUM_HEADS),
        window_size=s.WINDOW_SIZE,
        mlp_ratio=float(s.MLP_RATIO),
        drop_path_rate=s.DROP_PATH_RATE,
        ape=bool(s.APE),
        out_features=tuple(s.OUT_FEATURES),
        dtype=dtype,
    )
