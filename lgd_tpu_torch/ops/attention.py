"""Masked multi-head attention of the teacher (port of
lgd_tpu/ops/attention.py).

``masked_attention`` is ``softmax(where(valid, Q K^T * scale, -1e9)) V``
with a per-image key-validity mask, q (B, H, Nq, D), k and v (B, H, Nk, D),
key_valid (B, Nk) bool. On the card it is a ``torch.autograd.Function``
whose forward is kernel K1a (``attention_fwd``, replacing the Pallas
``_pallas_fwd_impl``) and whose backward is kernel K1b (``attention_bwd``,
replacing ``_pallas_bwd_impl``), both hand-written CUDA in
``csrc/attention.cu``, built for the head widths D in ``BUILT_D`` (the
teacher's 256 channels over 8 heads give 32; the mini configs' 64-channel
FPN gives 8); they run on every teacher attention call (the JAX package's
short-sequence dispatch to XLA is not ported). On the CPU it is the plain
version, ``masked_attention_reference``, differentiated by autograd. Any
other device raises.
"""

from __future__ import annotations

import ctypes

import torch

BUILT_D = (8, 16, 32, 64)  # the head widths the kernels are built for

_lib = None
_smem_limit = {}  # device index -> shared memory a block may opt in to


def _kernel():
    global _lib
    if _lib is None:
        from .. import csrc

        lib = csrc.load("attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lgd_attn_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                     ctypes.c_float, i, i, p]
        lib.lgd_attn_fwd.restype = i
        lib.lgd_attn_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i,
                                     i, i, ctypes.c_float, i, i, p]
        lib.lgd_attn_bwd.restype = i
        _lib = lib
    return _lib


def masked_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, key_valid: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """Plain version of K1a; its autograd gradient is the plain version of
    K1b."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    logits = torch.where(key_valid[:, None, None, :], logits, -1e9)
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


def _check(q, k, v, key_valid, saved=()):
    """What the kernels take: float32 CUDA tensors q (B, H, Nq, D), k and
    v (B, H, Nk, D), key_valid (B, Nk) bool, and for the backward the
    forward's out and the output gradient (B, H, Nq, D) and its rows' max
    and sum (B, H, Nq); all contiguous on one card, the float tensors
    16-byte aligned, D a width the kernels are built for."""
    tensors = [q, k, v, *saved]
    if any(t.device.type != "cuda" for t in (*tensors, key_valid)):
        raise ValueError("attention kernels take CUDA tensors")
    if any(t.device != q.device for t in (*tensors, key_valid)):
        raise ValueError("attention kernels: tensors on different devices")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"attention kernels take float32, got "
                        f"{[t.dtype for t in tensors]}")
    if key_valid.dtype != torch.bool:
        raise TypeError(f"key_valid must be bool, got {key_valid.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be (B, H, N, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    if (tuple(k.shape) != (B, H, Nk, D) or v.shape != k.shape
            or tuple(key_valid.shape) != (B, Nk)
            or any(tuple(t.shape) != w for t, w in zip(
                saved, (tuple(q.shape), (B, H, Nq), (B, H, Nq),
                        tuple(q.shape))))):
        raise ValueError(
            f"attention kernels: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, key_valid "
            f"{tuple(key_valid.shape)}, out, m, s, g "
            f"{[tuple(t.shape) for t in saved]}")
    if not all(t.is_contiguous() for t in (*tensors, key_valid)):
        raise ValueError("attention kernels take contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("attention kernels take 16-byte aligned tensors")
    if B * H > 65535:
        raise ValueError(f"attention kernels take at most 65535 (batch, "
                         f"head) pairs, got {B * H}")
    if D not in BUILT_D:
        raise ValueError(f"attention kernels are built for D in {BUILT_D}, "
                         f"got D = {D}")
    device = q.device.index
    if device not in _smem_limit:
        _smem_limit[device] = torch.cuda.get_device_properties(
            device).shared_memory_per_block_optin
    return _kernel(), (B, H, Nq, Nk, D), device, _smem_limit[device]


def attention_fwd(q, k, v, key_valid, scale: float):
    """Kernel K1a: ``masked_attention_reference`` on the card. Returns
    (out, m, s): the output and each query row's softmax max and sum
    (B, H, Nq), which K1b takes. Counts each launch in
    ``attention_fwd.launches``."""
    lib, (B, H, Nq, Nk, D), device, limit = _check(q, k, v, key_valid)
    out = torch.empty_like(q)
    m, s = (q.new_empty((B, H, Nq)) for _ in range(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lgd_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               key_valid.data_ptr(), out.data_ptr(),
                               m.data_ptr(), s.data_ptr(), B, H, Nq, Nk, D,
                               float(scale), device, limit, stream)
    if err != 0:
        raise RuntimeError(f"attention forward launch failed: cudaError {err}")
    attention_fwd.launches += 1
    return out, m, s


def attention_bwd(q, k, v, key_valid, out, m, s, g, scale: float):
    """Kernel K1b: (dq, dk, dv) of ``masked_attention_reference`` for the
    output gradient g, from K1a's out, m and s. Counts each launch in
    ``attention_bwd.launches``."""
    lib, (B, H, Nq, Nk, D), device, limit = _check(
        q, k, v, key_valid, (out, m, s, g))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lgd_attn_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               key_valid.data_ptr(), out.data_ptr(),
                               m.data_ptr(), s.data_ptr(), g.data_ptr(),
                               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                               B, H, Nq, Nk, D, float(scale), device, limit,
                               stream)
    if err != 0:
        raise RuntimeError(
            f"attention backward launch failed: cudaError {err}")
    attention_bwd.launches += 1
    return dq, dk, dv


attention_fwd.launches = 0
attention_bwd.launches = 0


class _MaskedAttention(torch.autograd.Function):
    """K1a forward, K1b backward; q, k, v, key_valid, the output and its
    rows' softmax max and sum are saved and the probabilities recomputed
    from them."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, scale):
        q, k, v, key_valid = (t.contiguous() for t in (q, k, v, key_valid))
        out, m, s = attention_fwd(q, k, v, key_valid, scale)
        ctx.save_for_backward(q, k, v, key_valid, out, m, s)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_valid, out, m, s = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, key_valid, out, m, s,
                                   g.contiguous(), ctx.scale)
        return dq, dk, dv, None, None


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_valid: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernels for tensors on the card, the plain version for tensors
    on the CPU."""
    if q.device.type == "cpu":
        return masked_attention_reference(q, k, v, key_valid, scale)
    if q.device.type != "cuda":
        raise ValueError(f"masked attention: unsupported device {q.device}")
    return _MaskedAttention.apply(q, k, v, key_valid, scale)
