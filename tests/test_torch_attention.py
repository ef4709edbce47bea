"""Masked attention of the port (lgd_tpu_torch/ops/attention.py) against the
JAX package: the plain version and its autograd gradients against
``masked_attention_reference`` and ``jax.grad``, and against the Pallas
kernels K1a/K1b run in interpret mode. The CUDA kernels themselves are held
against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: float32 on both sides, sums taken in other orders, so 1e-5
relative to the largest value for outputs and 1e-4 for gradients (the
gradients sum twice as many products).
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lgd_tpu.ops import attention as jattn
from lgd_tpu_torch.ops import attention as tattn


def _inputs(seed, B, H, N, D, all_invalid=True):
    """q, k, v, g and a key mask with padding: image 0 keeps a random
    subset, image 1 one key only (an image without GT keeps its fallback
    slot) and, with ``all_invalid``, the last image none."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, H, N, D).astype(np.float32) for _ in range(4))
    valid = rng.rand(B, N) > 0.3
    valid[0, 0] = True
    valid[1] = False
    valid[1, 0] = True
    if all_invalid:
        valid[-1] = False
    return q, k, v, g, valid


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _torch_fwd_bwd(q, k, v, g, valid, scale):
    q_t, k_t, v_t = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.masked_attention(q_t, k_t, v_t, torch.from_numpy(valid),
                                 scale)
    grads = torch.autograd.grad(out, (q_t, k_t, v_t),
                                torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("N,D", [(2, 8), (33, 8), (64, 8), (101, 8),
                                 (101, 64)],
                         ids=["2", "33", "64", "101", "101-D64"])
def test_plain_version_and_gradients_match_jax_reference(N, D):
    """At the mini configs' head width (D = 8) and at the widest one the
    kernels are built for (D = 64)."""
    B, H = 3, 8
    q, k, v, g, valid = _inputs(N, B, H, N, D)
    scale = 1.0 / D ** 0.5

    def loss(q_, k_, v_):
        return jnp.vdot(jattn.masked_attention_reference(
            q_, k_, v_, valid, scale), g)

    want = jattn.masked_attention_reference(q, k, v, valid, scale)
    want_grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    out, grads = _torch_fwd_bwd(q, k, v, g, valid, scale)
    _close(out, want, 1e-5, "out")
    for name, a, b in zip("qkv", grads, want_grads):
        _close(a, b, 1e-4, f"d{name}")
    # the image with no valid key averages V uniformly
    np.testing.assert_allclose(out[-1], np.broadcast_to(
        v[-1].mean(axis=1, keepdims=True), out[-1].shape), atol=1e-5)


def _interpret(fn, *args):
    """A Pallas TPU entry point run in interpret mode on the CPU, as
    tests/test_attention.py runs the backward kernel."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    with jax.disable_jit(), mock.patch.object(pl, "pallas_call", interp):
        return fn(*args)


@pytest.mark.parametrize("N", [33, 101])
def test_plain_version_matches_pallas_kernels(N):
    """Against K1a/K1b themselves, on keys with at least one valid entry
    per image (where the kernels' additive mask and the reference's
    ``where`` agree)."""
    B, H, D = 2, 2, 32
    q, k, v, g, valid = _inputs(100 + N, B, H, N, D, all_invalid=False)
    scale = 1.0 / D ** 0.5
    want = _interpret(jattn._pallas_fwd_impl, q, k, v, valid, scale)
    want_grads = _interpret(jattn._pallas_bwd_impl, q, k, v, valid, g, scale)
    out, grads = _torch_fwd_bwd(q, k, v, g, valid, scale)
    _close(out, want, 1e-5, "out")
    for name, a, b in zip("qkv", grads, want_grads):
        _close(a, b, 1e-4, f"d{name}")


def test_plain_version_with_fewer_keys_than_queries_matches_jax():
    """Nq != Nk (the cross-attention shape the kernels also take), D = 8:
    against the JAX reference and its VJP, and against K1a/K1b in interpret
    mode on keys with a valid entry in every image; each side compiled
    once under jit, to keep the test under a second."""
    B, H, Nq, Nk, D = 2, 1, 21, 9, 8
    rng = np.random.RandomState(7)
    q, g = (rng.randn(B, H, Nq, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, Nk, D).astype(np.float32) for _ in range(2))
    valid = rng.rand(B, Nk) > 0.3
    valid[:, 0] = True
    valid[1, 1:] = False
    scale = 1.0 / D ** 0.5

    @jax.jit
    def reference(q_, k_, v_, g_):
        out, vjp = jax.vjp(lambda *a: jattn.masked_attention_reference(
            *a, valid, scale), q_, k_, v_)
        return out, vjp(g_)

    @jax.jit
    def pallas(q_, k_, v_, g_):
        return (jattn._pallas_fwd_impl(q_, k_, v_, valid, scale),
                jattn._pallas_bwd_impl(q_, k_, v_, valid, g_, scale))

    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call",
                           lambda *a, **kw: orig(*a, **kw, interpret=True)):
        wants = [reference(q, k, v, g), pallas(q, k, v, g)]
    out, grads = _torch_fwd_bwd(q, k, v, g, valid, scale)
    for what, (want, want_grads) in zip(("reference", "Pallas"), wants):
        _close(out, want, 1e-5, f"out ({what})")
        for name, a, b in zip("qkv", grads, want_grads):
            _close(a, b, 1e-4, f"d{name} ({what})")


def test_other_devices_raise():
    """A tensor on neither the CPU nor the card reaches no plain version."""
    t = torch.empty((1, 1, 4, 8), device="meta")
    valid = torch.empty((1, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.masked_attention(t, t, t, valid, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.attention_fwd(torch.zeros(1, 1, 4, 8), torch.zeros(1, 1, 4, 8),
                            torch.zeros(1, 1, 4, 8),
                            torch.ones(1, 4, dtype=torch.bool), 0.5)
