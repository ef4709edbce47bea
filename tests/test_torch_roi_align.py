"""Multilevel ROIAlign of the port (``lgd_tpu_torch/ops/roi_align.py``: the
level routing, the shared geometry and the plain version of kernel K3)
against the JAX package's ``multilevel_roi_align``, float32, on a p2-p5
pyramid of a 128x160 canvas with 8 channels.

The ROIs cover every level, reach past the map's edges, include boxes
under a texel, boxes large enough to hit the s_max cap of 4 samples per
axis, and invalid slots. Tolerance 1e-5 absolute on values of order 1: the
JAX dense path sums its interpolation matmuls in another order than the
gather form. The card's kernel is held against the same plain version in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lgd_tpu.ops import roi_align as jra
from lgd_tpu_torch.ops import roi_align as tra

import torch_parity  # noqa: F401  (one torch thread per test process)

STRIDES = (4, 8, 16, 32)
CANVAS = (128, 160)
C = 8
TOL = 1e-5
# (JAX impl, sampling ratio): adaptive sampling against both JAX paths, a
# fixed 2x2 grid against the gather path
POOLS = (("dense", 0), ("gather", 0), ("gather", 2))


def _features(seed, B=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, CANVAS[0] // s, CANVAS[1] // s, C).astype(np.float32)
            for s in STRIDES]


def _boxes():
    """(2, 12, 4) ROIs and their validity."""
    rows = [
        [10.3, 12.7, 40.1, 30.9],     # p2
        [3.0, 5.0, 3.4, 5.3],         # under a texel
        [-20.0, -15.0, 60.0, 50.0],   # past the top-left edge
        [100.0, 90.0, 190.0, 150.0],  # past the bottom-right edge
        [5.0, 7.0, 117.0, 119.0],     # sqrt(area) = 112: p3
        [0.0, 0.0, 224.0, 224.0],     # 224: p4
        [0.0, 0.0, 448.0, 448.0],     # 448: p5, 2 samples per bin axis
        [-300.0, -200.0, 900.0, 700.0],  # clamped to p5, s_max cap hit
        [30.0, 20.0, 80.0, 110.0],
        [64.0, 64.0, 64.0, 64.0],     # empty box
        [50.0, 40.0, 160.0, 128.0],
        [12.0, 33.0, 150.0, 41.0],    # thin
    ]
    boxes = np.asarray([rows, rows[::-1]], np.float32)
    boxes[1] += np.float32(1.7)
    valid = np.ones((2, len(rows)), bool)
    valid[0, 8] = False
    valid[1, :3] = False
    return boxes, valid


def _jax_pool(feats, boxes, valid, impl, sr=0):
    pool = jax.jit(lambda fs, b, v: jra.multilevel_roi_align(
        fs, b, v, STRIDES, 7, min_level=2, sampling_ratio=sr, impl=impl))
    return np.asarray(pool([jnp.asarray(f) for f in feats],
                           jnp.asarray(boxes), jnp.asarray(valid)))


def _torch_feats(feats, requires_grad=False):
    return [torch.tensor(f).permute(0, 3, 1, 2).contiguous()
            .requires_grad_(requires_grad) for f in feats]


def _port_pool(feats, boxes, valid, sr=0):
    """(B, P, out, out, C), the JAX package's layout."""
    out = tra.multilevel_roi_align(feats, torch.tensor(boxes),
                                   torch.tensor(valid), STRIDES, 7,
                                   min_level=2, sampling_ratio=sr)
    return out.permute(0, 1, 3, 4, 2)


def _weights(shape, seed=5):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_results():
    feats = _features(0)
    boxes, valid = _boxes()
    res = {"feats": feats, "boxes": boxes, "valid": valid}
    for impl, sr in POOLS:
        res[impl, sr] = _jax_pool(feats, boxes, valid, impl, sr)
    # the gradient of sum(pooled * w) through the dense path
    w = _weights(res["dense", 0].shape)
    fn = lambda *fs: jra.multilevel_roi_align(
        list(fs), jnp.asarray(boxes), jnp.asarray(valid), STRIDES, 7,
        min_level=2, impl="dense")
    grad = jax.jit(lambda fs, g: jax.vjp(fn, *fs)[1](g))
    res["grad"] = [np.asarray(g) for g in grad(
        [jnp.asarray(f) for f in feats], jnp.asarray(w))]
    res["w"] = w
    # the Pallas kernel, in interpret mode, on FPN-routed ROIs of image 0
    keep = np.asarray([0, 4, 5, 6, 8, 10])
    res["pallas_boxes"] = boxes[:, keep]
    res["pallas_valid"] = valid[:, keep]
    res["pallas"] = _jax_pool(feats, boxes[:, keep], valid[:, keep],
                              "pallas")
    return res


def test_assign_fpn_levels_matches_jax():
    rng = np.random.RandomState(3)
    xy = rng.rand(300, 2).astype(np.float32) * 500
    wh = np.exp(rng.rand(300, 2) * 7).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)
    side = np.asarray([112.0, 224.0, 448.0, 111.99, 224.01, 20.0, 2000.0],
                      np.float32)
    boxes = np.concatenate([boxes, np.stack(
        [np.zeros_like(side), np.zeros_like(side), side, side], 1)])
    got = tra.assign_fpn_levels(torch.tensor(boxes), 2, 5).numpy()
    want = np.asarray(jra.assign_fpn_levels(jnp.asarray(boxes), 2, 5))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[-7:], [3, 4, 5, 2, 4, 2, 5])


@pytest.mark.parametrize("impl,sr", POOLS)
def test_plain_k3_matches_jax(jax_results, impl, sr):
    r = jax_results
    got = _port_pool(_torch_feats(r["feats"]), r["boxes"], r["valid"], sr)
    want = r[impl, sr]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # invalid slots pool to zeros
    assert not got[torch.tensor(~r["valid"])].any()


def test_s_max_cap_is_hit():
    """The clamped 1200x900 box needs more than 4 samples per bin axis on
    p5; the geometry caps both at 4."""
    boxes, valid = _boxes()
    index, _ = tra.roi_geometry(torch.tensor(boxes), torch.tensor(valid),
                                STRIDES, 7, 2)
    assert index[7].tolist() == [0, 3, 4, 4]
    assert index[6].tolist() == [0, 3, 2, 2]
    assert index[8, 1] == -1


def test_plain_k3_gradient_matches_jax_vjp(jax_results):
    r = jax_results
    feats = _torch_feats(r["feats"], requires_grad=True)
    pooled = _port_pool(feats, r["boxes"], r["valid"])
    (pooled * torch.tensor(r["w"])).sum().backward()
    for f, want in zip(feats, r["grad"]):
        got = f.grad.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL * max(np.abs(want).max(), 1.0))


def test_plain_k3_matches_the_pallas_kernel(jax_results):
    r = jax_results
    got = _port_pool(_torch_feats(r["feats"]), r["pallas_boxes"],
                     r["pallas_valid"])
    np.testing.assert_allclose(got.numpy(), r["pallas"], rtol=0, atol=TOL)


def test_bfloat16_levels_pool_in_float32():
    """bfloat16 levels: the plain version reads them exactly, sums in
    float32, and rounds once at the end (compare with the float32 pooling
    of the same, already rounded, values)."""
    feats = [f.to(torch.bfloat16) for f in _torch_feats(_features(1))]
    boxes, valid = _boxes()
    index, coords = tra.roi_geometry(torch.tensor(boxes), torch.tensor(valid),
                                     STRIDES, 7, 2)
    f32 = tra.multilevel_roi_align_reference([f.float() for f in feats],
                                             index, coords, 7)
    unrounded = tra.multilevel_roi_align_reference(
        feats, index, coords, 7, out_dtype=torch.float32)
    rounded = tra.multilevel_roi_align_reference(feats, index, coords, 7)
    assert rounded.dtype == torch.bfloat16
    assert torch.equal(unrounded, f32)
    assert torch.equal(rounded, f32.to(torch.bfloat16))


def test_chunks_do_not_change_the_result():
    feats = _torch_feats(_features(2))
    boxes, valid = _boxes()
    index, coords = tra.roi_geometry(torch.tensor(boxes), torch.tensor(valid),
                                     STRIDES, 7, 2)
    whole = tra.multilevel_roi_align_reference(feats, index, coords, 7)
    chunked = tra.multilevel_roi_align_reference(feats, index, coords, 7,
                                                 roi_chunk=5)
    assert torch.equal(whole, chunked)


def test_wrappers_refuse_cpu_tensors():
    feats = _torch_feats(_features(0))
    boxes, valid = _boxes()
    index, coords = tra.roi_geometry(torch.tensor(boxes), torch.tensor(valid),
                                     STRIDES, 7, 2)
    before = tra.roi_align_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        tra.roi_align_fwd(feats, index, coords, 7)
    with pytest.raises(ValueError, match="CUDA"):
        tra.roi_align_bwd(torch.zeros(24, C, 7, 7), index, coords, feats)
    assert tra.roi_align_fwd.launches == before
