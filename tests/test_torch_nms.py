"""Kernel K2's function in the PyTorch port (lgd_tpu_torch/ops/nms.py)
against the JAX package's NMS: the Pallas sweep in interpret mode (as
tests/test_ops.py runs it) at N <= 256, and the fixpoint iteration at the
inference pool size N = 2000. Keep masks must be equal exactly: both sides
do the same float32 IoU arithmetic and the same stable sort.

On the CPU the port's sweep is its plain version; the CUDA kernel itself is
held against that plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import jax
import numpy as np
import pytest
import torch

from lgd_tpu.ops import nms as jnms
from lgd_tpu_torch.ops import nms as tnms


def _boxes(rng, B, n, spread=64.0, size=30.0):
    ctr = rng.rand(B, n, 2) * spread
    wh = rng.rand(B, n, 2) * size + 2
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)


def _adversarial(rng, B, n):
    """Duplicate scores, duplicate boxes, invalid tails, one all-invalid
    image and a pair at IoU exactly 1/3."""
    boxes = _boxes(rng, B, n)
    scores = rng.rand(B, n).astype(np.float32)
    scores[:, 10:20] = scores[:, 5:6]              # duplicate-score group
    boxes[:, 30:35] = boxes[:, 29:30]              # exact duplicate boxes
    scores[:, 40:44] = 0.5                         # ... with tied scores too
    boxes[:, 40:44] = boxes[:, 39:40]
    boxes[:, 50] = [0.0, 0.0, 10.0, 10.0]          # IoU(50, 51) = 50 / 150
    boxes[:, 51] = [0.0, 5.0, 10.0, 15.0]
    scores[:, 50], scores[:, 51] = 2.0, 1.9
    valid = np.ones((B, n), bool)
    valid[0, n - n // 5:] = False                  # invalid tail
    valid[-1] = False                              # all invalid
    return boxes, scores, valid


def _jax_keep(boxes, scores, valid, thr, impl, classes=None):
    if classes is None:
        fn = lambda b, s, v: jnms.nms_mask(b, s, v, thr, impl=impl)  # noqa: E731
        return np.asarray(jax.vmap(fn)(boxes, scores, valid))
    fn = lambda b, s, c, v: jnms.batched_nms_mask(  # noqa: E731
        b, s, c, v, thr, impl=impl)
    return np.asarray(jax.vmap(fn)(boxes, scores, classes, valid))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


THIRD = float(np.float32(50.0) / np.float32(150.0))


@pytest.mark.parametrize("n,thr", [(100, 0.7), (256, 0.5), (256, THIRD)])
def test_nms_mask_matches_pallas_sweep(n, thr):
    rng = np.random.RandomState(n)
    boxes, scores, valid = _adversarial(rng, 3, n)
    want = _jax_keep(boxes, scores, valid, thr, "pallas")
    got = tnms.nms_mask(*_t(boxes, scores, valid), thr).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:-1].sum() > 0 and not got[-1].any()
    # IoU exactly at the threshold is not suppressed (strict >)
    assert got[1, 51] == (thr >= THIRD)


def test_batched_nms_mask_matches_pallas_sweep():
    rng = np.random.RandomState(3)
    boxes, scores, valid = _adversarial(rng, 2, 200)
    classes = rng.randint(0, 5, (2, 200)).astype(np.int32)
    want = _jax_keep(boxes, scores, valid, 0.5, "pallas", classes)
    got = tnms.batched_nms_mask(*_t(boxes, scores, classes, valid), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_nms_mask_matches_fixpoint_at_inference_size():
    """N = 2000 per image, the RetinaNet pre-NMS pool, with class offsets
    and a few valid-but-boxless padded slots."""
    rng = np.random.RandomState(4)
    B, n = 2, 2000
    boxes, scores, valid = _adversarial(rng, B, n)
    boxes = boxes * 12  # inference-scale coordinates
    classes = rng.randint(0, 80, (B, n)).astype(np.int32)
    want = _jax_keep(boxes, scores, valid, 0.5, "fixpoint", classes)
    got = tnms.batched_nms_mask(*_t(boxes, scores, classes, valid), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 100


def test_topk_detections_matches_jax():
    rng = np.random.RandomState(5)
    B, n, k = 2, 300, 100
    boxes = _boxes(rng, B, n)
    scores = rng.rand(B, n).astype(np.float32)
    classes = rng.randint(0, 80, (B, n)).astype(np.int64)
    keep = rng.rand(B, n) > 0.8  # fewer kept than k: padded outputs
    want = jax.vmap(lambda b, s, c, m: jnms.topk_detections(b, s, c, m, k))(
        boxes, scores, classes, keep)
    got = [g.numpy() for g in
           tnms.topk_detections(*_t(boxes, scores, classes, keep), k)]
    want = [np.asarray(w) for w in want]
    # scores and validity everywhere; boxes and classes where valid (the
    # padded slots hold whichever tied -1e10 entries each top-k picked)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[1], want[1])
    v = want[3]
    assert 0 < v.sum(axis=1).max() < k
    np.testing.assert_array_equal(got[0][v], want[0][v])
    np.testing.assert_array_equal(got[2][v], want[2][v])


def test_kernel_wrapper_takes_plain_version_only_on_cpu():
    """A tensor on any other device than the CPU never reaches the plain
    version: the wrapper launches the kernel or raises."""
    boxes = torch.empty((1, 8, 4), device="meta")
    valid = torch.empty((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tnms.greedy_keep_sorted(boxes, valid, 0.5)
