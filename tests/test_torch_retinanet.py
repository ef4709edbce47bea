"""RetinaNet inference of the PyTorch port against the JAX package's
``retinanet_inference`` on identical logits and deltas: per-level top-k,
score filter, decode, clip, class-aware NMS and the final top-k."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import retinanet_cfg

from lgd_tpu.models.heads import retinanet as jret
from lgd_tpu_torch.models.heads import retinanet as tret
from lgd_tpu_torch.ops.topk import topk_flat_pairs


def _sorted_valid(dets, b):
    """Valid detections of image b as rows (score, class, x1, y1, x2, y2),
    ordered by score then class: equal scores may sit in either order."""
    v = np.asarray(dets.valid[b])
    rows = np.concatenate([np.asarray(dets.scores[b])[v, None],
                           np.asarray(dets.classes[b])[v, None],
                           np.asarray(dets.boxes[b])[v]], axis=1)
    return rows[np.lexsort((rows[:, 1], -rows[:, 0]))]


@pytest.mark.parametrize("score_thresh", [0.05, 0.0])
def test_retinanet_inference_matches_jax(score_thresh):
    """Valid slots must match: classes exactly, scores to 1e-6 (sigmoid of
    the same float32 logits), boxes to 1e-3 px (exp in the decode may round
    differently in XLA and in PyTorch)."""
    cfg = retinanet_cfg(opts=["MODEL.RETINANET.SCORE_THRESH_TEST",
                              score_thresh])
    canvas = (128, 96)
    anchors, counts = jret.build_anchors(cfg, canvas)
    rng = np.random.RandomState(0)
    B, R, K = 2, anchors.shape[0], 80
    logits = (rng.randn(B, R, K) * 2 - 3).astype(np.float32)
    deltas = (rng.randn(B, R, 4) * 0.5).astype(np.float32)
    deltas[0, :5, 2:] = 10.0  # beyond SCALE_CLAMP
    sizes = np.asarray([[128, 96], [100, 70]], np.int32)

    want = jax.jit(lambda l, d, s: jret.retinanet_inference(
        cfg, l, d, anchors, counts, s))(logits, deltas, sizes)
    got = tret.retinanet_inference(
        cfg, torch.from_numpy(logits), torch.from_numpy(deltas),
        torch.from_numpy(anchors), counts, torch.from_numpy(sizes))

    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for b in range(B):
        g, w = _sorted_valid(got, b), _sorted_valid(want, b)
        assert len(w) == cfg.TEST.DETECTIONS_PER_IMAGE
        np.testing.assert_array_equal(g[:, 1], w[:, 1])
        np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(g[:, 2:], w[:, 2:], rtol=0, atol=1e-3)
        # clipped to the image
        assert (g[:, [2, 4]] <= sizes[b, 1]).all()
        assert (g[:, [3, 5]] <= sizes[b, 0]).all()


def test_build_anchors_matches_jax():
    cfg = retinanet_cfg()
    want, want_counts = jret.build_anchors(cfg, (96, 128))
    got, counts = tret.build_anchors(cfg, (96, 128))
    np.testing.assert_array_equal(got, want)
    assert counts == want_counts and counts[0] == 12 * 16 * 9


def test_topk_flat_pairs_matches_jax():
    from lgd_tpu.ops.topk import topk_flat_pairs as jtopk

    x = np.random.RandomState(3).randn(2, 500, 80).astype(np.float32)
    v_want, i_want = jtopk(x, 100)
    v, i = topk_flat_pairs(torch.from_numpy(x), 100)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_want))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_want))
    assert topk_flat_pairs(torch.from_numpy(x[:, :3, :5]), 100)[0].shape == (2, 15)


def test_head_emits_hwa_order():
    """(N, A*K, H, W) -> (N, H*W*A, K) is the flax head's NHWC reshape:
    row r holds position r // A, anchor r % A."""
    n, a, k, h, w = 2, 3, 4, 5, 6
    x = torch.arange(n * a * k * h * w, dtype=torch.float32).view(
        n, a * k, h, w)
    want = x.permute(0, 2, 3, 1).reshape(n, h * w * a, k)
    assert torch.equal(tret.permute_to_n_hwa_k(x, k), want)


def test_inference_finds_the_nms_sweep_when_it_is_called(monkeypatch):
    """Without ``keep_fn``, ``retinanet_inference`` calls the module's
    ``nms.greedy_keep_sorted`` as it stands at the call (as the R-CNN
    heads do), so a caller that swaps it for the plain sweep runs the
    plain sweep: the default no longer binds the kernel at import."""
    from lgd_tpu_torch.ops import nms

    cfg = retinanet_cfg(opts=["MODEL.RETINANET.TOPK_CANDIDATES_TEST", 50])
    anchors, counts = tret.build_anchors(cfg, (64, 64))
    rng = np.random.RandomState(1)
    logits = torch.from_numpy((rng.randn(1, anchors.shape[0], 80) - 3)
                              .astype(np.float32))
    deltas = torch.zeros((1, anchors.shape[0], 4))
    calls = []

    def plain(*args):
        calls.append(args[0].shape)
        return nms.greedy_keep_sorted_reference(*args)

    monkeypatch.setattr(nms, "greedy_keep_sorted", plain)
    dets = tret.retinanet_inference(cfg, logits, deltas,
                                    torch.from_numpy(anchors), counts,
                                    torch.tensor([[64, 64]]))
    assert len(calls) == 1 and dets.valid.any()
