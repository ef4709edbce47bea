"""The dynamic teacher of the port against the JAX package, at a small size
(a 64-channel FPN, 8 heads, MAX_INSTANCES 8 plus the context slot, a
128x128 canvas, batch 2): descriptors, the label encoder and the teacher's
feature pyramid, on the same weights (carried across by the param bridge)
and the same random FPN features.

Tolerances, float32 on both sides: descriptors and masks are exact; the
label embeddings and the teacher features (convolutions, GroupNorm and
attention summed in other orders) within 1e-4 of each tensor's largest
magnitude.
"""

import jax
import numpy as np
import pytest
import torch
from torch_parity import (
    jax_model,
    random_weights,
    retinanet_cfg,
    torch_instances,
    unflatten,
    variable_shapes,
)

from lgd_tpu.models.lgd import label_encoder as jle
from lgd_tpu.structures import BatchedInstances as JaxInstances
from lgd_tpu_torch.models.distillator import build_model
from lgd_tpu_torch.models.lgd import label_encoder as tle
from lgd_tpu_torch.utils.param_bridge import load_flax_weights

CANVAS = (128, 128)
LEVELS = {"p3": 16, "p4": 8, "p5": 4, "p6": 2, "p7": 1}


def _close(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1.0),
                               err_msg=what)


@pytest.fixture(scope="module")
def setup():
    cfg = retinanet_cfg(opts=["MODEL.FPN.OUT_CHANNELS", 64,
                              "TPU.MAX_INSTANCES", 8])
    jm = jax_model(cfg)
    flat = random_weights(variable_shapes(jm), seed=5)
    tm = load_flax_weights(build_model(cfg, dtype=torch.float32,
                                       device="cpu"), flat)
    rng = np.random.RandomState(7)
    boxes = [np.asarray([[10.0, 12.0, 60.0, 50.0], [30.0, 40.0, 127.0, 90.0],
                         [0.0, 0.0, 20.0, 128.0]], np.float32),
             np.zeros((0, 4), np.float32)]  # image 1 has no GT
    gt = JaxInstances.from_lists(boxes, [np.asarray([3, 17, 79]),
                                         np.zeros(0, np.int64)], capacity=8)
    feats = {k: rng.randn(2, s, s, 64).astype(np.float32)
             for k, s in LEVELS.items()}
    return cfg, jm, unflatten(flat), tm, gt, feats


def test_encode_descriptors_match_jax(setup):
    *_, gt, _ = setup
    want = jle.encode_descriptors(gt, CANVAS, 80, add_context_box=True)
    got = tle.encode_descriptors(torch_instances(gt), CANVAS, 80,
                                 add_context_box=True)
    for name, a, b in zip(("desc", "token_valid", "boxes"), got, want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    desc, valid, boxes = (t.numpy() for t in got)
    assert desc.shape == (2, 9, 84)
    # image 0: three instances and the context slot; image 1: the fallback
    # slot only (no context slot without GT)
    assert valid[0].tolist() == [True] * 3 + [False] * 5 + [True]
    assert valid[1].tolist() == [True] + [False] * 8
    np.testing.assert_array_equal(boxes[0, 8], [0, 0, 127, 127])
    np.testing.assert_array_equal(boxes[1, 0], [0, 0, 1, 1])
    np.testing.assert_array_equal(desc[1, 0, 4:], -1.0)  # all-zero one-hot


def test_label_encoder_matches_jax(setup):
    cfg, jm, variables, tm, gt, _ = setup
    desc, valid, _, _ = jle.encode_descriptors(gt, CANVAS, 80, True)
    enc = jle.LabelEncoder(num_classes=80)
    want = enc.apply({"params": variables["params"]["teacher"]
                      ["label_encoder_"]}, desc, valid)
    with torch.no_grad():
        got = tm.teacher.label_encoder_(torch.tensor(np.asarray(desc)),
                                        torch.tensor(np.asarray(valid)))
    _close(got.numpy(), want, 1e-4, "label embeddings")


def test_dynamic_teacher_matches_jax(setup):
    cfg, jm, variables, tm, gt, feats = setup
    want, want_masks, want_valid = jax.jit(
        lambda v, g, f: jm.apply(v, g, f, CANVAS,
                                 method=lambda m, g, f, hw: m.teacher(
                                     g, f, hw)))(variables, gt, feats)
    with torch.no_grad():
        got, masks, valid = tm.teacher(
            torch_instances(gt),
            {k: torch.from_numpy(v).permute(0, 3, 1, 2)
             for k, v in feats.items()}, CANVAS)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    assert sorted(got) == sorted(LEVELS)
    for k in LEVELS:
        np.testing.assert_array_equal(masks[k].numpy(),
                                      np.asarray(want_masks[k]), err_msg=k)
        _close(got[k].permute(0, 2, 3, 1).numpy(), want[k], 1e-4, k)
