"""The Faster R-CNN LGD path of the port (``lgd_tpu_torch/models/rcnn/`` and
``DistillatorGeneralizedRCNN``) against the JAX package at a small size:
R-18, a 64-channel FPN with the max-pool p6, one anchor size per level,
an 8-head teacher with the context box, MAX_INSTANCES 8, RPN top-k 200/100,
64 ROIs per image, 64-wide FCs, a 128x160 canvas, batch 2, float32.

The sample's uniforms are replayed: the keys that the student's two
``predict`` passes take from the JAX ``sampling`` stream are read from JAX
itself, the uniforms derived with the same splits, and handed to the port.

Tolerances, float32 on both sides with sums in other orders: module
outputs and losses within 1e-4 relative (1e-5 absolute where values are
near 0); proposals and detections compared as sets, each row matched to
the row of its class with the nearest box, boxes within BOX_TOL px and
scores within 1e-5 (1e-4 after the whole network); the composed
``train_forward``'s losses within 1e-4 relative, and each parameter's
gradient within GRAD_TOL of its tensor's largest magnitude. Two biases
have no gradient in exact arithmetic (``ZERO_GRADIENT``): both packages
give rounding noise there, held under 1e-8 of the model's largest
gradient.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_parity import (
    jax_model,
    random_weights,
    torch_instances,
    unflatten,
    variable_shapes,
)

from lgd_tpu.config import get_cfg
from lgd_tpu.config.cfg import FrozenCfg
from lgd_tpu.data import make_synthetic_batch
from lgd_tpu.models.rcnn import roi_heads as jroi
from lgd_tpu.models.rcnn import rpn as jrpn
from lgd_tpu_torch.models.distillator import build_model
from lgd_tpu_torch.models.rcnn import roi_heads as troi
from lgd_tpu_torch.models.rcnn import rpn as trpn
from lgd_tpu_torch.utils.param_bridge import flax_array, load_flax_weights

CANVAS = (128, 160)
B = 2
LOSSES = ("loss_box_reg", "loss_cls", "loss_rpn_cls", "loss_rpn_loc")
GRAD_TOL = 1e-4
BOX_TOL = 2e-3
# a per-channel constant that the next step removes: the adapter's last
# bias ahead of the distill loss's InstanceNorm, and the key bias, which
# shifts every logit of a query alike ahead of the softmax
ZERO_GRADIENT = ("params/adapter/conv2/bias",
                 "params/teacher/multi_head_attn/k_proj/bias")


def rcnn_cfg(opts=()):
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.META_ARCHITECTURE", "DistillatorGeneralizedRCNN",
        "MODEL.BACKBONE.NAME", "build_resnet_fpn_backbone",
        "MODEL.RESNETS.DEPTH", 18,
        "MODEL.RESNETS.OUT_FEATURES", ["res2", "res3", "res4", "res5"],
        "MODEL.FPN.IN_FEATURES", ["res2", "res3", "res4", "res5"],
        "MODEL.FPN.OUT_CHANNELS", 64,
        "MODEL.ANCHOR_GENERATOR.SIZES", [[32], [64], [128], [256], [512]],
        "MODEL.RPN.IN_FEATURES", ["p2", "p3", "p4", "p5", "p6"],
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200,
        "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100,
        "MODEL.RPN.PRE_NMS_TOPK_TEST", 200,
        "MODEL.RPN.POST_NMS_TOPK_TEST", 100,
        "MODEL.ROI_HEADS.IN_FEATURES", ["p2", "p3", "p4", "p5"],
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
        "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.0,
        "MODEL.ROI_BOX_HEAD.NUM_FC", 2,
        "MODEL.ROI_BOX_HEAD.FC_DIM", 64,
        "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", 7,
        "MODEL.DISTILLATOR.TEACHER.ADD_CONTEXT_BOX", True,
        "MODEL.DISTILLATOR.EVAL_TEACHER", False,
        "TPU.MAX_INSTANCES", 8,
        "TPU.COMPUTE_DTYPE", "float32",
        "OUTPUT_DIR", "",
        *opts])
    return cfg.freeze()


def jax_sampling_uniforms(key, R, pool):
    """The uniforms JAX draws from one ``predict``'s sampling key: the
    RPN's (B, R) from split(key)[0] split per image, then per image the
    ROI sample's and the slab order's (pool,) from the two halves of
    split(key)[1] split per image (rpn.py:127-131, roi_heads.py:109-122)."""
    r1, r2 = jax.random.split(key)
    rpn = jnp.stack([jax.random.uniform(k, (R,))
                     for k in jax.random.split(r1, B)])
    halves = [jax.random.split(k) for k in jax.random.split(r2, B)]
    sample = jnp.stack([jax.random.uniform(h[0], (pool,)) for h in halves])
    order = jnp.stack([jax.random.uniform(h[1], (pool,)) for h in halves])
    return {"rpn": np.asarray(rpn), "roi_sample": np.asarray(sample),
            "roi_order": np.asarray(order)}


def _nhwc(t):
    return jnp.asarray(t.permute(0, 2, 3, 1).numpy())


@pytest.fixture(scope="module")
def setup():
    """Both models on the same random weights, one batch, the JAX
    ``train_forward`` losses and gradients, JAX inference, the replayed
    uniforms, and random inputs for the module tests."""
    cfg = rcnn_cfg()
    jm = jax_model(cfg)
    flat = random_weights(variable_shapes(jm, CANVAS), seed=21)
    tm = load_flax_weights(build_model(cfg, dtype=torch.float32,
                                       device="cpu"), flat)
    batch = make_synthetic_batch(batch_size=B, canvas_hw=CANVAS,
                                 max_instances=8, seed=6)
    variables = unflatten(flat)
    key = jax.random.PRNGKey(5)
    args = (batch["image"], batch["image_size"], batch["gt"],
            jnp.float32(1.0), jnp.float32(100.0))

    def loss_fn(params):
        losses, norm = jm.apply({"params": params,
                                 "frozen": variables["frozen"]}, *args,
                                method=jm.train_forward,
                                rngs={"sampling": key})
        return sum(losses[k] for k in sorted(losses)), (losses, norm)

    (_, (losses, norm)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    dets = jax.jit(lambda v, im, s: jm.apply(v, im, s, method=jm.inference))(
        variables, batch["image"], batch["image_size"])
    # the student's two sampling keys, as its predict passes draw them
    keys = jm.apply(variables, method=lambda m: (
        m.student.make_rng("sampling"), m.student.make_rng("sampling")),
        rngs={"sampling": key})
    R = len(jrpn.rpn_anchors(cfg, CANVAS, cfg.MODEL.RPN.IN_FEATURES)[0])
    pool = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + 8
    uniforms = {name: jax_sampling_uniforms(k, R, pool)
                for name, k in zip(("student", "teacher"), keys)}
    return {"cfg": cfg, "jm": jm, "tm": tm, "flat": flat,
            "variables": variables, "batch": batch,
            "losses": {k: float(v) for k, v in losses.items()},
            "norm": float(norm), "grads": grads, "dets": dets,
            "uniforms": uniforms, "rng": np.random.RandomState(0)}


def _torch_batch(batch):
    return (torch.from_numpy(np.asarray(batch["image"])).permute(0, 3, 1, 2),
            torch.from_numpy(np.asarray(batch["image_size"])),
            torch_instances(batch["gt"]))


def _rows(boxes, scores, valid, extra=None):
    """The valid rows of one image as (score, [extra], box) sorted by
    descending score (stable)."""
    boxes, scores, valid = (np.asarray(a) for a in (boxes, scores, valid))
    cols = [scores[valid, None]]
    if extra is not None:
        cols.append(np.asarray(extra)[valid, None].astype(np.float32))
    rows = np.concatenate(cols + [boxes[valid]], 1)
    return rows[np.lexsort(rows.T[::-1])][::-1]


def assert_same_sets(got, want, atol=BOX_TOL, score_tol=1e-5):
    """Two sets of detections (rows of ``_rows``) are equal: the same count,
    and each row of ``got`` matches its own row of ``want``, the one of
    the same class (when rows carry one) with the nearest box, within
    tolerance. Near-equal scores may sort the two sets differently."""
    assert got.shape == want.shape, (got.shape, want.shape)
    box = slice(2, None) if got.shape[1] == 6 else slice(1, None)
    free = np.ones(len(want), bool)
    for row in got:
        cand = free.copy()
        if box.start == 2:
            cand &= want[:, 1] == row[1]
        assert cand.any(), row
        dist = np.where(cand, np.abs(want[:, box] - row[box]).max(1), np.inf)
        j = int(np.argmin(dist))
        assert dist[j] <= atol, (row, want[j])
        assert abs(want[j, 0] - row[0]) <= score_tol, (row, want[j])
        free[j] = False


def _pyramid(rng, C=64, levels=("p2", "p3", "p4", "p5", "p6")):
    out = {}
    for lvl in levels:
        s = 2 ** int(lvl[1])
        out[lvl] = rng.randn(B, -(-CANVAS[0] // s), -(-CANVAS[1] // s),
                             C).astype(np.float32)
    return out


def _torch_pyramid(feats):
    return {k: torch.from_numpy(v).permute(0, 3, 1, 2).contiguous()
            for k, v in feats.items()}


def test_rpn_head_and_anchors_match_jax(setup):
    cfg, rng = setup["cfg"], np.random.RandomState(1)
    feats = _pyramid(rng)
    jrpn_mod = jrpn.RPN(cfg=FrozenCfg(cfg), dtype=jnp.float32)
    jl, jd = jax.jit(jrpn_mod.apply)(
        {"params": setup["variables"]["params"]["student"]["rpn"]},
        {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        tl, td = setup["tm"].student.rpn(_torch_pyramid(feats))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-5)
    ja, jc = jrpn.rpn_anchors(cfg, CANVAS, cfg.MODEL.RPN.IN_FEATURES)
    ta, tc = trpn.rpn_anchors(cfg, CANVAS, cfg.MODEL.RPN.IN_FEATURES)
    np.testing.assert_array_equal(ta, ja)
    assert tc == jc


def _anchors(cfg):
    return jrpn.rpn_anchors(cfg, CANVAS, cfg.MODEL.RPN.IN_FEATURES)


def test_label_rpn_anchors_and_losses_match_jax(setup):
    """Anchor labels and matched boxes, the sample from replayed uniforms,
    and the RPN losses."""
    cfg, batch = setup["cfg"], setup["batch"]
    anchors, _ = _anchors(cfg)
    jl, jm = jax.jit(lambda gt: jrpn.label_rpn_anchors(cfg, anchors, gt))(
        batch["gt"])
    _, _, gt = _torch_batch(batch)
    tl, tm = trpn.label_rpn_anchors(cfg, torch.from_numpy(anchors), gt)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))

    rng = np.random.RandomState(2)
    logits = rng.randn(B, len(anchors), 1).astype(np.float32)
    deltas = (rng.randn(B, len(anchors), 4) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda *a: jrpn.rpn_losses(cfg, *a, anchors, key))(
        jnp.asarray(logits), jnp.asarray(deltas), jl, jm)
    rand = jnp.stack([jax.random.uniform(k, (len(anchors),))
                      for k in jax.random.split(key, B)])
    got = trpn.rpn_losses(cfg, torch.from_numpy(logits),
                          torch.from_numpy(deltas), tl, tm,
                          torch.from_numpy(anchors),
                          torch.from_numpy(np.asarray(rand)))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("n_pos", [0, 10, 300])
def test_subsample_labels_matches_jax(n_pos):
    """The same masks from the same uniforms: few, many and no
    positives, with ignored anchors."""
    labels = np.asarray([[1] * n_pos + [0] * 700 + [-1] * 100,
                         [0] * (700 + n_pos) + [-1] * 100])
    keys = jax.random.split(jax.random.PRNGKey(n_pos), 2)
    want = [jrpn.subsample_labels(jnp.asarray(l), 256, 0.5, k)
            for l, k in zip(labels, keys)]
    rand = np.stack([np.asarray(jax.random.uniform(k, labels.shape[1:]))
                     for k in keys])
    pos, neg = trpn.subsample_labels(torch.from_numpy(labels),
                                     torch.from_numpy(rand), 256, 0.5)
    for i, (wp, wn) in enumerate(want):
        np.testing.assert_array_equal(pos[i].numpy(), np.asarray(wp))
        np.testing.assert_array_equal(neg[i].numpy(), np.asarray(wn))
    assert int(pos[0].sum()) == min(n_pos, 128)
    assert int(neg[0].sum()) == 256 - min(n_pos, 128)


@pytest.mark.parametrize("training", [True, False])
def test_generate_proposals_match_jax(setup, training):
    cfg = setup["cfg"]
    anchors, counts = _anchors(cfg)
    rng = np.random.RandomState(3)
    logits = rng.randn(B, len(anchors), 1).astype(np.float32)
    deltas = (rng.randn(B, len(anchors), 4) * 0.2).astype(np.float32)
    sizes = np.asarray([CANVAS, (100, 130)], np.int32)
    jb, js, jv = jax.jit(lambda l, d, s: jrpn.generate_proposals(
        cfg, l, d, anchors, counts, s, training))(
        jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(sizes))
    tb, ts, tv = trpn.generate_proposals(
        cfg, torch.from_numpy(logits), torch.from_numpy(deltas),
        torch.from_numpy(anchors), counts, torch.from_numpy(sizes), training)
    assert tb.shape == tuple(jb.shape)
    for i in range(B):
        got = _rows(tb[i].numpy(), ts[i].numpy(), tv[i].numpy())
        assert len(got) > 20
        assert_same_sets(got, _rows(jb[i], js[i], jv[i]))


def _proposals(rng, n=100):
    xy = rng.rand(B, n, 2).astype(np.float32) * 120
    wh = rng.rand(B, n, 2).astype(np.float32) * 60 + 2
    valid = rng.rand(B, n) > 0.1
    return np.concatenate([xy, xy + wh], -1), valid


def test_label_and_sample_proposals_matches_jax(setup):
    """The slab from replayed uniforms: boxes, classes, matched GT and the
    foreground flags where the slab is valid."""
    cfg, batch = setup["cfg"], setup["batch"]
    props, pvalid = _proposals(np.random.RandomState(4))
    key = jax.random.PRNGKey(13)
    want = jax.jit(lambda *a: jroi.label_and_sample_proposals(cfg, *a))(
        jnp.asarray(props), jnp.asarray(pvalid), batch["gt"], key)
    pool = props.shape[1] + 8
    halves = [jax.random.split(k) for k in jax.random.split(key, B)]
    draw = lambda j: torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(h[j], (pool,))) for h in halves]))
    _, _, gt = _torch_batch(batch)
    got = troi.label_and_sample_proposals(
        cfg, torch.from_numpy(props), torch.from_numpy(pvalid), gt, draw(0),
        draw(1))
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert valid.sum() > 50
    for k in ("boxes", "classes", "matched_gt", "is_fg"):
        np.testing.assert_array_equal(got[k].numpy()[valid],
                                      np.asarray(want[k])[valid], err_msg=k)


def test_fast_rcnn_losses_match_jax(setup):
    cfg, batch = setup["cfg"], setup["batch"]
    props, pvalid = _proposals(np.random.RandomState(5))
    sampled = jax.jit(lambda *a: jroi.label_and_sample_proposals(cfg, *a))(
        jnp.asarray(props), jnp.asarray(pvalid), batch["gt"],
        jax.random.PRNGKey(1))
    rng = np.random.RandomState(6)
    S = cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
    scores = rng.randn(B, S, 81).astype(np.float32)
    deltas = (rng.randn(B, S, 320) * 0.5).astype(np.float32)
    want = jax.jit(lambda *a: jroi.fast_rcnn_losses(cfg, *a))(
        jnp.asarray(scores), jnp.asarray(deltas), sampled, batch["gt"])
    t_sampled = {k: torch.from_numpy(np.asarray(v)) for k, v in
                 sampled.items()}
    t_sampled["classes"] = t_sampled["classes"].long()
    t_sampled["matched_gt"] = t_sampled["matched_gt"].long()
    _, _, gt = _torch_batch(batch)
    got = troi.fast_rcnn_losses(cfg, torch.from_numpy(scores),
                                torch.from_numpy(deltas), t_sampled, gt)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_fast_rcnn_inference_matches_jax(setup):
    cfg = setup["cfg"]
    props, pvalid = _proposals(np.random.RandomState(7))
    rng = np.random.RandomState(8)
    scores = (rng.randn(B, props.shape[1], 81) * 2).astype(np.float32)
    deltas = (rng.randn(B, props.shape[1], 320) * 0.5).astype(np.float32)
    sizes = np.asarray([CANVAS, (110, 140)], np.int32)
    want = jax.jit(lambda *a: jroi.fast_rcnn_inference(cfg, *a))(
        *(jnp.asarray(a) for a in (scores, deltas, props, pvalid, sizes)))
    got = troi.fast_rcnn_inference(cfg, *(torch.from_numpy(a) for a in (
        scores, deltas, props, pvalid, sizes)))
    for i in range(B):
        assert_same_sets(
            _rows(got.boxes[i], got.scores[i], got.valid[i], got.classes[i]),
            _rows(want.boxes[i], want.scores[i], want.valid[i],
                  want.classes[i]))
    assert int(got.valid.sum()) == 2 * cfg.TEST.DETECTIONS_PER_IMAGE


def test_box_head_through_the_bridge_matches_jax(setup):
    """ROIAlign -> fc1 -> fc2 -> predictor on random p2-p5 features with
    the bridged weights: the port pools (C, 7, 7) and the flax head
    flattens (7, 7, C), so this holds fc1's reordered rows."""
    cfg = setup["cfg"]
    rng = np.random.RandomState(9)
    feats = _pyramid(rng, levels=("p2", "p3", "p4", "p5"))
    boxes, valid = _proposals(rng, 40)
    heads = jroi.StandardROIHeads(cfg=FrozenCfg(cfg), dtype=jnp.float32)
    js, jd = jax.jit(lambda *a: heads.apply(*a, method=heads.box_forward))(
        {"params": setup["variables"]["params"]["student"]["roi_heads"]},
        {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(boxes),
        jnp.asarray(valid))
    with torch.no_grad():
        ts, td = setup["tm"].student.roi_heads.box_forward(
            _torch_pyramid(feats), torch.from_numpy(boxes),
            torch.from_numpy(valid))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-5)
    fc1 = "params/student/roi_heads/box_head/fc1/kernel"
    back = flax_array(fc1, setup["tm"].state_dict()[
        "student.roi_heads.box_head.fc1.weight"].numpy(), setup["tm"])
    np.testing.assert_array_equal(back, setup["flat"][fc1])


@pytest.fixture(scope="module")
def port_forward(setup):
    """The port's train_forward on the batch with the replayed uniforms,
    and the gradients of the summed losses."""
    tm = setup["tm"]
    images, sizes, gt = _torch_batch(setup["batch"])
    uniforms = {name: {k: torch.from_numpy(v) for k, v in u.items()}
                for name, u in setup["uniforms"].items()}
    shapes = tm.sampling_shapes(B, CANVAS, gt.boxes.shape[1])
    assert {n: {k: tuple(v.shape) for k, v in u.items()}
            for n, u in uniforms.items()} == shapes
    tm.zero_grad(set_to_none=True)
    losses, norm = tm.train_forward(images, sizes, gt, 1.0,
                                    torch.tensor(100.0), uniforms)
    sum(losses[k] for k in sorted(losses)).backward()
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()
             if p.grad is not None}
    tm.zero_grad(set_to_none=True)
    return {k: float(v) for k, v in losses.items()}, float(norm), grads


def test_train_forward_matches_jax(setup, port_forward):
    """All nine losses ('.tea' and loss_distill included) with replayed
    draws; the normalizer passes through."""
    losses, norm, _ = port_forward
    want = setup["losses"]
    keys = sorted([*LOSSES, *(k + ".tea" for k in LOSSES), "loss_distill"])
    assert sorted(losses) == sorted(want) == keys
    for k in keys:
        np.testing.assert_allclose(losses[k], want[k], rtol=1e-4,
                                   err_msg=k)
    assert norm == setup["norm"] == 100.0


def test_train_forward_gradients_match_jax(setup, port_forward):
    _, _, grads = port_forward
    flat_grads = {"params/" + k: v for k, v in jax.tree_util.tree_map(
        np.asarray, _flatten(setup["grads"])).items()}
    tm = setup["tm"]
    from lgd_tpu_torch.utils.param_bridge import torch_key

    largest = max(np.abs(g).max() for g in flat_grads.values())
    checked = 0
    for key, want in flat_grads.items():
        got = grads.get(torch_key(key))
        scale = np.abs(want).max()
        if got is None:  # no gradient reached it in the port: none in JAX
            assert scale == 0, key
            continue
        got = flax_array(key, got.numpy(), tm)
        if key in ZERO_GRADIENT:
            assert max(np.abs(got).max(), scale) <= 1e-8 * largest, key
            continue
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_TOL * max(scale, 1e-12),
                                   err_msg=key)
        checked += 1
    assert checked > 100
    # the stem's gradient is computed (FREEZE_AT gates the update, not the
    # gradient), and the RPN and box heads have theirs
    for name in ("student.rpn.head.conv.weight",
                 "student.roi_heads.box_head.fc1.weight",
                 "teacher.refine_3.conv.weight"):
        assert grads[name].abs().max() > 0, name


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, name) if isinstance(v, dict) else {name: v})
    return out


def test_inference_matches_jax(setup):
    tm = setup["tm"]
    images, sizes, _ = _torch_batch(setup["batch"])
    got = tm.inference(images, sizes)
    want = setup["dets"]
    for i in range(B):
        assert_same_sets(
            _rows(got.boxes[i], got.scores[i], got.valid[i], got.classes[i]),
            _rows(want.boxes[i], want.scores[i], want.valid[i],
                  want.classes[i]), score_tol=1e-4)


def test_unported_options_raise():
    for opts, what in ((["MODEL.ROI_HEADS.NAME", "Res5ROIHeads"], "item 10"),
                       (["MODEL.BACKBONE.NAME", "build_resnet_backbone"],
                        "item 10")):
        with pytest.raises(NotImplementedError, match=what):
            build_model(rcnn_cfg(opts), dtype=torch.float32, device="cpu")


def test_cli_trains_the_rcnn_yaml_on_the_cpu(tmp_path):
    """``python -m lgd_tpu_torch.train`` on the in-package R-CNN YAML: two
    steps, then COCO evaluation with and without the teacher. Ten
    proposals per image keep the box head's NMS pool at 800 candidates:
    the plain NMS over the default pool of 2000 took most of the test."""
    from lgd_tpu_torch import train as ttrain

    yaml = os.path.join(os.path.dirname(ttrain.__file__), "configs",
                        "rcnn_R18_synthetic_mini.yaml")
    out = tmp_path / "out"
    argv = ["--config-file", yaml, "MODEL.DEVICE", "cpu",
            "SOLVER.MAX_ITER", "2", "INPUT.MIN_SIZE_TRAIN", "(64,)",
            "INPUT.MAX_SIZE_TRAIN", "96", "INPUT.MIN_SIZE_TEST", "64",
            "INPUT.MAX_SIZE_TEST", "96", "OUTPUT_DIR", str(out),
            "MODEL.RPN.POST_NMS_TOPK_TEST", "10",
            "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0"]
    res = ttrain.main(ttrain.default_argument_parser().parse_args(argv))
    assert np.isfinite(res["bbox"]["AP50"])
    state = torch.load(out / "model_final.pth", weights_only=True)
    assert "student.roi_heads.box_head.fc1.weight" in state
