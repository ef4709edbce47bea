"""The anchor-free LGD slice of the port (FCOS, ATSS and POTO:
``lgd_tpu_torch/models/heads/{fcos,atss,poto}.py``,
``lgd_tpu_torch/ops/hungarian.py`` and their distillators) against the
JAX package at a small size: R-18 with res3-res5 in, a 64-channel FPN
(GroupNorm(32) then has 2 channels a group), an 8-head teacher with the
context box, MAX_INSTANCES 8, a 64x96 canvas, batch 2, float32. Inputs
and weights come from numpy seeds; the weights are carried by the bridge.

Tolerances, float32 on both sides:
- GroupNorm within 1e-5 relative to the largest value: flax takes the
  variance as E[x^2] - E[x]^2, torch in two passes, and the two agree to
  a few float32 ulps where the mean is small against the spread; bf16
  outputs within one bf16 ulp more. ``Scale`` exactly.
- Head outputs within 1e-4 relative (1e-5 absolute): convolutions sum in
  other orders.
- Ground truth: classes and distances exactly, centerness within 1e-6.
- ``iou_loss`` within 1e-6 relative.
- Detections as sets: the same count, each row matched to the row of its
  class with the nearest box, boxes within 1e-3 px, scores within 1e-6
  (1e-4 after the whole network).
- The assignment: equal total quality within 1e-5 and the same assigned
  rows (tied optima may pick other columns).
- ``train_forward``'s losses within 1e-4 relative (they agree to about
  3e-7). FCOS's gradients: within GRAD_TOL of each tensor's largest
  magnitude, plus JITTER_FACTOR times how far the port's own gradient
  moves when every weight is scaled by 1 + 1e-7 N(0, 1), about one
  float32 rounding. The GroupNorm towers normalize groups of 2 channels
  (64 / 32), at p6 and p7 over 1x2 and 1x1 maps, and divide by those
  groups' small spreads: rounding in the forward then moves the trunk's
  and the adapter's gradients by up to 2.7e-4 of their largest value
  (top_p7, fed only through the 1x1 p7, by 4.3e-3), and the JAX
  package's differ from the port's by up to 1.3e-3 (4.4e-3), within 11
  times that jitter everywhere; the head's own gradients agree within
  3e-5. The two biases of ``ZERO_GRADIENT`` have no gradient in exact
  arithmetic and are held under 1e-8 of the largest gradient plus the
  same multiple of their jitter: the port's instance norm over p6's two
  values leaves 1.4e-7 of the largest gradient on the adapter's last
  bias, JAX's 1.4e-11.
  That the gap is float32 rounding is shown by
  ``tests/torch_float64_grads.py fcos``, which computes this fixture's
  gradient in one precision on both sides: in float32 the worst gap is
  4.39e-3 of the tensor's peak (top_p7's bias; the trunk 1.16e-3, the
  adapter 1.30e-3, the head 3.3e-5, the teacher 1.2e-5), in float64
  1.62e-11 (top_p7's kernel; every other tensor 4.8e-13 or less). The gap
  falls by the ratio of the two precisions' rounding, so no port fault
  lies under it.
"""

import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    jax_model,
    random_weights,
    torch_instances,
    unflatten,
    variable_shapes,
)

import chip_smoke
from lgd_tpu.config import get_cfg
from lgd_tpu.data import make_synthetic_batch
from lgd_tpu.models import layers as jlayers
from lgd_tpu.models.heads import atss as jatss
from lgd_tpu.models.heads import fcos as jfcos
from lgd_tpu.models.heads import poto as jpoto
from lgd_tpu.ops import hungarian as jhungarian
from lgd_tpu.ops import losses as jlosses
from lgd_tpu.structures import BatchedInstances as JaxInstances
from lgd_tpu_torch.models import layers as tlayers
from lgd_tpu_torch.models.distillator import build_model
from lgd_tpu_torch.models.heads import atss as tatss
from lgd_tpu_torch.models.heads import fcos as tfcos
from lgd_tpu_torch.models.heads import poto as tpoto
from lgd_tpu_torch.ops import hungarian as thungarian
from lgd_tpu_torch.ops import losses as tlosses
from lgd_tpu_torch.utils import param_bridge, weight_convert
from lgd_tpu_torch.utils.param_bridge import flax_array, load_flax_weights

CANVAS = (64, 96)
B = 2
GRAD_TOL = 1e-4
JITTER_FACTOR = 20
ZERO_GRADIENT = ("params/adapter/conv2/bias",
                 "params/teacher/multi_head_attn/k_proj/bias")
LOSSES = {"DistillatorFCOS": ("loss_box_reg", "loss_centerness", "loss_cls"),
          "DistillatorATSS": ("loss_box_reg", "loss_centerness", "loss_cls"),
          "DistillatorPOTO": ("loss_box_reg", "loss_cls")}


def fcos_cfg(arch="DistillatorFCOS", opts=()):
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.META_ARCHITECTURE", arch,
        "MODEL.RESNETS.DEPTH", 18,
        "MODEL.RESNETS.OUT_FEATURES", ["res3", "res4", "res5"],
        "MODEL.FPN.IN_FEATURES", ["res3", "res4", "res5"],
        "MODEL.FPN.OUT_CHANNELS", 64,
        "MODEL.DISTILLATOR.TEACHER.ADD_CONTEXT_BOX", True,
        "MODEL.DISTILLATOR.EVAL_TEACHER", False,
        "TPU.MAX_INSTANCES", 8,
        "TPU.COMPUTE_DTYPE", "float32",
        "OUTPUT_DIR", "",
        *opts])
    return cfg.freeze()


def _torch_batch(batch):
    return (torch.from_numpy(np.asarray(batch["image"])).permute(0, 3, 1, 2),
            torch.from_numpy(np.asarray(batch["image_size"])),
            torch_instances(batch["gt"]))


def _models(arch, opts, seed, flat=None):
    """Both packages' models on the same random weights (``flat``, else
    drawn for the model's variables) and a synthetic batch."""
    cfg = fcos_cfg(arch, opts)
    jm = jax_model(cfg)
    if flat is None:
        flat = random_weights(variable_shapes(jm, CANVAS), seed=seed)
    tm = load_flax_weights(build_model(cfg, dtype=torch.float32,
                                       device="cpu"), flat)
    batch = make_synthetic_batch(batch_size=B, canvas_hw=CANVAS,
                                 max_instances=8, seed=seed)
    return cfg, jm, tm, flat, unflatten(flat), batch


def _train_args(batch):
    return (batch["image"], batch["image_size"], batch["gt"],
            jnp.float32(1.0), jnp.float32(100.0))


@pytest.fixture(scope="module")
def fcos():
    """The FCOS models on the same weights, the JAX ``train_forward``
    losses and gradients (the file's one gradient compile), and the
    port's."""
    cfg, jm, tm, flat, variables, batch = _models("DistillatorFCOS", (), 31)
    args = _train_args(batch)

    def loss_fn(params):
        losses, norm = jm.apply({"params": params,
                                 "frozen": variables["frozen"]}, *args,
                                method=jm.train_forward)
        return sum(losses[k] for k in sorted(losses)), (losses, norm)

    (_, (losses, norm)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    images, sizes, gt = _torch_batch(batch)

    def port_step(model):
        losses, norm = model.train_forward(images, sizes, gt, 1.0,
                                           torch.tensor(100.0))
        sum(losses[k] for k in sorted(losses)).backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()
                 if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return {k: float(v) for k, v in losses.items()}, float(norm), grads

    t_losses, t_norm, t_grads = port_step(tm)
    saved = copy.deepcopy(tm.state_dict())
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tm.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g))
    jitter = {k: (v - t_grads[k]).abs().max().item()
              for k, v in port_step(tm)[2].items()}
    tm.load_state_dict(saved)
    return {"cfg": cfg, "jm": jm, "tm": tm, "flat": flat,
            "variables": variables, "batch": batch,
            "losses": {k: float(v) for k, v in losses.items()},
            "norm": float(norm), "grads": grads, "t_losses": t_losses,
            "t_norm": t_norm, "t_grads": t_grads, "jitter": jitter}


# --- layers, boxes and losses ----------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_and_scale_match_flax(dtype):
    """GroupNorm32 on a conv-like output (bf16 in, float32 inside, bf16
    out on the student path) and Scale in the input's dtype."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 64, 5, 7) * 3 + 0.5).astype(np.float32)
    scale = (rng.rand(64) + 0.5).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt)
    gn = jlayers.GroupNorm32(64)
    want = gn.apply({"params": {"GroupNorm_0": {"scale": scale,
                                                "bias": bias}}}, x_nhwc)
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2)
    tgn = tlayers.get_norm("GN", 64)
    with torch.no_grad():
        tgn.scale.copy_(torch.from_numpy(scale))
        tgn.bias.copy_(torch.from_numpy(bias))
        got = tgn(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    peak = np.abs(want).max()
    ulp = 2.0 ** -7 * np.abs(want) if dtype == "bfloat16" else 0.0
    assert np.all(np.abs(got.float().numpy() - want) <= 1e-5 * peak + ulp)

    s = jlayers.Scale()
    want = s.apply({"params": {"scale": jnp.float32(0.7)}}, x_nhwc)
    ts = tlayers.Scale(1.0)
    with torch.no_grad():
        ts.scale.fill_(0.7)
        got = ts(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and ts.scale.shape == ()
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2))


def test_shift_transform_and_centers_match_jax():
    from lgd_tpu.structures import Shift2BoxTransform as JT
    from lgd_tpu.structures import boxes as jboxes
    from lgd_tpu_torch.structures import Shift2BoxTransform as TT
    from lgd_tpu_torch.structures import centers

    rng = np.random.RandomState(1)
    shifts = (rng.rand(7, 2) * 50).astype(np.float32)
    xy = rng.rand(3, 2) * 40
    boxes = np.concatenate([xy, xy + rng.rand(3, 2) * 30 + 1],
                           -1).astype(np.float32)
    w = (1.0, 2.0, 0.5, 1.5)
    want = JT(w).get_deltas(shifts[None], boxes[:, None])
    got = TT(w).get_deltas(torch.from_numpy(shifts)[None],
                           torch.from_numpy(boxes)[:, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = TT(w).apply_deltas(got, torch.from_numpy(shifts)[None])
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JT(w).apply_deltas(want, shifts[None])))
    np.testing.assert_array_equal(centers(torch.from_numpy(boxes)).numpy(),
                                  np.asarray(jboxes.centers(boxes)))


@pytest.mark.parametrize("loss_type", ["iou", "linear_iou", "giou"])
def test_iou_loss_matches_jax(loss_type):
    """Both box modes, with and without smoothing and weight, on boxes
    that overlap, nest, touch and miss (negative ltrb distances too)."""
    rng = np.random.RandomState(2)
    pred = (rng.randn(64, 4) * 20).astype(np.float32)
    target = (rng.randn(64, 4) * 20).astype(np.float32)
    target[:8] = pred[:8]  # identical boxes
    weight = rng.rand(64).astype(np.float32)
    for mode in ("ltrb", "xyxy"):
        for smooth in (False, True):
            kw = dict(box_mode=mode, loss_type=loss_type, smooth=smooth)
            want = jlosses.iou_loss(pred, target, weight=weight, **kw)
            got = tlosses.iou_loss(torch.from_numpy(pred),
                                   torch.from_numpy(target),
                                   weight=torch.from_numpy(weight), **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tlosses.iou_loss(torch.zeros(1, 4), torch.zeros(1, 4),
                         loss_type="smooth_l1")


# --- heads -------------------------------------------------------------


def _pyramid(rng, C=64):
    return [rng.randn(B, C, -(-CANVAS[0] // s), -(-CANVAS[1] // s))
            .astype(np.float32) for s in (8, 16, 32, 64, 128)]


def test_fcos_head_outputs_match_jax(fcos):
    """GroupNorm towers, the Scales and the centerness branch through
    ``predict`` on random p3-p7."""
    jm, tm = fcos["jm"], fcos["tm"]
    feats = _pyramid(np.random.RandomState(3))
    want = jax.jit(lambda v, f: jm.apply(
        v, f, method=lambda m, f: m.student.predict(f)))(
        fcos["variables"], [jnp.asarray(f.transpose(0, 2, 3, 1))
                            for f in feats])
    with torch.no_grad():
        got = tm.student.predict([torch.from_numpy(f) for f in feats])
    assert len(got) == 3
    for g, w, name in zip(got, want, ("logits", "deltas", "centerness")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _gt(boxes_list, classes_list, capacity=8):
    jgt = JaxInstances.from_lists([np.asarray(b, np.float32)
                                   for b in boxes_list],
                                  [np.asarray(c) for c in classes_list],
                                  capacity)
    return jgt, torch_instances(jgt)


GT_CANVAS = (128, 192)
# nested boxes of equal area (the first wins), a box on each level's size
# range, a box whose center lies midway between grid points (ATSS's
# equidistant candidates), a thin box, and an empty image
GT_BOXES = ([[8, 8, 24, 24], [8, 8, 24, 24], [40, 30, 120, 110],
             [4, 60, 68, 124], [100, 10, 190, 100], [60, 40, 76, 56],
             [130, 100, 180, 104]], [])
GT_CLASSES = ([3, 7, 11, 0, 79, 5, 2], [])


@pytest.mark.parametrize("radius", [1.5, 0.0])
def test_fcos_ground_truth_matches_jax(radius):
    cfg = fcos_cfg(opts=["MODEL.FCOS.CENTER_SAMPLING_RADIUS", radius])
    shifts, counts, strides, lo, hi = jfcos.build_shifts(cfg, GT_CANVAS)
    t_shifts = tfcos.build_shifts(cfg, GT_CANVAS)
    for a, b in zip(t_shifts, (shifts, counts, strides, lo, hi)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jgt, tgt = _gt(GT_BOXES, GT_CLASSES)
    want = jax.jit(lambda g: jfcos.fcos_ground_truth(
        cfg, shifts, strides, lo, hi, g))(jgt)
    got = tfcos.fcos_ground_truth(
        cfg, *(torch.from_numpy(a) for a in (shifts, strides, lo, hi)), tgt)
    _assert_targets(got, want)
    # of the two equal boxes, the first takes every shift
    assert (got[0][0] == 3).any() and not (got[0][0] == 7).any()


def _assert_targets(got, want):
    cls, deltas = got[0], got[1]
    np.testing.assert_array_equal(cls.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(deltas.numpy(), np.asarray(want[1]))
    if len(got) == 3:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=0, atol=1e-6)
    assert (cls[0] != 80).sum() > 3 and (cls[1] == 80).all()


def test_atss_ground_truth_matches_jax():
    """Equidistant candidates on the grid must resolve as lax.top_k does:
    the lower index first."""
    cfg = fcos_cfg("DistillatorATSS")
    shifts, counts, strides, *_ = jfcos.build_shifts(cfg, GT_CANVAS)
    jgt, tgt = _gt(GT_BOXES, GT_CLASSES)
    want = jax.jit(lambda g: jatss.atss_ground_truth(
        cfg, shifts, counts, strides, g))(jgt)
    got = tatss.atss_ground_truth(cfg, torch.from_numpy(shifts), counts,
                                  torch.from_numpy(strides), tgt)
    _assert_targets(got, want)
    # the 16-px box centered at (16, 16) has 4 nearest p3 shifts at equal
    # distance, and its candidate set cuts through further equal ones
    d = np.hypot(*(shifts[:counts[0]] - 16.0).T)
    assert np.sort(d)[8] == np.sort(d)[9]


def _poto_preds(rng, R):
    logits = (rng.randn(B, R, 80) * 2 - 1).astype(np.float32)
    deltas = (rng.rand(B, R, 4) * 40).astype(np.float32)
    return logits, deltas


@pytest.mark.parametrize("radius", [1.5, 0.0])
def test_poto_ground_truth_greedy_matches_jax(radius):
    cfg = fcos_cfg("DistillatorPOTO", ["MODEL.POTO.ASSIGNMENT", "greedy",
                                       "MODEL.POTO.CENTER_SAMPLING_RADIUS",
                                       radius])
    shifts, counts, strides, *_ = jfcos.build_shifts(cfg, GT_CANVAS)
    logits, deltas = _poto_preds(np.random.RandomState(4), len(shifts))
    jgt, tgt = _gt(GT_BOXES, GT_CLASSES)
    want = jax.jit(lambda g, l, d: jpoto.poto_ground_truth(
        cfg, shifts, strides, g, l, d))(jgt, logits, deltas)
    got = tpoto.poto_ground_truth(cfg, torch.from_numpy(shifts),
                                  torch.from_numpy(strides), tgt,
                                  torch.from_numpy(logits),
                                  torch.from_numpy(deltas))
    _assert_targets(got, want)
    assert 5 <= (got[0][0] != 80).sum() <= 7  # at most one shift a GT
    with pytest.raises(ValueError, match="ASSIGNMENT"):
        tpoto.poto_ground_truth(
            fcos_cfg("DistillatorPOTO", ["MODEL.POTO.ASSIGNMENT", "auction"]),
            torch.from_numpy(shifts), torch.from_numpy(strides), tgt,
            torch.from_numpy(logits), torch.from_numpy(deltas))


# --- the one-to-one assignment -----------------------------------------


def _assignment_cases():
    rng = np.random.RandomState(5)
    cases = []
    for M, R in ((4, 6), (6, 10), (8, 8), (5, 30)):
        q = rng.rand(M, R).astype(np.float32)
        q[rng.rand(M, R) < 0.6] = -1e8
        q[0] = -1e8  # a row with nothing feasible
        q[1:3, 0] = np.float32(0.5)  # rows that compete for one column
        cases.append(q)
    # POTO's scale: 100 GT rows, 30 of them valid, each feasible on a
    # center region of 3x3 shifts on each of 3 levels of 22,400 columns
    q = np.full((100, 22400), -1e8, np.float32)
    for r in range(30):
        for base, width in ((0, 168), (16800, 84), (21000, 42)):
            x, y = rng.randint(1, width - 2), rng.randint(1, 20)
            cols = base + (y + np.arange(-1, 2))[:, None] * width + (
                x + np.arange(-1, 2))
            q[r, cols.ravel()] = rng.rand(9)
    cases.append(q)
    return cases


def test_max_quality_assignment_matches_jax():
    """The host solver against JAX's on-device one: the same total quality
    and the same assigned rows, one column per row."""
    for q in _assignment_cases():
        want = np.asarray(jax.jit(jhungarian.max_quality_assignment)(q))
        got = thungarian.max_quality_assignment(torch.from_numpy(q)).numpy()
        np.testing.assert_array_equal(got >= 0, want >= 0)
        rows = np.nonzero(got >= 0)[0]
        assert len(set(got[rows])) == len(rows)
        assert (q[rows, got[rows]] > -5e7).all()
        np.testing.assert_allclose(q[rows, got[rows]].sum(dtype=np.float64),
                                   q[rows, want[rows]].sum(dtype=np.float64),
                                   rtol=0, atol=1e-5)
    assert len(rows) == 30
    batched = thungarian.max_quality_assignment(
        torch.from_numpy(np.stack([q, q[::-1].copy()])))
    np.testing.assert_array_equal(batched[0].numpy(), got)
    np.testing.assert_array_equal(batched[1].numpy(), got[::-1])


# --- inference ---------------------------------------------------------


def _rows(dets, b):
    v = np.asarray(dets.valid[b])
    return np.concatenate([np.asarray(dets.scores[b])[v, None],
                           np.asarray(dets.classes[b])[v, None],
                           np.asarray(dets.boxes[b])[v]], axis=1)


def assert_same_sets(got, want, box_tol=1e-3, score_tol=1e-6):
    """Equal as sets: each row of got matched to its own row of want, of
    the same class, with the nearest box."""
    assert got.shape == want.shape, (got.shape, want.shape)
    free = np.ones(len(want), bool)
    for row in got:
        cand = free & (want[:, 1] == row[1])
        dist = np.where(cand, np.abs(want[:, 2:] - row[2:]).max(1), np.inf)
        j = int(np.argmin(dist))
        assert dist[j] <= box_tol and abs(want[j, 0] - row[0]) <= score_tol, (
            row, want[j])
        free[j] = False


INFER_CANVAS = (128, 160)


def _head_outputs(rng, R):
    return ((rng.randn(B, R, 80) * 2 - 2).astype(np.float32),
            (rng.rand(B, R, 4) * 60).astype(np.float32),
            rng.randn(B, R, 1).astype(np.float32))


def test_fcos_inference_matches_jax():
    """Per-level top-k, sqrt(cls * ctr), the pre-NMS top 2000 of about
    2,700 candidates, class-aware NMS and the top 100, as sets."""
    cfg = fcos_cfg()
    shifts, counts, *_ = jfcos.build_shifts(cfg, INFER_CANVAS)
    logits, deltas, ctr = _head_outputs(np.random.RandomState(6),
                                        len(shifts))
    sizes = np.asarray([INFER_CANVAS, (100, 130)], np.int32)
    want = jax.jit(lambda l, d, c, s: jfcos.fcos_inference(
        cfg, l, d, c, shifts, counts, s))(logits, deltas, ctr, sizes)
    got = tfcos.fcos_inference(cfg, *(torch.from_numpy(a) for a in (
        logits, deltas, ctr, shifts)), counts, torch.from_numpy(sizes))
    for b in range(B):
        assert got.valid[b].sum() == 100
        assert_same_sets(_rows(got, b), _rows(want, b))


@pytest.mark.parametrize("nms_type", ["normal", "null"])
def test_poto_inference_matches_jax(nms_type):
    cfg = fcos_cfg("DistillatorPOTO", ["MODEL.NMS_TYPE", nms_type])
    shifts, counts, *_ = jfcos.build_shifts(cfg, INFER_CANVAS)
    logits, deltas, _ = _head_outputs(np.random.RandomState(7), len(shifts))
    sizes = np.asarray([INFER_CANVAS, (90, 160)], np.int32)
    want = jax.jit(lambda l, d, s: jpoto.poto_inference(
        cfg, l, d, shifts, counts, s))(logits, deltas, sizes)
    got = tpoto.poto_inference(cfg, *(torch.from_numpy(a) for a in (
        logits, deltas, shifts)), counts, torch.from_numpy(sizes))
    for b in range(B):
        assert got.valid[b].sum() == 100
        assert_same_sets(_rows(got, b), _rows(want, b))


def test_distillator_inference_matches_jax(fcos):
    """The whole FCOS model's inference on the batch: normalize, ResNet,
    FPN, GroupNorm head, decode and NMS."""
    jm, tm, batch = fcos["jm"], fcos["tm"], fcos["batch"]
    want = jax.jit(lambda v, x, s: jm.apply(v, x, s, method=jm.inference))(
        fcos["variables"], batch["image"], batch["image_size"])
    images, sizes, _ = _torch_batch(batch)
    got = tm.inference(images, sizes)
    for b in range(B):
        assert_same_sets(_rows(got, b), _rows(want, b), box_tol=1e-2,
                         score_tol=1e-4)


# --- train_forward -----------------------------------------------------


def test_fcos_train_forward_matches_jax(fcos):
    keys = sorted([*LOSSES["DistillatorFCOS"],
                   *(k + ".tea" for k in LOSSES["DistillatorFCOS"]),
                   "loss_distill"])
    assert sorted(fcos["t_losses"]) == sorted(fcos["losses"]) == keys
    for k in keys:
        np.testing.assert_allclose(fcos["t_losses"][k], fcos["losses"][k],
                                   rtol=1e-4, err_msg=k)
    assert fcos["t_norm"] == fcos["norm"] == 100.0


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, name) if isinstance(v, dict) else {name: v})
    return out


def test_fcos_train_forward_gradients_match_jax(fcos):
    """Every parameter's gradient, the head's GroupNorms and Scales
    among them (the tolerance: the module's docstring)."""
    grads, tm, jitter = fcos["t_grads"], fcos["tm"], fcos["jitter"]
    flat_grads = {"params/" + k: np.asarray(v)
                  for k, v in _flatten(fcos["grads"]).items()}
    largest = max(np.abs(g).max() for g in flat_grads.values())
    checked = 0
    for key, want in flat_grads.items():
        name = param_bridge.torch_key(key)
        got = grads.get(name)
        scale = np.abs(want).max()
        if got is None:
            assert scale == 0, key
            continue
        got = flax_array(key, got.numpy(), tm)
        noise = JITTER_FACTOR * jitter[name]
        if key in ZERO_GRADIENT:
            assert max(np.abs(got).max(), scale) <= 1e-8 * largest + noise, key
            continue
        np.testing.assert_allclose(
            got, want, rtol=0, err_msg=key,
            atol=GRAD_TOL * max(scale, 1e-12) + noise)
        checked += 1
    assert checked > 100
    for name in ("student.head.cls_gn_0.scale", "student.head.bbox_gn_3.bias",
                 "student.head.scale_0.scale", "student.head.centerness.weight",
                 "student.fpn.top_p6.weight"):
        assert grads[name].abs().max() > 0, name


@pytest.mark.parametrize("arch,opts", [
    ("DistillatorATSS", ()),
    ("DistillatorPOTO", ("MODEL.POTO.ASSIGNMENT", "greedy"))],
    ids=["ATSS", "POTO"])
def test_train_forward_matches_jax(fcos, arch, opts):
    """The ATSS and POTO losses, '.tea' and loss_distill included, on the
    FCOS model's weights (POTO's without the centerness branch); POTO's
    assignment greedy on both sides, so that tied optima cannot part
    them."""
    flat = {k: v for k, v in fcos["flat"].items()
            if arch != "DistillatorPOTO" or "/head/centerness/" not in k}
    cfg, jm, tm, flat, variables, batch = _models(arch, opts, 32, flat)
    want, norm = jax.jit(lambda v, *a: jm.apply(
        v, *a, method=jm.train_forward))(variables, *_train_args(batch))
    images, sizes, gt = _torch_batch(batch)
    with torch.no_grad():
        got, t_norm = tm.train_forward(images, sizes, gt, 1.0,
                                       torch.tensor(100.0))
    keys = sorted([*LOSSES[arch], *(k + ".tea" for k in LOSSES[arch]),
                   "loss_distill"])
    assert sorted(got) == sorted(want) == keys
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(t_norm) == float(norm) == 100.0


# --- construction, the bridge and the pretrained import -----------------


@pytest.mark.parametrize("arch", ["DistillatorFCOS", "DistillatorPOTO"])
def test_bridge_covers_full_width(arch):
    """Every flax leaf of the R-50 distillator (256-channel p3-p7, GN
    towers, 80 classes) maps to exactly one port entry of the same shape,
    and every entry is covered, both ways. Shapes only."""
    cfg = fcos_cfg(arch, ["MODEL.RESNETS.DEPTH", 50,
                          "MODEL.FPN.OUT_CHANNELS", 256])
    shapes = variable_shapes(jax_model(cfg))
    sd = build_model(cfg, dtype=torch.float32, device="cpu").state_dict()
    mapped = {}
    for key, shape in shapes.items():
        tk = param_bridge.torch_key(key)
        assert tk in sd, key
        assert tk not in mapped, f"{key} and {mapped[tk]} share {tk}"
        assert tuple(sd[tk].shape) == param_bridge.torch_shape(key, shape), key
        mapped[tk] = key
    assert set(mapped) == set(sd)
    head = "params/student/head/"
    assert shapes[head + "cls_gn_3/scale"] == (256,)
    assert shapes[head + "scale_4/scale"] == ()
    assert shapes["params/student/fpn/top_p6/kernel"] == (3, 3, 256, 256)
    assert (head + "centerness/kernel" in shapes) == (arch == "DistillatorFCOS")


def test_group_norm_backbone_maps_through_the_bridge():
    """A ResNet with RESNETS.NORM GN: flax's ``<norm>/GroupNorm_0`` leaves
    (lgd_tpu/models/layers.py:41-52 wraps flax's GroupNorm) are the port's
    ``<norm>`` parameters."""
    cfg = fcos_cfg(opts=["MODEL.RESNETS.NORM", "GN"])
    sd = build_model(cfg, dtype=torch.float32, device="cpu").state_dict()
    for leaf in ("scale", "bias"):
        key = param_bridge.torch_key(
            f"params/student/bottom_up/res3_0/conv1_norm/GroupNorm_0/{leaf}")
        assert key == f"student.bottom_up.res3_0.conv1_norm.{leaf}"
        assert sd[key].shape == (128,)


def test_caffe2_pickle_cold_starts_the_fcos_student(tmp_path):
    """A Caffe2-named R-50 pickle (the MSRA file's layout) fills the FCOS
    student's bottom_up with 0 unmatched tensors."""
    cfg = fcos_cfg(opts=["MODEL.RESNETS.DEPTH", 50,
                         "MODEL.FPN.OUT_CHANNELS", 256])
    src = build_model(cfg, dtype=torch.float32, device="cpu", seed=3)
    raw = chip_smoke.caffe2_backbone(src.student.bottom_up, seed=4,
                                     stats=("scale", "bias", "mean", "var"))
    path = tmp_path / "R-50.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": raw}, f)
    dst = build_model(cfg, dtype=torch.float32, device="cpu", seed=5)
    conv = weight_convert.convert_resnet_state(weight_convert._load_raw(
        str(path)))
    counts = [weight_convert._merge_into(dst, conv[c])
              for c in ("params", "frozen")]
    assert sum(miss for _, miss in counts) == 0
    assert sum(ok for ok, _ in counts) == len(dst.student.bottom_up
                                              .state_dict())
    names = {v: k for k, v in ((chip_smoke.caffe2_name(k), k)
                               for k in src.student.bottom_up.state_dict())}
    for c2, arr in raw.items():
        if c2 in names:
            np.testing.assert_array_equal(
                dst.student.bottom_up.state_dict()[names[c2]].numpy(), arr)


@pytest.mark.parametrize("arch", ["DistillatorFCOS", "DistillatorATSS",
                                  "DistillatorPOTO"])
def test_build_model_defaults_to_the_card(arch):
    """Each anchor-free distillator builds on the CPU when asked, with GN
    towers; without a card the default device raises."""
    cfg = fcos_cfg(arch)
    model = build_model(cfg, dtype=torch.float32, device="cpu", seed=0)
    assert isinstance(model.student.head.cls_gn_0, tlayers.GroupNorm32)
    if torch.cuda.is_available():
        return
    with pytest.raises((AssertionError, RuntimeError)):
        build_model(cfg, dtype=torch.float32)


def test_cli_trains_the_fcos_yaml_on_the_cpu(tmp_path):
    """``python -m lgd_tpu_torch.train`` on the in-package FCOS YAML: two
    steps, distillation on in the second, then COCO evaluation of the
    student and the teacher."""
    from lgd_tpu_torch import train as ttrain

    yaml = os.path.join(os.path.dirname(ttrain.__file__), "configs",
                        "fcos_R18_synthetic_mini.yaml")
    out = tmp_path / "out"
    argv = ["--config-file", yaml, "MODEL.DEVICE", "cpu",
            "SOLVER.MAX_ITER", "2", "INPUT.MIN_SIZE_TRAIN", "(64,)",
            "INPUT.MAX_SIZE_TRAIN", "96", "INPUT.MIN_SIZE_TEST", "64",
            "INPUT.MAX_SIZE_TEST", "96", "OUTPUT_DIR", str(out),
            "MODEL.DISTILLATOR.PRE_NONDISTILL_ITERS", "1",
            "MODEL.FCOS.TOPK_CANDIDATES_TEST", "100"]
    res = ttrain.main(ttrain.default_argument_parser().parse_args(argv))
    assert np.isfinite(res["bbox"]["AP50"])
    state = torch.load(out / "model_final.pth", weights_only=True)
    assert "student.head.scale_4.scale" in state
