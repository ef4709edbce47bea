"""The Mask R-CNN LGD path of the port (the mask head, its targets and loss,
the LOAD_LABELMAP seg-mask teacher, the mask fields of the data path and
segm scoring) against the JAX package at a small size: the R-CNN file's
model (R-18, a 64-channel FPN, 64 ROIs per image, MAX_INSTANCES 8, a
128x160 canvas, batch 2, float32) with MASK_ON, a 4-conv 64-wide mask
head and LOAD_LABELMAP. The GT are blob polygons drawn from a numpy seed
and passed through both packages' mapper and batch packing; one image is
resized by 4/3 on the way.

Tolerances, float32 on both sides:
- the mapper's and the packed batch's mask fields, the mask targets, the
  seg-map inside masks and the masks49 descriptors: exactly. The GT boxes
  are among the proposals (PROPOSAL_APPEND_GT), and each of their cell
  centres falls halfway between two pixels of the 56x56 GT-frame crop,
  so on every polygon edge the bilinear sum is exactly 0.5 there and the
  >= 0.5 threshold decides. The targets are held against JAX under jit,
  as its training step computes them: XLA takes the centres' fractions
  (j + 0.5) / 28 as a product with the float32 reciprocal of 28, which
  moves some of these ties from the eager values (24 of the 12,544
  targets of the GT boxes here); the port computes the fractions so, and
  sums the four corner terms in JAX's order. At XLA's default backend
  optimization level the CPU also fuses x1 + w * g into one multiply-add
  and moves a few more; the suite runs at level 0 (tests/conftest.py),
  where it does not;
- the mask head through the bridge (its ConvTranspose kernel flipped)
  within 1e-4 relative; ``mask_rcnn_loss`` within 1e-5 relative;
- ``train_forward``'s losses, ``loss_mask`` and ``loss_mask.tea``
  included, within 1e-4 relative; every gradient within GRAD_TOL of its
  tensor's peak, with the R-CNN file's ZERO_GRADIENT rule and no jitter
  term, in float64 on both sides (the gradient test says why);
- inference: the detections as sets (the R-CNN file's rule) and the mask
  probabilities within 1e-4 after the whole network (the test says
  why);
- bbox and segm AP of the port's evaluator and the JAX evaluator on the
  same detections and grids within 1e-6.
"""

import json
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rcnn import (
    LOSSES,
    ZERO_GRADIENT,
    _pyramid,
    _rows,
    _torch_pyramid,
    assert_same_sets,
    jax_sampling_uniforms,
    rcnn_cfg,
)
from torch_parity import (
    jax_model,
    random_weights,
    torch_instances,
    unflatten,
    variable_shapes,
)

from lgd_tpu.config.cfg import FrozenCfg
from lgd_tpu.data import dataset_mapper as jmapper
from lgd_tpu.data import loader as jloader
from lgd_tpu.evaluation.coco_eval import COCOEvaluator as JaxCOCOEvaluator
from lgd_tpu.models.lgd import dynamic_teacher as jteacher
from lgd_tpu.models.lgd import label_encoder as jlabel
from lgd_tpu.models.rcnn import roi_heads as jroi
from lgd_tpu.models.rcnn import rpn as jrpn
from lgd_tpu.structures import BatchedInstances as JaxInstances
from lgd_tpu_torch.data import dataset_mapper as tmapper
from lgd_tpu_torch.data import loader as tloader
from lgd_tpu_torch.evaluation.coco_eval import COCOEvaluator
from lgd_tpu_torch.models.distillator import build_model
from lgd_tpu_torch.models.layers import ConvTranspose2d
from lgd_tpu_torch.models.lgd import dynamic_teacher as tteacher
from lgd_tpu_torch.models.lgd import label_encoder as tlabel
from lgd_tpu_torch.models.rcnn import roi_heads as troi
from lgd_tpu_torch.utils.param_bridge import flax_array, load_flax_weights

CANVAS = (128, 160)
B = 2
M = 8
GRAD_TOL = 1e-4
MASK_OPTS = ("MODEL.MASK_ON", True,
             "MODEL.ROI_MASK_HEAD.NUM_CONV", 4,
             "MODEL.ROI_MASK_HEAD.CONV_DIM", 64,
             "MODEL.DISTILLATOR.LABEL_ENCODER.LOAD_LABELMAP", True,
             "INPUT.MIN_SIZE_TRAIN", (128,),
             "INPUT.MAX_SIZE_TRAIN", 160,
             "TPU.SEGMASK_STRIDE", 8,
             "TPU.MASK_CROP_SIZE", 56)


def mask_cfg(opts=()):
    return rcnn_cfg((*MASK_OPTS, *opts))


def blob_dicts(seed=3):
    """Two images (128x160, and 96x120, which the mapper resizes by 4/3)
    with 3-5 star-shaped polygons each, painted in, and a rectangle on
    integer corners."""
    rng = np.random.RandomState(seed)
    dicts = []
    for i, (h, w) in enumerate(((128, 160), (96, 120))):
        img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        polys = []
        for _ in range(rng.randint(3, 6)):
            cx, cy = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
            r = rng.uniform(0.1, 0.3) * min(h, w)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 12))
            rad = r * rng.uniform(0.5, 1.0, 12)
            p = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
            polys.append(p.clip(0, [w - 1, h - 1]))
        polys.append(np.asarray([[10, 12], [40, 12], [40, 30], [10, 30]],
                                np.float64))
        annos = []
        for p in polys:
            c = int(rng.randint(0, 80))
            cv2.fillPoly(img, [np.round(p).astype(np.int32)],
                         ((c * 37) % 255, (c * 91) % 255, (c * 13) % 255))
            (x1, y1), (x2, y2) = p.min(0), p.max(0)
            annos.append({"bbox": [float(x1), float(y1), float(x2 - x1),
                                   float(y2 - y1)],
                          "category_id": c, "iscrowd": 0,
                          "segmentation": [p.reshape(-1).tolist()]})
        dicts.append({"image": img, "height": h, "width": w,
                      "image_id": i + 1, "annotations": annos})
    return dicts


def mapped(mapper_mod, cfg, dicts, seed=7):
    mapper = mapper_mod.DatasetMapper(cfg, is_train=True)
    rng = np.random.RandomState(seed)
    return [mapper(d, rng) for d in dicts]


def float64_gradients():
    """tests/torch_float64_grads.py on this file's model in float64, in a
    process of its own (the float64 mode replaces float32 process-wide),
    at XLA's default optimization level, where its JAX gradient compiles
    and runs in about 45 s instead of 95."""
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu", XLA_FLAGS="")
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_float64_grads.py"),
         "mask_rcnn", "float64", "--json"], cwd=os.path.dirname(here),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def setup():
    """Both models on the same random weights, the batch through both data
    paths, the JAX ``train_forward`` losses, JAX inference and the
    replayed uniforms; the float64 gradients start first in their own
    process and are read by the gradient test."""
    grads = float64_gradients()
    cfg = mask_cfg()
    jm = jax_model(cfg)
    dicts = blob_dicts()
    j_samples = mapped(jmapper, cfg, dicts)
    t_samples = mapped(tmapper, cfg, dicts)
    batch = jloader.pack_batch(j_samples, CANVAS, M, segmask_stride=8)
    t_batch = tloader.pack_batch(t_samples, CANVAS, M, segmask_stride=8)
    one = jloader.pack_batch(j_samples[:1], CANVAS, M, segmask_stride=8)
    flat = random_weights(variable_shapes(jm, CANVAS, one["gt"]), seed=23)
    tm = load_flax_weights(build_model(cfg, dtype=torch.float32,
                                       device="cpu"), flat)
    variables = unflatten(flat)
    key = jax.random.PRNGKey(5)
    losses = jax.jit(lambda v, *a: jm.apply(
        v, *a, method=jm.train_forward, rngs={"sampling": key})[0])(
        variables, batch["image"], batch["image_size"], batch["gt"],
        jnp.float32(1.0), jnp.float32(100.0))
    dets, _ = jax.jit(lambda v, im, s: jm.apply(
        v, im, s, method=jm.inference))(variables, batch["image"],
                                        batch["image_size"])
    keys = jm.apply(variables, method=lambda m: (
        m.student.make_rng("sampling"), m.student.make_rng("sampling")),
        rngs={"sampling": key})
    R = len(jrpn.rpn_anchors(cfg, CANVAS, cfg.MODEL.RPN.IN_FEATURES)[0])
    pool = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + M
    uniforms = {name: jax_sampling_uniforms(k, R, pool)
                for name, k in zip(("student", "teacher"), keys)}
    yield {"cfg": cfg, "jm": jm, "tm": tm, "flat": flat,
           "variables": variables, "dicts": dicts, "j_samples": j_samples,
           "t_samples": t_samples, "batch": batch, "t_batch": t_batch,
           "losses": {k: float(v) for k, v in losses.items()},
           "dets": dets, "uniforms": uniforms, "float64_grads": grads}
    if grads.poll() is None:
        grads.kill()
        grads.communicate()


# --- the data path -------------------------------------------------------


def test_mapper_and_packed_masks_match_jax(setup):
    """Per sample the boxes, the polygons after resize and flip, masks49
    and the 56x56 GT-frame crops; per batch every GT field, the stride-8
    bitmasks among them, exactly."""
    for js, ts in zip(setup["j_samples"], setup["t_samples"]):
        assert len(ts["boxes"]) == len(js["boxes"]) >= 4
        for k in ("image", "boxes", "classes", "masks49", "mask_crops"):
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
        for tp, jp in zip(ts["polygons"], js["polygons"]):
            np.testing.assert_array_equal(np.concatenate(tp),
                                          np.concatenate(jp))
    jgt, tgt = setup["batch"]["gt"], setup["t_batch"]["gt"]
    for k in ("boxes", "classes", "valid", "masks49", "bitmasks",
              "mask_crops"):
        np.testing.assert_array_equal(getattr(tgt, k).numpy(),
                                      np.asarray(getattr(jgt, k)), err_msg=k)
    assert tuple(tgt.bitmasks.shape) == (B, M, 16, 20)
    assert tgt.bitmasks.sum() > 100 and tgt.mask_crops.float().mean() > 0.3
    np.testing.assert_array_equal(setup["t_batch"]["image"],
                                  np.asarray(setup["batch"]["image"]))


def _gt_frame_sum(crops, gt_boxes, matched, boxes, out):
    """crop_gt_frame_masks before its threshold, in numpy float32 from the
    port's cell centres, to show where the bilinear sum lands on exactly
    0.5."""
    G = crops.shape[-1]
    f32 = np.float32
    px, py = (t.numpy() for t in troi._cell_centres(torch.from_numpy(boxes),
                                                     out))
    c = np.take_along_axis(crops, matched[..., None, None], 1).astype(f32)
    gb = np.take_along_axis(gt_boxes, matched[..., None], 1)
    u = (px - gb[..., 0:1]) / np.maximum(gb[..., 2:3] - gb[..., 0:1],
                                         f32(1e-3)) * f32(G) - f32(0.5)
    v = (py - gb[..., 1:2]) / np.maximum(gb[..., 3:4] - gb[..., 1:2],
                                         f32(1e-3)) * f32(G) - f32(0.5)
    u, v = np.clip(u, 0, G - 1), np.clip(v, 0, G - 1)
    u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
    fu, fv = (u - u0)[..., None, :], (v - v0)[..., :, None]
    u1, v1 = np.minimum(u0 + 1, G - 1), np.minimum(v0 + 1, G - 1)
    at = lambda yi, xi: np.take_along_axis(np.take_along_axis(
        c, yi[..., :, None].repeat(G, -1), 2),
        xi[..., None, :].repeat(out, -2), 3)
    return (at(v0, u0) * (1 - fv) * (1 - fu) + at(v0, u1) * (1 - fv) * fu
            + at(v1, u0) * fv * (1 - fu) + at(v1, u1) * fv * fu)


@pytest.mark.parametrize("source", ["gt_frame_crops", "bitmasks"])
def test_mask_targets_match_jax(setup, source):
    """Targets at 28x28 for the GT boxes themselves (whose cell centres
    fall halfway between crop pixels), the GT boxes shifted by half a crop
    pixel, and random boxes, each matched to a GT slot: exactly against
    JAX under jit, as its training step computes them."""
    jgt = setup["batch"]["gt"]
    gt_boxes = np.asarray(jgt.boxes)
    rng = np.random.RandomState(11)
    n_valid = np.asarray(jgt.valid).sum(1)
    matched = np.stack([np.concatenate([
        np.arange(M) % n, rng.randint(0, n, 16)]) for n in n_valid])
    own = np.take_along_axis(gt_boxes, matched[:, :M, None], 1)
    half = own + (own[..., 2:3] - own[..., 0:1]) / 112.0
    xy = rng.rand(B, 16 - M, 2).astype(np.float32) * 100
    rand = np.concatenate([xy, xy + rng.rand(B, 16 - M, 2) * 60 + 4], -1)
    boxes = np.concatenate([own, half, rand], 1).astype(np.float32)
    assert boxes.shape[1] == matched.shape[1]
    if source == "gt_frame_crops":
        crops = np.asarray(jgt.mask_crops)
        sums = _gt_frame_sum(crops, gt_boxes, matched, boxes, 28)
        assert (sums[:, :M] == 0.5).sum() > 50  # the half positions
        want = jax.jit(lambda *a: jroi.crop_gt_frame_masks(*a, 28))(
            jgt.mask_crops, jgt.boxes, jnp.asarray(matched), boxes)
        got = troi.crop_gt_frame_masks(
            torch.from_numpy(crops), torch.from_numpy(gt_boxes),
            torch.from_numpy(matched), torch.from_numpy(boxes), 28)
    else:
        want = jax.jit(lambda *a: jroi.crop_bitmasks(*a, 28, 8))(
            jgt.bitmasks, jnp.asarray(matched), boxes)
        got = troi.crop_bitmasks(torch.from_numpy(np.asarray(jgt.bitmasks)),
                                 torch.from_numpy(matched),
                                 torch.from_numpy(boxes), 28, 8)
    want = np.asarray(want)
    assert 0.1 < want.mean() < 0.9
    np.testing.assert_array_equal(got.numpy(), want)


def _gt_with_an_empty_image(setup):
    """The batch's first image and one without GT."""
    jgt = setup["batch"]["gt"]
    n = int(np.asarray(jgt.valid)[0].sum())
    keep = lambda a: [np.asarray(a)[0, :n], np.asarray(a)[0, :0]]
    return JaxInstances.from_lists(
        keep(jgt.boxes), keep(jgt.classes), M, masks49_list=keep(jgt.masks49),
        bitmasks_list=keep(jgt.bitmasks))


@pytest.mark.parametrize("context", [True, False], ids=["ctx", "no_ctx"])
def test_segmask_inside_masks_and_descriptors_match_jax(setup, context):
    """The seg-map teacher's inside masks at every level of p2-p6 (nearest
    by integer floor division) and the 4 + 80 + 49 descriptors, with an
    image without GT (its masks49 zeroed) and the context slot's all-ones
    mask: exactly."""
    jgt = _gt_with_an_empty_image(setup)
    tgt = torch_instances(jgt)
    jd, jv, jb, is_ctx = jlabel.encode_descriptors(jgt, CANVAS, 80, context,
                                                   True)
    td, tv, tb = tlabel.encode_descriptors(tgt, CANVAS, 80, context, True)
    assert td.shape == (B, M + context, 4 + 80 + 49)
    for got, want in ((td, jd), (tv, jv), (tb, jb)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (td[1, 0, 84:] == -1).all()  # the fallback token's empty mask
    for hw in ((32, 40), (16, 20), (8, 10), (4, 5), (2, 3), (3, 7)):
        want = jax.jit(lambda bm: jteacher.segmask_inside_masks(
            bm, is_ctx, hw))(jgt.bitmasks)
        got = tteacher.segmask_inside_masks(tgt.bitmasks, M + context, hw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the mask head and its loss ----------------------------------------


def test_deconv_bridge_flips_the_kernel():
    """flax's ConvTranspose (transpose_kernel False) equals torch's only
    with the kernel flipped in both spatial axes: the bridge's mapping
    gives the same outputs at unit and random inputs, the unflipped
    kernel does not, and ``flax_array`` inverts the mapping."""
    from flax import linen as fnn

    rng = np.random.RandomState(0)
    kernel = rng.randn(2, 2, 3, 5).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    layer = fnn.ConvTranspose(5, (2, 2), strides=(2, 2))
    params = {"params": {"kernel": kernel, "bias": bias}}
    owner = torch.nn.Module()
    owner.deconv = ConvTranspose2d(3, 5, 2, stride=2)
    load_flax_weights(owner, {"params/deconv/kernel": kernel,
                              "params/deconv/bias": bias})
    for x in (np.ones((1, 4, 6, 3), np.float32),
              rng.randn(2, 4, 6, 3).astype(np.float32)):
        want = np.asarray(layer.apply(params, x)).transpose(0, 3, 1, 2)
        with torch.no_grad():
            got = owner.deconv(torch.from_numpy(x).permute(0, 3, 1, 2))
            unflipped = torch.nn.functional.conv_transpose2d(
                torch.from_numpy(x).permute(0, 3, 1, 2),
                torch.from_numpy(kernel.transpose(2, 3, 0, 1).copy()),
                torch.from_numpy(bias), stride=2)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        assert np.abs(unflipped.numpy() - want).max() > 0.1
    back = flax_array("params/deconv/kernel",
                      owner.deconv.weight.detach().numpy(), owner)
    np.testing.assert_array_equal(back, kernel)


def test_mask_head_through_the_bridge_matches_jax(setup):
    """ROIAlign at 14x14 -> 4 convs -> deconv -> predictor on random p2-p5
    features with the bridged weights, invalid ROIs among them; the port's
    logits are (B, P, K, 28, 28), the flax head's (B, P, 28, 28, K)."""
    cfg = setup["cfg"]
    rng = np.random.RandomState(9)
    feats = _pyramid(rng, levels=("p2", "p3", "p4", "p5"))
    xy = rng.rand(B, 24, 2).astype(np.float32) * 120
    boxes = np.concatenate([xy, xy + rng.rand(B, 24, 2) * 60 + 2], -1)
    boxes = boxes.astype(np.float32)
    valid = rng.rand(B, 24) > 0.2
    heads = jroi.StandardROIHeads(cfg=FrozenCfg(cfg), dtype=jnp.float32)
    want = jax.jit(lambda *a: heads.apply(*a, method=heads.mask_forward))(
        {"params": setup["variables"]["params"]["student"]["roi_heads"]},
        {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(boxes),
        jnp.asarray(valid))
    with torch.no_grad():
        got = setup["tm"].student.roi_heads.mask_forward(
            _torch_pyramid(feats), torch.from_numpy(boxes),
            torch.from_numpy(valid))
    assert tuple(got.shape) == (B, 24, 80, 28, 28)
    want = np.asarray(want).transpose(0, 1, 4, 2, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_mask_rcnn_loss_matches_jax(setup):
    """The foreground-first subset (exactly) and the loss on random logits
    over the sample of the batch's GT-appended proposals, JAX under
    jit."""
    cfg, jgt = setup["cfg"], setup["batch"]["gt"]
    rng = np.random.RandomState(5)
    xy = rng.rand(B, 100, 2).astype(np.float32) * 120
    props = np.concatenate([xy, xy + rng.rand(B, 100, 2) * 60 + 2], -1)
    k = 16
    logits = rng.randn(B, k, 28, 28, 80).astype(np.float32) * 2

    def jax_loss(props, gt, logits):
        sampled = jroi.label_and_sample_proposals(
            cfg, props, jnp.ones((B, 100), bool), gt, jax.random.PRNGKey(1))
        sub = jroi.take_fg_subset(sampled, k)
        return sampled, sub, jroi.mask_rcnn_loss(cfg, logits, sub, gt)

    sampled, jsub, want = jax.jit(jax_loss)(jnp.asarray(props, jnp.float32),
                                            jgt, jnp.asarray(logits))
    t_sampled = {key: torch.from_numpy(np.asarray(v))
                 for key, v in sampled.items()}
    for key in ("classes", "matched_gt"):
        t_sampled[key] = t_sampled[key].long()
    tsub = troi.take_fg_subset(t_sampled, k)
    for key in jsub:
        np.testing.assert_array_equal(tsub[key].numpy(),
                                      np.asarray(jsub[key]), err_msg=key)
    assert 4 < int(tsub["is_fg"].sum()) < B * k
    got = troi.mask_rcnn_loss(
        cfg, torch.from_numpy(logits.transpose(0, 1, 4, 2, 3).copy()), tsub,
        torch_instances(jgt))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# --- train_forward and inference ------------------------------------------


@pytest.fixture(scope="module")
def port_forward(setup):
    """The port's train_forward losses on its own packed batch with the
    replayed uniforms."""
    tm, tb = setup["tm"], setup["t_batch"]
    images = torch.from_numpy(tb["image"]).permute(0, 3, 1, 2)
    uniforms = {name: {k: torch.from_numpy(v) for k, v in u.items()}
                for name, u in setup["uniforms"].items()}
    with torch.no_grad():
        losses, norm = tm.train_forward(images,
                                        torch.from_numpy(tb["image_size"]),
                                        tb["gt"], 1.0, torch.tensor(100.0),
                                        uniforms)
    return {k: float(v) for k, v in losses.items()}, float(norm)


def test_train_forward_matches_jax(setup, port_forward):
    """All eleven losses, loss_mask and loss_mask.tea among them."""
    losses, norm = port_forward
    names = (*LOSSES, "loss_mask")
    keys = sorted([*names, *(k + ".tea" for k in names), "loss_distill"])
    assert sorted(losses) == sorted(setup["losses"]) == keys
    for k in keys:
        np.testing.assert_allclose(losses[k], setup["losses"][k], rtol=1e-4,
                                   err_msg=k)
    assert losses["loss_mask"] > 0.1 and norm == 100.0


def test_inference_masks_match_jax(setup):
    """The detections as sets, and every detection's 28x28 mask
    probabilities against JAX's mask head on the same boxes and classes
    over JAX's own features: the two packages' boxes differ by rounding,
    which moves the pooled samples, so JAX's masks are taken at the
    port's boxes. They agree within 1.9e-5 after the whole network and
    are held within 1e-4, as the scores after the whole network are."""
    tm, tb, cfg = setup["tm"], setup["t_batch"], setup["cfg"]
    dets, masks = tm.inference(
        torch.from_numpy(tb["image"]).permute(0, 3, 1, 2),
        torch.from_numpy(tb["image_size"]))
    jd = setup["dets"]
    assert tuple(masks.shape) == (B, 100, 28, 28)
    for i in range(B):
        assert_same_sets(
            _rows(dets.boxes[i], dets.scores[i], dets.valid[i],
                  dets.classes[i]),
            _rows(jd.boxes[i], jd.scores[i], jd.valid[i], jd.classes[i]),
            score_tol=1e-4)
    heads = jroi.StandardROIHeads(cfg=FrozenCfg(cfg), dtype=jnp.float32)

    def jax_masks(variables, images, sizes, boxes, valid, classes):
        _, feats = setup["jm"].apply(variables, images, sizes,
                                     method=lambda m, *a: m.student(*a))
        logits = heads.apply(
            {"params": variables["params"]["student"]["roi_heads"]},
            feats, boxes, valid, method=heads.mask_forward)
        return jax.nn.sigmoid(jnp.take_along_axis(
            logits, classes[..., None, None, None], axis=-1)[..., 0])

    want = jax.jit(jax_masks)(setup["variables"], setup["batch"]["image"],
                              setup["batch"]["image_size"],
                              dets.boxes.numpy(), dets.valid.numpy(),
                              dets.classes.numpy().astype(np.int32))
    valid = dets.valid.numpy()
    assert valid.sum() == 2 * 100
    np.testing.assert_allclose(masks.numpy()[valid], np.asarray(want)[valid],
                               rtol=0, atol=1e-4)


def test_segm_ap_matches_jax(setup):
    """bbox and segm AP of both evaluators on the same detections: per GT
    its jittered box with its polygon's 28x28 crop plus noise as the
    grid, and false detections, two of them on crowd-free classes."""
    dicts = setup["dicts"]
    rng = np.random.RandomState(4)
    got_ev = COCOEvaluator(gt_dataset=dicts)
    want_ev = JaxCOCOEvaluator(gt_dataset=dicts)
    for d in dicts:
        boxes, scores, classes, grids = [], [], [], []
        for a in d["annotations"]:
            x, y, w, h = a["bbox"]
            box = np.asarray([x, y, x + w, y + h]) + rng.randn(4) * 2
            grid = tmapper.crop_and_resize_mask(a["segmentation"], box, 28,
                                                flatten=False)
            boxes.append(box)
            grids.append((grid * 0.8 + rng.rand(28, 28) * 0.4).clip(0, 1))
            scores.append(rng.rand())
            classes.append(a["category_id"])
        for _ in range(3):
            xy = rng.rand(2) * 60
            boxes.append(np.concatenate([xy, xy + rng.rand(2) * 40 + 5]))
            grids.append(rng.rand(28, 28))
            scores.append(rng.rand())
            classes.append(int(rng.choice(classes)))
        args = (d["image_id"], np.asarray(boxes), np.asarray(scores),
                np.asarray(classes))
        got_ev.process(*args, masks=np.asarray(grids))
        want_ev.process(*args, masks=np.asarray(grids))
    got = got_ev.evaluate(("bbox", "segm"))
    want = want_ev.evaluate(("bbox", "segm"))
    assert sorted(got) == sorted(want) == ["bbox", "segm"]
    for t in ("bbox", "segm"):
        assert sorted(got[t]) == sorted(want[t])
        for k, v in want[t].items():
            np.testing.assert_allclose(got[t][k], v, rtol=0, atol=1e-6,
                                       err_msg=f"{t} {k}")
    assert 10 < got["segm"]["AP"] < 95 and got["segm"]["AP"] != \
        got["bbox"]["AP"]


def test_cli_trains_and_evaluates_the_mask_rcnn_yaml(tmp_path, capsys):
    """``python -m lgd_tpu_torch.train`` on the in-package Mask R-CNN
    YAML: two steps with the seg-mask teacher and loss_mask, then
    ``--eval-only`` from the checkpoint, scoring bbox and segm on four
    images of the synthetic split, 20 detections each (the plain ROIAlign
    of the mask head's ROIs takes most of an evaluation here)."""
    from lgd_tpu_torch import train as ttrain
    from lgd_tpu_torch.data import register_synthetic

    yaml = os.path.join(os.path.dirname(ttrain.__file__), "configs",
                        "mask_rcnn_R18_synthetic_mini.yaml")
    split = register_synthetic("synthetic_mini_4", num_images=4)
    out = tmp_path / "out"
    opts = ["MODEL.DEVICE", "cpu",
            "SOLVER.MAX_ITER", "2", "INPUT.MIN_SIZE_TRAIN", "(64,)",
            "INPUT.MAX_SIZE_TRAIN", "96", "INPUT.MIN_SIZE_TEST", "64",
            "INPUT.MAX_SIZE_TEST", "96", "OUTPUT_DIR", str(out),
            "MODEL.RPN.POST_NMS_TOPK_TEST", "10",
            "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
            "TEST.DETECTIONS_PER_IMAGE", "20",
            "MODEL.DISTILLATOR.EVAL_TEACHER", "False",
            "DATASETS.TEST", f"('{split}',)"]
    parse = ttrain.default_argument_parser().parse_args
    ttrain.main(parse(["--config-file", yaml, *opts]))
    metrics = (out / "metrics.json").read_text()
    assert '"loss_mask.tea"' in metrics and '"loss_mask"' in metrics
    capsys.readouterr()
    res = ttrain.main(parse(["--config-file", yaml, "--eval-only", *opts]))
    assert sorted(res) == ["bbox", "segm"]
    assert np.isfinite(res["segm"]["AP"]) and np.isfinite(res["bbox"]["AP"])
    printed = capsys.readouterr().out
    assert "COCO segm results" in printed and "COCO bbox results" in printed


def test_train_forward_gradients_match_jax(setup):
    """Every parameter's gradient of the summed losses, in float64 on both
    sides (tests/torch_float64_grads.py, the GT-frame crops at 57 pixels
    there so that no target ties), within GRAD_TOL of its tensor's peak,
    and the two of ZERO_GRADIENT under 1e-8 of the largest gradient.

    Why float64: in float32 the seg-map teacher's gradients, those driven
    through its p2 level, differ from JAX's by up to 1.8e-3 of their peak
    (the teacher's q_proj), and the JAX package's own float32 gradients
    differ by up to 3.5e-3 between XLA's backend optimization levels 0 and
    the default, while the port's move by 4e-7 when every weight is
    scaled by 1 + 1e-7 N(0, 1): the float32 reference is not fixed to
    1e-4 there. In float64 every gradient agrees within 1.7e-14 of its
    peak."""
    out, err = setup["float64_grads"].communicate(timeout=900)
    assert setup["float64_grads"].returncode == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    gaps, zero, peaks = result["gaps"], result["zero"], result["peaks"]
    assert sorted(zero) == sorted(ZERO_GRADIENT)
    for key, (jax_peak, port_peak) in zero.items():
        assert max(jax_peak, port_peak) <= 1e-8, key
    bad = {k: v for k, v in gaps.items() if not v <= GRAD_TOL}
    assert not bad, bad
    assert len(gaps) > 100
    for name in ("student/roi_heads/mask_head/deconv/kernel",
                 "student/roi_heads/mask_head/mask_fcn1/kernel",
                 "student/roi_heads/mask_head/predictor/bias",
                 "teacher/label_encoder_/stn_desc/conv1/linear/kernel"):
        assert peaks["params/" + name] > 1e-6, name
