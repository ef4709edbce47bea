#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the CUDA kernels from the sources in the checkout,
   one nvcc per source, all at once.
2. Kernel K2 (greedy NMS, lgd_tpu_torch/csrc/nms.cu) against its plain
   PyTorch version on the card: pools that stress each step of its sweep
   (NMS_STRESS: disjoint boxes, a chain of alternating kept rows, invalid
   rows inside the row blocks, duplicates, all invalid, pairs at IoU
   exactly the threshold) at 63-4097 candidates, one launch per call and
   the same bits twice; adversarial pools (duplicate scores and boxes, IoU
   exactly at the threshold, invalid tails, all-invalid) up to 13000
   candidates, where the sweep stages a row block's tile in chunks, among
   them the inference shape, 8 images x 2000 candidates with class
   offsets; and the R-CNN RPN's 16 x 2000 pools with the levels as
   classes. Keep masks must be equal bit for bit.
3. Kernels K1a and K1b (masked attention forward and backward,
   lgd_tpu_torch/csrc/attention.cu) against the plain version and its
   autograd gradient, float32 with TF32 off, at B in {1, 16}, 8 heads,
   N in {1, 15, 16, 17, 101, 128, 257} and 101 queries x 37 keys, at each
   head width the kernels are built for (D in {8, 16, 32, 64}: the mini
   configs' 64-channel FPN gives 8, the full width 32), with padded keys,
   an image whose only valid key is the fallback slot and an image with no
   valid key; K1b run twice must give the same bits. Then timed at
   (16, 8, 101, 32) beside the plain version and
   scaled_dot_product_attention (the yardstick; the port never calls it):
   a CUDA graph of 200 calls replayed, which the host cannot pace, with
   CUDA events over a loop of launches beside it; and at each tile size.
4. Inference: DistillatorRetinaNet, R-50 FPN at full width (256-channel
   p3-p7, 9 anchors, 80 classes), seeded random weights, bf16 convolutions,
   through the port's ``do_test`` on the 16-image synthetic split at the
   800x1344 / 1344x800 test canvases, batches of 8. The NMS launch counter
   must rise, every image must have 1..100 finite detections and COCO
   metrics must come back. One batch is then decoded again with the plain
   NMS: the valid detections must be equal as sets. The kernel (by
   CUDA-graph replay, by a loop of launches, and its two CUDA kernels
   apart by torch.profiler) and its plain version are timed on that
   batch's real pre-NMS pool.
5. Training: the same model with its 8-head float32 teacher (context box,
   MAX_INSTANCES 100, so 101 tokens) through ``do_train`` on the synthetic
   split at the 800x1344 / 1344x800 training canvases, batch
   TRAIN_BATCH, TRAIN_STEPS steps, the backbone pre-freeze lifting after
   step 0 and distillation starting at step 3. Every loss is finite,
   loss_distill reaches the student only once distillation is on, K1a and
   K1b launch 5 times each per step, and the FREEZE_AT stem never moves.
   Then steady-state steps are timed (step ms, images/s, peak memory) and
   profiled: device idle share, time by kernel family and by kernel, and
   the device time of the step's forward and optimizer ranges.
6. ``do_test(eval_teacher=True)`` on the trained model: the teacher's
   features through the student's head; COCO metrics, K1a launches.
7. The R-50 model in float32 on the card and on the CPU (the CPU path is
   the one the tests hold against the JAX package) on a small input: FPN
   features, head outputs, and ``train_forward``'s five losses and
   normalizer with a backward, TF32 off; the card runs K1a/K1b, the CPU
   their plain versions.
8. Kernel K3 (multilevel ROIAlign forward and backward,
   lgd_tpu_torch/csrc/roi_align.cu) against the plain version on
   adversarial ROIs (every level, past each edge, under a texel, the s_max
   cap, invalid slots, an all-invalid image; for the backward's windows a
   whole-level ROI, one-texel levels, high corners clamped on the edge and
   windows of several tiles) in float32 and bf16, then at
   the slice's shapes (16 x 512 ROIs of the student's bf16 and the
   teacher's float32 p2-p5 at 800x1344, forward and backward; 8 x 1000 at
   inference), held at the same limits and timed beside the plain version.
9. Faster R-CNN R-50 FPN (detectron2's Base-RCNN-FPN at full width) through
   ``do_test``: K2 twice and K3 once per batch, 1..100 finite detections
   per image, COCO metrics; one batch again through ``model.inference``
   with the plain NMS swapped in, equal detection sets, and K3 held
   against the plain ROIAlign on that batch's own ROIs; K2 held and timed
   on the batch's RPN and box-head pools, as in 4.
10. Faster R-CNN LGD training through ``do_train``, checked and timed as in
   5, with K1a/K1b 5, K2 2 and K3 forward and backward 2 each per step;
   then ``do_test(eval_teacher=True)`` and the float32 card-vs-CPU
   ``train_forward`` of 7 for the R-CNN model, with the same uniforms.
11. Kernel K4 (modulated deformable sampling forward and backward,
   lgd_tpu_torch/csrc/deform_conv.cu) against the plain version on
   adversarial offsets (integer, fractional, negative, past each border by
   under a texel and by more, exactly -1 and the last row or column,
   beyond +-6 px, +-1e3; masks of 0 and 1, unmodulated, stride 2,
   dilation 2; for both directions' tiles offsets beyond the windows'
   halos, samples pushed off every border, a mask of zeros, partial stages
   of channels and runs of positions, maps too wide for the forward's
   window of full rows) in float32 and bf16, then at R-101's res3-res5
   shapes (batch 16 at 800x1344, bf16, offsets N(0, 1.5) px), held at
   the same limits and timed beside the plain version and F.grid_sample
   times the mask (the yardstick; the port never calls it).
12. RetinaNet R-101-DCNv2 (modulated DCN in res3-res5) and
   X-101-32x8d-DCNv2 inference through ``do_test`` at batch 8: K2 once and
   K4 30 times per batch (X-101: 3 of them stride 2), finite detections,
   COCO metrics; one batch again through ``model.inference`` with the
   plain NMS and plain K4 forward swapped in, equal detection sets. The
   offset convs, zero at init, are drawn at random and scaled to offsets
   of 1.5 px (``draw_offset_convs``), so that samples fall between texels.
13. RetinaNet R-101-DCNv2 LGD training through ``do_train``, checked and
   timed as in 5 (gradients clipped by value, ``dcn_train_cfg``), with
   K1a/K1b 5 and K4 forward and backward 30 each per step and the offset
   convs trained; K4's forward and backward held and timed again on the
   backward's inputs of the third step, one per res stage (offsets that
   vary smoothly over the map, unlike 11's independent draws); then
   ``do_test(eval_teacher=True)``.
14. The float32 card-vs-CPU ``train_forward`` of 7 for the R-101-DCNv2
   model with the same drawn offset convs.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failed check raises, and the script exits
non-zero without that line; so it does without a card.
"""

import json
import math
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

NMS_TOL = 0  # keep masks are booleans: equal bit for bit
# K1a/K1b against the plain version, float32 with TF32 off, relative to
# the largest value: sums in other orders (forward), and twice as many
# products summed (gradients)
ATTN_FWD_TOL = 1e-5
ATTN_GRAD_TOL = 1e-4
# card against CPU, float32 with TF32 off: losses summed over ~10^6 terms
# in other orders, after 50 layers of convolutions
TRAIN_LOSS_TOL = 1e-3
# K3 against its plain version, relative to the largest value: the float32
# forward, and bfloat16 levels pooled into float32 (the kernel sums each
# bin's samples in another order: along each window row, then down the
# rows); the float32 backward (float32 atomics add the shares in an order
# that changes from run to run). bfloat16 outputs and gradients: within
# one ulp of the rounding plus the float32 tolerance, since a sum of terms
# of both signs may differ in float32 by more than an ulp of its small
# result.
ROI_TOL = 1e-5
# K4 against its plain version: the float32 forward bit for bit (the kernel
# repeats the plain version's float32 arithmetic), bfloat16 columns within
# one bf16 ulp; the backward relative to each gradient's largest value:
# float32 atomics add dx's shares in an order that changes from run to
# run, and each offset's and mask's gradient is a sum over the channels in
# another order than autograd's (bfloat16 dx one ulp more, as K3's)
DCN_TOL = 1e-5
KERNEL_SOURCES = ("nms", "attention", "roi_align", "deform_conv")
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM bytes/s
# and float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
TRAIN_BATCH = 16       # the reference's global batch
TRAIN_STEPS = 8        # do_train steps with the checks
TIMED_STEPS = 5        # steady-state steps timed after them
RCNN_TRAIN_STEPS = 4   # R-CNN do_train steps with the checks
RCNN_TIMED_STEPS = 3
# record_function ranges of engine/train_step.py; the backward runs on
# autograd's threads, outside them
STEP_RANGES = ("train_step.forward", "train_step.optimizer")


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    """A failed check ends the run (unlike ``assert``, also under -O)."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_header():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


def build_kernels():
    """One nvcc per source, all started together, then each loaded."""
    from concurrent.futures import ThreadPoolExecutor

    from lgd_tpu_torch import csrc
    from lgd_tpu_torch.ops import attention, deform_conv, nms, roi_align

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for path in pool.map(csrc.build, KERNEL_SOURCES):
            log(f"built {path}")
    nms._kernel()
    attention._kernel()
    roi_align._kernel()
    deform_conv._kernel()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{n} {csrc.build_seconds.get(n, 0.0):.2f} s"
                    for n in KERNEL_SOURCES) + ")")


def launch_counters():
    """The kernels' wrappers by name; each counts its launches in
    ``launches``."""
    from lgd_tpu_torch.ops import attention, deform_conv, nms, roi_align

    return {"K1a": attention.attention_fwd, "K1b": attention.attention_bwd,
            "K2": nms.greedy_keep_sorted,
            "K3 forward": roi_align.roi_align_fwd,
            "K3 backward": roi_align.roi_align_bwd,
            "K4 forward": deform_conv.deform_sample_fwd,
            "K4 backward": deform_conv.deform_sample_bwd}


def zero_launches():
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in launch_counters().items()}


def expect_launches(per_run, runs):
    """{kernel: launches} of ``runs`` runs with ``per_run`` launches each,
    every other kernel none."""
    return {name: runs * per_run.get(name, 0) for name in launch_counters()}


def cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time for the bytes at the HBM rate
    and the float32 operations at the CUDA-core rate, the larger one."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def adversarial_pool(rng, B, n, device):
    import numpy as np

    ctr = rng.rand(B, n, 2) * 800
    wh = rng.rand(B, n, 2) * 300 + 2
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = rng.rand(B, n).astype(np.float32)
    if n > 51:
        scores[:, 10:20] = scores[:, 5:6]      # duplicate scores
        boxes[:, 30:35] = boxes[:, 29:30]      # duplicate boxes
        scores[:, 40:44] = 0.5                 # duplicate boxes, tied scores
        boxes[:, 40:44] = boxes[:, 39:40]
        boxes[:, 50] = [0.0, 0.0, 10.0, 10.0]  # IoU(50, 51) = 50 / 150
        boxes[:, 51] = [0.0, 5.0, 10.0, 15.0]
        scores[:, 50], scores[:, 51] = 2.0, 1.9
    valid = np.ones((B, n), bool)
    valid[0, n - n // 5:] = False              # invalid tail
    valid[-1] = False                          # all invalid
    classes = rng.randint(0, 80, (B, n))
    return [torch.from_numpy(a).to(device)
            for a in (boxes, scores, classes, valid)]


# sorted pools for K2 that each stress one step of its sweep
NMS_STRESS = ("disjoint", "chain", "invalid inside blocks", "duplicates",
              "all invalid", "at the threshold")


def nms_stress_pool(kind, B, n, device, seed=0):
    """Score-sorted boxes (B, n, 4), valid (B, n) and the thresholds to
    hold K2 at, for one of NMS_STRESS: disjoint boxes (every row kept); a
    chain in which each row overlaps only the next above 0.5 (IoU 7 / 13;
    the next but one 1 / 4), so kept rows alternate; random boxes with
    invalid rows inside the blocks, among them rows that would suppress;
    runs of 7 equal boxes (only a run's first row can be kept); every row
    invalid; pairs at IoU exactly 50 / 150, none suppressed at that
    threshold and every second row just below it. Image b is shifted by
    1000 b px (integers: every IoU stays exact)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    i = np.arange(n, dtype=np.float32)
    zero = np.zeros_like(i)
    third = float(np.float32(50.0) / np.float32(150.0))
    thresholds = (0.5,)
    valid = np.ones((B, n), bool)
    if kind == "disjoint":
        boxes = np.stack([10 * i, zero, 10 * i + 5, zero + 5], -1)
    elif kind == "chain":
        boxes = np.stack([3 * i, zero, 3 * i + 10, zero + 10], -1)
    elif kind == "at the threshold":
        x, y = 20 * (i // 2), 5 * (i % 2)
        boxes = np.stack([x, y, x + 10, y + 10], -1)
        thresholds = (third, third - 1e-6)
    else:
        ctr = np.round(rng.rand(n, 2) * 800)
        wh = np.round(rng.rand(n, 2) * 300) + 2
        boxes = np.concatenate([ctr - wh // 2, ctr + wh // 2], -1)
        if kind == "duplicates":
            boxes = np.repeat(boxes[::7], 7, axis=0)[:n]
        elif kind == "invalid inside blocks":
            valid[:, 20:40] = False
            valid &= rng.rand(B, n) > 0.1
        elif kind == "all invalid":
            valid[:] = False
        else:
            raise ValueError(kind)
    boxes = boxes[None].astype(np.float32).repeat(B, 0)
    boxes[..., 0::2] += 1000 * np.arange(B, dtype=np.float32)[:, None, None]
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(valid).to(device), thresholds)


def hold_k2(boxes_s, valid_s, thr, what):
    """K2 on one sorted pool: one launch per call, bit-equal to its plain
    version, and the same bits from a second call. Returns the keep mask."""
    from lgd_tpu_torch.ops import nms

    before = nms.greedy_keep_sorted.launches
    got = nms.greedy_keep_sorted(boxes_s, valid_s, thr)
    check(nms.greedy_keep_sorted.launches == before + 1,
          f"K2 launched {nms.greedy_keep_sorted.launches - before} times")
    again = nms.greedy_keep_sorted(boxes_s, valid_s, thr)
    want = nms.greedy_keep_sorted_reference(boxes_s, valid_s, thr)
    check(torch.equal(got, want), f"K2 differs ({what}, {thr})")
    check(torch.equal(again, got), f"K2 differs from itself ({what}, {thr})")
    return got


def phase_nms(device):
    """K2 against its plain version on adversarial pools, at the edges of
    its row blocks and of its chunked tiles, and on NMS_STRESS."""
    import numpy as np

    from lgd_tpu_torch.ops import nms

    for n in (63, 129, 2000, 4097):
        for kind in NMS_STRESS:
            B = 1 if n > 2000 else 3
            boxes, valid, thresholds = nms_stress_pool(kind, B, n, device)
            for thr in thresholds:
                hold_k2(boxes, valid, thr, f"{kind}, {B} x {n}")
    rng = np.random.RandomState(0)
    third = float(np.float32(50.0) / np.float32(150.0))
    checked = 0
    for B, n in ((8, 2000), (2, 64), (3, 65), (2, 1), (4, 513), (2, 2049),
                 (1, 13000)):
        boxes, scores, classes, valid = adversarial_pool(rng, B, n, device)
        for thr in (0.5, third, third - 1e-6):
            got = nms.batched_nms_mask(boxes, scores, classes, valid, thr)
            want = nms.batched_nms_mask(
                boxes, scores, classes, valid, thr,
                keep_fn=nms.greedy_keep_sorted_reference)
            check(torch.equal(got, want), f"K2 differs at B={B} n={n} {thr}")
            got = nms.nms_mask(boxes, scores, valid, thr)
            want = nms.nms_mask(boxes, scores, valid, thr,
                                keep_fn=nms.greedy_keep_sorted_reference)
            check(torch.equal(got, want), f"K2 differs at B={B} n={n} {thr}")
            checked += 2
        if n > 51 and B > 1:  # the pair at exactly the threshold survives
            k = nms.nms_mask(boxes[:1, 50:52], scores[:1, 50:52],
                             valid[:1, 50:52], third)
            check(k.tolist() == [[True, True]], k)
    torch.cuda.synchronize()
    log(f"K2: {checked} adversarial pools and {len(NMS_STRESS)} stress "
        f"pools at 4 sizes bit-equal to the plain version")


def smoke_cfg(opts=()):
    from lgd_tpu_torch.config import get_cfg

    sizes = [[x, x * 2 ** (1 / 3), x * 2 ** (2 / 3)]
             for x in [32, 64, 128, 256, 512]]
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.META_ARCHITECTURE", "DistillatorRetinaNet",
        "MODEL.RESNETS.DEPTH", 50,
        "MODEL.RESNETS.OUT_FEATURES", ["res3", "res4", "res5"],
        "MODEL.FPN.IN_FEATURES", ["res3", "res4", "res5"],
        "MODEL.ANCHOR_GENERATOR.SIZES", sizes,
        # random weights put every probability near the 0.01 prior, under
        # the default 0.05 threshold: keep them so NMS sees full pools
        "MODEL.RETINANET.SCORE_THRESH_TEST", 0.0,
        "MODEL.DISTILLATOR.EVAL_TEACHER", False,
        "DATASETS.TEST", ("synthetic_mini",),
        "TPU.COMPUTE_DTYPE", "bfloat16",
        "OUTPUT_DIR", "",
        *opts,
    ])
    return cfg.freeze()


class RecordingModel:
    """Passes ``inference`` through and keeps what it returned."""

    def __init__(self, model):
        self.model = model
        self.num_classes = model.num_classes
        self.outputs = []

    def inference(self, *args, **kwargs):
        dets = self.model.inference(*args, **kwargs)
        self.outputs.append(dets)
        return dets


def det_set(dets, b):
    v = dets.valid[b]
    rows = torch.cat([dets.scores[b][v, None], dets.classes[b][v, None].float(),
                      dets.boxes[b][v]], dim=1)
    return {tuple(r) for r in rows.cpu().tolist()}


def phase_slice(device, card):
    """R-50 FPN RetinaNet inference through do_test, then one batch again
    with the plain NMS; returns the kernel's record fields."""
    from lgd_tpu_torch.data import TestLoader, get_dataset_dicts
    from lgd_tpu_torch.engine.trainer import do_test
    from lgd_tpu_torch.models.distillator import build_model
    from lgd_tpu_torch.models.heads.retinanet import retinanet_inference
    from lgd_tpu_torch.ops import nms

    cfg = smoke_cfg()
    model = build_model(cfg, dtype=torch.bfloat16, device=device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: R-{cfg.MODEL.RESNETS.DEPTH} FPN RetinaNet, {n_params} "
        f"parameters, {cfg.TPU.COMPUTE_DTYPE} convolutions")

    rec = RecordingModel(model)
    zero_launches()
    t0 = time.perf_counter()
    res = do_test(cfg, rec, device, batch_size=8)
    wall = time.perf_counter() - t0
    path_launches = read_launches()
    launches = path_launches["K2"]

    check(launches > 0, "the slice never launched the NMS kernel")
    check(path_launches == expect_launches({"K2": 1}, len(rec.outputs)),
          (path_launches, len(rec.outputs)))
    n_images = 0
    for dets in rec.outputs:
        for t in (dets.boxes, dets.scores):
            check(torch.isfinite(t).all(), "non-finite detections")
        per_image = dets.valid.sum(dim=1).tolist()
        n_images += len(per_image)
        check(all(1 <= n <= 100 for n in per_image), per_image)
        check(dets.boxes.shape[1:] == (100, 4), tuple(dets.boxes.shape))
    for key in ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR@100"):
        check(key in res["bbox"], key)
    loader = TestLoader(cfg, get_dataset_dicts("synthetic_mini"), 8)
    canvases = {loader.canvases[b] for b, _ in loader._sched}
    log(f"do_test: {len(rec.outputs)} batches ({n_images} slots, "
        f"canvases {sorted(canvases)}), NMS launches {launches}, "
        f"AP {res['bbox']['AP']:.4f}, wall {wall:.2f} s "
        f"= {16 / wall:.2f} images/s incl. host preprocessing and COCO "
        f"scoring [{card}]")

    # one batch again: the same logits through the kernel and the plain NMS
    batch = next(iter(loader))
    images = torch.from_numpy(batch["image"]).to(device).permute(0, 3, 1, 2)
    sizes = torch.from_numpy(batch["image_size"]).to(device)
    pool = {}

    def plain_capturing(boxes_s, valid_s, thr):
        pool.update(boxes=boxes_s, valid=valid_s, thr=thr)
        return nms.greedy_keep_sorted_reference(boxes_s, valid_s, thr)

    with torch.no_grad():
        anchors, counts = model.anchors(images.shape[-2:], device)
        _, feats = model.student(images, sizes)
        logits, deltas = model.student.predict(model._head_features(feats))
        kern = retinanet_inference(cfg, logits, deltas, anchors, counts, sizes)
        plain = retinanet_inference(cfg, logits, deltas, anchors, counts,
                                    sizes, keep_fn=plain_capturing)
    for b in range(images.shape[0]):
        check(det_set(kern, b) == det_set(plain, b), f"image {b} differs")
    keep_k = nms.greedy_keep_sorted(pool["boxes"], pool["valid"], pool["thr"])
    keep_p = nms.greedy_keep_sorted_reference(pool["boxes"], pool["valid"],
                                              pool["thr"])
    err = (keep_k.float() - keep_p.float()).abs().max().item()
    check(err <= NMS_TOL, err)
    log(f"one batch ({tuple(images.shape)}): kernel and plain NMS give equal "
        f"detection sets; pool {tuple(pool['boxes'].shape)}, "
        f"{int(keep_k.sum())} kept")

    ms, loop_ms, split = k2_times(nms.greedy_keep_sorted, pool["boxes"],
                                  pool["valid"], pool["thr"])
    plain_ms = cuda_ms(lambda: nms.greedy_keep_sorted_reference(
        pool["boxes"], pool["valid"], pool["thr"]), iters=3, warmup=1)
    # what this pool needs: boxes and valid read, keep written; one IoU
    # (about 20 operations) of every kept row against each later row
    B, N = keep_p.shape
    later = N - 1 - torch.arange(N, device=keep_p.device)
    pairs = int((keep_p.long() * later).sum())
    bound_ms, bound_by = bound(B * N * (16 + 1 + 1), 20 * pairs)
    log(f"K2 at {tuple(pool['boxes'].shape)}: kernel {ms:.4f} ms by "
        f"CUDA-graph replay ({loop_ms:.4f} over a loop of launches; by "
        f"kernel {fmt_ms(split)}), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}, {pairs} IoUs) [{card}]")

    def infer():
        model.inference(images, sizes)

    step_ms = cuda_ms(infer, iters=5)
    log(f"model.inference, batch {images.shape[0]} at "
        f"{tuple(images.shape[-2:])}: {step_ms:.2f} ms = "
        f"{1000 * images.shape[0] / step_ms:.2f} images/s [{card}]")
    return path_launches, {"max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "library_ms": None}


def attention_inputs(B, N, seed, device, H=8, D=32, Nk=None):
    """q and an output gradient (B, H, N, D), k and v (B, H, Nk, D) (Nk
    defaults to N), and a key mask with padding: image 0 keeps only its
    first key (an image without GT keeps its fallback slot), the last of
    several images keeps none, the others a random 70%."""
    Nk = N if Nk is None else Nk
    g = torch.Generator().manual_seed(seed)
    q, grad = (torch.randn(B, H, N, D, generator=g) for _ in range(2))
    k, v = (torch.randn(B, H, Nk, D, generator=g) for _ in range(2))
    valid = torch.rand(B, Nk, generator=g) > 0.3
    valid[0] = False
    valid[0, 0] = True
    if B > 1:
        valid[-1] = False
    return [t.to(device) for t in (q, k, v, grad, valid)]


class NoTF32:
    """TF32 off for matmuls and cuDNN inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


# K1a/K1b's correctness shapes: (B, Nq, Nk) at the edges of a warp's 4
# rows and of the 32-lane token groups (15, 16, 17), the teacher's 101
# tokens, one full 128-token chunk, three chunks (257), and more queries
# than keys
ATTN_SHAPES = tuple((B, N, N) for B in (1, 16)
                    for N in (1, 15, 16, 17, 101, 128, 257)) + ((16, 101, 37),)


def hold_attention(got, want, what):
    """K1a's output and K1b's gradients (lists [out, dq, dk, dv]) against
    the plain version's: ATTN_FWD_TOL and ATTN_GRAD_TOL of each largest
    value. Returns the largest absolute errors of both."""
    for t in got:
        check(torch.isfinite(t).all(), f"K1 non-finite ({what})")
    errs = []
    for name, a, b, tol in zip(("out", "dq", "dk", "dv"), got, want,
                               (ATTN_FWD_TOL,) + 3 * (ATTN_GRAD_TOL,)):
        check(a.shape == b.shape, (name, a.shape, b.shape))
        e = (a - b).abs().max().item() if b.numel() else 0.0
        check(e <= tol * (b.abs().max().item() if b.numel() else 0.0),
              f"K1 {name} differs ({what}): {e}")
        errs.append(e)
    return errs[0], max(errs[1:])


def graph_ms(make, iters=200):
    """Device time per call of the callable that ``make()`` returns: the
    callable is built and warmed up on a side stream, so that autograd's
    backward of a graph built there runs there too; ``iters`` calls are
    captured into a CUDA graph and one replay is timed with CUDA events.
    The host launches the replay once, so it cannot pace the calls."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn = make()
        for _ in range(3):
            fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph, fn
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / iters


def fmt_ms(times):
    return ", ".join(f"{k} {v:.4f}" for k, v in times.items())


def k2_times(keep_fn, boxes_s, valid_s, thr, calls=20):
    """Kernel K2 (``keep_fn``, a ``greedy_keep_sorted``) on one sorted
    pool: (device ms per call by CUDA-graph replay, ms per call by CUDA
    events over a loop of launches, which the host may pace, {CUDA kernel:
    device ms per call} from torch.profiler over ``calls`` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def fn():
        keep_fn(boxes_s, valid_s, thr)

    graph = graph_ms(lambda: fn)
    loop = cuda_ms(fn, 50)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            name = re.search(r"(\w+)\(|$", e.name).group(1) or e.name
            split[name] = (split.get(name, 0.0)
                           + e.time_range.elapsed_us() / 1e3 / calls)
    return graph, loop, split


def phase_attention(device, card):
    """K1a and K1b against the plain version and its autograd gradient at
    ATTN_SHAPES and every built head width, K1b run twice and bit-equal;
    then timed at the teacher's
    shape (16, 8, 101, 32) beside the plain version and
    scaled_dot_product_attention (the yardstick; the port never calls it),
    by replaying a CUDA graph and by CUDA events over a loop. Returns their
    records (launches come from training)."""
    from lgd_tpu_torch.ops import attention as A

    err_f = err_g = 0.0
    by_width = {}
    with NoTF32():
        for D, (B, Nq, Nk) in ((D, shape) for D in A.BUILT_D
                               for shape in ATTN_SHAPES):
            q, k, v, g, valid = attention_inputs(
                B, Nq, B * 1000 + Nq + Nk + D, device, D=D, Nk=Nk)
            scale = 1.0 / D ** 0.5
            what = f"B={B} Nq={Nq} Nk={Nk} D={D}"
            res = []
            for fn in (A.masked_attention, A.masked_attention_reference):
                qkv = [t.clone().requires_grad_() for t in (q, k, v)]
                out = fn(*qkv, valid, scale)
                res.append([out.detach(), *torch.autograd.grad(out, qkv, g)])
            e_f, e_g = hold_attention(*res, what)
            err_f, err_g = max(err_f, e_f), max(err_g, e_g)
            w_f, w_g = by_width.get(D, (0.0, 0.0))
            by_width[D] = (max(w_f, e_f), max(w_g, e_g))
            # K1b twice on the same inputs: the same bits
            saved = A.attention_fwd(q, k, v, valid, scale)
            first = A.attention_bwd(q, k, v, valid, *saved, g, scale)
            second = A.attention_bwd(q, k, v, valid, *saved, g, scale)
            check(all(torch.equal(a, b) for a, b in zip(first, second)),
                  f"K1b differs from run to run at {what}")
            # the image with no valid key averages V uniformly
            if B > 1:
                got = res[0][0]
                check(torch.allclose(got[-1], v[-1].mean(
                    dim=1, keepdim=True).expand_as(got[-1]), atol=1e-5),
                      f"all-invalid image is not a uniform average at {what}")
    torch.cuda.synchronize()
    log(f"K1a/K1b: {len(ATTN_SHAPES)} shapes (B, Nq, Nk) {ATTN_SHAPES} at "
        f"D in {A.BUILT_D} match the plain version (max abs err forward "
        f"{err_f:.3e}, gradients {err_g:.3e}; by D: " + ", ".join(
            f"{D} {e[0]:.3e} / {e[1]:.3e}" for D, e in by_width.items())
        + f"; tolerances {ATTN_FWD_TOL} / {ATTN_GRAD_TOL} of the largest "
        f"value); K1b bit-equal from run to run")

    B, H, N, D = 16, 8, 101, 32
    q, k, v, g, valid = attention_inputs(B, N, 7, device)
    scale = 1.0 / D ** 0.5
    mask = valid[:, None, None, :]
    saved = A.attention_fwd(q, k, v, valid, scale)

    def backward_of(fn):
        """Makes a call of autograd's backward of fn alone: the forward
        graph is built once and kept."""
        def make():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = fn(*qkv)
            return lambda: torch.autograd.grad(out, qkv, g,
                                               retain_graph=True)
        return make

    calls = {
        "K1a": lambda: lambda: A.attention_fwd(q, k, v, valid, scale),
        "plain forward": lambda: lambda: A.masked_attention_reference(
            q, k, v, valid, scale),
        "SDPA": lambda: lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale),
        "K1b": lambda: lambda: A.attention_bwd(q, k, v, valid, *saved, g,
                                               scale),
        "plain backward": backward_of(lambda *t: A.masked_attention_reference(
            *t, valid, scale)),
        "SDPA backward": backward_of(lambda *t: F.scaled_dot_product_attention(
            *t, attn_mask=mask, scale=scale)),
    }
    with NoTF32():
        dev = {name: graph_ms(make) for name, make in calls.items()}
        loop = {name: cuda_ms(make(), 200, 5) for name, make in calls.items()}
    elems, pairs = B * H * N * D * 4, B * H * N * N
    rows = B * H * N * 4  # one float per query row (m, s)
    f_bound, f_by = bound(4 * elems + 2 * rows + B * N, pairs * (4 * D + 6))
    b_bound, b_by = bound(8 * elems + 2 * rows + B * N,
                          pairs * (10 * D + 10) + 2 * B * H * N * D)
    for what, names, bnd, by in (
            ("K1a", ("K1a", "plain forward", "SDPA"), f_bound, f_by),
            ("K1b", ("K1b", "plain backward", "SDPA backward"), b_bound,
             b_by)):
        log(f"{what} at {(B, H, N, D)}, ms per call, a CUDA graph of 200 "
            f"calls replayed (CUDA events over a loop of 200 launches from "
            f"Python in brackets): " + ", ".join(
                f"{n} {dev[n]:.4f} ({loop[n]:.4f})" for n in names)
            + f"; bound {bnd:.6f} ms ({by}) [{card}]")

    return ({"max_abs_err": err_f, "ms": dev["K1a"],
             "plain_ms": dev["plain forward"], "bound_ms": f_bound,
             "bound_by": f_by, "library_ms": dev["SDPA"]},
            {"max_abs_err": err_g, "ms": dev["K1b"],
             "plain_ms": dev["plain backward"], "bound_ms": b_bound,
             "bound_by": b_by, "library_ms": dev["SDPA backward"]})


FPN_STRIDES = (4, 8, 16, 32)   # p2-p5, the ROI heads' levels


def roi_inputs(B, C, canvas, dtype, device, seed, n_random):
    """A p2-p5 pyramid (B, C) of a canvas and B x (16 + n_random) ROIs: the
    fixed cases (every level, past each edge, under a texel, sqrt(area) of
    112 and 224, the s_max cap, an empty box, a thin one; then, for the
    backward's windows, the whole canvas (the whole top level), a box
    ending on the bottom-right edge (high corners clamped onto one
    texel), and a wide and a tall box on p2 whose capped bins span
    several of the kernel's 32-texel window tiles), then random boxes of
    log-uniform size; slot 8 of image 0 is invalid, and so is the whole
    last image."""
    g = torch.Generator().manual_seed(seed)
    H, W = canvas
    feats = [torch.randn(B, C, -(-H // s), -(-W // s), generator=g)
             .to(device, dtype) for s in FPN_STRIDES]
    fixed = torch.tensor([
        [10.3, 12.7, 40.1, 30.9], [3.0, 5.0, 3.4, 5.3],
        [-20.0, -15.0, 60.0, 50.0], [W - 90.0, H - 60.0, W + 30.0, H + 20.0],
        [5.0, 7.0, 117.0, 119.0], [0.0, 0.0, 224.0, 224.0],
        [0.0, 0.0, 448.0, 448.0], [-300.0, -200.0, W + 300.0, H + 200.0],
        [30.0, 20.0, 80.0, 110.0], [64.0, 64.0, 64.0, 64.0],
        [50.0, 40.0, 160.0, 128.0], [12.0, 33.0, 150.0, 41.0],
        [0.0, 0.0, W, H], [W - 40.0, H - 40.0, W, H],
        [10.0, 10.0, 400.0, 30.0], [20.0, 15.0, 44.0, 700.0]])
    ctr = torch.rand(B, n_random, 2, generator=g) * torch.tensor([W, H])
    wh = torch.exp(torch.rand(B, n_random, 2, generator=g) * 6.5) + 1.0
    boxes = torch.cat([fixed.expand(B, -1, -1),
                       torch.cat([ctr - wh / 2, ctr + wh / 2], -1)], 1)
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool)
    valid[0, 8] = False
    valid[-1] = False
    return feats, boxes.to(device), valid.to(device)


def proposal_inputs(B, P, dtype, device, seed, canvas=(800, 1344), C=256):
    """A p2-p5 pyramid at full width and B x P proposal-like ROIs (random
    centres, log-uniform sides of 8-800 px, clipped to the canvas), all
    valid: the shapes of the R-CNN box head on the slice."""
    g = torch.Generator().manual_seed(seed)
    H, W = canvas
    feats = [torch.randn(B, C, H // s, W // s, generator=g).to(device, dtype)
             for s in FPN_STRIDES]
    ctr = torch.rand(B, P, 2, generator=g) * torch.tensor([W, H])
    wh = 8.0 * torch.exp(torch.rand(B, P, 2, generator=g) * math.log(100.0))
    lo = torch.minimum(ctr - wh / 2, torch.tensor([W, H]) - 2.0).clamp(min=0)
    hi = torch.maximum(ctr + wh / 2, lo + 2.0).clamp(max=torch.tensor(
        [W, H], dtype=torch.float32))
    boxes = torch.cat([lo, hi], -1)
    return feats, boxes.to(device), torch.ones(B, P, dtype=torch.bool,
                                               device=device)


def bf16_ulp(x):
    """One bfloat16 ulp (8 significant bits) at each value of x."""
    a = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def weighed_texel_bytes(features, index, coords, out, roi_chunk=512):
    """Bytes of the level texels (all channels of each) that this run's
    samples give a non-zero weight: what a forward must read. A mask per
    level, scattered from the kernel's own sample geometry; computed once
    per input, outside the timed calls."""
    from lgd_tpu_torch.ops import roi_align as RA

    dev = index.device
    grid = torch.arange(out, device=dev, dtype=torch.float32)
    n_max = max(int(index[:, 2:].max()), 1)
    masks = [torch.zeros(f.shape[0] * f.shape[2] * f.shape[3],
                         dtype=torch.bool, device=dev) for f in features]

    def axis(origin, bin_size, n, size):
        """(rows or columns, weighed) of every sample's two corners along
        one axis: (ROIs, out * n_max * 2) each."""
        rows, used = [], []
        for i in range(n_max):
            share = torch.where(i < n, 1.0 / n, 0.0)
            c0, w0, c1, w1 = RA._bilinear_axis(
                origin + bin_size * (grid + (i + 0.5) / n), size, share)
            rows += [c0, c1]
            used += [w0 > 0, w1 > 0]
        return torch.cat(rows, 1), torch.cat(used, 1)

    for s in range(0, index.shape[0], roi_chunk):
        idx, crd = index[s:s + roi_chunk].long(), coords[s:s + roi_chunk]
        for lvl, f in enumerate(features):
            sel = idx[:, 1] == lvl
            if not sel.any():
                continue
            i, c = idx[sel], crd[sel]
            H, W = f.shape[2:]
            n = i.shape[0]
            ys, y_used = axis(c[:, 0:1], c[:, 2:3], i[:, 2:3].float(),
                              torch.full((n, 1), H, device=dev))
            xs, x_used = axis(c[:, 1:2], c[:, 3:4], i[:, 3:4].float(),
                              torch.full((n, 1), W, device=dev))
            pix = ((i[:, 0, None, None] * H + ys[:, :, None]) * W
                   + xs[:, None, :])
            masks[lvl][pix[y_used[:, :, None] & x_used[:, None, :]]] = True
    C, itemsize = features[0].shape[1], features[0].element_size()
    return sum(int(m.sum()) for m in masks) * C * itemsize


def roi_bound(features, index, coords, out, out_itemsize, forward):
    """(bound_ms, bound_by) of one K3 call: the level texels that the
    samples weigh read once (forward), or every level's gradient written
    once (backward: the gradient is dense); the pooled output written
    (forward) or its gradient read (backward) once; the ROI tables read
    once; 12 operations (4 weight products, 4 products and 4 sums) per
    output element and sample that this run's ROIs take."""
    out_elems_per_roi = features[0].shape[1] * out * out
    levels = (weighed_texel_bytes(features, index, coords, out) if forward
              else sum(f.numel() * f.element_size() for f in features))
    n_bytes = (levels + index.numel() * 4 + coords.numel() * 4
               + index.shape[0] * out_elems_per_roi * out_itemsize)
    samples = (index[:, 2].long() * index[:, 3].long()
               * (index[:, 1] >= 0).long()).sum().item()
    return bound(n_bytes, 12 * out_elems_per_roi * samples)


def hold_roi(feats, index, coords, out, grad, what):
    """K3 forward and, given a pooled gradient, backward against the plain
    version on the same inputs. The forward summed in float32 within
    ROI_TOL of the largest value; for bfloat16 levels, also the rounded
    output within one bf16 ulp more. The backward against autograd of the plain
    version on float32 copies of the levels (the weights do not depend on
    the values): float32 within ROI_TOL of each level's largest value,
    bfloat16 within one ulp of the rounding plus that. Returns the forward
    summed in float32, the gradients, and the largest absolute errors of
    the forward and the backward in the levels' dtype."""
    from lgd_tpu_torch.ops import roi_align as RA

    dtype = feats[0].dtype
    got = RA.roi_align_fwd(feats, index, coords, out, out_dtype=torch.float32)
    want = RA.multilevel_roi_align_reference(feats, index, coords, out,
                                             out_dtype=torch.float32)
    err_f = (got - want).abs().max().item()
    tol_f = ROI_TOL * want.abs().max().item()
    check(err_f <= tol_f, f"K3 forward differs ({what}): {err_f}")
    if dtype == torch.bfloat16:  # then rounded once to bf16
        k = RA.roi_align_fwd(feats, index, coords, out)
        p = RA.multilevel_roi_align_reference(feats, index, coords, out)
        check(k.dtype == torch.bfloat16, k.dtype)
        diff = (k.float() - p.float()).abs()
        check((diff <= tol_f + bf16_ulp(p)).all(),
              f"K3 bf16 forward beyond one ulp more ({what})")
        err_f = max(err_f, diff.max().item())
        del k, p, diff
    del want
    if grad is None:
        return got, None, err_f, 0.0
    got_g = RA.roi_align_bwd(grad, index, coords, feats)
    leaves = [f.detach().float().requires_grad_() for f in feats]
    want_g = torch.autograd.grad(RA.multilevel_roi_align_reference(
        leaves, index, coords, out), leaves, grad.float())
    err_b = 0.0
    for lvl, (a, b) in enumerate(zip(got_g, want_g)):
        check(a.dtype == dtype and a.shape == b.shape, (a.dtype, a.shape))
        b = b.to(dtype).float()
        e = (a.float() - b).abs()
        tol = ROI_TOL * b.abs().max()
        if dtype == torch.bfloat16:
            tol = tol + bf16_ulp(b)
        check((e <= tol).all(),
              f"K3 backward beyond tolerance at p{lvl + 2} ({what}): "
              f"{e.max().item()}")
        err_b = max(err_b, e.max().item())
    return got, got_g, err_f, err_b


def check_roi_case(B, C, canvas, n_random, dtype, device, out=7):
    """``hold_roi`` on the adversarial ROIs of ``roi_inputs``; invalid ROIs
    pool zeros and the all-invalid image gets no gradient. Returns the
    largest absolute errors of the forward and the backward."""
    from lgd_tpu_torch.ops import roi_align as RA

    feats, boxes, valid = roi_inputs(B, C, canvas, dtype, device,
                                     B * 100 + C, n_random)
    index, coords = RA.roi_geometry(boxes, valid, FPN_STRIDES, out, 2)
    grad = torch.randn(index.shape[0], feats[0].shape[1], out, out,
                       generator=torch.Generator().manual_seed(C))
    what = f"{dtype}, C={C}"
    got, got_g, err_f, err_b = hold_roi(feats, index, coords, out,
                                        grad.to(device, dtype), what)
    check(not got[~valid.flatten()].any(), "an invalid ROI pooled non-zeros")
    check(not any(g[-1].any() for g in got_g),
          "the all-invalid image got a gradient")
    return err_f, err_b


def phase_roi_align(device, card):
    """K3 forward and backward against the plain version on adversarial
    ROIs in both dtypes, then timed at the slice's shapes; returns the
    forward's and the backward's records (launches come from the paths)."""
    from lgd_tpu_torch.ops import roi_align as RA

    out = 7
    err_f = err_b = 0.0
    checked = 0
    with NoTF32():
        # the third canvas has one-texel p5 and 2 x 2 p4 levels
        for B, C, canvas, n_random in ((3, 32, (256, 352), 60),
                                       (2, 256, (800, 1344), 40),
                                       (3, 16, (32, 32), 30)):
            for dtype in (torch.float32, torch.bfloat16):
                e_f, e_b = check_roi_case(B, C, canvas, n_random, dtype,
                                          device, out)
                err_f, err_b = max(err_f, e_f), max(err_b, e_b)
                checked += 1
    torch.cuda.synchronize()
    log(f"K3: {checked} adversarial cases (float32 and bfloat16 levels, "
        f"edges, tiny boxes, the s_max cap, invalid slots and an all-invalid "
        f"image; whole-level ROIs, one-texel levels, high corners clamped "
        f"on the edge, windows of several tiles) match the plain version "
        f"(max abs err forward {err_f:.3e}, backward {err_b:.3e}; "
        f"tolerance {ROI_TOL} of the largest value, "
        f"one bf16 ulp more after rounding)")

    # the slice's shapes: held against the plain version at the same
    # limits, then timed; the kernel line's errors are these
    records = {}
    slice_err_f = slice_err_b = 0.0
    for what, B, P, dtype in (("training, student", 16, 512, torch.bfloat16),
                              ("training, teacher", 16, 512, torch.float32),
                              ("inference", 8, 1000, torch.bfloat16)):
        feats, boxes, valid = proposal_inputs(B, P, dtype, device, seed=P)
        index, coords = RA.roi_geometry(boxes, valid, FPN_STRIDES, out, 2)
        training = what.startswith("training")
        grad = (torch.randn(index.shape[0], feats[0].shape[1], out, out,
                            device=device, dtype=dtype) if training else None)
        with NoTF32():
            _, _, e_f, e_b = hold_roi(feats, index, coords, out, grad, what)
        slice_err_f, slice_err_b = max(slice_err_f, e_f), max(slice_err_b,
                                                              e_b)
        f_ms = cuda_ms(lambda: RA.roi_align_fwd(feats, index, coords, out),
                       20, 3)
        f_plain = cuda_ms(lambda: RA.multilevel_roi_align_reference(
            feats, index, coords, out), 2, 1)
        f_bound, f_by = roi_bound(feats, index, coords, out,
                                  feats[0].element_size(), forward=True)
        line = (f"K3 forward, {what}: {index.shape[0]} ROIs of "
                f"{tuple(feats[0].shape)}"
                f"-p5 {dtype}: max abs err {e_f:.3e}, kernel {f_ms:.4f} ms, "
                f"plain {f_plain:.4f} ms, bound {f_bound:.6f} ms ({f_by})")
        if training:
            b_ms = cuda_ms(lambda: RA.roi_align_bwd(grad, index, coords,
                                                    feats), 20, 3)
            leaves = [f.detach().requires_grad_() for f in feats]
            pooled = RA.multilevel_roi_align_reference(leaves, index, coords,
                                                       out)
            b_plain = cuda_ms(lambda: torch.autograd.grad(
                pooled, leaves, grad, retain_graph=True), 2, 1)
            del pooled, leaves
            b_bound, b_by = roi_bound(feats, index, coords, out,
                                      grad.element_size(), forward=False)
            line += (f"; backward: max abs err {e_b:.3e}, kernel {b_ms:.4f} "
                     f"ms, plain (autograd backward) {b_plain:.4f} ms, bound "
                     f"{b_bound:.6f} ms ({b_by})")
            if "student" in what:  # the kernel line's shapes
                records = ({"ms": f_ms, "plain_ms": f_plain,
                            "bound_ms": f_bound, "bound_by": f_by,
                            "library_ms": None},
                           {"ms": b_ms, "plain_ms": b_plain,
                            "bound_ms": b_bound, "bound_by": b_by,
                            "library_ms": None})
        log(line + f" [{card}]")
        del feats, grad
        torch.cuda.empty_cache()
    records[0]["max_abs_err"] = slice_err_f
    records[1]["max_abs_err"] = slice_err_b
    return records


def rpn_pool(device):
    """A pool at the RPN's training shape: 16 images x 2000 proposals
    (boxes, scores, levels, valid), the five levels as classes."""
    import numpy as np

    rng = np.random.RandomState(1)
    boxes, scores, _, valid = adversarial_pool(rng, 16, 2000, device)
    levels = torch.from_numpy(rng.randint(0, 5, (16, 2000))).to(device)
    return boxes, scores, levels, valid


def phase_nms_rpn(device):
    """K2 at the RPN's shape (``rpn_pool``) at NMS 0.7 and 0.5, bit-equal
    to its plain version."""
    from lgd_tpu_torch.ops import nms

    boxes, scores, levels, valid = rpn_pool(device)
    for thr in (0.7, 0.5):
        got = nms.batched_nms_mask(boxes, scores, levels, valid, thr)
        want = nms.batched_nms_mask(boxes, scores, levels, valid, thr,
                                    keep_fn=nms.greedy_keep_sorted_reference)
        check(torch.equal(got, want), f"K2 differs at (16, 2000), {thr}")
    torch.cuda.synchronize()
    log("K2 at the RPN's (16, 2000) pools, levels as classes: bit-equal to "
        "the plain version")


def dcn_inputs(B, C, H, W, stride=1, dilation=1, modulated=True,
               dtype=torch.float32, device="cpu", seed=0, spread=None):
    """x (B, C, H, W), float32 offsets (B, 18, Ho, Wo) and mask (B, 9, Ho,
    Wo), or None, of a 3x3 deformable conv, drawn with numpy from ``seed``.
    With ``spread`` the offsets are N(0, spread) px. Without, adversarial:
    each dy and each dx is, at random, an integer, a fraction, a negative
    fraction, a point past either border by under one texel or by more,
    exactly -1, exactly the last row or column, an offset beyond +-6 px, or
    +-1e3. A tenth of the mask is exactly 0 and a tenth exactly 1."""
    import numpy as np

    from lgd_tpu_torch.ops import deform_conv as D

    rng = np.random.RandomState(seed)
    Ho, Wo = D.output_size(H, W, 3, stride, dilation)
    shape = (B, 9, Ho, Wo)
    x = rng.randn(B, C, H, W).astype(np.float32)

    def axis(base, size):
        base = np.broadcast_to(base, shape)
        u = rng.rand(*shape)
        sign = np.where(rng.rand(*shape) < 0.5, -1.0, 1.0)
        edge = np.where(sign < 0, 0.0, size - 1.0)
        cases = np.stack([
            rng.randint(-3, 4, shape).astype(np.float64),
            (u - 0.5) * 4.0,
            -3.0 * u,
            edge + sign * u - base,
            edge + sign * (1.0 + 3.0 * u) - base,
            -1.0 - base,
            size - 1.0 - base,
            sign * (6.0 + 4.0 * u),
            sign * 1e3])
        pick = rng.randint(0, len(cases), shape)
        return np.take_along_axis(cases, pick[None], 0)[0]

    if spread is None:
        base_y, base_x = (t.numpy() for t in D.base_grid(Ho, Wo, 3, stride,
                                                         dilation))
        off = np.stack([axis(base_y, H), axis(base_x, W)], 2)
    else:
        off = rng.randn(B, 9, 2, Ho, Wo) * spread
    mask = None
    if modulated:
        pick = rng.rand(*shape)
        mask = np.where(pick < 0.1, 0.0,
                        np.where(pick < 0.2, 1.0, rng.rand(*shape)))
        mask = torch.from_numpy(mask.astype(np.float32)).to(device)
    off = off.reshape(B, 18, Ho, Wo).astype(np.float32)
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(off).to(device), mask)


# K4's tiles: the backward's (8 x 16 output positions, an input window 2
# texels wider than the unmoved taps' reach, channels staged 4 at a time)
# and the forward's (runs of 256 output positions, a window 3 rows past
# the taps' reach, at full width where it fits in shared memory, else over
# the run's own columns; channels staged up to 8 at a time): cases at
# their edges, (kind, B, C, H, W, stride, dilation). "spill": offsets of
# N(0, 6) px, mostly beyond the windows' halos; "borders": each image's
# samples pushed across one border, partly and wholly off the image;
# "zero mask": every share 0; "plain": the adversarial draw of
# ``dcn_inputs`` (here stride 2 with dilation 2). 22, 20 and 18 channels
# leave partial stages, and no case has a whole number of runs; "ragged
# run": res5's 25 x 42 map (1050 positions, an odd number of pairs past
# the last whole run); "unmodulated": no mask, samples leaving both
# windows, stride 2 with dilation 2; "wide": maps too wide for the
# forward's window of full rows (X-101's stride-2 res3 unit at a 1760 px
# wide input, a stride-1 map of 600 columns), where each run lies in one
# output row, and one whose run window is cut to fit (stride 2 with
# dilation 2), offsets N(0, 3) px; "tiny gradient": gradients near
# 1e-33, under the bound the fixed-point window takes, which add in
# float32 instead; "nan gradient" and "inf gradient": one gradient in 500
# NaN, or +-inf (times a zero mask, NaN), which must reach dx where the
# plain version's do.
DCN_TILE_CASES = (("spill", 2, 22, 40, 56, 1, 1),
                  ("spill", 2, 20, 33, 47, 2, 2),
                  ("borders", 4, 16, 35, 50, 1, 1),
                  ("zero mask", 2, 16, 20, 36, 1, 1),
                  ("plain", 2, 18, 37, 45, 2, 2),
                  ("ragged run", 1, 24, 25, 42, 1, 1),
                  ("unmodulated", 2, 20, 33, 47, 2, 2),
                  ("wide", 1, 16, 24, 440, 2, 1),
                  ("wide", 1, 12, 16, 600, 1, 1),
                  ("wide", 1, 8, 20, 1100, 2, 2),
                  ("tiny gradient", 2, 16, 20, 36, 1, 1),
                  ("nan gradient", 2, 16, 20, 36, 1, 1),
                  ("inf gradient", 2, 16, 20, 36, 1, 1))


def dcn_tile_case(kind, B, C, H, W, stride, dilation, dtype, device, seed):
    """x, offsets, mask and the columns' gradient of a ``DCN_TILE_CASES``
    entry."""
    import numpy as np

    from lgd_tpu_torch.ops import deform_conv as D

    x, off, mask = dcn_inputs(B, C, H, W, stride, dilation,
                              kind != "unmodulated", dtype, device, seed,
                              spread={"spill": 6.0, "borders": 1.5,
                                      "ragged run": 1.5,
                                      "unmodulated": 6.0,
                                      "wide": 3.0}.get(kind))
    if kind == "borders":
        # image 0 samples in y from (-3, 0), image 1 from (H - 1, H + 2),
        # images 2 and 3 likewise in x: some corners in, most out
        rng = np.random.RandomState(seed)
        Ho, Wo = off.shape[-2:]
        base = D.base_grid(Ho, Wo, 3, stride, dilation, device)
        off = off.reshape(B, 9, 2, Ho, Wo)
        for img, (axis, lo) in enumerate(((0, -3.0), (0, H - 1.0),
                                          (1, -3.0), (1, W - 1.0))):
            u = torch.from_numpy(rng.rand(9, Ho, Wo).astype(np.float32))
            off[img, :, axis] = lo + 3.0 * u.to(device) - base[axis]
        off = off.reshape(B, 18, Ho, Wo).contiguous()
    if kind == "zero mask":
        mask = torch.zeros_like(mask)
    grad = torch.randn(B, C, 9, *off.shape[-2:],
                       generator=torch.Generator().manual_seed(H))
    if kind == "tiny gradient":
        grad = grad * 1e-33
    if kind in ("nan gradient", "inf gradient"):
        g = torch.Generator().manual_seed(W)
        hit = torch.rand(grad.shape, generator=g) < 0.002
        bad = (torch.full_like(grad, float("nan")) if kind == "nan gradient"
               else torch.sign(grad) * float("inf"))
        grad = torch.where(hit, bad, grad)
    return x, off, mask, grad.to(device, dtype)


def hold_dcn(x, offsets, mask, stride, dilation, grad, what):
    """K4 forward and, given the columns' gradient, backward against the
    plain version on the same inputs: the columns bit for bit in float32
    and within one bf16 ulp in bfloat16; the backward's recomputed columns
    equal to the forward's; dx, the offsets' and the mask's gradients
    against autograd of the plain version on float32 copies, within
    DCN_TOL of each one's largest value (bfloat16 dx one ulp more). Where
    the gradients hold NaN or inf: dx NaN, +inf and -inf where the plain
    version's are, the offsets' and the mask's gradients not finite where
    its are, and the finite values within the same limits of the largest
    finite one. Returns the largest absolute errors of the forward and the
    backward."""
    from lgd_tpu_torch.ops import deform_conv as D

    got = D.deform_sample_fwd(x, offsets, mask, 3, stride, dilation)
    want = D.deform_sample_reference(x, offsets, mask, 3, stride, dilation)
    check(got.dtype == x.dtype and got.shape == want.shape,
          (got.dtype, tuple(got.shape)))
    diff = (got.float() - want.float()).abs()
    err_f = diff.max().item()
    if x.dtype == torch.float32:
        check(torch.equal(got, want), f"K4 forward differs ({what}): {err_f}")
    else:
        check((diff <= bf16_ulp(want)).all(),
              f"K4 bf16 forward beyond one ulp ({what}): {err_f}")
    del want, diff
    if grad is None:
        return err_f, 0.0
    dx, doff, dmask, cols = D.deform_sample_bwd(grad, x, offsets, mask, 3,
                                                stride, dilation)
    check(torch.equal(cols, got),
          f"K4 backward's columns differ from the forward's ({what})")
    del cols, got
    want = D.deform_sample_bwd_reference(grad.float(), x.float(), offsets,
                                         mask, 3, stride, dilation)
    check((dmask is None) == (mask is None), "K4 mask gradient")
    err_b = 0.0
    for name, a, b in zip(("dx", "doffsets", "dmask"), (dx, doff, dmask),
                          want[:3]):
        if a is None:
            continue
        check(a.dtype == (x.dtype if name == "dx" else torch.float32)
              and a.shape == b.shape, (name, a.dtype, tuple(a.shape)))
        bf16 = a.dtype == torch.bfloat16
        a, b = a.float(), b.to(a.dtype).float()
        finite = torch.isfinite(b)
        if name == "dx":
            check(all(torch.equal(f(a), f(b)) for f in (
                torch.isnan, torch.isposinf, torch.isneginf)),
                f"K4 dx: NaN or inf elsewhere than the plain version's "
                f"({what})")
        else:
            check(torch.equal(torch.isfinite(a), finite),
                  f"K4 {name}: not finite elsewhere than the plain "
                  f"version's ({what})")
        a, b = torch.where(finite, a, 0.0), torch.where(finite, b, 0.0)
        e = (a - b).abs()
        tol = DCN_TOL * b.abs().max()
        if bf16:
            tol = tol + bf16_ulp(b)
        check((e <= tol).all(), f"K4 {name} beyond tolerance ({what}): "
                                f"{e.max().item()} (largest "
                                f"{b.abs().max().item()})")
        err_b = max(err_b, e.max().item())
    return err_f, err_b


def dcn_bound(x, offsets, mask, forward):
    """(bound_ms, bound_by) of one K4 call. Forward: x, the offsets and
    the mask read once, the columns written once; 12 operations per sample
    and channel (8 products and 3 sums of the bilinear form, the mask).
    Backward: the columns' gradient, x, the offsets and the mask read once;
    dx, the offsets' and the mask's gradients and the columns written
    once; 43 operations per sample and channel (the sample and its mask
    again, 4 shares and their sums, 2 x 8 for the offsets' derivatives, 2
    for the mask's)."""
    n_cols = x.shape[0] * x.shape[1] * 9 * offsets[0, 0].numel()
    side = 4 * (offsets.numel() + (0 if mask is None else mask.numel()))
    xb = x.numel() * x.element_size()
    cb = n_cols * x.element_size()
    if forward:
        return bound(xb + side + cb, 12 * n_cols)
    return bound(2 * (xb + side + cb), 43 * n_cols)


def sampling_grid(offsets, H, W):
    """The sample points of ``offsets`` (B, 18, Ho, Wo) of a stride-1,
    dilation-1 conv as F.grid_sample's grid (B, 9 * Ho, Wo, 2) with
    align_corners=True, float32."""
    from lgd_tpu_torch.ops import deform_conv as D

    B, _, Ho, Wo = offsets.shape
    base_y, base_x = D.base_grid(Ho, Wo, device=offsets.device)
    off = offsets.reshape(B, 9, 2, Ho, Wo)
    py, px = base_y + off[:, :, 0], base_x + off[:, :, 1]
    grid = torch.stack([px / (W - 1) * 2 - 1, py / (H - 1) * 2 - 1], -1)
    return grid.reshape(B, 9 * Ho, Wo, 2)


# R-101's deformable layers at batch 16 on the 800x1344 canvas: name,
# channels, height, width, and the number of layers of that shape (all
# stride 1; X-101's stride-2 first blocks are among the adversarial cases)
DCN_SLICE = (("res3", 128, 100, 168, 4), ("res4", 256, 50, 84, 23),
             ("res5", 512, 25, 42, 3))


def phase_deform_conv(device, card):
    """K4 forward and backward against the plain version on adversarial
    offsets, float32 and bfloat16, modulated and not, stride 2 and
    dilation 2; then at the slice's own shapes, held at the same limits
    and timed beside the plain version and F.grid_sample times the mask
    (the yardstick; the port never calls it). Returns the forward's and
    the backward's records at res4, where 23 of the 30 layers sit
    (launches come from the paths)."""
    from lgd_tpu_torch.ops import deform_conv as D

    err_f = err_b = 0.0
    checked = 0
    for B, C, H, W, stride, dil, mod in ((2, 8, 13, 17, 1, 1, True),
                                         (2, 8, 13, 17, 1, 1, False),
                                         (2, 16, 12, 9, 2, 1, True),
                                         (3, 4, 10, 11, 1, 2, True),
                                         (1, 32, 25, 42, 2, 2, False),
                                         (2, 64, 50, 84, 1, 1, True),
                                         (2, 512, 25, 42, 2, 1, True)):
        for dtype in (torch.float32, torch.bfloat16):
            x, off, mask = dcn_inputs(B, C, H, W, stride, dil, mod, dtype,
                                      device, seed=C + H + stride + dil)
            Ho, Wo = off.shape[-2:]
            grad = torch.randn(B, C, 9, Ho, Wo, generator=torch.Generator()
                               .manual_seed(C)).to(device, dtype)
            what = (f"{dtype}, {(B, C, H, W)}, stride {stride}, dilation "
                    f"{dil}, {'modulated' if mod else 'unmodulated'}")
            e_f, e_b = hold_dcn(x, off, mask, stride, dil, grad, what)
            err_f, err_b = max(err_f, e_f), max(err_b, e_b)
            checked += 1
    for kind, B, C, H, W, stride, dil in DCN_TILE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, off, mask, grad = dcn_tile_case(kind, B, C, H, W, stride,
                                               dil, dtype, device,
                                               seed=C + H + W)
            what = (f"{kind}, {dtype}, {(B, C, H, W)}, stride {stride}, "
                    f"dilation {dil}")
            e_f, e_b = hold_dcn(x, off, mask, stride, dil, grad, what)
            err_f, err_b = max(err_f, e_f), max(err_b, e_b)
            checked += 1
    torch.cuda.synchronize()
    log(f"K4: {checked} adversarial cases (integer, fractional and "
        f"negative offsets, past each border by under a texel and by more, "
        f"exactly -1 and the last row and column, beyond +-6 px, +-1e3; "
        f"masks of 0 and 1, unmodulated, stride 2, dilation 2; for both "
        f"directions' tiles: offsets of N(0, 6) px beyond the windows' "
        f"halos, samples pushed off every border, a mask of zeros, partial "
        f"channel stages, ragged runs, maps too wide for the forward's "
        f"full rows, gradients near 1e-33) match the plain version "
        f"(max abs err forward {err_f:.3e}, float32 bit for bit; backward "
        f"{err_b:.3e}; tolerance {DCN_TOL} of the largest value, one bf16 "
        f"ulp more)")

    records, errs = None, [0.0, 0.0]
    for name, C, H, W, layers in DCN_SLICE:
        x, off, mask = dcn_inputs(16, C, H, W, dtype=torch.bfloat16,
                                  device=device, seed=C, spread=1.5)
        Ho, Wo = off.shape[-2:]
        grad = torch.randn(16, C, 9, Ho, Wo, device=device,
                           dtype=torch.bfloat16)
        what = f"R-101 {name}, {(16, C, H, W)} bf16"
        e_f, e_b = hold_dcn(x, off, mask, 1, 1, grad, what)
        errs = [max(errs[0], e_f), max(errs[1], e_b)]
        f_ms = cuda_ms(lambda: D.deform_sample_fwd(x, off, mask), 20, 3)
        f_plain = cuda_ms(lambda: D.deform_sample_reference(x, off, mask),
                          1, 1)
        b_ms = cuda_ms(lambda: D.deform_sample_bwd(grad, x, off, mask), 10, 2)
        b_plain = cuda_ms(lambda: D.deform_sample_bwd_reference(
            grad, x, off, mask), 1, 1)
        # the yardstick: grid_sample at the same points times the mask, in
        # the columns' own layout (B, C, 9 * Ho, Wo), and its backward
        leaves = [x.detach().requires_grad_(),
                  sampling_grid(off, H, W).to(x.dtype).requires_grad_(),
                  mask.reshape(16, 1, 9 * Ho, Wo).to(x.dtype)
                  .requires_grad_()]

        def yardstick(x_, grid_, m_):
            return F.grid_sample(x_, grid_, mode="bilinear",
                                 padding_mode="zeros",
                                 align_corners=True) * m_

        with torch.no_grad():
            f_lib = cuda_ms(lambda: yardstick(*leaves), 20, 3)
        lib_out = yardstick(*leaves)
        g_lib = grad.reshape(16, C, 9 * Ho, Wo)
        b_lib = cuda_ms(lambda: torch.autograd.grad(
            lib_out, leaves, g_lib, retain_graph=True), 10, 2)
        del lib_out, leaves
        f_bound, f_by = dcn_bound(x, off, mask, forward=True)
        b_bound, b_by = dcn_bound(x, off, mask, forward=False)
        log(f"K4 at {what} ({layers} layers): forward max abs err {e_f:.3e}, "
            f"kernel {f_ms:.4f} ms, plain {f_plain:.4f} ms, grid_sample "
            f"{f_lib:.4f} ms, bound {f_bound:.6f} ms ({f_by}); backward max "
            f"abs err {e_b:.3e}, kernel {b_ms:.4f} ms, plain (autograd "
            f"backward) {b_plain:.4f} ms, grid_sample backward {b_lib:.4f} "
            f"ms, bound {b_bound:.6f} ms ({b_by}) [{card}]")
        if name == "res4":
            records = ({"ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound,
                        "bound_by": f_by, "library_ms": f_lib},
                       {"ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound,
                        "bound_by": b_by, "library_ms": b_lib})
        del x, off, mask, grad
        torch.cuda.empty_cache()
    records[0]["max_abs_err"], records[1]["max_abs_err"] = errs
    return records


def lgd_train_opts(steps, distill_from):
    """The LGD training settings of both detectors: reference R-50 solver
    settings, the synthetic split at the reference training size (short
    edge 800, long edge <= 1333: canvases 800x1344 and 1344x800), batch
    TRAIN_BATCH, the teacher's context box, the backbone pre-freeze lifting
    after step 0 and distillation from step ``distill_from``."""
    solver = []
    for who in ("STUDENT", "TEACHER"):
        node = f"MODEL.DISTILLATOR.{who}.SOLVER."
        solver += [node + "OPTIMIZER", "SGD", node + "BASE_LR", 0.01,
                   node + "MOMENTUM", 0.9, node + "WEIGHT_DECAY", 1e-4,
                   node + "LR_SCHEDULER_NAME", "WarmupMultiStepLR",
                   node + "STEPS", (60000, 80000), node + "GAMMA", 0.1,
                   node + "WARMUP_FACTOR", 1e-3, node + "WARMUP_ITERS", 1000,
                   node + "WARMUP_METHOD", "linear"]
    return [
        "MODEL.DISTILLATOR.TEACHER.ADD_CONTEXT_BOX", True,
        "MODEL.DISTILLATOR.PRE_FREEZE_STUDENT_BACKBONE_ITERS", 1,
        "MODEL.DISTILLATOR.PRE_NONDISTILL_ITERS", distill_from,
        "DATASETS.TRAIN", ("synthetic_mini",),
        "INPUT.MIN_SIZE_TRAIN", (800,), "INPUT.MAX_SIZE_TRAIN", 1333,
        "SOLVER.IMS_PER_BATCH", TRAIN_BATCH,
        "SOLVER.MAX_ITER", steps,
        *solver]


def train_cfg(opts=()):
    """The RetinaNet training slice."""
    return smoke_cfg([*lgd_train_opts(TRAIN_STEPS, 3),
                      "MODEL.RETINANET.SMOOTH_L1_LOSS_BETA", 0.0, *opts])


def rcnn_cfg(opts=()):
    """Faster R-CNN R-50 FPN at full width, as detectron2's public
    configs/Base-RCNN-FPN.yaml: res2-res5 into a 256-channel FPN with the
    max-pool p6, one anchor size per level (32-512) at 3 ratios, RPN
    proposals 2000 per level then 1000 per image in training and 1000 /
    1000 at test at NMS 0.7, 512 ROIs per image at 0.25 positives,
    ROIAlignV2 7x7 with adaptive sampling over p2-p5, two FCs of 1024, 80
    classes; bf16 student convolutions, seeded random weights."""
    from lgd_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.META_ARCHITECTURE", "DistillatorGeneralizedRCNN",
        "MODEL.BACKBONE.NAME", "build_resnet_fpn_backbone",
        "MODEL.RESNETS.DEPTH", 50,
        "MODEL.RESNETS.OUT_FEATURES", ["res2", "res3", "res4", "res5"],
        "MODEL.FPN.IN_FEATURES", ["res2", "res3", "res4", "res5"],
        "MODEL.ANCHOR_GENERATOR.SIZES", [[32], [64], [128], [256], [512]],
        "MODEL.RPN.IN_FEATURES", ["p2", "p3", "p4", "p5", "p6"],
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 2000,
        "MODEL.RPN.PRE_NMS_TOPK_TEST", 1000,
        "MODEL.RPN.POST_NMS_TOPK_TRAIN", 1000,
        "MODEL.RPN.POST_NMS_TOPK_TEST", 1000,
        "MODEL.ROI_HEADS.IN_FEATURES", ["p2", "p3", "p4", "p5"],
        "MODEL.ROI_BOX_HEAD.NAME", "FastRCNNConvFCHead",
        "MODEL.ROI_BOX_HEAD.NUM_FC", 2,
        "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", 7,
        # random weights put every class probability near 1/81, under the
        # default 0.05 threshold: keep them so NMS sees full pools
        "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 0.0,
        "MODEL.DISTILLATOR.EVAL_TEACHER", False,
        "DATASETS.TEST", ("synthetic_mini",),
        "TPU.COMPUTE_DTYPE", "bfloat16",
        "OUTPUT_DIR", "",
        *opts,
    ])
    return cfg.freeze()


def rcnn_train_cfg(opts=()):
    """The R-CNN training slice: distillation from step 2."""
    return rcnn_cfg([*lgd_train_opts(RCNN_TRAIN_STEPS, 2), *opts])


# device kernels grouped by what they do, for the profile's summary: the
# first family with a substring of the kernel's name; then elementwise by
# type
KERNEL_FAMILIES = (
    ("K1a/K1b attention", ("attn_fwd_kernel", "attn_bwd_kernel")),
    ("K3 ROIAlign", ("roi_align_fwd_kernel", "roi_align_bwd_kernel")),
    ("K4 deformable sampling", ("deform_fwd_kernel", "deform_bwd_kernel")),
    ("K2 NMS", ("nms_mask_kernel", "nms_sweep_kernel")),
    ("layout NCHW<->NHWC", ("nchwToNhwc", "nhwcToNchw", "AddPadding")),
    ("convolution", ("implicit_gemm", "conv", "fprop", "dgrad", "wgrad",
                     "winograd", "cudnn", "cutlass", "tensorTransform")),
    ("matrix product", ("gemm", "gemv", "nvjet", "cublas")),
    ("reduction", ("reduce_kernel",)),
    ("copy, cast, concatenate, gather", ("Memcpy", "Memset", "copy", "Copy",
                                         "gather")),
)


def kernel_family(name):
    for family, keys in KERNEL_FAMILIES:
        if any(k in name for k in keys):
            return family
    if "elementwise" in name:
        return "elementwise " + ("bf16" if "BFloat16" in name else "float32")
    return "other"


def device_profile(fn, steps):
    """(wall ms, device busy ms, [(kernel, ms)] by total time, {range:
    device ms}) over ``steps`` calls of fn under torch.profiler. A range's
    device time is that of the kernels launched inside it on the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name, ranges = {}, dict.fromkeys(STEP_RANGES, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
        elif e.device_type == DeviceType.CPU and e.name in ranges:
            ranges[e.name] += e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return wall, sum(by_name.values()), top, ranges


RETINANET_LOSSES = ("loss_box_reg", "loss_box_reg.tea", "loss_cls",
                    "loss_cls.tea", "loss_distill")
RCNN_LOSSES = tuple(sorted(
    [k + t for k in ("loss_box_reg", "loss_cls", "loss_rpn_cls",
                     "loss_rpn_loc") for t in ("", ".tea")]
    + ["loss_distill"]))


def phase_train(device, card, cfg, what, steps, timed, distill_from,
                per_step, loss_keys, prepare=None):
    """LGD training at full width through do_train (``steps`` steps, the
    backbone pre-freeze lifting after step 0, distillation from step
    ``distill_from``), then ``timed`` timed steady-state steps and a
    profile of two. Every kernel launches ``per_step`` times per step.
    ``prepare(model)`` runs once the model is built. Returns (model,
    launches of the do_train run)."""
    from lgd_tpu_torch.data import TrainLoader
    from lgd_tpu_torch.engine.train_step import (
        batch_to_device,
        make_train_step,
        phase,
    )
    from lgd_tpu_torch.engine.trainer import do_train
    from lgd_tpu_torch.models.distillator import build_model

    check(phase(cfg, 0) == (0.0, 0.0) and phase(cfg, 1) == (0.0, 1.0)
          and phase(cfg, distill_from) == (1.0, 1.0)
          and phase(cfg, distill_from - 1)[0] == 0.0, "phase schedule")
    batch = cfg.SOLVER.IMS_PER_BATCH
    dtype = getattr(torch, cfg.TPU.COMPUTE_DTYPE)
    model = build_model(cfg, dtype=dtype, device=device, seed=0)
    if prepare is not None:
        prepare(model)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"train model: R-{cfg.MODEL.RESNETS.DEPTH} FPN {what} + "
        f"{cfg.MODEL.DISTILLATOR.TEACHER.NR_TRANSFORMER_HEADS}-head teacher "
        f"({cfg.TPU.MAX_INSTANCES + 1} tokens), {n_params} parameters, "
        f"{cfg.TPU.COMPUTE_DTYPE} student, float32 teacher, batch {batch}")

    # record what each step computed: the losses, and the gradient that
    # loss_distill alone sends into the student's p3 features
    losses_seen, distill_grads = [], []
    train_forward, distill_loss = model.train_forward, model.distill_loss

    def recording_forward(*args, **kwargs):
        losses, norm = train_forward(*args, **kwargs)
        losses_seen.append({k: v.detach() for k, v in losses.items()})
        return losses, norm

    def probing_distill(stu, tea, flag):
        loss = distill_loss(stu, tea, flag)
        (grad,) = torch.autograd.grad(loss, [stu["p3"]], retain_graph=True)
        distill_grads.append((flag, grad.abs().max().float()))
        return loss

    model.train_forward, model.distill_loss = recording_forward, probing_distill
    stem = model.student.bottom_up.stem_conv1.weight.detach().clone()
    # res3's first block trains once the pre-freeze lifts: its 1x1 conv,
    # and a deformable unit's offset conv, which learns through K4's
    # backward
    trunk = dict(model.student.bottom_up.named_parameters())
    moving = {n: trunk[n].detach().clone() for n in (
        "res3_0.conv1.weight", "res3_0.conv2.offset_conv.weight",
        "res3_0.conv2.offset_conv.bias") if n in trunk}
    loader = TrainLoader(cfg)
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    do_train(cfg, model, device, loader)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    del model.train_forward, model.distill_loss

    check(len(losses_seen) == steps, len(losses_seen))
    for i, losses in enumerate(losses_seen):
        check(tuple(sorted(losses)) == loss_keys, sorted(losses))
        for key, val in losses.items():
            check(math.isfinite(float(val)), f"step {i} {key} = {val}")
    for i, (flag, grad) in enumerate(distill_grads):
        g = float(grad)
        on = i >= distill_from
        check(flag == float(on), f"step {i} distill flag {flag}")
        check((g > 0) == on, f"step {i}: loss_distill sends {g} to the "
                             f"student with flag {flag}")
    check(launches == expect_launches(per_step, steps),
          f"{launches} launches in {steps} steps, expected {per_step} per "
          f"step")
    check(torch.equal(model.student.bottom_up.stem_conv1.weight, stem),
          "the FREEZE_AT stem conv moved")
    for name, before in moving.items():
        check(not torch.equal(trunk[name], before),
              f"{name} never trained after the pre-freeze")
    log(f"do_train: {steps} steps in {wall:.2f} s (first-step set-up and "
        f"host data included); launches {launches}; loss_distill reaches "
        f"the student from step {distill_from} (|grad p3| "
        f"{float(distill_grads[distill_from - 1][1]):.3e} at step "
        f"{distill_from - 1}, {float(distill_grads[distill_from][1]):.3e} "
        f"at step {distill_from}); stem unchanged, {', '.join(moving)} "
        f"moved; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for i in (0, steps - 1):
        log(f"  step {i}: " + ", ".join(
            f"{k} {float(v):.4f}" for k, v in sorted(losses_seen[i].items())))

    # steady state (distillation on, backbone training), staged batches
    init_state, train_step = make_train_step(cfg, model)
    state = init_state()
    state.step = steps
    it = iter(loader)
    batches = [batch_to_device(next(it), device) for _ in range(2)]
    canvases = sorted({tuple(b["image"].shape[-2:]) for b in batches})
    holder = [state]

    def one_step(i=[0]):
        holder[0], _ = train_step(holder[0], batches[i[0] % 2])
        i[0] += 1

    one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        one_step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / timed
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof_wall, busy, top, ranges = device_profile(one_step, 2)
    log(f"train step ({what}), batch {batch} at {canvases}: {step_ms:.2f} ms "
        f"= {1e3 * batch / step_ms:.2f} images/s, peak memory {peak:.2f} GiB "
        f"[{card}]")
    if busy > 0:
        log(f"profiled 2 steps: wall {prof_wall:.2f} ms, device busy "
            f"{busy:.2f} ms, idle share {1 - busy / prof_wall:.4f} [{card}]")
        families = {}
        for name, ms in top:
            family = kernel_family(name)
            families[family] = families.get(family, 0.0) + ms / 2
        families = sorted(families.items(), key=lambda kv: -kv[1])
        for family, ms in families:
            log(f"  {ms:10.3f} ms/step  {100 * ms / (busy / 2):6.2f}%  "
                f"{family}")
        for name, ms in top[:12]:
            log(f"  {ms / 2:10.3f} ms/step  {name[:100]}")
        fwd, opt = (ranges[k] / 2 for k in STEP_RANGES)
        log(f"device time per step: forward {fwd:.2f} ms, optimizer "
            f"{opt:.2f} ms, backward and the rest "
            f"{busy / 2 - fwd - opt:.2f} ms [{card}]" if fwd > 0 else
            "profiler saw no device time under the step's ranges: the "
            "split is not measured")
    else:
        log("profiler saw no device time: idle share not measured")
    del batches, holder, state
    return model, launches


def phase_eval_teacher(model, cfg, device, card, per_batch):
    """do_test with the teacher's features through the student's head;
    every kernel launches ``per_batch`` times per batch."""
    from lgd_tpu_torch.engine.trainer import do_test

    rec = RecordingModel(model)
    zero_launches()
    t0 = time.perf_counter()
    res = do_test(cfg, rec, device, batch_size=8, eval_teacher=True)
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(launches == expect_launches(per_batch, len(rec.outputs)),
          (launches, len(rec.outputs)))
    for dets in rec.outputs:
        check(torch.isfinite(dets.scores).all(), "non-finite detections")
    for key in ("AP", "AP50", "AP75", "AR@100"):
        check(key in res["bbox"] and math.isfinite(res["bbox"][key]), key)
    log(f"do_test(eval_teacher=True): {len(rec.outputs)} batches, launches "
        f"{launches}, AP {res['bbox']['AP']:.4f}, AP50 "
        f"{res['bbox']['AP50']:.4f}, wall {wall:.2f} s [{card}]")
    return launches


def same_det_sets(a, b, i, box_tol=1e-3, score_tol=1e-4):
    """Image i's valid detections of a and b are equal as sets: the same
    count, each row of a matched to its own row of b of the same class with
    the nearest box, within tolerance. Returns the largest box and score
    differences."""
    rows = []
    for d in (a, b):
        v = d.valid[i]
        rows.append((d.scores[i][v].float().cpu(), d.classes[i][v].cpu(),
                     d.boxes[i][v].float().cpu()))
    (sa, ca, ba), (sb, cb, bb) = rows
    check(len(sa) == len(sb), f"image {i}: {len(sa)} vs {len(sb)} detections")
    free = torch.ones(len(sb), dtype=torch.bool)
    worst_box = worst_score = 0.0
    for s, c, box in zip(sa, ca, ba):
        dist = (bb - box).abs().amax(1)
        dist = torch.where(free & (cb == c), dist, float("inf"))
        j = int(dist.argmin())
        check(float(dist[j]) <= box_tol
              and abs(float(sb[j] - s)) <= score_tol,
              f"image {i}: detection {c.item()} {box.tolist()} {float(s)} "
              f"has no match")
        free[j] = False
        worst_box = max(worst_box, float(dist[j]))
        worst_score = max(worst_score, abs(float(sb[j] - s)))
    return worst_box, worst_score


class PlainKernels:
    """Inside the block the NMS sweep and the deformable sampling forward
    are their plain versions: the model's code finds
    ``nms.greedy_keep_sorted`` and ``deform_conv.deform_sample_fwd`` by
    module attribute when it calls them, so ``model.inference`` itself runs
    the plain path. Every pool the sweep sees is kept in ``pools``."""

    def __enter__(self):
        from lgd_tpu_torch.ops import deform_conv as D
        from lgd_tpu_torch.ops import nms

        self.saved = (nms.greedy_keep_sorted, D.deform_sample_fwd)
        self.pools = []

        def keep(boxes_s, valid_s, thr):
            self.pools.append((boxes_s, valid_s, thr))
            return nms.greedy_keep_sorted_reference(boxes_s, valid_s, thr)

        nms.greedy_keep_sorted = keep
        D.deform_sample_fwd = D.deform_sample_reference
        return self

    def __exit__(self, *exc):
        from lgd_tpu_torch.ops import deform_conv as D
        from lgd_tpu_torch.ops import nms

        nms.greedy_keep_sorted, D.deform_sample_fwd = self.saved


def phase_rcnn_inference(device, card):
    """Faster R-CNN R-50 FPN inference through do_test, then one batch
    again through ``model.inference`` with the plain NMS, equal detection
    sets, and K3 held against the plain ROIAlign on that batch's own ROIs
    (K3 sums in another order than the plain version, so one bf16 ulp in
    a pooled value may reorder the random box head's near-tied
    detections: the sets with the plain ROIAlign are not compared); K2 on
    that batch's RPN pool. Returns the path's launches."""
    from lgd_tpu_torch.data import TestLoader, get_dataset_dicts
    from lgd_tpu_torch.engine.trainer import do_test
    from lgd_tpu_torch.models.distillator import build_model
    from lgd_tpu_torch.ops import nms
    from lgd_tpu_torch.ops import roi_align as RA

    cfg = rcnn_cfg()
    model = build_model(cfg, dtype=torch.bfloat16, device=device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: R-{cfg.MODEL.RESNETS.DEPTH} FPN Faster R-CNN, {n_params} "
        f"parameters, {cfg.TPU.COMPUTE_DTYPE} convolutions")

    rec = RecordingModel(model)
    zero_launches()
    t0 = time.perf_counter()
    res = do_test(cfg, rec, device, batch_size=8)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n = len(rec.outputs)
    check(launches == expect_launches({"K2": 2, "K3 forward": 1}, n),
          (launches, n))
    for dets in rec.outputs:
        for t in (dets.boxes, dets.scores):
            check(torch.isfinite(t).all(), "non-finite detections")
        per_image = dets.valid.sum(dim=1).tolist()
        check(all(1 <= k <= 100 for k in per_image), per_image)
    for key in ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR@100"):
        check(key in res["bbox"], key)
    log(f"R-CNN do_test: {n} batches, launches {launches}, AP "
        f"{res['bbox']['AP']:.4f}, wall {wall:.2f} s = {16 / wall:.2f} "
        f"images/s incl. host preprocessing and COCO scoring [{card}]")

    loader = TestLoader(cfg, get_dataset_dicts("synthetic_mini"), 8)
    batch = next(iter(loader))
    images = torch.from_numpy(batch["image"]).to(device).permute(0, 3, 1, 2)
    sizes = torch.from_numpy(batch["image_size"]).to(device)
    kern = model.inference(images, sizes)
    before = read_launches()
    # the box head's ROIAlign inputs, recorded by an instance attribute
    # that shadows the ROI heads' ``pool`` method until it is deleted
    heads = model.student.roi_heads
    pool, pooled = heads.pool, []

    def recorded_pool(*args):
        pooled.append(args)
        return pool(*args)

    heads.pool = recorded_pool
    try:
        with PlainKernels() as plain_run:
            plain = model.inference(images, sizes)
    finally:
        del heads.pool
    check(read_launches() == {**before,
                              "K3 forward": before["K3 forward"] + 1},
          "the run with the plain NMS launched another kernel than K3")
    pools = plain_run.pools
    check(len(pools) == 2, f"{len(pools)} NMS pools")
    check(len(pooled) == 1, f"{len(pooled)} ROIAlign calls")
    worst = [same_det_sets(kern, plain, i) for i in range(images.shape[0])]
    for what, (boxes_s, valid_s, thr) in zip(("RPN", "box head"), pools):
        keep = nms.greedy_keep_sorted(boxes_s, valid_s, thr)
        check(torch.equal(keep, nms.greedy_keep_sorted_reference(
            boxes_s, valid_s, thr)), f"K2 differs on the {what} pool")
    feats, boxes, valid = pooled[0]
    out = heads.resolution
    index, coords = RA.roi_geometry(boxes, valid, heads.strides, out,
                                    heads.min_level, heads.sampling_ratio)
    feats = [feats[f].contiguous() for f in heads.in_features]
    with NoTF32():
        _, _, err_roi, _ = hold_roi(feats, index, coords, out, None,
                                    "the R-CNN inference batch's own ROIs")
    log(f"one batch ({tuple(images.shape)}): the kernels and the plain NMS "
        f"give equal detection sets (largest differences: box "
        f"{max(w[0] for w in worst):.3e} px, score "
        f"{max(w[1] for w in worst):.3e}); K2 bit-equal on the RPN pool "
        f"{tuple(pools[0][0].shape)} and the box head's "
        f"{tuple(pools[1][0].shape)}; K3 on the batch's "
        f"{index.shape[0]} ROIs within its tolerance of the plain version "
        f"(max abs err {err_roi:.3e})")
    for what, (boxes_s, valid_s, thr) in zip(("RPN", "box head"), pools):
        ms, loop_ms, split = k2_times(nms.greedy_keep_sorted, boxes_s,
                                      valid_s, thr)
        log(f"K2 at the {what} pool {tuple(boxes_s.shape)}: kernel "
            f"{ms:.4f} ms by CUDA-graph replay ({loop_ms:.4f} over a loop "
            f"of launches; by kernel {fmt_ms(split)}) [{card}]")
    boxes_s, valid_s, thr = pools[0]
    plain_ms = cuda_ms(lambda: nms.greedy_keep_sorted_reference(
        boxes_s, valid_s, thr), 2, 1)
    log(f"K2's plain version at the RPN pool: {plain_ms:.4f} ms [{card}]")

    def infer():
        model.inference(images, sizes)

    step_ms = cuda_ms(infer, iters=5)
    log(f"R-CNN model.inference, batch {images.shape[0]} at "
        f"{tuple(images.shape[-2:])}: {step_ms:.2f} ms = "
        f"{1000 * images.shape[0] / step_ms:.2f} images/s [{card}]")
    del model, rec
    torch.cuda.empty_cache()
    return launches


def card_vs_cpu_gt(cfg):
    from lgd_tpu_torch.structures import BatchedInstances

    return BatchedInstances.from_lists(  # image 1 has no GT: fallback slot
        [[[8.0, 10.0, 90.0, 70.0], [40.0, 30.0, 150.0, 120.0]],
         torch.zeros((0, 4)).numpy()], [[3, 41], []], cfg.TPU.MAX_INSTANCES)


def compare_card_cpu(names, got, want):
    for name, a, b in zip(names, got, want):
        scale = b.abs().max().item()
        diff = (a - b).abs().max().item()
        # cuDNN and oneDNN sum 50 layers of convolutions in other orders
        tol = TRAIN_LOSS_TOL if name.startswith("loss") else 1e-3
        check(diff <= tol * scale, (name, diff, scale))
        log(f"card vs CPU float32 {name} {tuple(a.shape)}: max abs diff "
            f"{diff:.3e} (scale {scale:.3e})")


def phase_card_vs_cpu(device, opts=(), per_run=None, prepare=None):
    """The float32 model on the card against the same model on the CPU, on
    a small input, TF32 off: features and head outputs of inference, then
    train_forward's losses and normalizer with a backward (K1a and K1b on
    the card, their plain versions on the CPU). ``opts`` change the
    R-50 model, whose run launches ``per_run``; ``prepare(model, images,
    sizes)`` sets the CPU model's weights, which the card's model then
    loads."""
    from lgd_tpu_torch.models.distillator import build_model

    cfg = smoke_cfg(["TPU.COMPUTE_DTYPE", "float32",
                     "MODEL.DISTILLATOR.TEACHER.ADD_CONTEXT_BOX", True,
                     *opts])
    cpu = build_model(cfg, dtype=torch.float32, device="cpu", seed=1)
    gpu = build_model(cfg, dtype=torch.float32, device=device, seed=1)
    g = torch.Generator().manual_seed(0)
    images = torch.rand(2, 3, 128, 160, generator=g) * 255
    sizes = torch.tensor([[128, 160], [100, 120]])
    if prepare is not None:
        prepare(cpu, images, sizes)
        gpu.load_state_dict(cpu.state_dict())
    gt = card_vs_cpu_gt(cfg)

    def outputs(model, dev):
        with torch.no_grad():
            _, feats = model.student(images.to(dev), sizes.to(dev))
            head = model._head_features(feats)
            out = [t.cpu() for t in [*head, *model.student.predict(head)]]
        losses, norm = model.train_forward(images.to(dev), sizes.to(dev),
                                           gt.to(dev), 1.0,
                                           torch.tensor(100.0, device=dev))
        sum(losses[k] for k in sorted(losses)).backward()
        out += [losses[k].detach().cpu() for k in sorted(losses)]
        return out + [norm.cpu()]

    zero_launches()
    with NoTF32():
        got = outputs(gpu, device)
    torch.cuda.synchronize()
    launched = read_launches()
    check(launched == expect_launches(per_run or {"K1a": 5, "K1b": 5}, 1),
          f"card train_forward launched {launched}")
    want = outputs(cpu, "cpu")
    check(read_launches() == launched, "the CPU model launched a kernel")
    compare_card_cpu([*cfg.MODEL.RETINANET.IN_FEATURES, "logits", "deltas",
                      *RETINANET_LOSSES, "loss_normalizer"], got, want)


def phase_rcnn_card_vs_cpu(device):
    """The float32 R-CNN model on the card against the same model on the
    CPU, on a small input, TF32 off, with the same uniforms: the FPN
    levels, the RPN's outputs, and train_forward's nine losses and
    normalizer with a backward (K1a/K1b, K2 and K3 on the card, their plain
    versions on the CPU). Smaller proposal pools than the slice's: the
    order of near-equal proposal scores decides which uniform each
    proposal draws, and a large pool on a 128x160 input holds near-ties
    that rounding can reorder."""
    from lgd_tpu_torch.engine.train_step import draw_uniforms
    from lgd_tpu_torch.models.distillator import build_model

    cfg = rcnn_cfg(["TPU.COMPUTE_DTYPE", "float32",
                    "MODEL.DISTILLATOR.TEACHER.ADD_CONTEXT_BOX", True,
                    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", 200,
                    "MODEL.RPN.POST_NMS_TOPK_TRAIN", 100,
                    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64])
    cpu = build_model(cfg, dtype=torch.float32, device="cpu", seed=1)
    gpu = build_model(cfg, dtype=torch.float32, device=device, seed=1)
    g = torch.Generator().manual_seed(0)
    images = torch.rand(2, 3, 128, 160, generator=g) * 255
    sizes = torch.tensor([[128, 160], [100, 120]])
    gt = card_vs_cpu_gt(cfg)
    uniforms = draw_uniforms(cpu.sampling_shapes(2, (128, 160),
                                                 gt.boxes.shape[1]),
                             torch.Generator().manual_seed(1), "cpu")
    levels = cfg.MODEL.RPN.IN_FEATURES

    def outputs(model, dev):
        with torch.no_grad():
            _, feats = model.student(images.to(dev), sizes.to(dev))
            out = [t.cpu() for t in [*(feats[k] for k in levels),
                                     *model.student.rpn(feats)]]
        u = {who: {k: v.to(dev) for k, v in d.items()}
             for who, d in uniforms.items()}
        losses, norm = model.train_forward(images.to(dev), sizes.to(dev),
                                           gt.to(dev), 1.0,
                                           torch.tensor(100.0, device=dev),
                                           uniforms=u)
        check(tuple(sorted(losses)) == RCNN_LOSSES, sorted(losses))
        sum(losses[k] for k in sorted(losses)).backward()
        out += [losses[k].detach().cpu() for k in sorted(losses)]
        return out + [norm.cpu()]

    zero_launches()
    with NoTF32():
        got = outputs(gpu, device)
    torch.cuda.synchronize()
    launched = read_launches()
    check(launched == expect_launches({"K1a": 5, "K1b": 5, "K2": 2,
                                       "K3 forward": 2, "K3 backward": 2}, 1),
          f"card train_forward launched {launched}")
    want = outputs(cpu, "cpu")
    check(read_launches() == launched, "the CPU model launched a kernel")
    compare_card_cpu([*levels, "rpn logits", "rpn deltas", *RCNN_LOSSES,
                      "loss_normalizer"], got, want)


DCN_OPTS = ["MODEL.RESNETS.DEPTH", 101,
            "MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True],
            "MODEL.RESNETS.DEFORM_MODULATED", True]
X101_OPTS = ["MODEL.RESNETS.NUM_GROUPS", 32, "MODEL.RESNETS.WIDTH_PER_GROUP",
             8, "MODEL.RESNETS.STRIDE_IN_1X1", False]
DCN_UNITS = 30  # deformable 3x3s of R-101 / X-101 in res3-res5: 4 + 23 + 3
DCN_TRAIN_STEPS = 4    # R-101-DCNv2 do_train steps with the checks
DCN_TIMED_STEPS = 3
OFFSET_SPREAD = 1.5    # px, the spread the drawn offset convs give


def dcn_train_cfg(opts=()):
    """The RetinaNet R-101-DCNv2 LGD training slice: distillation from
    step 2, gradients clipped by value at 1.0 (SOLVER.CLIP_GRADIENTS, as
    the in-repo mini configs set it). Without the clip, seeded random
    weights at R-101 depth diverge at the first backbone update, with and
    without deformable stages and with K4 or its plain version alike:
    loss_cls 3.7e3, then 1.5e8, then NaN (R-101 without DCN: 1.8e5, then
    2.4e15, then NaN); R-50 does not."""
    return smoke_cfg([*DCN_OPTS, *lgd_train_opts(DCN_TRAIN_STEPS, 2),
                      "MODEL.RETINANET.SMOOTH_L1_LOSS_BETA", 0.0,
                      "SOLVER.CLIP_GRADIENTS.ENABLED", True, *opts])


def draw_offset_convs(model, images, sizes, seed=0):
    """Seeded random weights for every deformable unit's offset conv
    (the model's own start at zero, where every sample lies on the grid
    and the kernel's fractional arithmetic never runs), scaled unit by unit
    in one forward pass over ``images`` so that its offsets spread
    OFFSET_SPREAD px there; the mask logits scale alike. Logs each stage's
    offset spread and the share of sample points outside the feature
    map."""
    from lgd_tpu_torch.models.backbones.resnet import DeformConvUnit
    from lgd_tpu_torch.ops import deform_conv as D

    g = torch.Generator().manual_seed(seed)
    stats, handles = {}, []

    def calibrate(unit, stage):
        def hook(conv, inputs, out):
            scale = OFFSET_SPREAD / out[:, :18].std()
            conv.weight.mul_(scale)
            out = out * scale
            H, W = inputs[0].shape[-2:]
            Ho, Wo = out.shape[-2:]
            base_y, base_x = D.base_grid(Ho, Wo, 3, unit.stride,
                                         unit.dilation, out.device)
            off = out[:, :18].reshape(-1, 9, 2, Ho, Wo)
            py, px = base_y + off[:, :, 0], base_x + off[:, :, 1]
            outside = (py < 0) | (py > H - 1) | (px < 0) | (px > W - 1)
            stats.setdefault(stage, []).append(
                (float(off.std()), float(outside.float().mean())))
            return out
        return hook

    for name, unit in model.student.bottom_up.named_modules():
        if isinstance(unit, DeformConvUnit):
            conv = unit.offset_conv
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=g))
                conv.bias.zero_()
            handles.append(conv.register_forward_hook(
                calibrate(unit, name.split("_")[0])))
    with torch.no_grad():
        model.student(images, sizes)
    for h in handles:
        h.remove()
    check(sum(len(v) for v in stats.values()) == DCN_UNITS, stats.keys())
    log("offset convs drawn: " + "; ".join(
        f"{stage} {len(v)} units, offsets spread "
        f"{sum(x[0] for x in v) / len(v):.3f} px, "
        f"{100 * sum(x[1] for x in v) / len(v):.2f}% of sample points "
        f"outside the map" for stage, v in stats.items()))


def eval_batch(cfg, device):
    """The first batch of the synthetic split at the test canvases:
    (images NCHW, sizes) on the card."""
    from lgd_tpu_torch.data import TestLoader, get_dataset_dicts

    batch = next(iter(TestLoader(cfg, get_dataset_dicts("synthetic_mini"),
                                 8)))
    return (torch.from_numpy(batch["image"]).to(device).permute(0, 3, 1, 2),
            torch.from_numpy(batch["image_size"]).to(device))


def phase_dcn_inference(device, card, what, opts):
    """DistillatorRetinaNet with modulated DCN in res3-res5 through do_test
    at batch 8 (offset convs drawn), K2 once and K4 30 times per batch, of
    which the stride-2 first blocks (X-101) are counted; then one batch
    again through ``model.inference`` inside PlainKernels (plain NMS and
    plain K4 forward): equal detection sets. Returns the path's
    launches."""
    from lgd_tpu_torch.engine.trainer import do_test
    from lgd_tpu_torch.models.backbones.resnet import DeformConvUnit
    from lgd_tpu_torch.models.distillator import build_model

    cfg = smoke_cfg([*DCN_OPTS, *opts])
    model = build_model(cfg, dtype=torch.bfloat16, device=device, seed=0)
    images, sizes = eval_batch(cfg, device)
    draw_offset_convs(model, images, sizes)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {what} FPN RetinaNet, {n_params} parameters, "
        f"{cfg.TPU.COMPUTE_DTYPE} convolutions")
    strided = [0]
    handles = [u.register_forward_hook(lambda *a: strided.__setitem__(
        0, strided[0] + 1)) for u in model.student.bottom_up.modules()
        if isinstance(u, DeformConvUnit) and u.stride == 2]

    rec = RecordingModel(model)
    zero_launches()
    t0 = time.perf_counter()
    res = do_test(cfg, rec, device, batch_size=8)
    wall = time.perf_counter() - t0
    launches = read_launches()
    for h in handles:
        h.remove()
    n = len(rec.outputs)
    check(launches == expect_launches({"K2": 1, "K4 forward": DCN_UNITS}, n),
          (launches, n))
    check(strided[0] == len(handles) * n, (strided, len(handles), n))
    for dets in rec.outputs:
        for t in (dets.boxes, dets.scores):
            check(torch.isfinite(t).all(), "non-finite detections")
        per_image = dets.valid.sum(dim=1).tolist()
        check(all(1 <= k <= 100 for k in per_image), per_image)
    for key in ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR@100"):
        check(key in res["bbox"], key)
    log(f"{what} do_test: {n} batches, launches {launches} (stride-2 K4 "
        f"{strided[0]}), AP {res['bbox']['AP']:.4f}, wall {wall:.2f} s "
        f"= {16 / wall:.2f} images/s incl. host preprocessing and COCO "
        f"scoring [{card}]")

    kern = model.inference(images, sizes)
    before = read_launches()
    with PlainKernels():
        plain = model.inference(images, sizes)
    check(read_launches() == before, "the plain run launched a kernel")
    worst = [same_det_sets(kern, plain, i) for i in range(images.shape[0])]
    log(f"one batch ({tuple(images.shape)}): K4 and the plain sampling (and "
        f"K2 and the plain NMS) give equal detection sets (largest "
        f"differences: box {max(w[0] for w in worst):.3e} px, score "
        f"{max(w[1] for w in worst):.3e})")
    step_ms = cuda_ms(lambda: model.inference(images, sizes), iters=5)
    log(f"{what} model.inference, batch {images.shape[0]} at "
        f"{tuple(images.shape[-2:])}: {step_ms:.2f} ms = "
        f"{1000 * images.shape[0] / step_ms:.2f} images/s [{card}]")
    del model, rec
    torch.cuda.empty_cache()
    return launches


class CaptureK4Backward:
    """Inside the block, keeps the inputs of the first K4 backward call of
    each input shape after the first ``after`` calls, in ``inputs`` (shape
    -> grad_cols, x, offsets, mask, stride, dilation), copied to the host
    so that the device's peak memory stays the model's. The model finds
    ``deform_conv.deform_sample_bwd`` by module attribute, and the kernel's
    wrapper counts its launches on whatever that attribute holds, so the
    stand-in carries the count and hands it back at the end."""

    def __init__(self, after):
        self.after, self.calls, self.inputs = after, 0, {}

    def __enter__(self):
        from lgd_tpu_torch.ops import deform_conv as D

        self.saved = kernel = D.deform_sample_bwd

        def capture(grad_cols, x, offsets, mask, kernel_size=3, stride=1,
                    dilation=1):
            self.calls += 1
            if self.calls > self.after and tuple(x.shape) not in self.inputs:
                self.inputs[tuple(x.shape)] = (
                    *(None if t is None else t.detach().cpu()
                      for t in (grad_cols, x, offsets, mask)),
                    stride, dilation)
            return kernel(grad_cols, x, offsets, mask, kernel_size, stride,
                          dilation)

        capture.launches = kernel.launches
        D.deform_sample_bwd = capture
        return self

    def __exit__(self, *exc):
        from lgd_tpu_torch.ops import deform_conv as D

        self.saved.launches = D.deform_sample_bwd.launches
        D.deform_sample_bwd = self.saved


def phase_dcn_training(device, card):
    """RetinaNet R-101-DCNv2 LGD training through do_train at batch 16 on
    the 800x1344 canvases (offset convs drawn), K1a/K1b 5 and K4 forward
    and backward 30 each per step, then do_test(eval_teacher=True); K4's
    backward is held and timed again on its own inputs of the third step,
    whose offsets vary smoothly across the map, unlike the independent
    draws of phase_deform_conv; so is its forward, on the same inputs.
    Returns the launches of the do_train run."""
    from lgd_tpu_torch.ops import deform_conv as D

    cfg = dcn_train_cfg()
    images, sizes = eval_batch(cfg, device)
    with CaptureK4Backward(after=2 * DCN_UNITS) as captured:
        model, train = phase_train(
            device, card, cfg, "RetinaNet, DCNv2 in res3-res5",
            DCN_TRAIN_STEPS, DCN_TIMED_STEPS, 2,
            {"K1a": 5, "K1b": 5, "K4 forward": DCN_UNITS,
             "K4 backward": DCN_UNITS}, RETINANET_LOSSES,
            prepare=lambda m: draw_offset_convs(m, images, sizes))
    check(len(captured.inputs) == len(DCN_SLICE), captured.inputs.keys())
    for shape, inputs in sorted(captured.inputs.items()):
        grad, x, off, mask = (None if t is None else t.to(device)
                              for t in inputs[:4])
        stride, dil = inputs[4:]
        Ho, Wo = off.shape[-2:]
        o = off.reshape(-1, 9, 2, Ho, Wo)
        e_f, e_b = hold_dcn(x, off, mask, stride, dil, grad,
                            f"training path's input {shape}")
        f_ms = cuda_ms(lambda: D.deform_sample_fwd(x, off, mask, 3, stride,
                                                   dil), 20, 3)
        ms = cuda_ms(lambda: D.deform_sample_bwd(grad, x, off, mask, 3,
                                                 stride, dil), 10, 2)
        f_bound, f_by = dcn_bound(x, off, mask, forward=True)
        b_bound, b_by = dcn_bound(x, off, mask, forward=False)
        log(f"K4 on the training path's own input {shape} {x.dtype} (step "
            f"2): offsets spread {off.std().item():.3f} px, neighbours' "
            f"offsets differ by "
            f"{(o[..., 1:] - o[..., :-1]).std().item():.3f} px; forward max "
            f"abs err {e_f:.3e}, kernel {f_ms:.4f} ms, bound {f_bound:.6f} "
            f"ms ({f_by}); backward max abs err {e_b:.3e}, kernel {ms:.4f} "
            f"ms, bound {b_bound:.6f} ms ({b_by}) [{card}]")
    del captured
    torch.cuda.empty_cache()
    phase_eval_teacher(model, cfg, device, card,
                       {"K1a": 5, "K2": 1, "K4 forward": DCN_UNITS})
    del model
    torch.cuda.empty_cache()
    return train


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_header()
    build_kernels()
    records, paths = {}, {}
    phase_nms(device)
    phase_nms_rpn(device)
    records["K1a"], records["K1b"] = phase_attention(device, card)
    records["K3 forward"], records["K3 backward"] = phase_roi_align(device,
                                                                    card)
    records["K4 forward"], records["K4 backward"] = phase_deform_conv(device,
                                                                      card)
    # the main paths, each run with the launch counts set to 0 just before
    paths["RetinaNet inference"], records["K2"] = phase_slice(device, card)
    model, paths["RetinaNet training"] = phase_train(
        device, card, train_cfg(), "RetinaNet", TRAIN_STEPS, TIMED_STEPS, 3,
        {"K1a": 5, "K1b": 5}, RETINANET_LOSSES)
    phase_eval_teacher(model, train_cfg(), device, card,
                       {"K1a": 5, "K2": 1})
    del model
    torch.cuda.empty_cache()
    phase_card_vs_cpu(device)
    paths["R-CNN inference"] = phase_rcnn_inference(device, card)
    rcnn_step = {"K1a": 5, "K1b": 5, "K2": 2, "K3 forward": 2,
                 "K3 backward": 2}
    model, paths["R-CNN training"] = phase_train(
        device, card, rcnn_train_cfg(), "Faster R-CNN", RCNN_TRAIN_STEPS,
        RCNN_TIMED_STEPS, 2, rcnn_step, RCNN_LOSSES)
    phase_eval_teacher(model, rcnn_train_cfg(), device, card,
                       {"K1a": 5, "K2": 2, "K3 forward": 1})
    del model
    torch.cuda.empty_cache()
    phase_rcnn_card_vs_cpu(device)
    paths["R-101-DCNv2 inference"] = phase_dcn_inference(
        device, card, "R-101-DCNv2", [])
    paths["X-101-32x8d-DCNv2 inference"] = phase_dcn_inference(
        device, card, "X-101-32x8d-DCNv2", X101_OPTS)
    paths["R-101-DCNv2 training"] = phase_dcn_training(device, card)
    phase_card_vs_cpu(device, DCN_OPTS, {"K1a": 5, "K1b": 5,
                                         "K4 forward": 2 * DCN_UNITS,
                                         "K4 backward": DCN_UNITS},
                      draw_offset_convs)
    for name, launches in paths.items():
        log(f"launches on the {name} path: {launches}")
    for name in records:
        records[name]["launches"] = sum(p[name] for p in paths.values())
        check(records[name]["launches"] > 0, f"{name} never ran on a path")
    kernels = [
        {"name": "greedy_keep_sorted", "route": "cuda",
         "source": "lgd_tpu_torch/csrc/nms.cu",
         "replaces": "lgd_tpu/ops/nms.py:45", **records["K2"]},
        {"name": "attention_fwd", "route": "cuda",
         "source": "lgd_tpu_torch/csrc/attention.cu",
         "replaces": "lgd_tpu/ops/attention.py:114", **records["K1a"]},
        {"name": "attention_bwd", "route": "cuda",
         "source": "lgd_tpu_torch/csrc/attention.cu",
         "replaces": "lgd_tpu/ops/attention.py:130", **records["K1b"]},
        {"name": "roi_align_fwd", "route": "cuda",
         "source": "lgd_tpu_torch/csrc/roi_align.cu",
         "replaces": "lgd_tpu/ops/roi_align.py:414",
         **records["K3 forward"]},
        {"name": "roi_align_bwd", "route": "cuda",
         "source": "lgd_tpu_torch/csrc/roi_align.cu",
         "replaces": "lgd_tpu/ops/roi_align.py:486",
         **records["K3 backward"]},
        {"name": "deform_sample_fwd", "route": "cuda",
         "source": "lgd_tpu_torch/csrc/deform_conv.cu",
         "replaces": "lgd_tpu/ops/deform_conv.py:401",
         **records["K4 forward"]},
        {"name": "deform_sample_bwd", "route": "cuda",
         "source": "lgd_tpu_torch/csrc/deform_conv.cu",
         "replaces": "lgd_tpu/ops/deform_conv.py:563",
         **records["K4 backward"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
