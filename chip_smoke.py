#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the CUDA kernels from the sources in the checkout,
   one nvcc per source, all at once.
2. Kernel K2 (greedy NMS, lgd_tpu_torch/csrc/nms.cu) against its plain
   PyTorch version on the card: adversarial pools (duplicate scores and
   boxes, IoU exactly at the threshold, invalid tails, all-invalid) and the
   inference shape, 8 images x 2000 candidates with class offsets. Keep masks
   must be equal bit for bit.
3. Kernels K1a and K1b (masked attention forward and backward,
   lgd_tpu_torch/csrc/attention.cu) against the plain version and its
   autograd gradient, float32 with TF32 off, at B in {1, 16}, 8 heads,
   N in {2, 33, 64, 101}, D = 32, with padded keys, an image whose only
   valid key is the fallback slot and an image with no valid key; then
   timed at (16, 8, 101, 32) beside the plain version and
   scaled_dot_product_attention (the yardstick; the port never calls it).
4. Inference: DistillatorRetinaNet, R-50 FPN at full width (256-channel
   p3-p7, 9 anchors, 80 classes), seeded random weights, bf16 convolutions,
   through the port's ``do_test`` on the 16-image synthetic split at the
   800x1344 / 1344x800 test canvases, batches of 8. The NMS launch counter
   must rise, every image must have 1..100 finite detections and COCO
   metrics must come back. One batch is then decoded again with the plain
   NMS: the valid detections must be equal as sets. The kernel and its
   plain version are timed on that batch's real pre-NMS pool.
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

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failed check raises, and the script exits
non-zero without that line; so it does without a card.
"""

import json
import math
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
KERNEL_SOURCES = ("nms", "attention")
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM bytes/s
# and float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
TRAIN_BATCH = 16       # the reference's global batch
TRAIN_STEPS = 8        # do_train steps with the checks
TIMED_STEPS = 5        # steady-state steps timed after them
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
    from lgd_tpu_torch.ops import attention, nms

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for path in pool.map(csrc.build, KERNEL_SOURCES):
            log(f"built {path}")
    nms._kernel()
    attention._kernel()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{n} {csrc.build_seconds.get(n, 0.0):.2f} s"
                    for n in KERNEL_SOURCES) + ")")


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


def phase_nms(device):
    """K2 against its plain version on adversarial pools."""
    import numpy as np

    from lgd_tpu_torch.ops import nms

    rng = np.random.RandomState(0)
    third = float(np.float32(50.0) / np.float32(150.0))
    checked = 0
    for B, n in ((8, 2000), (2, 64), (3, 65), (2, 1), (4, 513)):
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
        if n > 51:  # the pair at exactly the threshold survives, strictly
            k = nms.nms_mask(boxes[:1, 50:52], scores[:1, 50:52],
                             valid[:1, 50:52], third)
            check(k.tolist() == [[True, True]], k)
    torch.cuda.synchronize()
    log(f"K2: {checked} adversarial pools bit-equal to the plain version")


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
    nms.greedy_keep_sorted.launches = 0
    t0 = time.perf_counter()
    res = do_test(cfg, rec, device, batch_size=8)
    wall = time.perf_counter() - t0
    launches = nms.greedy_keep_sorted.launches

    check(launches > 0, "the slice never launched the NMS kernel")
    check(launches == len(rec.outputs), (launches, len(rec.outputs)))
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

    ms = cuda_ms(lambda: nms.greedy_keep_sorted(
        pool["boxes"], pool["valid"], pool["thr"]), iters=50)
    plain_ms = cuda_ms(lambda: nms.greedy_keep_sorted_reference(
        pool["boxes"], pool["valid"], pool["thr"]), iters=3, warmup=1)
    # what this pool needs: boxes and valid read, keep written; one IoU
    # (about 20 operations) of every kept row against each later row
    B, N = keep_p.shape
    later = N - 1 - torch.arange(N, device=keep_p.device)
    pairs = int((keep_p.long() * later).sum())
    bound_ms, bound_by = bound(B * N * (16 + 1 + 1), 20 * pairs)
    log(f"K2 at {tuple(pool['boxes'].shape)}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}, {pairs} "
        f"IoUs) [{card}]")

    def infer():
        model.inference(images, sizes)

    step_ms = cuda_ms(infer, iters=5)
    log(f"model.inference, batch {images.shape[0]} at "
        f"{tuple(images.shape[-2:])}: {step_ms:.2f} ms = "
        f"{1000 * images.shape[0] / step_ms:.2f} images/s [{card}]")
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def attention_inputs(B, N, seed, device, H=8, D=32):
    """q, k, v and an output gradient, and a key mask with padding: image
    0 keeps only its first key (an image without GT keeps its fallback
    slot), the last of several images keeps none, the others a random
    70%."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, grad = (torch.randn(B, H, N, D, generator=g) for _ in range(4))
    valid = torch.rand(B, N, generator=g) > 0.3
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


def phase_attention(device, card):
    """K1a and K1b against the plain version and its autograd gradient,
    then timed; returns their records (launches come from training)."""
    from lgd_tpu_torch.ops import attention as A

    err_f = err_g = 0.0
    checked = 0
    with NoTF32():
        for B in (1, 16):
            for N in (2, 33, 64, 101):
                q, k, v, g, valid = attention_inputs(B, N, B * 1000 + N,
                                                     device)
                scale = 1.0 / q.shape[-1] ** 0.5
                res = []
                for fn in (A.masked_attention, A.masked_attention_reference):
                    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
                    out = fn(*qkv, valid, scale)
                    res.append([out.detach(),
                                *torch.autograd.grad(out, qkv, g)])
                torch.cuda.synchronize()
                (got, *got_g), (want, *want_g) = res
                for t in (got, *got_g):
                    check(torch.isfinite(t).all(), f"K1 non-finite B={B} "
                                                   f"N={N}")
                e = (got - want).abs().max().item()
                check(e <= ATTN_FWD_TOL * want.abs().max().item(),
                      f"K1a differs at B={B} N={N}: {e}")
                err_f = max(err_f, e)
                for name, a, b in zip("qkv", got_g, want_g):
                    e = (a - b).abs().max().item()
                    check(e <= ATTN_GRAD_TOL * b.abs().max().item(),
                          f"K1b d{name} differs at B={B} N={N}: {e}")
                    err_g = max(err_g, e)
                # the image with no valid key averages V uniformly
                if B > 1:
                    check(torch.allclose(got[-1], v[-1].mean(
                        dim=1, keepdim=True).expand_as(got[-1]), atol=1e-5),
                          "all-invalid image is not a uniform average")
                checked += 1
    log(f"K1a/K1b: {checked} shapes match the plain version (max abs err "
        f"forward {err_f:.3e}, gradients {err_g:.3e}; tolerances "
        f"{ATTN_FWD_TOL} / {ATTN_GRAD_TOL} of the largest value)")

    B, H, N, D = 16, 8, 101, 32
    q, k, v, g, valid = attention_inputs(B, N, 7, device)
    scale = 1.0 / D ** 0.5
    mask = valid[:, None, None, :]

    def backward_of(fn):
        """A call of autograd's backward of fn alone: the forward graph is
        built once and kept."""
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fn(*qkv)
        return lambda: torch.autograd.grad(out, qkv, g, retain_graph=True)

    with NoTF32():
        f_ms = cuda_ms(lambda: A.attention_fwd(q, k, v, valid, scale), 200, 5)
        f_plain = cuda_ms(lambda: A.masked_attention_reference(
            q, k, v, valid, scale), 200, 5)
        f_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), 200, 5)
        b_ms = cuda_ms(lambda: A.attention_bwd(q, k, v, valid, g, scale),
                       200, 5)
        b_plain = cuda_ms(backward_of(lambda *t: A.masked_attention_reference(
            *t, valid, scale)), 200, 5)
        b_lib = cuda_ms(backward_of(lambda *t: F.scaled_dot_product_attention(
            *t, attn_mask=mask, scale=scale)), 200, 5)
    elems, pairs = B * H * N * D * 4, B * H * N * N
    f_bound, f_by = bound(4 * elems + B * N, pairs * (4 * D + 6))
    b_bound, b_by = bound(7 * elems + B * N, pairs * (10 * D + 10)
                          + 2 * B * H * N * D)
    log(f"K1a at {(B, H, N, D)}: kernel {f_ms:.4f} ms, plain {f_plain:.4f} "
        f"ms, SDPA {f_lib:.4f} ms, bound {f_bound:.6f} ms ({f_by}) [{card}]")
    log(f"K1b at {(B, H, N, D)}: kernel {b_ms:.4f} ms, plain (autograd "
        f"backward) {b_plain:.4f} ms, SDPA backward {b_lib:.4f} ms, bound "
        f"{b_bound:.6f} ms ({b_by}) [{card}]")
    return ({"max_abs_err": err_f, "ms": f_ms, "plain_ms": f_plain,
             "bound_ms": f_bound, "bound_by": f_by, "library_ms": f_lib},
            {"max_abs_err": err_g, "ms": b_ms, "plain_ms": b_plain,
             "bound_ms": b_bound, "bound_by": b_by, "library_ms": b_lib})


def train_cfg(opts=()):
    """The training slice: reference RetinaNet R-50 LGD solver settings,
    the synthetic split at the reference training size (short edge 800,
    long edge <= 1333: canvases 800x1344 and 1344x800), the pre-freeze
    lifting after step 0 and distillation from step 3."""
    solver = []
    for who in ("STUDENT", "TEACHER"):
        node = f"MODEL.DISTILLATOR.{who}.SOLVER."
        solver += [node + "OPTIMIZER", "SGD", node + "BASE_LR", 0.01,
                   node + "MOMENTUM", 0.9, node + "WEIGHT_DECAY", 1e-4,
                   node + "LR_SCHEDULER_NAME", "WarmupMultiStepLR",
                   node + "STEPS", (60000, 80000), node + "GAMMA", 0.1,
                   node + "WARMUP_FACTOR", 1e-3, node + "WARMUP_ITERS", 1000,
                   node + "WARMUP_METHOD", "linear"]
    return smoke_cfg([
        "MODEL.DISTILLATOR.TEACHER.ADD_CONTEXT_BOX", True,
        "MODEL.DISTILLATOR.PRE_FREEZE_STUDENT_BACKBONE_ITERS", 1,
        "MODEL.DISTILLATOR.PRE_NONDISTILL_ITERS", 3,
        "MODEL.RETINANET.SMOOTH_L1_LOSS_BETA", 0.0,
        "DATASETS.TRAIN", ("synthetic_mini",),
        "INPUT.MIN_SIZE_TRAIN", (800,), "INPUT.MAX_SIZE_TRAIN", 1333,
        "SOLVER.IMS_PER_BATCH", TRAIN_BATCH,
        "SOLVER.MAX_ITER", TRAIN_STEPS,
        *solver, *opts])


# device kernels grouped by what they do, for the profile's summary: the
# first family with a substring of the kernel's name; then elementwise by
# type
KERNEL_FAMILIES = (
    ("K1a/K1b attention", ("attn_fwd_kernel", "attn_bwd_kernel")),
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


def phase_train(device, card):
    """R-50 FPN LGD training at full width through do_train, then timed
    steady-state steps; returns (model, cfg, K1a launches, K1b launches)."""
    from lgd_tpu_torch.data import TrainLoader
    from lgd_tpu_torch.engine.train_step import (
        batch_to_device,
        make_train_step,
        phase,
    )
    from lgd_tpu_torch.engine.trainer import do_train
    from lgd_tpu_torch.models.distillator import build_model
    from lgd_tpu_torch.ops import attention as A

    cfg = train_cfg()
    check(phase(cfg, 0) == (0.0, 0.0) and phase(cfg, 1) == (0.0, 1.0)
          and phase(cfg, 3) == (1.0, 1.0), "phase schedule")
    dtype = getattr(torch, cfg.TPU.COMPUTE_DTYPE)
    model = build_model(cfg, dtype=dtype, device=device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"train model: R-{cfg.MODEL.RESNETS.DEPTH} FPN RetinaNet + "
        f"{cfg.MODEL.DISTILLATOR.TEACHER.NR_TRANSFORMER_HEADS}-head teacher "
        f"({cfg.TPU.MAX_INSTANCES + 1} tokens), {n_params} parameters, "
        f"{cfg.TPU.COMPUTE_DTYPE} student, float32 teacher, batch "
        f"{TRAIN_BATCH}")

    # record what each step computed: the losses, and the gradient that
    # loss_distill alone sends into the student's p3 features
    losses_seen, distill_grads = [], []
    train_forward, distill_loss = model.train_forward, model.distill_loss

    def recording_forward(*args):
        losses, norm = train_forward(*args)
        losses_seen.append({k: v.detach() for k, v in losses.items()})
        return losses, norm

    def probing_distill(stu, tea, flag):
        loss = distill_loss(stu, tea, flag)
        (grad,) = torch.autograd.grad(loss, [stu["p3"]], retain_graph=True)
        distill_grads.append((flag, grad.abs().max().float()))
        return loss

    model.train_forward, model.distill_loss = recording_forward, probing_distill
    stem = model.student.bottom_up.stem_conv1.weight.detach().clone()
    res3 = model.student.bottom_up.res3_0.conv1.weight.detach().clone()
    loader = TrainLoader(cfg)
    A.attention_fwd.launches = A.attention_bwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    do_train(cfg, model, device, loader)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1a, k1b = A.attention_fwd.launches, A.attention_bwd.launches
    del model.train_forward, model.distill_loss

    check(len(losses_seen) == TRAIN_STEPS, len(losses_seen))
    for i, losses in enumerate(losses_seen):
        check(sorted(losses) == ["loss_box_reg", "loss_box_reg.tea",
                                 "loss_cls", "loss_cls.tea", "loss_distill"],
              sorted(losses))
        for key, val in losses.items():
            check(math.isfinite(float(val)), f"step {i} {key} = {val}")
    for i, (flag, grad) in enumerate(distill_grads):
        g = float(grad)
        check(flag == float(i >= 3), f"step {i} distill flag {flag}")
        check((g > 0) == (i >= 3), f"step {i}: loss_distill sends {g} to "
                                   f"the student with flag {flag}")
    check(k1a == 5 * TRAIN_STEPS and k1b == 5 * TRAIN_STEPS,
          f"K1a {k1a}, K1b {k1b} launches in {TRAIN_STEPS} steps")
    check(torch.equal(model.student.bottom_up.stem_conv1.weight, stem),
          "the FREEZE_AT stem conv moved")
    check(not torch.equal(model.student.bottom_up.res3_0.conv1.weight, res3),
          "res3 never trained after the pre-freeze")
    log(f"do_train: {TRAIN_STEPS} steps in {wall:.2f} s (first-step set-up "
        f"and host data included); K1a {k1a}, K1b {k1b} launches; "
        f"loss_distill reaches the student from step 3 (|grad p3| "
        f"{float(distill_grads[2][1]):.3e} at step 2, "
        f"{float(distill_grads[3][1]):.3e} at step 3); stem unchanged")
    for i in (0, TRAIN_STEPS - 1):
        log(f"  step {i}: " + ", ".join(
            f"{k} {float(v):.4f}" for k, v in sorted(losses_seen[i].items())))

    # steady state (distillation on, backbone training), staged batches
    init_state, train_step = make_train_step(cfg, model)
    state = init_state()
    state.step = TRAIN_STEPS
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
    for _ in range(TIMED_STEPS):
        one_step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof_wall, busy, top, ranges = device_profile(one_step, 2)
    log(f"train step, batch {TRAIN_BATCH} at {canvases}: {step_ms:.2f} ms = "
        f"{1e3 * TRAIN_BATCH / step_ms:.2f} images/s, peak memory "
        f"{peak:.2f} GiB [{card}]")
    if busy > 0:
        log(f"profiled 2 steps: wall {prof_wall:.2f} ms, device busy "
            f"{busy:.2f} ms, idle share {1 - busy / prof_wall:.4f} [{card}]")
        families = {}
        for name, ms in top:
            family = kernel_family(name)
            families[family] = families.get(family, 0.0) + ms / 2
        families = sorted(families.items(), key=lambda kv: -kv[1])
        for family, ms in families:
            log(f"  {ms:10.3f} ms/step  {family}")
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
    return model, cfg, k1a, k1b


def phase_eval_teacher(model, cfg, device, card):
    """do_test with the teacher's features through the student's head."""
    from lgd_tpu_torch.engine.trainer import do_test
    from lgd_tpu_torch.ops import attention as A

    rec = RecordingModel(model)
    A.attention_fwd.launches = 0
    t0 = time.perf_counter()
    res = do_test(cfg, rec, device, batch_size=8, eval_teacher=True)
    wall = time.perf_counter() - t0
    launches = A.attention_fwd.launches
    check(launches == 5 * len(rec.outputs), (launches, len(rec.outputs)))
    for dets in rec.outputs:
        check(torch.isfinite(dets.scores).all(), "non-finite detections")
    for key in ("AP", "AP50", "AP75", "AR@100"):
        check(key in res["bbox"] and math.isfinite(res["bbox"][key]), key)
    log(f"do_test(eval_teacher=True): {len(rec.outputs)} batches, K1a "
        f"launches {launches}, AP {res['bbox']['AP']:.4f}, AP50 "
        f"{res['bbox']['AP50']:.4f}, wall {wall:.2f} s [{card}]")


def phase_card_vs_cpu(device):
    """The float32 model on the card against the same model on the CPU, on
    a small input, TF32 off: features and head outputs of inference, then
    train_forward's losses and normalizer with a backward (K1a and K1b on
    the card, their plain versions on the CPU)."""
    from lgd_tpu_torch.models.distillator import build_model
    from lgd_tpu_torch.ops import attention as A
    from lgd_tpu_torch.structures import BatchedInstances

    cfg = smoke_cfg(["TPU.COMPUTE_DTYPE", "float32",
                     "MODEL.DISTILLATOR.TEACHER.ADD_CONTEXT_BOX", True])
    cpu = build_model(cfg, dtype=torch.float32, device="cpu", seed=1)
    gpu = build_model(cfg, dtype=torch.float32, device=device, seed=1)
    g = torch.Generator().manual_seed(0)
    images = torch.rand(2, 3, 128, 160, generator=g) * 255
    sizes = torch.tensor([[128, 160], [100, 120]])
    gt = BatchedInstances.from_lists(  # image 1 has no GT: fallback slot
        [[[8.0, 10.0, 90.0, 70.0], [40.0, 30.0, 150.0, 120.0]],
         torch.zeros((0, 4)).numpy()], [[3, 41], []], cfg.TPU.MAX_INSTANCES)

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

    A.attention_fwd.launches = A.attention_bwd.launches = 0
    with NoTF32():
        got = outputs(gpu, device)
    torch.cuda.synchronize()
    launched = (A.attention_fwd.launches, A.attention_bwd.launches)
    check(launched == (5, 5), f"card train_forward launched {launched}")
    want = outputs(cpu, "cpu")
    check((A.attention_fwd.launches, A.attention_bwd.launches) == launched,
          "the CPU model launched a kernel")
    names = [*cfg.MODEL.RETINANET.IN_FEATURES, "logits", "deltas",
             "loss_box_reg", "loss_box_reg.tea", "loss_cls", "loss_cls.tea",
             "loss_distill", "loss_normalizer"]
    for name, a, b in zip(names, got, want):
        scale = b.abs().max().item()
        diff = (a - b).abs().max().item()
        # cuDNN and oneDNN sum 50 layers of convolutions in other orders
        tol = TRAIN_LOSS_TOL if name.startswith("loss") else 1e-3
        check(diff <= tol * scale, (name, diff, scale))
        log(f"card vs CPU float32 {name} {tuple(a.shape)}: max abs diff "
            f"{diff:.3e} (scale {scale:.3e})")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_header()
    build_kernels()
    records = {}
    phase_nms(device)
    records["K1a"], records["K1b"] = phase_attention(device, card)
    records["K2"] = phase_slice(device, card)
    model, cfg, records["K1a"]["launches"], records["K1b"]["launches"] = (
        phase_train(device, card))
    phase_eval_teacher(model, cfg, device, card)
    del model
    phase_card_vs_cpu(device)
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
