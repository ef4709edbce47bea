#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds the CUDA kernels from the sources in the checkout.
2. Kernel K2 (greedy NMS, lgd_tpu_torch/csrc/nms.cu) against its plain
   PyTorch version on the card: adversarial pools (duplicate scores and
   boxes, IoU exactly at the threshold, invalid tails, all-invalid) and the
   inference shape, 8 images x 2000 candidates with class offsets. Keep masks
   must be equal bit for bit.
3. The slice: DistillatorRetinaNet, R-50 FPN at full width (256-channel
   p3-p7, 9 anchors, 80 classes), seeded random weights, bf16 convolutions,
   through the port's ``do_test`` on the 16-image synthetic split at the
   800x1344 / 1344x800 test canvases, batches of 8. The NMS launch counter
   must rise, every image must have 1..100 finite detections and COCO
   metrics must come back. One batch is then decoded again with the plain
   NMS: the valid detections must be equal as sets. The kernel and its
   plain version are timed on that batch's real pre-NMS pool.
4. The same R-50 model in float32 on the card and on the CPU (the CPU path
   is the one the tests hold against the JAX package) on a small input.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failed check raises, and the script exits
non-zero without that line; so it does without a card.
"""

import json
import subprocess
import sys
import time

import torch

NMS_TOL = 0  # keep masks are booleans: equal bit for bit


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
    from lgd_tpu_torch import csrc
    from lgd_tpu_torch.ops import nms

    t0 = time.perf_counter()
    nms._kernel()
    log(f"kernel build+load: nms {time.perf_counter() - t0:.2f} s "
        f"(nvcc {csrc.build_seconds.get('nms', 0.0):.2f} s)")


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
    log(f"K2 at {tuple(pool['boxes'].shape)}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms [{card}]")

    def infer():
        model.inference(images, sizes)

    step_ms = cuda_ms(infer, iters=5)
    log(f"model.inference, batch {images.shape[0]} at "
        f"{tuple(images.shape[-2:])}: {step_ms:.2f} ms = "
        f"{1000 * images.shape[0] / step_ms:.2f} images/s [{card}]")
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


def phase_card_vs_cpu(device):
    """The float32 model on the card against the same model on the CPU, on
    a small input (cuDNN's TF32 off for the run)."""
    from lgd_tpu_torch.models.distillator import build_model

    cfg = smoke_cfg(["TPU.COMPUTE_DTYPE", "float32"])
    cpu = build_model(cfg, dtype=torch.float32, seed=1)
    gpu = build_model(cfg, dtype=torch.float32, device=device, seed=1)
    g = torch.Generator().manual_seed(0)
    images = torch.rand(2, 3, 128, 160, generator=g) * 255
    sizes = torch.tensor([[128, 160], [100, 120]])

    def outputs(model, dev):
        with torch.no_grad():
            _, feats = model.student(images.to(dev), sizes.to(dev))
            head = model._head_features(feats)
            return [t.cpu() for t in [*head, *model.student.predict(head)]]

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = outputs(gpu, device)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    want = outputs(cpu, "cpu")
    names = [*cfg.MODEL.RETINANET.IN_FEATURES, "logits", "deltas"]
    for name, a, b in zip(names, got, want):
        scale = b.abs().max().item()
        diff = (a - b).abs().max().item()
        # cuDNN and oneDNN sum 50 layers of convolutions in other orders
        check(diff <= 1e-3 * scale, (name, diff, scale))
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
    phase_nms(device)
    record = phase_slice(device, card)
    phase_card_vs_cpu(device)
    kernels = [{"name": "greedy_keep_sorted", "route": "cuda",
                "source": "lgd_tpu_torch/csrc/nms.cu",
                "replaces": "lgd_tpu/ops/nms.py:45", **record}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
