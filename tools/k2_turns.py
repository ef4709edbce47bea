#!/usr/bin/env python3
"""Kernel K2 (greedy NMS, lgd_tpu_torch/csrc/nms.cu) of this tree beside
that of other checkouts, on the card, in turns, on the main paths' pools
and in the main paths' inference.

    python3 tools/k2_turns.py [OTHER_TREE ...]

Each OTHER_TREE is the root of another checkout of the repo, for example
the parent commit unpacked by ``git archive`` under the ignored ``build/``.
Its wrapper ``lgd_tpu_torch/ops/nms.py`` is loaded beside this tree's and
its ``csrc/nms.cu`` built with the same nvcc flags; every other kernel is
this tree's. The models are chip_smoke.py's at full width with seeded
random weights, one test batch of 8 each: RetinaNet R-50 FPN, Faster R-CNN
R-50 FPN and RetinaNet R-101-DCNv2 (offset convs drawn). The pools, sorted
as ``nms_mask`` sorts them and captured with the plain sweep swapped in:

- RetinaNet R-50: the pre-NMS pool, 8 x 2000, the 80 classes shifted
  apart;
- Faster R-CNN: the RPN's pool (8 x 2000, the levels shifted apart) and
  the box head's;
- the RPN at training: chip_smoke's synthetic 16 x 2000 pool with the five
  levels as classes, at NMS 0.7.

On each pool every version is first held bit for bit against the plain
version (this tree's must agree; another checkout that does not, such as
a test build with a part of the kernel taken out to see what bounds it,
is only timed on the pools), then timed in the order A B ... B A
(``chip_smoke.k2_times``: CUDA-graph replay, CUDA events over a loop of
launches, and each CUDA kernel's device time per call by name). Then each
model's ``model.inference`` is timed on its batch (CUDA events over 30
calls) with each agreeing version's wrapper in the ``nms`` module, in the
same order, twice. Each version's nvcc build prints its kernels'
registers and spills. The last line is a JSON object of every
measurement.
"""

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402


def build_nms(tree, tag):
    """Builds ``csrc/nms.cu`` of a checkout under this tree's ``build/``
    and prints each kernel's registers, spills and shared memory."""
    from lgd_tpu_torch import csrc

    src = os.path.join(tree, "lgd_tpu_torch", "csrc", "nms.cu")
    out = os.path.join(csrc.BUILD_DIR, f"libnms_{tag}.so")
    os.makedirs(csrc.BUILD_DIR, exist_ok=True)
    res = subprocess.run([csrc._nvcc(), *csrc.NVCC_FLAGS, "-Xptxas", "-v",
                          "-o", out, src], capture_output=True, text=True)
    S.check(res.returncode == 0, f"nvcc failed for {src}:\n{res.stderr}")
    for line in res.stderr.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            S.log(f"{tag}: {line.strip()}")
    return out


def other_nms(tree, tag):
    """The ``ops/nms.py`` module of another checkout, bound to its own
    ``csrc/nms.cu``."""
    from lgd_tpu_torch import csrc

    out = build_nms(tree, tag)
    spec = importlib.util.spec_from_file_location(
        f"lgd_tpu_torch.ops._nms_{tag}",
        os.path.join(tree, "lgd_tpu_torch", "ops", "nms.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib, load = ctypes.CDLL(out), csrc.load
    csrc.load = lambda name: lib  # the module's _kernel() sets argtypes
    try:
        mod._kernel()
    finally:
        csrc.load = load
    return mod


def model_and_pools(cfg, device, prepare=None):
    """A model of ``cfg``, its test batch, and the NMS pools that the
    batch sends to K2, captured with the plain sweep swapped in."""
    from lgd_tpu_torch.models.distillator import build_model

    model = build_model(cfg, dtype=torch.bfloat16, device=device, seed=0)
    images, sizes = S.eval_batch(cfg, device)
    if prepare:
        prepare(model, images, sizes)
    with torch.no_grad(), S.PlainKernels() as run:
        model.inference(images, sizes)
    return model, images, sizes, run.pools


def synthetic_rpn_pool(device):
    """chip_smoke's ``rpn_pool`` at NMS 0.7, sorted."""
    from lgd_tpu_torch.ops import nms

    boxes, scores, levels, valid = S.rpn_pool(device)
    pools = []
    nms.batched_nms_mask(boxes, scores, levels, valid, 0.7,
                         keep_fn=lambda b, v, t: pools.append((b, v, t))
                         or nms.greedy_keep_sorted_reference(b, v, t))
    return pools[0]


def main(others):
    from lgd_tpu_torch.ops import nms

    if not torch.cuda.is_available():
        print("k2_turns: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = S.card_header()
    nms._kernel()
    build_nms(ROOT, "tree")
    wrapper = nms.greedy_keep_sorted
    versions = {"tree": wrapper}
    for i, tree in enumerate(others):
        versions[f"other{i}"] = other_nms(os.path.abspath(tree),
                                          f"other{i}").greedy_keep_sorted
    names = list(versions)
    models, pools = {}, {}
    for what, cfg, prepare, names_of in (
            ("RetinaNet R-50", S.smoke_cfg(), None, ("RetinaNet",)),
            ("Faster R-CNN R-50", S.rcnn_cfg(), None,
             ("R-CNN RPN", "R-CNN box head")),
            ("RetinaNet R-101-DCNv2", S.smoke_cfg(S.DCN_OPTS),
             S.draw_offset_convs, ())):
        model, images, sizes, found = model_and_pools(cfg, device, prepare)
        models[what] = (model, images, sizes)
        pools.update(zip(names_of, found))
    pools["RPN 16 x 2000 synthetic"] = synthetic_rpn_pool(device)
    # another checkout may be a test build with a part taken out, timed
    # only: it is held on every pool, and left out of the inference turns
    # if it differs; this tree must not differ
    results, equal = [], set(names)
    for what, (boxes_s, valid_s, thr) in pools.items():
        want = nms.greedy_keep_sorted_reference(boxes_s, valid_s, thr)
        for name in names:
            if not torch.equal(versions[name](boxes_s, valid_s, thr), want):
                S.check(name != "tree", f"K2 differs on {what}")
                S.log(f"{name} differs on {what}: timed only")
                equal.discard(name)
    order = names + names[::-1]
    for what, (boxes_s, valid_s, thr) in pools.items():
        kept = int(nms.greedy_keep_sorted_reference(boxes_s, valid_s,
                                                    thr).sum())
        for name in order:
            graph, loop, split = S.k2_times(versions[name], boxes_s,
                                            valid_s, thr)
            results.append({"pool": what, "shape": list(boxes_s.shape),
                            "kept": kept, "version": name,
                            "equal": name in equal, "graph_ms": graph,
                            "loop_ms": loop, "kernels_ms": split})
            S.log(f"K2 {name} on the {what} pool {tuple(boxes_s.shape)} "
                  f"({kept} kept): graph {graph:.4f} ms, loop "
                  f"{loop:.4f} ms, by kernel {S.fmt_ms(split)} [{card}]")
    turns = [name for name in order if name in equal]
    try:
        for what, (model, images, sizes) in models.items():
            for name in turns + turns:
                nms.greedy_keep_sorted = versions[name]
                ms = S.cuda_ms(lambda: model.inference(images, sizes), 30)
                results.append({"model": what, "version": name,
                                "inference_ms": ms})
                S.log(f"{what} model.inference with K2 of {name}, batch "
                      f"{images.shape[0]} at {tuple(images.shape[-2:])}: "
                      f"{ms:.2f} ms [{card}]")
    finally:
        nms.greedy_keep_sorted = wrapper
    print(json.dumps({"card": card, "versions": {
        "tree": ROOT, **{f"other{i}": t for i, t in enumerate(others)}},
        "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
