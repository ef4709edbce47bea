"""A model's whole ``train_forward`` gradient, JAX package against the
port, in one precision on both sides, to tell float32 rounding from a
port fault. Not a tier-1 test itself: each run compiles the JAX gradient
once (40-60 s on one CPU).

    PYTHONPATH= JAX_PLATFORMS=cpu python tests/torch_float64_grads.py fcos float64
    PYTHONPATH= JAX_PLATFORMS=cpu python tests/torch_float64_grads.py mask_rcnn float32 [--json]

``fcos`` is the fixture of tests/test_torch_fcos.py (its gradient test
``test_fcos_train_forward_gradients_match_jax``); ``mask_rcnn`` the one of
tests/test_torch_mask_rcnn.py with the GT-frame crops at 57 instead of 56
pixels, so that no mask target's cell centre falls exactly halfway between
two crop pixels, where the port and XLA's float64 code (a fused
multiply-add) round to opposite sides. That file's gradient test runs
this script in float64 with ``--json``.

The float64 mode replaces every float32 that either package names at run
time, as tests/torch_float64_steps.py does, and edits neither package.
The script prints the largest difference of each gradient from JAX's
relative to that gradient's largest magnitude: the worst tensors, the
worst of the head, the trunk, the adapter and the teacher, and the worst
over all; with ``--json``, one last line {"gaps": {key: relative gap},
"peaks": {key: JAX's largest magnitude over the largest gradient},
"zero": {key: [JAX, port] largest magnitude over the largest gradient}}
for the gradients of ``ZERO_GRADIENT``, which vanish in exact arithmetic.
"""

import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
MODEL, MODE = (sys.argv[1:3] + [None, None])[:2]
if MODEL not in ("fcos", "mask_rcnn") or MODE not in ("float32", "float64"):
    sys.exit(f"usage: {sys.argv[0]} fcos|mask_rcnn float32|float64 [--json]")
if MODE == "float64":
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    torch.float32 = torch.float64
    torch.Tensor.float = lambda self, *a, **k: self.double()
    torch.set_default_dtype(torch.float64)

from torch_parity import (random_weights, torch_instances,  # noqa: E402
                          unflatten, variable_shapes)

import lgd_tpu.models.distillator as jdist  # noqa: E402
from lgd_tpu.data import make_synthetic_batch  # noqa: E402
from lgd_tpu_torch.models.distillator import build_model  # noqa: E402
from lgd_tpu_torch.utils.param_bridge import (  # noqa: E402
    flax_array, load_flax_weights, torch_key)

JDT, TDT = ((jnp.float64, torch.float64) if MODE == "float64"
            else (jnp.float32, torch.float32))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, name) if isinstance(v, dict) else {name: v})
    return out


def fcos_case():
    """(cfg, weights, JAX batch, JAX rngs, port uniforms) of the FCOS
    file's fixture."""
    import test_torch_fcos as T

    cfg = T.fcos_cfg()
    jm = jdist.build_model(cfg, dtype=JDT)
    flat = random_weights(variable_shapes(jm, T.CANVAS), seed=31)
    batch = dict(make_synthetic_batch(batch_size=T.B, canvas_hw=T.CANVAS,
                                      max_instances=8, seed=31))
    return cfg, jm, flat, batch, {}, None


def mask_rcnn_case():
    """The same of the Mask R-CNN file's fixture, crops at 57 pixels."""
    import test_torch_mask_rcnn as T

    cfg = T.mask_cfg(("TPU.MASK_CROP_SIZE", 57))
    jm = jdist.build_model(cfg, dtype=JDT)
    samples = T.mapped(T.jmapper, cfg, T.blob_dicts())
    batch = T.jloader.pack_batch(samples, T.CANVAS, T.M, segmask_stride=8)
    one = T.jloader.pack_batch(samples[:1], T.CANVAS, T.M, segmask_stride=8)
    flat = random_weights(variable_shapes(jm, T.CANVAS, one["gt"]), seed=23)
    variables = unflatten(flat)
    key = jax.random.PRNGKey(5)
    keys = jm.apply(variables, method=lambda m: (
        m.student.make_rng("sampling"), m.student.make_rng("sampling")),
        rngs={"sampling": key})
    R = len(T.jrpn.rpn_anchors(cfg, T.CANVAS, cfg.MODEL.RPN.IN_FEATURES)[0])
    pool = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + T.M
    uniforms = {name: {k: torch.from_numpy(v).to(TDT) for k, v in
                       T.jax_sampling_uniforms(kk, R, pool).items()}
                for name, kk in zip(("student", "teacher"), keys)}
    return cfg, jm, flat, dict(batch), {"sampling": key}, uniforms


def run():
    """{flax key: (JAX gradient, port gradient in the flax layout)}, in
    MODE."""
    cfg, jm, flat, batch, rngs, uniforms = (fcos_case() if MODEL == "fcos"
                                            else mask_rcnn_case())
    flat = {k: np.asarray(v).astype(MODE) for k, v in flat.items()}
    batch["image"] = jnp.asarray(batch["image"], JDT)
    # the GT boxes too: targets computed from float32 boxes alone would
    # round in float32 on the JAX side
    gt = dataclasses.replace(batch["gt"],
                             boxes=jnp.asarray(batch["gt"].boxes, JDT))
    variables = unflatten(flat)
    args = (batch["image"], batch["image_size"], gt, JDT(1.0), JDT(100.0))

    def loss_fn(params):
        losses, _ = jm.apply({"params": params,
                              "frozen": variables["frozen"]}, *args,
                             method=jm.train_forward, rngs=rngs)
        return sum(losses[k] for k in sorted(losses))

    jgrads = jax.jit(jax.grad(loss_fn))(variables["params"])
    jgrads = {"params/" + k: np.asarray(v)
              for k, v in _flatten(jgrads).items()}

    tm = load_flax_weights(build_model(cfg, dtype=TDT, device="cpu"),
                           flat).to(TDT)
    tgt = torch_instances(gt)
    images = torch.from_numpy(np.asarray(batch["image"])).permute(0, 3, 1, 2)
    sizes = torch.from_numpy(np.asarray(batch["image_size"]))
    losses, _ = tm.train_forward(images, sizes, tgt, 1.0,
                                 torch.tensor(100.0, dtype=TDT), uniforms)
    sum(losses[k] for k in sorted(losses)).backward()
    out = {}
    for key, want in jgrads.items():
        p = tm.get_parameter(torch_key(key))
        got = (np.zeros_like(want) if p.grad is None
               else flax_array(key, p.grad.detach().numpy(), tm))
        out[key] = (want, got)
    return out


def report(pairs, as_json=False):
    from test_torch_rcnn import ZERO_GRADIENT

    largest = max(np.abs(w).max() for w, _ in pairs.values())
    gaps, zero, peaks = {}, {}, {}
    for key, (want, got) in pairs.items():
        peak = np.abs(want).max()
        peaks[key] = float(peak / largest)
        if key in ZERO_GRADIENT:
            zero[key] = [float(peak / largest),
                         float(np.abs(got).max() / largest)]
            print(f"{MODE} {key}: no gradient in exact arithmetic; JAX "
                  f"{zero[key][0]:.3e}, port {zero[key][1]:.3e} of the "
                  "largest gradient", flush=True)
            continue
        gaps[key] = float(np.abs(got - want).max() / max(peak, 1e-30))
    rows = sorted(((v, k) for k, v in gaps.items()), reverse=True)
    for rel, key in rows[:8]:
        print(f"{MODE} {rel:.3e} {key}", flush=True)
    for part in ("student/head", "student/roi_heads", "student/bottom_up",
                 "student/fpn", "adapter", "teacher"):
        sub = [r for r in rows if r[1].startswith("params/" + part)]
        if sub:
            print(f"{MODE} worst of {part}: {max(sub)[0]:.3e} "
                  f"({max(sub)[1]}), {len(sub)} tensors", flush=True)
    print(f"{MODE} worst of all {len(rows)}: {rows[0][0]:.3e} ({rows[0][1]})",
          flush=True)
    if as_json:
        print(json.dumps({"gaps": gaps, "peaks": peaks, "zero": zero}),
              flush=True)


if __name__ == "__main__":
    t0 = time.time()
    report(run(), "--json" in sys.argv)
    print(f"{MODEL} {MODE}: {time.time() - t0:.1f} s", file=sys.stderr,
          flush=True)
