"""The deformable convolution of the port (``lgd_tpu_torch/ops/deform_conv.py``
and the DCNv2 ResNet stages) against the JAX package's exact gather form,
``deform_conv2d_params(impl='gather')``, at small sizes, float32.

- The op: forward and the gradients of x, the offsets, the mask and the
  weight on adversarial offsets (``chip_smoke.dcn_inputs``: integer and
  fractional points, past each border by under a texel and by more,
  exactly -1 and the last row or column, beyond +-6 px and +-1e3), masks
  of exactly 0 and 1, modulated and not, stride 1 and 2, dilation 1 and 2,
  groups 1 and 2. Tolerance: 1e-5 of each tensor's largest value (sums in
  other orders; the sample positions, their floors and the corners'
  validity are computed alike, so no sample changes corners).
- The model: an R-18 DistillatorRetinaNet with modulated DCN on res3-res5
  (JAX: ``TPU.DCN_IMPL gather``), weights carried across by the bridge,
  random offset convs so that samples fall between texels. res3-res5 and
  p3-p7 within 2e-4 of each map's largest value (as
  ``test_torch_backbone.py``); the composed ``train_forward``'s losses
  within 1e-4 relative (as ``test_torch_train_step.py``) and each
  parameter's gradient within 1e-4 of its tensor's largest value plus 1e-7
  of the model's largest gradient, one float32 rounding of it. That floor
  binds only for tensors whose gradients are thousands of times smaller
  than the model's: the adapter's, fed by the distill loss through the
  difference of two instance-normed maps that cancel to a few percent of
  either (their sums in other orders then differ by about 1e-4 of the
  result), and two biases whose gradient is zero in exact arithmetic (the
  adapter's last, ahead of the InstanceNorm, and the key projection's,
  ahead of the softmax).
- The bridge: coverage at full R-101-DCNv2 and X-101-32x8d-DCNv2 width.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_parity import (
    jax_model,
    random_weights,
    retinanet_cfg,
    torch_instances,
    unflatten,
    variable_shapes,
)

from chip_smoke import dcn_inputs
from lgd_tpu.data import make_synthetic_batch
from lgd_tpu.ops.deform_conv import deform_conv2d_params
from lgd_tpu_torch.models.distillator import build_model
from lgd_tpu_torch.ops.deform_conv import deform_conv2d
from lgd_tpu_torch.utils import param_bridge

OP_TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-7  # of the model's largest gradient (module docstring)
DCN = ["MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True],
       "MODEL.RESNETS.DEFORM_MODULATED", True, "TPU.DCN_IMPL", "gather"]


def _nhwc(t):
    return None if t is None else t.permute(0, 2, 3, 1).numpy()


def _close(got, want, tol, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


@pytest.mark.parametrize("modulated,stride,dilation,groups", [
    (True, 1, 1, 1), (False, 1, 1, 1), (True, 2, 1, 2), (True, 1, 2, 2),
    (False, 2, 2, 1)])
def test_deform_conv2d_matches_jax_gather(modulated, stride, dilation,
                                          groups):
    B, C, H, W, Fo = 2, 8, 11, 13, 6
    x, off, mask = dcn_inputs(B, C, H, W, stride, dilation, modulated,
                              seed=stride * 10 + dilation + groups)
    rng = np.random.RandomState(groups)
    w = rng.randn(Fo, C // groups, 3, 3).astype(np.float32) / 6.0
    Ho, Wo = off.shape[-2:]
    cot = rng.randn(B, Fo, Ho, Wo).astype(np.float32)

    def jax_fn(x, w, off, *mask):
        return deform_conv2d_params(
            x, w, off, mask[0] if mask else None, stride=stride,
            dilation=dilation, groups=groups, dtype=jnp.float32,
            impl="gather")

    args = [_nhwc(x), w.transpose(2, 3, 1, 0), _nhwc(off),
            *([_nhwc(mask)] if modulated else [])]

    @jax.jit
    def fwd_bwd(cot, *args):
        out, vjp = jax.vjp(jax_fn, *args)
        return out, vjp(cot)

    want, want_g = fwd_bwd(cot.transpose(0, 2, 3, 1), *args)
    leaves = [t.clone().requires_grad_() for t in (x, torch.from_numpy(w),
                                                   off, mask)
              if t is not None]
    out = deform_conv2d(leaves[0], leaves[1], leaves[2],
                        leaves[3] if modulated else None, stride, dilation,
                        groups)
    got_g = torch.autograd.grad(out, leaves, torch.from_numpy(cot))

    _close(_nhwc(out.detach()), want, OP_TOL, "forward")
    names = ["dx", "dweight", "doffsets", "dmask"]
    for name, g, wg in zip(names, got_g, want_g):
        g = g.numpy()
        g = g.transpose(2, 3, 1, 0) if name == "dweight" else g.transpose(
            0, 2, 3, 1)
        _close(g, wg, OP_TOL, name)
    # the adversarial points reach every kind of corner
    assert np.abs(np.asarray(want_g[2])).max() > 0


def test_zero_offsets_equal_a_plain_conv():
    """Zero offsets and a mask of ones sample the grid itself: a grouped,
    strided, dilated convolution, for every channel and tap."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 9, 10, generator=g)
    w = torch.randn(4, 4, 3, 3, generator=g)
    for stride, dilation in ((1, 1), (2, 1), (1, 2)):
        want = F.conv2d(x, w, stride=stride, padding=dilation,
                        dilation=dilation, groups=2)
        Ho, Wo = want.shape[-2:]
        got = deform_conv2d(x, w, torch.zeros(2, 18, Ho, Wo),
                            torch.ones(2, 9, Ho, Wo), stride, dilation, 2)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())


def _dcn_flat(jm, seed):
    """Random weights for every key, the offset convs' at a scale that
    moves the samples by about a texel."""
    flat = random_weights(variable_shapes(jm), seed=seed)
    for key in flat:
        if "/offset_conv/" in key:
            flat[key] = flat[key] * 0.04
    return flat


@pytest.fixture(scope="module")
def dcn_r18():
    """Both R-18-DCNv2 distillators on the same weights and batch: the JAX
    student's features, train_forward's losses and gradients (one jit),
    and the port's model."""
    cfg = retinanet_cfg(opts=[*DCN, "MODEL.FPN.OUT_CHANNELS", 64,
                              "TPU.MAX_INSTANCES", 8])
    jm = jax_model(cfg)
    flat = _dcn_flat(jm, seed=31)
    batch = make_synthetic_batch(batch_size=2, canvas_hw=(64, 96),
                                 max_instances=8, seed=7)
    variables = unflatten(flat)
    args = (batch["image"], batch["image_size"], batch["gt"],
            jnp.float32(1.0), jnp.float32(100.0))

    @jax.jit
    def run(params):
        v = {"params": params, "frozen": variables["frozen"]}
        feats = jm.apply(v, batch["image"], batch["image_size"],
                         method=lambda m, x, s: m.student(x, s))

        def loss_fn(p):
            losses, norm = jm.apply({"params": p,
                                     "frozen": variables["frozen"]}, *args,
                                    method=jm.train_forward)
            return sum(losses[k] for k in sorted(losses)), (losses, norm)

        (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return feats, aux, grads

    feats, (losses, norm), grads = run(variables["params"])
    tm = param_bridge.load_flax_weights(
        build_model(cfg, dtype=torch.float32, device="cpu"), flat)
    return {"cfg": cfg, "tm": tm, "batch": batch, "feats": feats,
            "losses": {k: float(v) for k, v in losses.items()},
            "norm": float(norm),
            "grads": param_bridge.flatten_variables({"params": grads})}


def _port_batch(batch):
    return (torch.from_numpy(np.asarray(batch["image"])).permute(0, 3, 1, 2),
            torch.from_numpy(np.asarray(batch["image_size"])),
            torch_instances(batch["gt"]))


def test_dcn_backbone_and_fpn_match_jax(dcn_r18):
    images, sizes, _ = _port_batch(dcn_r18["batch"])
    seen = []
    unit = dcn_r18["tm"].student.bottom_up.res4_0.conv2
    hook = unit.offset_conv.register_forward_hook(
        lambda m, i, o: seen.append(o[:, :18]))
    with torch.no_grad():
        raw_t, feats_t = dcn_r18["tm"].student(images, sizes)
    hook.remove()
    raw_j, feats_j = dcn_r18["feats"]
    pairs = ([(k, raw_j[k], raw_t[k]) for k in ("res3", "res4", "res5")]
             + [(k, feats_j[k], feats_t[k]) for k in sorted(feats_t)])
    assert len(pairs) == 8
    for name, want, got in pairs:
        got = _nhwc(got)
        assert got.shape == np.shape(want), name
        _close(got, want, 2e-4, name)
    # the offsets move the samples by about a texel, between texels
    assert 0.2 < seen[0].std() < 5.0


@pytest.fixture(scope="module")
def port_forward(dcn_r18):
    tm = dcn_r18["tm"]
    images, sizes, gt = _port_batch(dcn_r18["batch"])
    tm.zero_grad(set_to_none=True)
    losses, norm = tm.train_forward(images, sizes, gt, 1.0,
                                    torch.tensor(100.0))
    sum(losses[k] for k in sorted(losses)).backward()
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()
             if p.grad is not None}
    tm.zero_grad(set_to_none=True)
    return {k: float(v) for k, v in losses.items()}, float(norm), grads


def test_dcn_train_forward_matches_jax(dcn_r18, port_forward):
    losses, norm, _ = port_forward
    want = dcn_r18["losses"]
    assert sorted(losses) == sorted(want) and len(want) == 5
    for k in want:
        np.testing.assert_allclose(losses[k], want[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(norm, dcn_r18["norm"], rtol=1e-6)


def test_dcn_train_forward_gradients_match_jax(dcn_r18, port_forward):
    """Every parameter's gradient, the deformable units' weights and
    offset convs included."""
    _, _, grads = port_forward
    tm = dcn_r18["tm"]
    want_all = {k: np.asarray(v) for k, v in dcn_r18["grads"].items()}
    floor = GRAD_FLOOR * max(np.abs(v).max() for v in want_all.values())
    checked = 0
    for key, want in want_all.items():
        got = grads.get(param_bridge.torch_key(key))
        if got is None:  # no gradient reached it in the port: none in JAX
            assert np.abs(want).max() == 0, key
            continue
        got = param_bridge.flax_array(key, got.numpy(), tm)
        np.testing.assert_allclose(
            got, want, rtol=0, atol=GRAD_TOL * np.abs(want).max() + floor,
            err_msg=key)
        checked += 1
    assert checked > 100
    for name in ("student.bottom_up.res3_0.conv2.weight",
                 "student.bottom_up.res3_0.conv2.offset_conv.weight",
                 "student.bottom_up.res5_1.conv2.offset_conv.bias"):
        assert grads[name].abs().max() > 0, name


@pytest.mark.parametrize("opts", [
    ["MODEL.RESNETS.DEPTH", 101],
    ["MODEL.RESNETS.DEPTH", 101, "MODEL.RESNETS.NUM_GROUPS", 32,
     "MODEL.RESNETS.WIDTH_PER_GROUP", 8, "MODEL.RESNETS.STRIDE_IN_1X1",
     False]], ids=["R-101-DCNv2", "X-101-32x8d-DCNv2"])
def test_bridge_covers_dcn_full_width(opts):
    """Every flax leaf of the full-width DCN distillator maps to exactly
    one port entry of the same shape, and every entry is covered; the DCN
    keys go through the generic rules (HWIO -> OIHW). Shapes only."""
    cfg = retinanet_cfg(opts=[*DCN, *opts])
    shapes = variable_shapes(jax_model(cfg))
    sd = build_model(cfg, dtype=torch.float32, device="cpu").state_dict()
    mapped = {}
    for key, shape in shapes.items():
        tk = param_bridge.torch_key(key)
        assert tk in sd, key
        assert tk not in mapped, f"{key} and {mapped.get(tk)} share {tk}"
        assert tuple(sd[tk].shape) == param_bridge.torch_shape(key, shape), key
        mapped[tk] = key
    assert set(mapped) == set(sd)
    units = [k for k in shapes if k.endswith("/conv2/offset_conv/kernel")]
    assert len(units) == 30  # res3 4 + res4 23 + res5 3
    res4 = "params/student/bottom_up/res4_0/conv2/"
    C, Cg = (1024, 32) if "MODEL.RESNETS.NUM_GROUPS" in opts else (256, 256)
    assert shapes[res4 + "kernel"] == (3, 3, Cg, C)
    assert shapes[res4 + "offset_conv/kernel"] == (3, 3, C, 27)


def test_cli_trains_the_dcn_yaml_on_the_cpu(tmp_path):
    """``python -m lgd_tpu_torch.train`` on the in-package R-18-DCNv2
    YAML: one step, then COCO evaluation of the student."""
    from lgd_tpu_torch import train as ttrain

    yaml = os.path.join(os.path.dirname(ttrain.__file__), "configs",
                        "retinanet_R18_dcnv2_synthetic_mini.yaml")
    out = tmp_path / "out"
    argv = ["--config-file", yaml, "MODEL.DEVICE", "cpu",
            "SOLVER.MAX_ITER", "1", "INPUT.MIN_SIZE_TRAIN", "(64,)",
            "INPUT.MAX_SIZE_TRAIN", "96", "INPUT.MIN_SIZE_TEST", "64",
            "INPUT.MAX_SIZE_TEST", "96", "OUTPUT_DIR", str(out),
            "MODEL.RETINANET.TOPK_CANDIDATES_TEST", "100",
            "MODEL.DISTILLATOR.EVAL_TEACHER", "False"]
    res = ttrain.main(ttrain.default_argument_parser().parse_args(argv))
    assert np.isfinite(res["bbox"]["AP50"])
    state = torch.load(out / "model_final.pth", weights_only=True)
    assert "student.bottom_up.res3_0.conv2.offset_conv.weight" in state
