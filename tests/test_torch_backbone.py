"""ResNet + FPN (p3-p7) of the PyTorch port against the JAX modules, and the
param bridge's coverage at the full R-50 RetinaNet width."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import (
    jax_model,
    random_weights,
    retinanet_cfg,
    variable_shapes,
    unflatten,
)

from lgd_tpu_torch.models.distillator import build_model
from lgd_tpu_torch.utils import param_bridge


@pytest.fixture(scope="module")
def r18():
    cfg = retinanet_cfg(depth=18)
    jm = jax_model(cfg)
    flat = random_weights(variable_shapes(jm), seed=1)
    tm = param_bridge.load_flax_weights(
        build_model(cfg, dtype=torch.float32, device="cpu"), flat)
    return cfg, jm, flat, tm


def test_resnet_fpn_match_jax(r18):
    """Float32 on both sides. Tolerance 2e-4 relative to each map's largest
    magnitude: XLA and oneDNN sum the convolutions in different orders."""
    cfg, jm, flat, tm = r18
    rng = np.random.RandomState(0)
    images = (rng.rand(2, 96, 128, 3) * 255).astype(np.float32)
    sizes = np.asarray([[96, 128], [70, 100]], np.int32)

    raw_j, feats_j = jax.jit(lambda v, x, s: jm.apply(
        v, x, s, method=lambda m, x, s: m.student(x, s)))(
            unflatten(flat), images, sizes)
    with torch.no_grad():
        raw_t, feats_t = tm.student(
            torch.from_numpy(images).permute(0, 3, 1, 2),
            torch.from_numpy(sizes))

    assert sorted(feats_t) == ["p3", "p4", "p5", "p6", "p7"]
    for name, want, got in (
            [(k, raw_j[k], raw_t[k]) for k in ("res3", "res4", "res5")]
            + [(k, feats_j[k], feats_t[k]) for k in sorted(feats_t)]):
        want = np.asarray(want)
        got = got.permute(0, 2, 3, 1).numpy()  # NCHW -> NHWC
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=2e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_bridge_covers_r50_full_width():
    """Every flax leaf of the R-50 FPN RetinaNet distillator (student with a
    256-channel FPN, 9 anchors and 80 classes; 8-head teacher; adapter) maps
    to exactly one port state_dict entry of the same shape, and every entry
    is covered. Shapes only: nothing is computed."""
    cfg = retinanet_cfg(depth=50)
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
    assert shapes["params/student/head/cls_score/kernel"] == (3, 3, 256, 720)
    assert len(shapes) > 250


def test_bridge_raises_on_unmapped_keys(r18):
    cfg, _, flat, tm = r18
    extra = dict(flat)
    extra["params/student/head/extra_conv/kernel"] = np.zeros((3, 3, 1, 1))
    with pytest.raises(ValueError, match="unmapped"):
        param_bridge.state_dict_from_flax(extra, tm)
    short = dict(flat)
    short.pop("frozen/student/bottom_up/res2_0/conv1_norm/var")
    with pytest.raises(ValueError, match="missing"):
        param_bridge.state_dict_from_flax(short, tm)
    # the teacher and adapter of the dump map like the student; a teacher
    # key the port does not have still raises
    teacher = dict(flat)
    teacher["params/teacher/encoder/kernel"] = np.zeros((4, 4))
    with pytest.raises(ValueError, match="unmapped"):
        param_bridge.state_dict_from_flax(teacher, tm)
    sd = param_bridge.state_dict_from_flax(flat, tm)
    assert any(k.startswith("teacher.") for k in sd)
    assert any(k.startswith("adapter.") for k in sd)


def test_frozen_bn_folds_in_float32_then_casts():
    """FrozenBN keeps float32 buffers and folds them before the cast to the
    compute dtype (lgd_tpu/models/layers.py:36-38)."""
    from lgd_tpu_torch.models.layers import FrozenBatchNorm

    bn = FrozenBatchNorm(3)
    bn.scale.copy_(torch.tensor([1.5, 0.5, 2.0]))
    bn.var.copy_(torch.tensor([0.25, 4.0, 1.0]))
    bn.mean.copy_(torch.tensor([1.0, -2.0, 0.0]))
    bn.bias.copy_(torch.tensor([0.1, 0.2, 0.3]))
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    w = bn.scale / torch.sqrt(bn.var + 1e-5)
    b = bn.bias - bn.mean * w
    want = x.bfloat16() * w.bfloat16()[:, None, None] + b.bfloat16()[:, None, None]
    got = bn(x.bfloat16())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)
