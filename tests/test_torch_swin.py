"""The Swin-T slice of the port (``lgd_tpu_torch/models/backbones/swin.py``,
the Swin trunk of the RetinaNet, FCOS and R-CNN students, drop-path in
training, the bridge's Swin leaves and ``convert_swin_state``) against the
JAX package at a small size: a narrow Swin (EMBED_DIM 24, DEPTHS
(2, 2, 2, 2), NUM_HEADS (1, 2, 3, 6), window 7) into a 64-channel FPN, an
8-head teacher with the context box, MAX_INSTANCES 8, batch 2, float32.
The backbone alone runs on a 96x136 canvas, the detectors on 96x128 (a
multiple of the FPN's 32): neither is a multiple of 28, so every stage
has padding tokens and shifted windows that straddle them. Inputs and
weights come from numpy seeds; the weights are carried by the bridge.

Tolerances, float32 on both sides, at DROP_PATH_RATE 0 (the two packages
draw drop-path from different generators):
- the static tables exactly;
- the stage maps within 1e-4 of each map's peak, with and without the
  absolute position embedding (they agree to about 5e-6);
- the RetinaNet student's FPN levels within 1e-4 of each level's peak,
  ``train_forward``'s losses within 1e-4 relative, for RetinaNet and for
  Mask R-CNN on the Swin FPN trunk;
- every gradient within GRAD_TOL of its tensor's peak plus JITTER_FACTOR
  times how far the port's own gradient moves when every weight is
  scaled by 1 + 1e-7 N(0, 1) (the FCOS file's rule; the test gives the
  gaps it saw).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    ANCHOR_SIZES,
    jax_model,
    random_weights,
    torch_instances,
    unflatten,
    variable_shapes,
)

from lgd_tpu.config import get_cfg
from lgd_tpu.data import make_synthetic_batch
from lgd_tpu.engine.train_step import freeze_gates as jax_freeze_gates
from lgd_tpu.models.backbones import swin as jswin
from lgd_tpu.utils import weight_convert as jconvert
from lgd_tpu_torch.engine.train_step import draw_uniforms, freeze_gates
from lgd_tpu_torch.models.backbones import swin as tswin
from lgd_tpu_torch.models.distillator import build_model
from lgd_tpu_torch.models.layers import DropPath
from lgd_tpu_torch.utils import param_bridge, weight_convert
from lgd_tpu_torch.utils.param_bridge import (
    flatten_variables,
    flax_array,
    load_flax_weights,
    state_dict_from_flax,
)

CANVAS = (96, 128)
B = 2
GRAD_TOL = 1e-4
JITTER_FACTOR = 20
NARROW = dict(embed_dim=24, depths=(2, 2, 2, 2), num_heads=(1, 2, 3, 6))
SWIN_OPTS = ("MODEL.SWINT.EMBED_DIM", 24,
             "MODEL.SWINT.DEPTHS", [2, 2, 2, 2],
             "MODEL.SWINT.NUM_HEADS", [1, 2, 3, 6],
             "MODEL.SWINT.DROP_PATH_RATE", 0.0)
RETINANET_LOSSES = sorted([k + t for k in ("loss_box_reg", "loss_cls")
                           for t in ("", ".tea")] + ["loss_distill"])


def swin_cfg(arch="DistillatorRetinaNet", opts=()):
    """A Swin-T student of ``arch`` at the narrow width: RetinaNet and the
    FCOS family on stage3-stage5 (build_retinanet_swint_fpn_backbone), R-CNN
    on stage2-stage5 (build_swint_fpn_backbone)."""
    rcnn = arch == "DistillatorGeneralizedRCNN"
    stages = (["stage2", "stage3", "stage4", "stage5"] if rcnn
              else ["stage3", "stage4", "stage5"])
    if rcnn:
        from test_torch_mask_rcnn import mask_cfg

        return mask_cfg(("MODEL.BACKBONE.NAME", "build_swint_fpn_backbone",
                         "MODEL.SWINT.OUT_FEATURES", stages,
                         "MODEL.FPN.IN_FEATURES", stages,
                         *SWIN_OPTS, *opts))
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.META_ARCHITECTURE", arch,
        "MODEL.BACKBONE.NAME", "build_retinanet_swint_fpn_backbone",
        "MODEL.SWINT.OUT_FEATURES", stages,
        "MODEL.FPN.IN_FEATURES", stages,
        "MODEL.FPN.OUT_CHANNELS", 64,
        "MODEL.ANCHOR_GENERATOR.SIZES", ANCHOR_SIZES,
        "MODEL.DISTILLATOR.TEACHER.ADD_CONTEXT_BOX", True,
        "MODEL.DISTILLATOR.EVAL_TEACHER", False,
        "TPU.MAX_INSTANCES", 8,
        "TPU.COMPUTE_DTYPE", "float32",
        "OUTPUT_DIR", "",
        *SWIN_OPTS, *opts])
    return cfg.freeze()


def _torch_batch(batch):
    return (torch.from_numpy(np.asarray(batch["image"])).permute(0, 3, 1, 2),
            torch.from_numpy(np.asarray(batch["image_size"])),
            torch_instances(batch["gt"]))


def _train_args(batch):
    return (batch["image"], batch["image_size"], batch["gt"],
            jnp.float32(1.0), jnp.float32(100.0))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, name) if isinstance(v, dict) else {name: v})
    return out


@pytest.fixture(scope="module")
def retinanet():
    """The RetinaNet Swin models on the same weights, the JAX
    ``train_forward`` losses, gradients and FPN levels (the file's one
    gradient compile), and the port's, with its gradients' jitter."""
    cfg = swin_cfg()
    jm = jax_model(cfg)
    flat = random_weights(variable_shapes(jm, CANVAS), seed=41)
    tm = load_flax_weights(build_model(cfg, dtype=torch.float32,
                                       device="cpu"), flat)
    variables = unflatten(flat)
    batch = make_synthetic_batch(batch_size=B, canvas_hw=CANVAS,
                                 max_instances=8, seed=41)
    args = _train_args(batch)

    def loss_fn(params):
        # a Swin trunk has no FrozenBN: no "frozen" collection
        losses, norm = jm.apply({**variables, "params": params}, *args,
                                method=jm.train_forward)
        return sum(losses[k] for k in sorted(losses)), (losses, norm)

    (_, (losses, norm)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    feats = jax.jit(lambda v, x, s: jm.apply(
        v, x, s, method=lambda m, *a: m.student(*a)[1]))(
            variables, batch["image"], batch["image_size"])
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
    return {"cfg": cfg, "jm": jm, "tm": tm, "flat": flat, "batch": batch,
            "losses": {k: float(v) for k, v in losses.items()},
            "norm": float(norm), "grads": grads,
            "feats": {k: np.asarray(v) for k, v in feats.items()},
            "t_losses": t_losses, "t_norm": t_norm, "t_grads": t_grads,
            "jitter": jitter}


# --- the backbone ---------------------------------------------------------


@pytest.mark.parametrize("hw", [(24, 34), (12, 17), (7, 7), (3, 5)])
def test_static_tables_equal_jax(hw):
    """The relative-position index, the shifted-window mask, the shift's
    permutations and the pad mask of a stage's canvas, exactly."""
    ws, shift = 7, 3
    h, w = hw
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    np.testing.assert_array_equal(tswin._rel_pos_index(ws),
                                  jswin._rel_pos_index(ws))
    np.testing.assert_array_equal(tswin._shift_attn_mask(hp, wp, ws, shift),
                                  jswin._shift_attn_mask(hp, wp, ws, shift))
    for got, want in zip(tswin._shift_perms(hp, wp, ws, shift),
                         jswin._shift_perms(hp, wp, ws, shift)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tswin._pad_keep_mask(h, w, hp, wp, ws),
                                  jswin._pad_keep_mask(h, w, hp, wp, ws))


@pytest.mark.parametrize("ape", [False, True], ids=["plain", "ape"])
def test_stage_maps_match_jax(ape):
    """The four stage maps of the narrow Swin on a 96x136 canvas in float32,
    through the bridge, within 1e-4 of each map's peak. With ``ape`` the
    56x56 embedding is resized to the 24x34 patch grid: downsampling, so
    the resize's antialiased Keys cubic is held too."""
    jm = jswin.SwinTransformer(**NARROW, drop_path_rate=0.0, ape=ape,
                               dtype=jnp.float32)
    rng = np.random.RandomState(5)
    x = (rng.randn(B, 96, 136, 3) * 50).astype(np.float32)
    shapes = {k: np.shape(v) for k, v in flatten_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), x))).items()}
    flat = random_weights(shapes, seed=7)
    want = jax.jit(jm.apply)(unflatten(flat), x)
    tm = tswin.SwinTransformer(**NARROW, drop_path_rate=0.0, ape=ape,
                               dtype=torch.float32)
    tm.load_state_dict(state_dict_from_flax(flat, tm))
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(want) == ["stage2", "stage3", "stage4",
                                           "stage5"]
    for k, w in want.items():
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_bicubic_weights_match_jax_resize():
    """The position embedding's resize against ``jax.image.resize(...,
    "bicubic")`` up and down (the pretrain grid 56 to 200x336 and to
    24x34)."""
    rng = np.random.RandomState(9)
    pe = rng.randn(1, 56, 56, 5).astype(np.float32)
    for out in ((200, 336), (24, 34), (56, 17)):
        want = np.asarray(jax.image.resize(pe, (1, *out, 5), "bicubic"))
        got = np.einsum("Hh,Ww,nhwc->nHWc",
                        tswin.bicubic_weights(56, out[0]),
                        tswin.bicubic_weights(56, out[1]), pe)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- the RetinaNet Swin student --------------------------------------------


def test_retinanet_fpn_features_and_losses_match_jax(retinanet):
    """p3-p7 of the student on the batch, and ``train_forward``'s five
    losses and normalizer."""
    images, sizes, _ = _torch_batch(retinanet["batch"])
    with torch.no_grad():
        _, feats = retinanet["tm"].student(images, sizes)
    for k, w in retinanet["feats"].items():
        w = w.transpose(0, 3, 1, 2)
        np.testing.assert_allclose(feats[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
    assert sorted(feats) == ["p3", "p4", "p5", "p6", "p7"]
    assert sorted(retinanet["t_losses"]) == sorted(retinanet["losses"]) \
        == RETINANET_LOSSES
    for k in RETINANET_LOSSES:
        np.testing.assert_allclose(retinanet["t_losses"][k],
                                   retinanet["losses"][k], rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(retinanet["t_norm"], retinanet["norm"],
                               rtol=1e-6)


def test_retinanet_gradients_match_jax(retinanet):
    """Every parameter's gradient, the Swin trunk's LayerNorms, bias
    tables and patch embed among them, by the module docstring's rule. The
    worst gap seen is 6.5e-6 of its tensor's peak (the teacher's q_proj
    kernel; the trunk's worst 3.8e-6, a bias table). Two biases have no
    gradient in exact arithmetic, the adapter's last and the teacher's
    k_proj (2.8e-9 and 4.0e-10 of the largest gradient here): their scale
    is floored at 1e-8 of the largest gradient, and the jitter term holds
    them."""
    grads, tm, jitter = (retinanet["t_grads"], retinanet["tm"],
                         retinanet["jitter"])
    flat_grads = {"params/" + k: np.asarray(v)
                  for k, v in _flatten(retinanet["grads"]).items()}
    largest = max(np.abs(g).max() for g in flat_grads.values())
    checked = 0
    for key, want in flat_grads.items():
        name = param_bridge.torch_key(key)
        got = grads.get(name)
        scale = np.abs(want).max()
        if got is None:
            assert scale <= 1e-8 * largest, key
            continue
        got = flax_array(key, got.numpy(), tm)
        np.testing.assert_allclose(
            got, want, rtol=0, err_msg=key,
            atol=GRAD_TOL * max(scale, 1e-8 * largest)
            + JITTER_FACTOR * jitter[name])
        checked += 1
    assert checked > 150
    for name in ("student.bottom_up.patch_embed.weight",
                 "student.bottom_up.patch_norm.weight",
                 "student.bottom_up.stage3_block1.attn."
                 "relative_position_bias_table",
                 "student.bottom_up.stage5_block1.mlp_fc2.weight",
                 "student.bottom_up.stage4_downsample.reduction.weight",
                 "student.bottom_up.stage5_norm.bias"):
        assert grads[name].abs().max() > 0, name


def test_freeze_gates_leave_swin_trainable(retinanet):
    """FREEZE_AT 2 (the default) freezes a ResNet's stem and res2; no Swin
    parameter is named so, in either package."""
    tm, jm = retinanet["tm"], retinanet["jm"]
    gates = freeze_gates(tm.student, 2)
    trunk = [k for k in gates if k.startswith("bottom_up.")]
    assert len(trunk) == len(list(tm.student.bottom_up.parameters())) > 100
    assert all(gates[k] == 1.0 for k in trunk)
    jgates = jax_freeze_gates(
        unflatten(retinanet["flat"])["params"]["student"], 2)
    assert set(jax.tree_util.tree_leaves(jgates)) == {1.0}


def test_drop_path_active_in_training():
    """With DROP_PATH_RATE 0.5 (DropPath as JAX's test_swin_drop_path_
    active_in_training): ``sampling_shapes`` asks for two uniforms per block
    and image; ``train_forward`` draws differ with the generator's state
    and repeat with it; inference passes none and is deterministic; one
    DropPath keeps a sample exactly when its uniform is under 1 - rate and
    scales it by 1 / (1 - rate)."""
    cfg = swin_cfg(opts=("MODEL.SWINT.DROP_PATH_RATE", 0.5,
                         "TPU.MAX_INSTANCES", 4))
    model = build_model(cfg, dtype=torch.float32, device="cpu", seed=3)
    batch = make_synthetic_batch(batch_size=B, canvas_hw=(64, 64),
                                 max_instances=4, seed=3)
    images, sizes, gt = _torch_batch(batch)
    shapes = model.sampling_shapes(B, (64, 64), 4)
    assert shapes == {"drop_path": (16, B)}
    assert build_model(swin_cfg(), dtype=torch.float32, device="cpu"
                       ).sampling_shapes(B, (64, 64), 4) == {}

    def p3(seed):
        u = draw_uniforms(shapes, torch.Generator().manual_seed(seed), "cpu")
        with torch.no_grad():
            return model.student(images, sizes, u["drop_path"])[1]["p3"]

    assert not torch.allclose(p3(1), p3(2))
    assert torch.equal(p3(1), p3(1))
    with torch.no_grad():
        losses = [model.train_forward(images, sizes, gt, 1.0,
                                      torch.tensor(100.0), draw_uniforms(
                                          shapes, torch.Generator()
                                          .manual_seed(s), "cpu"))[0]
                  for s in (1, 2, 1)]
        plain = model.student(images, sizes)[1]["p3"]
        again = model.student(images, sizes)[1]["p3"]
    assert losses[0]["loss_cls"] != losses[1]["loss_cls"]
    assert all(float(losses[0][k]) == float(losses[2][k]) for k in losses[0])
    assert torch.equal(plain, again)

    drop = DropPath(0.25)
    x = torch.rand(4000, 3, 5) + 1.0
    u = torch.rand(4000, generator=torch.Generator().manual_seed(0))
    y = drop(x, u)
    kept = u < 0.75
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert (y[~kept] == 0).all()
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    assert torch.equal(drop(x), x) and torch.equal(DropPath(0.0)(x, u), x)


# --- the Mask R-CNN Swin student, FCOS on Swin, and the bridge -------------


def test_mask_rcnn_train_forward_matches_jax():
    """The eleven losses of Mask R-CNN on the Swin FPN trunk (stage2-stage5
    into p2-p6) with the seg-mask teacher, on the Mask R-CNN file's blob
    polygons and the JAX sampling stream's uniforms replayed."""
    import test_torch_mask_rcnn as T
    from test_torch_rcnn import jax_sampling_uniforms

    from lgd_tpu.models.rcnn import rpn as jrpn
    from lgd_tpu_torch.data import dataset_mapper as tmapper
    from lgd_tpu_torch.data import loader as tloader

    cfg = swin_cfg("DistillatorGeneralizedRCNN")
    jm = jax_model(cfg)
    dicts = T.blob_dicts()
    batch = T.jloader.pack_batch(T.mapped(T.jmapper, cfg, dicts), T.CANVAS,
                                 T.M, segmask_stride=8)
    t_batch = tloader.pack_batch(T.mapped(tmapper, cfg, dicts), T.CANVAS,
                                 T.M, segmask_stride=8)
    one = T.jloader.pack_batch(T.mapped(T.jmapper, cfg, dicts)[:1], T.CANVAS,
                               T.M, segmask_stride=8)
    flat = random_weights(variable_shapes(jm, T.CANVAS, one["gt"]), seed=43)
    tm = load_flax_weights(build_model(cfg, dtype=torch.float32,
                                       device="cpu"), flat)
    variables = unflatten(flat)
    key = jax.random.PRNGKey(6)
    want = jax.jit(lambda v, *a: jm.apply(
        v, *a, method=jm.train_forward, rngs={"sampling": key})[0])(
        variables, batch["image"], batch["image_size"], batch["gt"],
        jnp.float32(1.0), jnp.float32(100.0))
    keys = jm.apply(variables, method=lambda m: (
        m.student.make_rng("sampling"), m.student.make_rng("sampling")),
        rngs={"sampling": key})
    R = len(jrpn.rpn_anchors(cfg, T.CANVAS, cfg.MODEL.RPN.IN_FEATURES)[0])
    pool = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + T.M
    uniforms = {name: {k: torch.from_numpy(v) for k, v in
                       jax_sampling_uniforms(kk, R, pool).items()}
                for name, kk in zip(("student", "teacher"), keys)}
    assert tm.sampling_shapes(B, T.CANVAS, T.M).keys() == uniforms.keys()
    with torch.no_grad():
        got, norm = tm.train_forward(
            torch.from_numpy(t_batch["image"]).permute(0, 3, 1, 2),
            torch.from_numpy(t_batch["image_size"]), t_batch["gt"], 1.0,
            torch.tensor(100.0), uniforms)
    assert sorted(got) == sorted(want) and len(got) == 11
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(got["loss_mask"]) > 0.1 and float(norm) == 100.0


def test_fcos_train_forward_on_swin_matches_jax(retinanet):
    """FCOS takes the Swin trunk through ``FCOSCT`` (as ATSS and POTO, its
    subclasses, do), with the p6/p7 top from p5: ``train_forward``'s seven
    losses on the RetinaNet fixture's batch within 1e-4 relative."""
    cfg = swin_cfg("DistillatorFCOS")
    jm = jax_model(cfg)
    flat = random_weights(variable_shapes(jm, CANVAS), seed=47)
    tm = load_flax_weights(build_model(cfg, dtype=torch.float32,
                                       device="cpu"), flat)
    batch = retinanet["batch"]
    want = jax.jit(lambda v, *a: jm.apply(v, *a, method=jm.train_forward)[0])(
        unflatten(flat), *_train_args(batch))
    with torch.no_grad():
        got, _ = tm.train_forward(*_torch_batch(batch), 1.0,
                                  torch.tensor(100.0))
    assert sorted(got) == sorted(want) and len(got) == 7
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["DistillatorRetinaNet",
                                  "DistillatorGeneralizedRCNN"],
                         ids=["RetinaNet", "Mask R-CNN"])
def test_bridge_covers_swin_t(arch):
    """Every flax leaf of the Swin-T distillator at the published widths
    (embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24), a 256-channel
    FPN) maps to exactly one port entry of the same shape, and every entry
    is covered. Shapes only."""
    full = ("MODEL.SWINT.EMBED_DIM", 96, "MODEL.SWINT.DEPTHS", [2, 2, 6, 2],
            "MODEL.SWINT.NUM_HEADS", [3, 6, 12, 24],
            "MODEL.FPN.OUT_CHANNELS", 256)
    cfg = swin_cfg(arch, full)
    jm = jax_model(cfg)
    shapes = variable_shapes(jm) if arch != "DistillatorGeneralizedRCNN" \
        else None
    if shapes is None:
        import test_torch_mask_rcnn as T

        one = T.jloader.pack_batch(T.mapped(T.jmapper, cfg, T.blob_dicts())
                                   [:1], T.CANVAS, T.M, segmask_stride=8)
        shapes = variable_shapes(jm, T.CANVAS, one["gt"])
    flat = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    sd = state_dict_from_flax(flat, model)
    assert sorted(sd) == sorted(model.state_dict())
    trunk = [k for k in sd if k.startswith("student.bottom_up.")]
    assert len(trunk) == 4 + 13 * 12 + 3 * 3 + (8 if "RCNN" in arch else 6)


def official_swin_state(rng, embed=24, depths=(2, 2, 2, 2),
                        heads=(1, 2, 3, 6), ws=7, out_stages=(1, 2, 3),
                        pretrain=56):
    """A state dict in the official Swin layout (torch names and shapes of
    microsoft/Swin-Transformer's SwinTransformer, with the detection
    build's per-stage ``norm<i>``), drawn at random, with the buffers and
    the classifier the converter must leave out."""
    sd = {"patch_embed.proj.weight": rng.randn(embed, 3, 4, 4) * 0.2,
          "patch_embed.proj.bias": rng.randn(embed) * 0.1,
          "patch_embed.norm.weight": rng.rand(embed) + 0.5,
          "patch_embed.norm.bias": rng.randn(embed) * 0.1,
          "absolute_pos_embed": rng.randn(1, embed, pretrain, pretrain) * 0.1,
          "head.weight": rng.randn(10, 8 * embed),
          "norm.weight": rng.rand(8 * embed)}
    dim = embed
    for i, (depth, h) in enumerate(zip(depths, heads)):
        for j in range(depth):
            p = f"layers.{i}.blocks.{j}."
            sd.update({
                p + "norm1.weight": rng.rand(dim) + 0.5,
                p + "norm1.bias": rng.randn(dim) * 0.1,
                p + "attn.relative_position_bias_table":
                    rng.randn((2 * ws - 1) ** 2, h) * 0.1,
                p + "attn.relative_position_index":
                    np.zeros((ws * ws, ws * ws), np.int64),
                p + "attn.qkv.weight": rng.randn(3 * dim, dim) / dim ** 0.5,
                p + "attn.qkv.bias": rng.randn(3 * dim) * 0.1,
                p + "attn.proj.weight": rng.randn(dim, dim) / dim ** 0.5,
                p + "attn.proj.bias": rng.randn(dim) * 0.1,
                p + "norm2.weight": rng.rand(dim) + 0.5,
                p + "norm2.bias": rng.randn(dim) * 0.1,
                p + "mlp.fc1.weight": rng.randn(4 * dim, dim) / dim ** 0.5,
                p + "mlp.fc1.bias": rng.randn(4 * dim) * 0.1,
                p + "mlp.fc2.weight": rng.randn(dim, 4 * dim) / (2 * dim ** .5),
                p + "mlp.fc2.bias": rng.randn(dim) * 0.1})
        if i < len(depths) - 1:
            p = f"layers.{i}.downsample."
            sd.update({p + "norm.weight": rng.rand(4 * dim) + 0.5,
                       p + "norm.bias": rng.randn(4 * dim) * 0.1,
                       p + "reduction.weight":
                           rng.randn(2 * dim, 4 * dim) / (2 * dim ** 0.5)})
        if i in out_stages:
            sd.update({f"norm{i}.weight": rng.rand(dim) + 0.5,
                       f"norm{i}.bias": rng.randn(dim) * 0.1})
        dim *= 2
    return {k: np.asarray(v, np.float32 if v.dtype != np.int64 else v.dtype)
            for k, v in sd.items()}


def test_convert_swin_state_matches_jax(tmp_path):
    """An official-layout Swin ``.pth`` built here, with APE: JAX's
    ``convert_swin_state`` into the JAX backbone, and the port's
    ``maybe_load_pretrained`` (routed by the bias tables) into the port's
    RetinaNet student, give the same stage maps; every trunk tensor the
    file has is loaded."""
    raw = official_swin_state(np.random.RandomState(13))
    path = str(tmp_path / "swin_tiny_converted.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in raw.items()}},
               path)
    cfg = swin_cfg(opts=("MODEL.SWINT.APE", True, "MODEL.WEIGHTS", path))
    model = weight_convert.maybe_load_pretrained(
        cfg, build_model(cfg, dtype=torch.float32, device="cpu", seed=0))
    sd = model.state_dict()
    conv = weight_convert.convert_swin_state(raw)["params"]
    assert len(conv) == len(raw) - 2 - 8  # head, norm, the index buffers
    for k, v in conv.items():
        assert torch.equal(sd[k], torch.from_numpy(v)), k

    jm = jswin.SwinTransformer(**NARROW, drop_path_rate=0.0, ape=True,
                               out_features=("stage3", "stage4", "stage5"),
                               dtype=jnp.float32)
    jparams = jconvert.convert_swin_state(raw)["params"]
    x = (np.random.RandomState(2).randn(1, 64, 96, 3) * 50).astype(np.float32)
    want = jax.jit(jm.apply)({"params": jparams}, x)
    with torch.no_grad():
        got = model.student.bottom_up(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k, w in want.items():
        w = np.asarray(w).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_cli_trains_the_swin_yaml_on_the_cpu(tmp_path):
    """``python -m lgd_tpu_torch.train`` on the in-package Swin RetinaNet
    YAML: two AdamW steps with drop-path on, distillation on in the second,
    then COCO evaluation of the student."""
    from lgd_tpu_torch import train as ttrain

    yaml = os.path.join(os.path.dirname(ttrain.__file__), "configs",
                        "retinanet_swint_synthetic_mini.yaml")
    out = tmp_path / "out"
    argv = ["--config-file", yaml, "MODEL.DEVICE", "cpu",
            "SOLVER.MAX_ITER", "2", "INPUT.MIN_SIZE_TRAIN", "(64,)",
            "INPUT.MAX_SIZE_TRAIN", "96", "INPUT.MIN_SIZE_TEST", "64",
            "INPUT.MAX_SIZE_TEST", "96", "OUTPUT_DIR", str(out),
            "MODEL.DISTILLATOR.PRE_NONDISTILL_ITERS", "1",
            "MODEL.DISTILLATOR.EVAL_TEACHER", "False",
            "MODEL.RETINANET.TOPK_CANDIDATES_TEST", "100"]
    res = ttrain.main(ttrain.default_argument_parser().parse_args(argv))
    assert np.isfinite(res["bbox"]["AP50"])
    state = torch.load(out / "model_final.pth", weights_only=True)
    assert "student.bottom_up.stage5_block1.attn.relative_position_bias_table" \
        in state
