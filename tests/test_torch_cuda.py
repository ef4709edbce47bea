"""Kernels K2 (lgd_tpu_torch/csrc/nms.cu), K1a/K1b
(lgd_tpu_torch/csrc/attention.cu), K3 (lgd_tpu_torch/csrc/roi_align.cu) and
K4 (lgd_tpu_torch/csrc/deform_conv.cu) on the card, against their plain
PyTorch versions. Imports no JAX, so it runs on a machine that has only the port's
dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Without a card every test here skips: a CUDA kernel has no CPU mode."""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (DCN_TILE_CASES, check_roi_case, dcn_inputs,
                        dcn_tile_case, hold_dcn)
from lgd_tpu_torch.ops import attention, deform_conv, nms, roi_align


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda", 0)


def _pool(seed, B, n, device):
    """Inference-scale candidates with duplicate scores and boxes, an IoU
    pair exactly at 1/3, an invalid tail and one all-invalid image."""
    rng = np.random.RandomState(seed)
    ctr = rng.rand(B, n, 2) * 800
    wh = rng.rand(B, n, 2) * 300 + 2
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = rng.rand(B, n).astype(np.float32)
    if n > 51:
        scores[:, 10:20] = scores[:, 5:6]
        boxes[:, 30:35] = boxes[:, 29:30]
        boxes[:, 50] = [0.0, 0.0, 10.0, 10.0]
        boxes[:, 51] = [0.0, 5.0, 10.0, 15.0]
        scores[:, 50], scores[:, 51] = 2.0, 1.9
    valid = np.ones((B, n), bool)
    valid[0, n - n // 5:] = False
    valid[-1] = False
    classes = rng.randint(0, 80, (B, n))
    return [torch.from_numpy(a).to(device)
            for a in (boxes, scores, classes, valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(8, 2000), (2, 64), (3, 65), (1, 1)])
def test_kernel_matches_plain_version(cuda_device, B, n):
    boxes, scores, classes, valid = _pool(B * 1000 + n, B, n, cuda_device)
    before = nms.greedy_keep_sorted.launches
    got = nms.batched_nms_mask(boxes, scores, classes, valid, 0.5)
    want = nms.batched_nms_mask(boxes, scores, classes, valid, 0.5,
                                keep_fn=nms.greedy_keep_sorted_reference)
    torch.cuda.synchronize()
    assert nms.greedy_keep_sorted.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_iou_exactly_at_threshold(cuda_device):
    boxes = torch.tensor([[[0.0, 0.0, 10.0, 10.0], [0.0, 5.0, 10.0, 15.0]]],
                         device=cuda_device)
    scores = torch.tensor([[0.9, 0.8]], device=cuda_device)
    valid = torch.ones((1, 2), dtype=torch.bool, device=cuda_device)
    thr = float(np.float32(50.0) / np.float32(150.0))
    assert nms.nms_mask(boxes, scores, valid, thr).tolist() == [[True, True]]
    assert nms.nms_mask(boxes, scores, valid,
                        thr - 1e-6).tolist() == [[True, False]]


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_does_not_take(cuda_device):
    boxes = torch.zeros((1, 8, 4), device=cuda_device)
    valid = torch.ones((1, 8), dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        nms.greedy_keep_sorted(boxes.half(), valid, 0.5)
    with pytest.raises(ValueError):
        nms.greedy_keep_sorted(boxes[:, :, :3], valid, 0.5)
    with pytest.raises(ValueError):
        nms.greedy_keep_sorted(torch.zeros((1, 8, 8), device=cuda_device)
                               [..., ::2], valid, 0.5)


def _attention_inputs(device, B, Nq, Nk, seed, H=8, D=32):
    """q and an output gradient (B, H, Nq, D), k and v (B, H, Nk, D) and a
    padded key mask: image 0 has one valid key, the last image (of
    several) none."""
    g = torch.Generator().manual_seed(seed)
    q, grad = (torch.randn(B, H, Nq, D, generator=g).to(device)
               for _ in range(2))
    k, v = (torch.randn(B, H, Nk, D, generator=g).to(device)
            for _ in range(2))
    valid = (torch.rand(B, Nk, generator=g) > 0.3).to(device)
    valid[0] = False
    valid[0, 0] = True
    if B > 1:
        valid[-1] = False
    return q, k, v, grad, valid


def _hold_attention(q, k, v, grad, valid):
    """K1a forward and K1b gradients through ``masked_attention`` against
    the plain version and its autograd gradient, float32 with TF32 off:
    1e-5 (forward) and 1e-4 (gradients) of the largest value."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for fn in (attention.masked_attention,
                   attention.masked_attention_reference):
            qkv = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fn(*qkv, valid, 1.0 / q.shape[-1] ** 0.5)
            outs.append([out, *torch.autograd.grad(out, qkv, grad)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (got, *got_g), (want, *want_g) = outs
    torch.cuda.synchronize()
    for a, b, tol in zip([got, *got_g], [want, *want_g], (1e-5, 1e-4, 1e-4,
                                                          1e-4)):
        assert (a - b).abs().max() <= tol * b.abs().max()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(1, 2), (16, 33), (3, 101)])
def test_attention_kernels_match_plain_version(cuda_device, B, N):
    """K1a forward and K1b gradients through ``masked_attention`` against
    the plain version and its autograd gradient, float32 with TF32 off:
    1e-5 (forward) and 1e-4 (gradients) of the largest value. Keys are
    padded; image 0 has one valid key, the last image none."""
    q, k, v, grad, valid = _attention_inputs(cuda_device, B, N, N,
                                             B * 1000 + N)
    before = attention.attention_fwd.launches, attention.attention_bwd.launches
    _hold_attention(q, k, v, grad, valid)
    assert attention.attention_fwd.launches == before[0] + 1
    assert attention.attention_bwd.launches == before[1] + 1
    attention.masked_attention(q, k, v, valid, 0.5)
    assert attention.attention_fwd.launches == before[0] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("B,Nq,Nk", [
    (1, 1, 1), (16, 15, 15), (16, 16, 16), (16, 17, 17), (16, 128, 128),
    (16, 257, 257), (16, 101, 37), (2, 37, 101), (1, 700, 700)])
def test_attention_kernels_at_the_tiles_edges(cuda_device, B, Nq, Nk):
    """The same at the edges of a lane's keys, of the row tiles and of the
    128-token chunks, with more queries than keys and fewer, and past the
    old kernel's shared-memory limit (700 tokens); the all-invalid image
    averages V uniformly."""
    q, k, v, grad, valid = _attention_inputs(cuda_device, B, Nq, Nk,
                                             B + Nq * 1000 + Nk)
    got = _hold_attention(q, k, v, grad, valid)
    if B > 1:
        assert torch.allclose(got[-1], v[-1].mean(dim=1, keepdim=True)
                              .expand_as(got[-1]), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 16, 64])
@pytest.mark.parametrize("B,Nq,Nk", [(1, 1, 1), (16, 17, 17), (16, 101, 101),
                                     (16, 101, 37), (2, 257, 257)])
def test_attention_kernels_at_other_head_widths(cuda_device, D, B, Nq, Nk):
    """The head widths besides the teacher's 32 that the kernels are built
    for: 8 (the mini configs' 64-channel FPN over 8 heads), 16 and 64,
    where a lane sums a share of the tokens of one column (8, 16) or two
    columns (64); K1b gives the same bits twice."""
    q, k, v, grad, valid = _attention_inputs(cuda_device, B, Nq, Nk,
                                             D * 1000 + Nq + Nk, D=D)
    got = _hold_attention(q, k, v, grad, valid)
    if B > 1:
        assert torch.allclose(got[-1], v[-1].mean(dim=1, keepdim=True)
                              .expand_as(got[-1]), atol=1e-5)
    scale = 1.0 / D ** 0.5
    saved = attention.attention_fwd(q, k, v, valid, scale)
    first = attention.attention_bwd(q, k, v, valid, *saved, grad, scale)
    second = attention.attention_bwd(q, k, v, valid, *saved, grad, scale)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_rcnn_mini_yaml_trains_a_step_on_the_card(cuda_device, tmp_path):
    """The in-package R-CNN YAML (a 64-channel FPN: the teacher's heads are
    8 wide) trains one step on the card (its default device) through the
    command line and evaluates, with K1a and K1b at D = 8."""
    from lgd_tpu_torch import train as ttrain

    yaml = os.path.join(os.path.dirname(ttrain.__file__), "configs",
                        "rcnn_R18_synthetic_mini.yaml")
    before = attention.attention_fwd.launches, attention.attention_bwd.launches
    argv = ["--config-file", yaml, "SOLVER.MAX_ITER", "1",
            "OUTPUT_DIR", str(tmp_path / "out")]
    res = ttrain.main(ttrain.default_argument_parser().parse_args(argv))
    assert np.isfinite(res["bbox"]["AP50"])
    assert attention.attention_fwd.launches > before[0]
    assert attention.attention_bwd.launches > before[1]


@pytest.mark.cuda
def test_attention_backward_is_the_same_from_run_to_run(cuda_device):
    """K1b writes every element from one lane, without atomics: two runs
    on the same inputs give the same bits."""
    q, k, v, grad, valid = _attention_inputs(cuda_device, 16, 101, 101, 5)
    saved = attention.attention_fwd(q, k, v, valid, 0.25)
    first = attention.attention_bwd(q, k, v, valid, *saved, grad, 0.25)
    second = attention.attention_bwd(q, k, v, valid, *saved, grad, 0.25)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_attention_wrapper_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 2, 8, 32), device=cuda_device)
    valid = torch.ones((1, 8), dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        attention.attention_fwd(q.half(), q, q, valid, 0.5)
    with pytest.raises(ValueError):
        attention.attention_fwd(q, q[:, :1], q, valid, 0.5)
    with pytest.raises(ValueError):
        attention.attention_fwd(q.transpose(2, 3), q, q, valid, 0.5)
    unbuilt = torch.zeros((1, 2, 8, 24), device=cuda_device)
    with pytest.raises(ValueError, match="built for D in"):
        attention.attention_fwd(unbuilt, unbuilt, unbuilt, valid, 0.5)
    out, m, s = attention.attention_fwd(q, q, q, valid, 0.5)
    with pytest.raises(ValueError):
        attention.attention_bwd(q, q, q, valid, out, m[..., :4], s, q, 0.5)


def _rois(device, dtype, B=3, C=16, canvas=(256, 352)):
    """A p2-p5 pyramid and ROIs on every level, past the edges, under a
    texel, at the s_max cap, empty; one invalid slot and an all-invalid
    last image. Returns (levels, index, coords, valid)."""
    g = torch.Generator().manual_seed(C)
    H, W = canvas
    feats = [torch.randn(B, C, H // s, W // s, generator=g).to(device, dtype)
             for s in (4, 8, 16, 32)]
    fixed = torch.tensor([
        [10.3, 12.7, 40.1, 30.9], [3.0, 5.0, 3.4, 5.3],
        [-20.0, -15.0, 60.0, 50.0], [W - 90.0, H - 60.0, W + 30.0, H + 20.0],
        [0.0, 0.0, 224.0, 224.0], [-300.0, -200.0, W + 300.0, H + 200.0],
        [64.0, 64.0, 64.0, 64.0], [12.0, 33.0, 150.0, 41.0]])
    ctr = torch.rand(B, 40, 2, generator=g) * torch.tensor([W, H])
    wh = torch.exp(torch.rand(B, 40, 2, generator=g) * 6.0) + 1.0
    boxes = torch.cat([fixed.expand(B, -1, -1),
                       torch.cat([ctr - wh / 2, ctr + wh / 2], -1)], 1)
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool)
    valid[0, 2] = False
    valid[-1] = False
    index, coords = roi_align.roi_geometry(boxes.to(device), valid.to(device),
                                           (4, 8, 16, 32), 7, 2)
    return feats, index, coords, valid.flatten().to(device)


def _bf16_ulp(x):
    a = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernels_match_plain_version(cuda_device, dtype):
    """K3 forward, summed in float32, within 1e-5 of the largest value of
    the plain version (bfloat16 outputs within one bfloat16 ulp more: the
    kernel sums each bin's samples in another order), and the
    backward against autograd of the plain version on float32 copies of
    the levels: 1e-5 of the largest value in float32 (the atomics' order
    changes from run to run), in bfloat16 one ulp more (the rounding).
    Invalid ROIs pool to zeros and send no gradient."""
    feats, index, coords, valid = _rois(cuda_device, dtype)
    got = roi_align.roi_align_fwd(feats, index, coords, 7,
                                  out_dtype=torch.float32)
    want = roi_align.multilevel_roi_align_reference(
        feats, index, coords, 7, out_dtype=torch.float32)
    tol = 1e-5 * want.abs().max()
    assert (got - want).abs().max() <= tol
    assert not got[~valid].any()
    got = roi_align.roi_align_fwd(feats, index, coords, 7)
    want = roi_align.multilevel_roi_align_reference(feats, index, coords, 7)
    assert got.dtype == dtype
    assert ((got.float() - want.float()).abs() <= tol + _bf16_ulp(want)).all()

    grad = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    grad = grad.to(cuda_device, dtype)
    got_g = roi_align.roi_align_bwd(grad, index, coords, feats)
    leaves = [f.detach().float().requires_grad_() for f in feats]
    want_g = torch.autograd.grad(roi_align.multilevel_roi_align_reference(
        leaves, index, coords, 7), leaves, grad.float())
    for a, b in zip(got_g, want_g):
        assert a.dtype == dtype and not a[-1].any()
        if dtype == torch.float32:
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()
        else:
            b = b.to(dtype).float()
            tol = _bf16_ulp(b) + 1e-5 * b.abs().max()
            assert ((a.float() - b).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("out", [7, 14, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,canvas,n_random", [(2, 16, (800, 1344), 20),
                                                 (3, 16, (32, 32), 30)])
def test_roi_align_backward_windows(cuda_device, dtype, B, C, canvas,
                                    n_random, out):
    """K3 (chip_smoke's ``check_roi_case``) on the ROIs that probe the
    windows that both directions tile: the whole canvas (the whole top
    level, two window tiles wide at 800x1344), a box ending on the
    bottom-right edge (high corners clamped onto one texel), elongated
    boxes whose capped bins span several tiles, and at 32x32 one-texel p5
    levels; forward and backward within the limits of ``hold_roi``, at the
    box heads' 7 bins per side, the config default's 14 and the kernels'
    most, 16."""
    check_roi_case(B, C, canvas, n_random, dtype, cuda_device, out)


@pytest.mark.cuda
def test_roi_align_autograd_counts_one_launch_each_way(cuda_device):
    feats, _, _, _ = _rois(cuda_device, torch.float32, B=2)
    feats = [f.requires_grad_() for f in feats]
    boxes = torch.tensor([[[10.0, 10.0, 90.0, 70.0], [0.0, 0.0, 300.0,
                                                       200.0]]] * 2,
                         device=cuda_device)
    valid = torch.ones((2, 2), dtype=torch.bool, device=cuda_device)
    before = roi_align.roi_align_fwd.launches, roi_align.roi_align_bwd.launches
    pooled = roi_align.multilevel_roi_align(feats, boxes, valid, (4, 8, 16, 32),
                                            7, 2)
    assert pooled.shape == (2, 2, 16, 7, 7)
    pooled.sum().backward()
    assert (roi_align.roi_align_fwd.launches,
            roi_align.roi_align_bwd.launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert all(f.grad is not None for f in feats)


@pytest.mark.cuda
def test_roi_align_wrapper_rejects_what_it_does_not_take(cuda_device):
    feats, index, coords, _ = _rois(cuda_device, torch.float32, B=2)
    with pytest.raises(TypeError):
        roi_align.roi_align_fwd([f.half() for f in feats], index, coords, 7)
    with pytest.raises(TypeError):
        roi_align.roi_align_fwd(feats, index.long(), coords, 7)
    with pytest.raises(TypeError):
        roi_align.roi_align_fwd([feats[0], feats[1].bfloat16()], index,
                                coords, 7)
    with pytest.raises(ValueError):
        roi_align.roi_align_fwd([f.transpose(2, 3) for f in feats], index,
                                coords, 7)
    with pytest.raises(ValueError, match="CUDA"):
        roi_align.roi_align_fwd([f.cpu() for f in feats], index, coords, 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,dilation,modulated", [
    (1, 1, True), (1, 1, False), (2, 1, True), (1, 2, True)])
def test_deform_conv_kernels_match_plain_version(cuda_device, dtype, stride,
                                                 dilation, modulated):
    """K4 forward and backward on adversarial offsets (chip_smoke's
    ``hold_dcn``): the float32 columns bit for bit, bfloat16 within one
    ulp, the backward's recomputed columns equal to the forward's, dx and
    the offsets' and mask's gradients within 1e-5 of each one's largest
    value (bfloat16 dx one ulp more)."""
    x, off, mask = dcn_inputs(2, 24, 19, 23, stride, dilation, modulated,
                              dtype, cuda_device, seed=stride + dilation)
    grad = torch.randn(2, 24, 9, *off.shape[-2:], generator=torch.Generator()
                       .manual_seed(3)).to(cuda_device, dtype)
    before = (deform_conv.deform_sample_fwd.launches,
              deform_conv.deform_sample_bwd.launches)
    hold_dcn(x, off, mask, stride, dilation, grad, "test")
    torch.cuda.synchronize()
    assert (deform_conv.deform_sample_fwd.launches,
            deform_conv.deform_sample_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DCN_TILE_CASES,
                         ids=[f"{c[0]}-{c[5]}x{c[6]}".replace(" ", "-")
                              for c in DCN_TILE_CASES])
def test_deform_conv_backward_tiles(cuda_device, dtype, case):
    """K4 forward and backward at the edges of their tiles (chip_smoke's
    ``DCN_TILE_CASES``), held by ``hold_dcn`` (the float32 columns bit for
    bit, bfloat16 within one ulp): offsets far beyond the windows' halos
    (the samples that read x itself), samples pushed off every border, a
    mask of zeros, stride 2 with dilation 2, unmodulated, partial stages of
    channels, the forward's runs of positions cut short at res5's 1050,
    maps too wide for the forward's window of full rows (runs along one
    output row, a window cut to fit), and gradients too small for the
    fixed-point window (float atomics instead)."""
    kind, B, C, H, W, stride, dilation = case
    x, off, mask, grad = dcn_tile_case(kind, B, C, H, W, stride, dilation,
                                       dtype, cuda_device, seed=C + H + W)
    hold_dcn(x, off, mask, stride, dilation, grad, kind)


@pytest.mark.cuda
def test_deform_conv_autograd_counts_one_launch_each_way(cuda_device):
    x, off, mask = dcn_inputs(2, 8, 12, 14, device=cuda_device, seed=1,
                              spread=1.5)
    leaves = [x.requires_grad_(), off.requires_grad_(),
              mask.requires_grad_(),
              torch.randn(6, 8, 3, 3, device=cuda_device).requires_grad_()]
    before = (deform_conv.deform_sample_fwd.launches,
              deform_conv.deform_sample_bwd.launches)
    out = deform_conv.deform_conv2d(leaves[0], leaves[3], leaves[1],
                                    leaves[2])
    assert out.shape == (2, 6, 12, 14)
    out.sum().backward()
    assert (deform_conv.deform_sample_fwd.launches,
            deform_conv.deform_sample_bwd.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)


@pytest.mark.cuda
def test_deform_conv_wrapper_rejects_what_it_does_not_take(cuda_device):
    x, off, mask = dcn_inputs(1, 4, 8, 8, device=cuda_device)
    fwd = deform_conv.deform_sample_fwd
    with pytest.raises(TypeError):
        fwd(x.half(), off, mask)
    with pytest.raises(TypeError):
        fwd(x, off.double(), mask)
    with pytest.raises(ValueError):
        fwd(x, off[:, :16].contiguous(), mask)
    with pytest.raises(ValueError):
        fwd(x.transpose(2, 3), off, mask)
    with pytest.raises(ValueError, match="CUDA"):
        fwd(x, off.cpu(), mask)
