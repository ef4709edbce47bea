"""Kernels K2 (lgd_tpu_torch/csrc/nms.cu) and K1a/K1b
(lgd_tpu_torch/csrc/attention.cu) on the card, against their plain PyTorch
versions. Imports no JAX, so it runs on a machine that has only the port's
dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Without a card every test here skips: a CUDA kernel has no CPU mode."""

import numpy as np
import pytest
import torch

from lgd_tpu_torch.ops import attention, nms


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


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(1, 2), (16, 33), (3, 101)])
def test_attention_kernels_match_plain_version(cuda_device, B, N):
    """K1a forward and K1b gradients through ``masked_attention`` against
    the plain version and its autograd gradient, float32 with TF32 off:
    1e-5 (forward) and 1e-4 (gradients) of the largest value. Keys are
    padded; image 0 has one valid key, the last image none."""
    H, D = 8, 32
    g = torch.Generator().manual_seed(B * 1000 + N)
    q, k, v, grad = (torch.randn(B, H, N, D, generator=g).to(cuda_device)
                     for _ in range(4))
    valid = (torch.rand(B, N, generator=g) > 0.3).to(cuda_device)
    valid[0] = False
    valid[0, 0] = True
    valid[-1] = False
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for fn in (attention.masked_attention,
                   attention.masked_attention_reference):
            qkv = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fn(*qkv, valid, 1.0 / D ** 0.5)
            outs.append([out, *torch.autograd.grad(out, qkv, grad)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    before = attention.attention_fwd.launches, attention.attention_bwd.launches
    (got, *got_g), (want, *want_g) = outs
    torch.cuda.synchronize()
    for a, b, tol in zip([got, *got_g], [want, *want_g], (1e-5, 1e-4, 1e-4,
                                                          1e-4)):
        assert (a - b).abs().max() <= tol * b.abs().max()
    attention.masked_attention(q, k, v, valid, 0.5)
    assert attention.attention_fwd.launches == before[0] + 1


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
    big = torch.zeros((1, 1, 4096, 32), device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        attention.attention_fwd(big, big, big, torch.ones(
            (1, 4096), dtype=torch.bool, device=cuda_device), 0.5)
