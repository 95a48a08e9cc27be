"""The port's CUDA kernels against their plain PyTorch versions at edge-case
shapes. These need an NVIDIA GPU: here they skip. On the card, run them
with ``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``
(``--noconftest``: the suite's conftest configures JAX, which the card's
machine does not need). ``chip_smoke.py`` covers the serving and training
paths' shapes.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the einsum comparison
    return torch.device("cuda")


def _boxes(rng, shape, size=100.0):
    p1 = rng.uniform(0, size, shape + (2,))
    wh = rng.uniform(1, size / 2, shape + (2,))
    return torch.from_numpy(np.concatenate([p1, p1 + wh], -1).astype(np.float32))


def test_nms_kernel_matches_plain(dev):
    # N at and around the 64-candidate mask word, several row chunks, and a
    # walk whose prefetch buffers exceed 48 KB of shared memory (N >= 3000)
    for case in [(1, 1, 1, 0.5), (3, 255, 50, 0.5), (2, 257, 300, 0.3), (4, 700, 5, 0.7),
                 (2, 63, 63, 0.5), (2, 64, 64, 0.5), (2, 65, 65, 0.5),
                 (2, 3000, 3000, 0.7), (2, 4097, 4097, 0.6),
                 (1, 15000, 700, 0.7)]:  # rows beyond the walk's shared-memory window
        _nms_case(dev, *case)
    _nms_walk_cases(dev)


def _nms_walk_cases(dev):
    """max_out reached in the middle of a mask word, the training shape with
    long suppression chains, and dead candidates interleaved in a sorted
    input (assume_sorted with a mask: -inf in place, no re-sort)."""
    from replication_faster_rcnn_tpu_torch.ops.cuda.nms_kernel import nms_fixed_cuda
    from replication_faster_rcnn_tpu_torch.ops.nms_tiled import nms_fixed_tiled

    def same(boxes, scores, thresh, max_out, **kw):
        got = nms_fixed_cuda(boxes, scores, thresh, max_out, **kw)
        want = nms_fixed_tiled(boxes, scores, thresh, max_out, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return want

    rng = np.random.default_rng(5)
    # disjoint boxes: every candidate is kept, so max_out = 100 stops inside word 1
    side = torch.arange(200, dtype=torch.float32)[:, None] * 10.0
    disjoint = torch.cat([side, side, side + 5.0, side + 5.0], dim=1)[None].to(dev)
    _, valid = same(disjoint, torch.linspace(1, 0, 200, device=dev)[None], 0.5, 100)
    assert int(valid.sum()) == 100
    # clustered 2 x 12000 -> 600 at 0.7, scores sorted
    centres = _boxes(rng, (2, 40), 500.0).numpy()
    pick = rng.integers(0, 40, (2, 12000))
    clustered = np.take_along_axis(centres, pick[..., None], axis=1)
    clustered = clustered + rng.normal(0, 6, (2, 12000, 4))
    scores = -np.sort(-rng.uniform(0, 1, (2, 12000)), axis=1)
    boxes = torch.from_numpy(clustered.astype(np.float32)).to(dev)
    s = torch.from_numpy(scores.astype(np.float32)).to(dev)
    same(boxes, s, 0.7, 600, mask=torch.isfinite(s), assume_sorted=True)
    # dead candidates anywhere in the sorted order
    mask = torch.from_numpy(rng.uniform(size=(2, 12000)) > 0.3).to(dev)
    mask[:, 60:70] = False
    mask[:, 128:192] = False  # a whole dead word
    same(boxes, s, 0.7, 600, mask=mask, assume_sorted=True)


def _nms_case(dev, b, n, max_out, thresh):
    from replication_faster_rcnn_tpu_torch.ops.cuda.nms_kernel import nms_fixed_cuda
    from replication_faster_rcnn_tpu_torch.ops.nms_tiled import nms_fixed_tiled

    rng = np.random.default_rng(n)
    boxes = _boxes(rng, (b, n), 60.0).to(dev)
    scores = torch.from_numpy((rng.integers(0, 5, (b, n)) / 5).astype(np.float32)).to(dev)
    scores[:, :: 7] = float("nan")
    scores[:, 3 :: 11] = float("inf")
    mask = torch.from_numpy(rng.uniform(size=(b, n)) > 0.2).to(dev)
    for kw in ({}, {"mask": mask}):
        got = nms_fixed_cuda(boxes, scores, thresh, max_out, **kw)
        want = nms_fixed_tiled(boxes, scores, thresh, max_out, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    one = nms_fixed_cuda(boxes[0], scores[0], thresh, max_out)
    want = nms_fixed_tiled(boxes[0], scores[0], thresh, max_out)
    assert torch.equal(one[0], want[0]) and torch.equal(one[1], want[1])


def test_nms_kernel_empty_and_all_masked(dev):
    from replication_faster_rcnn_tpu_torch.ops.cuda import nms_kernel

    empty = nms_kernel.nms_fixed_cuda(torch.zeros(2, 0, 4, device=dev),
                                      torch.zeros(2, 0, device=dev), 0.5, 4)
    assert empty[0].shape == (2, 4) and not empty[1].any()
    boxes = _boxes(np.random.default_rng(0), (2, 40)).to(dev)
    idx, valid = nms_kernel.nms_fixed_cuda(boxes, torch.full((2, 40), float("-inf"), device=dev),
                                           0.5, 10)
    assert not valid.any() and (idx == 0).all()
    with pytest.raises(ValueError):
        nms_kernel.nms_fixed_cuda(boxes, torch.zeros(2, 39, device=dev), 0.5, 10)


def test_roi_align_kernel_matches_gather(dev):
    # C not a multiple of 8 (the scalar path), multiples (16-byte vectors,
    # one channel tile or a second, nearly empty one),
    # bins split over several blocks (few rois) or not, float32 and
    # bfloat16 features and outputs
    for dtype in (torch.float32, torch.bfloat16):
        for c, out, s, scale in [(3, 7, 2, 1.0), (12, 7, 2, 1.0), (130, 5, 3, 0.5),
                                 (64, 1, 1, 0.25), (256, 7, 2, 1.0), (264, 7, 2, 1.0)]:
            _roi_case(dev, dtype, c, out, s, scale)
    _roi_edge_cases(dev)


def _roi_case(dev, dtype, c, out, s, scale):
    from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import _forward_cuda, roi_align_cuda
    from replication_faster_rcnn_tpu_torch.ops.roi_ops import roi_align

    rng = np.random.default_rng(c)
    feat = torch.from_numpy(rng.normal(0, 1, (2, 13, 11, c)).astype(np.float32)).to(dev, dtype)
    rois = _boxes(rng, (2, 37), 40.0)
    rois[:, :3] = torch.tensor([[-9.0, -9.0, -2.0, -3.0], [3.0, 3.0, 3.0, 3.0],
                                [30.0, 30.0, 60.0, 70.0]])
    rois = rois.to(dev)
    got = roi_align_cuda(feat, rois, out, s, scale)
    want = roi_align(feat, rois, out, s, scale, method="gather")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    einsum = roi_align(feat, rois, out, s, scale, method="einsum")
    torch.testing.assert_close(got, einsum, atol=2e-5, rtol=1e-5)
    # the bfloat16 store rounds the float32 value once, as .to() does
    got16 = roi_align_cuda(feat, rois, out, s, scale, out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16 and torch.equal(got16, want.to(torch.bfloat16))
    # one block per roi gives the same bits as the split launch
    one = _forward_cuda(feat, rois * scale, out, s, torch.float32, splits=1)
    assert torch.equal(one, got)
    assert roi_align_cuda(feat, rois[:, :0], out, s, scale).shape == (2, 0, out, out, c)


def _roi_edge_cases(dev):
    """A feature base one element off 16-byte alignment, N = 1, R = 0 and a
    NaN roi (a diverged step's proposal: it reads nothing)."""
    from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import roi_align_cuda
    from replication_faster_rcnn_tpu_torch.ops.roi_ops import roi_align

    rng = np.random.default_rng(9)
    rois = _boxes(rng, (1, 20), 40.0)
    rois[0, 0] = torch.tensor([float("nan"), 2.0, 9.0, 9.0])
    rois[0, 1] = float("nan")
    rois[0, 2] = torch.tensor([1.0, 2.0, float("nan"), 9.0])  # only the far corner
    rois = rois.to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.from_numpy(rng.normal(0, 1, 13 * 11 * 64 + 1).astype(np.float32))
        feat = flat.to(dev, dtype)[1:].view(1, 13, 11, 64)  # N = 1, misaligned base
        assert feat.is_contiguous() and feat.data_ptr() % 16
        want = roi_align(feat, rois, 7, 2, method="gather")
        assert torch.isfinite(want).all() and not want[0, :3].any()
        for out_dtype in (torch.float32, torch.bfloat16):
            got = roi_align_cuda(feat, rois, 7, 2, out_dtype=out_dtype)
            assert got.dtype == out_dtype and torch.equal(got, want.to(out_dtype))
        empty = roi_align_cuda(feat, rois[:, :0], 7, 2, out_dtype=torch.bfloat16)
        assert empty.shape == (1, 0, 7, 7, 64) and empty.dtype == torch.bfloat16


# ------------------------------------------------------------- IoU matching


def test_iou_match_kernel_bitwise(dev):
    for case in [(2, 257, 5, False, "random"),       # M not a multiple of the 256-row block
                 (3, 1000, 1, True, "random"),       # G = 1
                 (2, 300, 4, False, "all_padded"),   # every gt column padded
                 (2, 700, 6, True, "ties"),          # exact ties between rows in different blocks
                 (8, 12996, 32, True, "random"),     # the anchor site
                 (8, 632, 32, False, "random")]:     # the proposal site
        _iou_case(dev, *case)


def _iou_case(dev, b, m, g, shared, case):
    from replication_faster_rcnn_tpu_torch.ops.cuda import iou_kernel
    from replication_faster_rcnn_tpu_torch.ops.iou_match import match_boxes

    rng = np.random.default_rng(m + g)
    boxes = _boxes(rng, (1 if shared else b, m), 600.0).to(dev)
    gt = _boxes(rng, (b, g), 600.0)
    mask = torch.from_numpy(rng.uniform(size=(b, g)) > 0.3)
    mask[:, 0] = True
    if case == "all_padded":
        mask[:] = False
    if case == "ties":
        boxes[0, 600] = boxes[0, 5]       # row 5 (block 0) and row 600 (block 2) tie
        boxes[0, 260] = gt[0, 0].to(dev)  # IoU 1 in two blocks: the first row wins
        boxes[0, 517] = gt[0, 0].to(dev)
        gt[:, -1] = gt[:, 0]              # equal columns: the first wins the row
        mask[:, -1] = True
    gt, mask = gt.to(dev), mask.to(dev)
    want = match_boxes(boxes, gt, mask)
    for want_iou in (True, False):
        n0 = iou_kernel.launches
        got = iou_kernel.match_boxes_cuda(boxes, gt, mask, want_col=True, want_iou=want_iou)
        torch.cuda.synchronize()
        assert iou_kernel.launches == n0 + 1
        for a, w in zip(got, want):
            if a is not None:
                assert a.dtype == w.dtype and torch.equal(a, w)
    if case == "ties":
        assert int(want[3][0, 0]) == 260
    _, argmax, max_iou, col = iou_kernel.match_boxes_cuda(boxes, gt, mask, want_col=False,
                                                          want_iou=False)
    assert col is None and torch.equal(argmax, want[1]) and torch.equal(max_iou, want[2])


# ------------------------------------------------------------ ROIAlign backward


def test_roi_align_backward_kernel_matches_plain(dev):
    # C not a multiple of 8 or of the 256-channel tile, float32 and
    # bfloat16 gradients and features, s*s a power of two or not, N = 1
    for dtype in (torch.float32, torch.bfloat16):
        for grad_dtype in (torch.float32, torch.bfloat16):
            for c, h, w, r, out, s, n in [(3, 13, 11, 37, 7, 2, 2), (12, 13, 11, 37, 7, 2, 2),
                                          (130, 9, 70, 20, 5, 3, 1), (256, 38, 38, 128, 7, 2, 2),
                                          (264, 9, 11, 10, 7, 2, 1)]:
                _roi_bwd_case(dev, dtype, grad_dtype, c, h, w, r, out, s, n)
    _roi_bwd_edge_cases(dev)


def _roi_bwd_rois(rng, n, r, h, w):
    rois = _boxes(rng, (n, r), float(max(h, w)))
    rois[:, :5] = torch.tensor([[-0.9, -0.9, 3.0, 3.0],              # at the top-left border
                                [h - 3.0, w - 4.0, h + 2.0, w + 3.0],  # beyond the bottom-right
                                [2.2, 2.2, 2.2, 2.2],                # a 1-pixel roi
                                [-5.0, -5.0, -2.0, -1.5],            # entirely out of range
                                [h - 1.0, w - 1.0, h - 0.5, w - 0.2]])  # taps collapse at the edge
    return rois


def _roi_bwd_check(dev, g, rois, shape, dtype, out, s):
    """Kernel within tolerance of the plain scatter, and bitwise the same in
    a second launch."""
    from replication_faster_rcnn_tpu_torch.ops.cuda import roi_kernel
    from replication_faster_rcnn_tpu_torch.ops.roi_ops import roi_align_backward

    n0 = roi_kernel.backward_launches
    got = roi_kernel.roi_align_backward_cuda(g, rois, shape, dtype, out, s)
    again = roi_kernel.roi_align_backward_cuda(g, rois, shape, dtype, out, s)
    want = roi_align_backward(g, rois, shape, dtype, out, s)
    torch.cuda.synchronize()
    assert roi_kernel.backward_launches == n0 + 2 and got.dtype == dtype
    assert torch.equal(got, again)  # deterministic: no atomics, a fixed order
    if dtype == torch.float32:  # the same float32 products summed in another order
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    else:  # the float32 sums rounded once to bfloat16: one bf16 ulp
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=2**-7)


def _roi_bwd_case(dev, dtype, grad_dtype, c, h, w, r, out, s, n):
    rng = np.random.default_rng(c + r)
    rois = _roi_bwd_rois(rng, n, r, h, w).to(dev)
    g = torch.from_numpy(rng.normal(0, 1, (n, r, out, out, c)).astype(np.float32))
    _roi_bwd_check(dev, g.to(dev, grad_dtype), rois, (n, h, w, c), dtype, out, s)


def _roi_bwd_edge_cases(dev):
    """R = 0 (a zero gradient, written by the kernel), a NaN roi, a gradient
    base one element off alignment, and 128 identical rois per image, where
    every roi adds to the same pixels."""
    from replication_faster_rcnn_tpu_torch.ops.cuda import roi_kernel

    rng = np.random.default_rng(31)
    shape = (2, 13, 11, 16)
    zero = roi_kernel.roi_align_backward_cuda(torch.zeros(2, 0, 7, 7, 16, device=dev),
                                              torch.zeros(2, 0, 4, device=dev), shape,
                                              torch.bfloat16, 7, 2)
    assert zero.dtype == torch.bfloat16 and zero.shape == shape and not zero.any()
    rois = _roi_bwd_rois(rng, 2, 12, 13, 11)
    rois[1, 5] = torch.tensor([float("nan"), 1.0, 6.0, 7.0])
    rois[1, 6] = torch.tensor([1.0, 2.0, 6.0, float("nan")])
    rois = rois.to(dev)
    flat = torch.from_numpy(rng.normal(0, 1, 2 * 12 * 49 * 16 + 1).astype(np.float32)).to(dev)
    g = flat[1:].view(2, 12, 7, 7, 16)
    assert g.is_contiguous() and g.data_ptr() % 8
    for dtype in (torch.float32, torch.bfloat16):
        _roi_bwd_check(dev, g, rois, shape, dtype, 7, 2)
    same = torch.tensor([5.3, 7.1, 30.2, 33.9], device=dev).expand(2, 128, 4).contiguous()
    g = torch.from_numpy(rng.normal(0, 1, (2, 128, 7, 7, 256)).astype(np.float32)).to(dev)
    for grad_dtype in (torch.float32, torch.bfloat16):
        _roi_bwd_check(dev, g.to(grad_dtype), same, (2, 38, 38, 256), torch.bfloat16, 7, 2)


def test_training_reaches_the_trunk_through_roi_align_cuda(dev):
    """The head's losses alone give the trunk a gradient on the card, through
    the ROIAlign forward and backward kernels."""
    from replication_faster_rcnn_tpu_torch import get_config
    from replication_faster_rcnn_tpu_torch.config import (
        DataConfig, ProposalConfig, ROITargetConfig, RPNTargetConfig, TrainConfig)
    from replication_faster_rcnn_tpu_torch.data.loader import collate
    from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from replication_faster_rcnn_tpu_torch.ops.cuda import roi_kernel
    from replication_faster_rcnn_tpu_torch.train.train_step import compute_losses
    from replication_faster_rcnn_tpu_torch.train.trainer import Trainer

    cfg = get_config("voc12_resnet18_align").replace(
        data=DataConfig(image_size=(128, 128), max_boxes=4),
        proposals=ProposalConfig(pre_nms_train=400, post_nms_train=64),
        rpn_targets=RPNTargetConfig(n_sample=64), roi_targets=ROITargetConfig(n_sample=16),
        train=TrainConfig(batch_size=2, loss_weights=(0.0, 0.0, 1.0, 1.0)))
    trainer = Trainer(cfg, SyntheticDataset(cfg.data, length=2))
    assert trainer.device.type == "cuda"
    batch = trainer.stage_batch(next(trainer.batches(0)))
    model = trainer.model
    n0, b0 = roi_kernel.launches, roi_kernel.backward_launches
    total, _ = compute_losses(model, cfg, batch, trainer.state.generator)
    total.backward()
    torch.cuda.synchronize()
    assert roi_kernel.launches == n0 + 1 and roi_kernel.backward_launches == b0 + 1
    grad = model.trunk.conv1.weight.grad
    assert grad is not None and torch.isfinite(grad).all() and float(grad.abs().sum()) > 0
    assert float(model.rpn.cls.weight.grad.abs().sum()) == 0.0
    metrics = trainer.train_one_batch(next(trainer.batches(0)))
    assert np.isfinite(metrics["loss"]) and metrics["skipped"] == 0.0


# -------------------------------------------------------------- int8 kernels


def test_int8_kernels_bitwise(dev):
    """The int8 GEMM at M around its 16-row MMA and 32-row block tiles, N
    around the 8-column MMA tile and the head's 21 and 84, and K not a
    multiple of 16 (byte-filled tiles), a multiple (cp.async copies) or
    longer than the 512 bytes staged at once (the two-stage ring), over the
    whole int8 range; non-contiguous operands (copied by the wrapper) and a
    base that is not 16-byte aligned; and the dequantize on rank-1 to rank-4
    weights along either end axis, into float32 and bfloat16."""
    from replication_faster_rcnn_tpu_torch.ops import quant_ops
    from replication_faster_rcnn_tpu_torch.ops.cuda import quant_kernel

    rng = np.random.default_rng(8)

    def int8(shape):
        x = rng.integers(-128, 128, shape, dtype=np.int8)
        x.flat[:3] = (-128, 127, -127)
        return torch.from_numpy(x).to(dev)

    for m in (1, 15, 16, 17, 33, 2400):
        for n in (1, 8, 21, 24, 84, 88, 130):
            for k in (1, 7, 16, 32, 70, 512, 1027, 1040):
                x, w = int8((m, k)), int8((k, n))
                n0 = quant_kernel.matmul_launches
                got = quant_kernel.int8_matmul_cuda(x, w)
                torch.cuda.synchronize()
                assert quant_kernel.matmul_launches == n0 + 1
                assert got.dtype == torch.int32 and got.shape == (m, n)
                assert torch.equal(got, quant_ops.int8_matmul_plain(x, w)), (m, n, k)
    # contiguous operands whose base is one byte past a 16-byte boundary
    buf_x, buf_w = int8((33 * 512 + 1,)), int8((24 * 512 + 1,))
    x, wt = buf_x[1:].view(33, 512), buf_w[1:].view(24, 512)
    assert x.is_contiguous() and x.data_ptr() % 16 and wt.data_ptr() % 16
    assert torch.equal(quant_kernel.int8_matmul_cuda(x, wt.t()),
                       quant_ops.int8_matmul_plain(x, wt.t()))
    extreme = torch.full((15, 520), -128, dtype=torch.int8, device=dev)
    got = quant_kernel.int8_matmul_cuda(extreme, extreme.t()[:, :21])
    assert int(got.max()) == 520 * 128 * 128
    x, w = int8((40, 2 * 70)), int8((84, 2 * 70))
    for a, b in ((x[:, ::2], w[:, ::2].t()), (x.t().contiguous().t(), w.t())):
        assert not (a.is_contiguous() and b.is_contiguous())
        assert torch.equal(quant_kernel.int8_matmul_cuda(a, b), quant_ops.int8_matmul_plain(a, b))
    with pytest.raises(TypeError):
        quant_kernel.int8_matmul_cuda(x.float(), w.t())
    with pytest.raises(ValueError):
        quant_kernel.int8_matmul_cuda(x, w)

    for shape in [(7,), (21, 512), (512, 512, 3, 3), (3, 3, 64, 64), (5, 1, 1, 3)]:
        w = int8(shape)
        # the same values as a non-contiguous view (copied by the wrapper)
        views = (w, w.transpose(0, -1).contiguous().transpose(0, -1)) if w.dim() > 1 else (w,)
        for axis in (0, -1):
            scale = torch.from_numpy(
                rng.uniform(1e-4, 0.1, shape[axis]).astype(np.float32)).to(dev)
            for t in views:
                for dtype in (torch.float32, torch.bfloat16):
                    n0 = quant_kernel.dequantize_launches
                    got = quant_kernel.dequantize_cuda(t, scale, axis, dtype)
                    torch.cuda.synchronize()
                    assert quant_kernel.dequantize_launches == n0 + 1
                    want = quant_ops.dequantize_plain(t, scale, axis, dtype)
                    assert got.dtype == dtype and torch.equal(got, want), (shape, axis, dtype)
    with pytest.raises(ValueError):
        quant_kernel.dequantize_cuda(int8((4, 5)), torch.ones(4, device=dev))
    with pytest.raises(TypeError):
        quant_kernel.dequantize_cuda(int8((4, 5)), torch.ones(5, device=dev), -1, torch.float16)
