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


@pytest.mark.parametrize(
    "b,n,max_out,thresh",
    [(1, 1, 1, 0.5), (3, 255, 50, 0.5), (2, 257, 300, 0.3), (4, 700, 5, 0.7),
     (2, 3000, 3000, 0.7)],  # the last needs > 48 KB of shared memory
)
def test_nms_kernel_matches_plain(dev, b, n, max_out, thresh):
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,out,s,scale", [(3, 7, 2, 1.0), (130, 5, 3, 0.5), (64, 1, 1, 0.25)])
def test_roi_align_kernel_matches_gather(dev, dtype, c, out, s, scale):
    from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import roi_align_cuda
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
    assert roi_align_cuda(feat, rois[:, :0], out, s, scale).shape == (2, 0, out, out, c)


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
    for dtype in (torch.float32, torch.bfloat16):
        for c, h, w, r in [(3, 13, 11, 37), (256, 38, 38, 128)]:
            _roi_bwd_case(dev, dtype, c, h, w, r)


def _roi_bwd_case(dev, dtype, c, h, w, r):
    from replication_faster_rcnn_tpu_torch.ops.cuda import roi_kernel
    from replication_faster_rcnn_tpu_torch.ops.roi_ops import roi_align_backward

    rng = np.random.default_rng(c + r)
    n = 2
    rois = _boxes(rng, (n, r), float(max(h, w)))
    rois[:, :5] = torch.tensor([[-0.9, -0.9, 3.0, 3.0],              # at the top-left border
                                [h - 3.0, w - 4.0, h + 2.0, w + 3.0],  # beyond the bottom-right
                                [2.2, 2.2, 2.2, 2.2],                # a 1-pixel roi
                                [-5.0, -5.0, -2.0, -1.5],            # entirely out of range
                                [h - 1.0, w - 1.0, h - 0.5, w - 0.2]])  # taps collapse at the edge
    rois = rois.to(dev)
    g = torch.from_numpy(rng.normal(0, 1, (n, r, 7, 7, c)).astype(np.float32)).to(dev)
    n0 = roi_kernel.backward_launches
    got = roi_kernel.roi_align_backward_cuda(g, rois, (n, h, w, c), dtype, 7, 2)
    want = roi_align_backward(g, rois, (n, h, w, c), dtype, 7, 2)
    torch.cuda.synchronize()
    assert roi_kernel.backward_launches == n0 + 1 and got.dtype == dtype
    if dtype == torch.float32:  # atomics: float sums in another order
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    else:  # the float32 sums rounded once to bfloat16: one bf16 ulp
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=2**-7)


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
