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


def test_nms_and_iou_match_kernels_match_plain(dev):
    """One test id for the NMS and the IoU-matching kernels (each id costs
    the fast tier's budget)."""
    _nms_cases(dev)
    _iou_cases(dev)


def _nms_cases(dev):
    # N at and around the 64-candidate mask word, several row chunks, and a
    # walk whose prefetch buffers exceed 48 KB of shared memory (N >= 3000)
    for case in [(1, 1, 1, 0.5), (3, 255, 50, 0.5), (2, 257, 300, 0.3), (4, 700, 5, 0.7),
                 (2, 63, 63, 0.5), (2, 64, 64, 0.5), (2, 65, 65, 0.5),
                 (2, 3000, 3000, 0.7), (2, 4097, 4097, 0.6),
                 (1, 15000, 700, 0.7),  # rows beyond the walk's shared-memory window
                 (32, 12000, 600, 0.7)]:  # coco_resnet50's training proposals, batch 32
        _nms_case(dev, *case)
    _nms_walk_cases(dev)
    _nms_empty_and_all_masked(dev)


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


def _nms_empty_and_all_masked(dev):
    """No candidates, every candidate masked, and a score row of the wrong length."""
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


def test_roi_align_kernels_match_plain(dev):
    """One test id for the ROIAlign kernels (each id costs the fast tier's
    budget): the forward against its gather twin, the backward against the
    plain scatter, a training step reaching the trunk through both, and the
    FPN's multi-level forward and backward against their plain versions."""
    _roi_forward_cases(dev)
    _roi_backward_cases(dev)
    _roi_preset_cases(dev)
    _training_reaches_the_trunk_through_roi_align_cuda(dev)
    _multilevel_cases(dev)


def _roi_preset_cases(dev):
    """The single-scale presets' training shapes: 38x38 maps of 512 (VGG16)
    and 1024 channels (the ResNet50 C4 map), b8 and b32 x 128 rois (edge
    cases included), float32 and bfloat16: the forward bitwise its gather
    twin (and its bfloat16 store), the backward from float32 and bfloat16
    gradients within tolerance of the plain scatter, bitwise across two
    launches."""
    from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import roi_align_cuda
    from replication_faster_rcnn_tpu_torch.ops.roi_ops import roi_align

    for n, c in ((8, 512), (8, 1024), (32, 1024)):
        rng = np.random.default_rng(n + c)
        rois = _roi_bwd_rois(rng, n, 128, 38, 38).to(dev)
        feat32 = torch.from_numpy(rng.normal(0, 1, (n, 38, 38, c)).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.normal(0, 1, (n, 128, 7, 7, c)).astype(np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            feat = feat32.to(dtype)
            want = roi_align(feat, rois, 7, 2, method="gather")
            assert torch.equal(roi_align_cuda(feat, rois, 7, 2), want)
            got16 = roi_align_cuda(feat, rois, 7, 2, out_dtype=torch.bfloat16)
            assert torch.equal(got16, want.to(torch.bfloat16))
            del want, got16
            for grad_dtype in (torch.float32, torch.bfloat16):
                _roi_bwd_check(dev, g.to(grad_dtype), rois, (n, 38, 38, c), dtype, 7, 2)
        del feat32, g
        torch.cuda.empty_cache()


def _roi_forward_cases(dev):
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


def test_roi_pool_kernels_match_plain(dev):
    # C not a multiple of 8 (the scalar path), multiples (16-byte vectors,
    # whole 64-channel tiles or a partial last one), maps 11, 38 and 70
    # wide, out 1, 5 and 7, N = 1 and 2, float32 and bfloat16 features and
    # gradients; then ties, NaN and +-inf, a misaligned base, no rois,
    # autograd, and the shapes the backward refuses
    for dtype in (torch.float32, torch.bfloat16):
        for c, out, scale, hw, n in [(3, 7, 1.0, (13, 11), 2), (12, 5, 0.5, (13, 11), 1),
                                     (130, 5, 0.5, (38, 38), 2), (64, 1, 0.25, (13, 11), 2),
                                     (256, 7, 1.0 / 16, (38, 38), 2), (256, 5, 1.0, (38, 38), 1),
                                     (264, 7, 1.0, (20, 70), 1)]:
            _pool_case(dev, dtype, c, out, scale, n=n, hw=hw)
        # the presets' training shapes: VGG16's 512 and ResNet50's 1024
        # channels at 38x38, b8 x 128 rois
        for c in (512, 1024):
            _pool_case(dev, dtype, c, 7, 1.0 / 16, n=8, r=128, hw=(38, 38))
            torch.cuda.empty_cache()
    _pool_edge_cases(dev)


def _pool_rois(rng, n, r, h, w, scale):
    """Random rois with the edge cases (in image coordinates: / scale)."""
    rois = _boxes(rng, (n, r), float(max(h, w)))
    rois[:, :7] = torch.tensor([[-0.9, -0.9, 3.0, 3.0],              # at the top-left border
                                [h - 3.0, w - 4.0, h + 2.0, w + 3.0],  # beyond the bottom-right
                                [2.2, 2.2, 2.2, 2.2],                # one pixel
                                [-5.0, -5.0, -2.0, -1.5],            # entirely out of the map
                                [2.5, 3.5, 4.5, 5.5],                # corners at .5: half to even
                                [float("nan"), 1.0, 6.0, 7.0],       # a diverged proposal
                                [-3.0, -3.0, h + 3.0, w + 3.0]])     # the whole map
    rois[:, 8:12] = rois[:, 7:8]  # identical rois
    return rois / scale


def _pool_case(dev, dtype, c, out, scale, feat=None, n=2, r=37, hw=(13, 11)):
    """Forward bitwise against the plain version; the backward (from
    float32 and bfloat16 gradients) bitwise across two launches, finite,
    and against the plain VJP on float32 copies where that is finite:
    float32 within atol 1e-5 / rtol 1e-6, bfloat16 within one bfloat16 ulp
    of the plain gradient rounded once or atol 1e-5 (chip_smoke's
    ROI_POOL_BWD)."""
    from replication_faster_rcnn_tpu_torch.ops.cuda import roi_kernel
    from replication_faster_rcnn_tpu_torch.ops.roi_ops import roi_pool, roi_pool_backward

    rng = np.random.default_rng(c + out)
    h, w = hw if feat is None else feat.shape[1:3]
    if feat is None:
        feat = torch.from_numpy(rng.normal(0, 1, (n, h, w, c)).astype(np.float32))
    feat = feat.to(dev, dtype)
    rois = _pool_rois(rng, feat.shape[0], r, h, w, scale).to(dev)
    n0 = roi_kernel.pool_launches
    got = roi_kernel.roi_pool_cuda(feat, rois, out, scale)
    assert roi_kernel.pool_launches == n0 + 1 and got.dtype == dtype
    assert torch.equal(got, roi_pool(feat, rois, out, scale))
    frois = (rois * scale).contiguous()
    g = torch.from_numpy(rng.normal(0, 1, tuple(got.shape)).astype(np.float32)).to(dev)
    want = roi_pool_backward(g, feat.float(), frois, out)
    fin = torch.isfinite(want)
    for gd in (torch.float32, torch.bfloat16):
        b0 = roi_kernel.pool_backward_launches
        k = roi_kernel.roi_pool_backward_cuda(g.to(gd), feat, frois, out)
        again = roi_kernel.roi_pool_backward_cuda(g.to(gd), feat, frois, out)
        torch.cuda.synchronize()
        assert roi_kernel.pool_backward_launches == b0 + 2 and k.dtype == dtype
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        assert torch.equal(k.view(bits), again.view(bits)) and torch.isfinite(k).all()
        p = (want if gd == torch.float32 else
             roi_pool_backward(g.to(gd), feat.float(), frois, out))
        if dtype == torch.float32:
            torch.testing.assert_close(k[fin], p[fin], atol=1e-5, rtol=1e-6)
        else:
            ref = p[fin].to(torch.bfloat16).float()
            _, e = torch.frexp(ref)
            ulp = torch.where(ref != 0, torch.ldexp(torch.ones_like(ref), e - 8),
                              torch.zeros_like(ref))
            assert ((k[fin].float() - ref).abs() <= torch.clamp(ulp, min=1e-5)).all()


def _pool_edge_cases(dev):
    """Integer-valued features (exact ties), NaN and +-inf in the map, a
    feature base one element off 16-byte alignment (the scalar path), N = 1,
    R = 0, rois that need no gradient through autograd, 128 identical rois
    per image, and the shapes the backward refuses (a map too wide for its
    shared-memory row, more rows than its uint8 tie count)."""
    from replication_faster_rcnn_tpu_torch.ops.cuda import roi_kernel
    from replication_faster_rcnn_tpu_torch.ops.roi_ops import roi_pool

    rng = np.random.default_rng(41)
    ties = torch.from_numpy(rng.integers(-2, 3, (2, 13, 11, 16)).astype(np.float32))
    bad = torch.from_numpy(rng.normal(0, 1, (2, 13, 11, 16)).astype(np.float32))
    bad[0, 3, 4, 1], bad[0, 7, 2, 3], bad[1, 5, 5, 0] = float("nan"), float("inf"), -float("inf")
    bad[1, 0, :, 2] = -float("inf")
    for dtype in (torch.float32, torch.bfloat16):
        _pool_case(dev, dtype, 16, 7, 0.5, feat=ties)
        _pool_case(dev, dtype, 16, 7, 0.5, feat=bad)
        flat = torch.from_numpy(rng.normal(0, 1, 13 * 11 * 64 + 1).astype(np.float32))
        _pool_case(dev, dtype, 64, 7, 1.0, feat=flat[1:].view(1, 13, 11, 64), n=1)
        empty = roi_kernel.roi_pool_cuda(ties.to(dev, dtype), torch.zeros(2, 0, 4, device=dev))
        assert empty.shape == (2, 0, 7, 7, 16) and empty.dtype == dtype
        zero = roi_kernel.roi_pool_backward_cuda(torch.zeros(2, 0, 7, 7, 16, device=dev),
                                                 ties.to(dev, dtype), torch.zeros(2, 0, 4,
                                                                                  device=dev), 7)
        assert zero.shape == (2, 13, 11, 16) and not zero.any()
    # through autograd: the Function's backward is the backward kernel
    feat = torch.from_numpy(rng.normal(0, 1, (2, 38, 38, 256)).astype(np.float32)).to(dev)
    same = torch.tensor([5.3, 7.1, 30.2, 33.9], device=dev).expand(2, 128, 4).contiguous()
    leaf = feat.to(torch.bfloat16).requires_grad_(True)
    b0 = roi_kernel.pool_backward_launches
    out = roi_kernel.roi_pool_cuda(leaf, same, 7)
    g = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    out.backward(g.to(out.dtype))
    assert roi_kernel.pool_backward_launches == b0 + 1
    direct = roi_kernel.roi_pool_backward_cuda(g.to(torch.bfloat16), leaf.detach(), same, 7)
    assert torch.equal(leaf.grad, direct)
    with pytest.raises(ValueError):
        roi_kernel.roi_pool_cuda(leaf, same.clone().requires_grad_(True), 7)
    # the forward takes any width; the gather keeps a [W, 64] row twice in shared memory
    wide = torch.from_numpy(rng.normal(0, 1, (1, 2, 8000, 8)).astype(np.float32)).to(dev)
    box = torch.tensor([[[0.0, 0.0, 1.0, 7999.0]]], device=dev)
    assert torch.equal(roi_kernel.roi_pool_cuda(wide, box, 7), roi_pool(wide, box, 7))
    with pytest.raises(ValueError, match="too wide"):
        roi_kernel.roi_pool_backward_cuda(torch.zeros(1, 1, 7, 7, 8, device=dev), wide, box, 7)
    tall = torch.zeros(1, 256, 2, 8, device=dev)
    with pytest.raises(ValueError, match="255 rows"):
        roi_kernel.roi_pool_backward_cuda(torch.zeros(1, 1, 7, 7, 8, device=dev), tall, box, 7)


# ------------------------------------------------------------- IoU matching


def _iou_cases(dev):
    for case in [(2, 257, 5, False, "random"),       # M not a multiple of the 256-row block
                 (3, 1000, 1, True, "random"),       # G = 1
                 (2, 300, 4, False, "all_padded"),   # every gt column padded
                 (2, 700, 6, True, "ties"),          # exact ties between rows in different blocks
                 (8, 12996, 32, True, "random"),     # the anchor site
                 (8, 632, 32, False, "random"),      # the proposal site
                 (2, 300, 33, True, "random"),       # lane chunks: 32 + 1 columns
                 (2, 1000, 64, False, "random"),     # two full chunks
                 (3, 520, 100, True, "random"),      # four chunks, the last one ragged
                 (2, 300, 600, False, "random"),     # > 48 KB of dynamic shared memory
                 (2, 1, 7, False, "random"),         # M = 1
                 (2, 32, 9, True, "random"),         # one full warp tile
                 (2, 33, 9, False, "random"),        # a warp tile and one row
                 (2, 256, 40, True, "random"),       # one full block
                 (2, 512, 9, False, "random"),       # two full blocks
                 (2, 800, 40, False, "lane_warp_block_ties"),
                 (2, 300, 35, True, "nonfinite"),
                 (8, 12996, 32, True, "few_gt"),     # the train step's 1-4 objects, one image none
                 (3, 700, 70, False, "few_gt"),      # unpadded columns spread over three chunks
                 (32, 12996, 100, True, "random"),   # coco_resnet50's anchor site: 100 gt slots
                 (32, 700, 100, False, "random"),    # and its proposal site, batch 32
                 (8, 17328, 100, True, "few_gt")]:   # coco_vgg16's 12 anchors a cell
        _iou_case(dev, *case)


def _iou_case(dev, b, m, g, shared, case):
    """All four outputs bitwise equal to the plain version with and without
    the column argmax and the IoU matrix, two launches bitwise equal, one
    counted launch per call (the wrapper's count; ``chip_smoke.py`` [6]
    counts the kernel's activities in the profiler)."""
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
    if case == "lane_warp_block_ties":
        # gt 3 repeated in lanes 9 and 37 (the second chunk): the row goes to
        # column 3; IoU 1 with gt 3 at rows in three warps of block 0 and in
        # blocks 1 and 3: the column goes to row 40
        for col in (9, 37):
            gt[:, col] = gt[:, 3]
        mask[:, [3, 9, 37]] = True
        for row in (40, 70, 200, 300, 799):
            boxes[:, row] = gt[:, 3].to(dev)
    if case == "few_gt":
        mask[:] = False
        for i in range(1, b):
            mask[i, rng.choice(g, size=1 + i % 4, replace=False)] = True
    if case == "nonfinite":
        nan, inf = float("nan"), float("inf")
        boxes[0, :6] = torch.tensor([[nan, 1, 50, 50], [0, 0, inf, 50], [-inf, 0, inf, 50],
                                     [nan, nan, nan, nan], [inf, inf, inf, inf],
                                     [0, 0, 1e30, 1e30]], device=dev)
        gt[0, 1] = torch.tensor([0, 0, inf, nan])
        gt[1, 2] = torch.tensor([-inf, -inf, inf, inf])
        mask[:, 1:3] = True
    gt, mask = gt.to(dev), mask.to(dev)
    want = match_boxes(boxes, gt, mask)
    for want_col in (True, False):
        for want_iou in (True, False):
            n0 = iou_kernel.launches
            got = iou_kernel.match_boxes_cuda(boxes, gt, mask, want_col, want_iou)
            again = iou_kernel.match_boxes_cuda(boxes, gt, mask, want_col, want_iou)
            torch.cuda.synchronize()
            assert iou_kernel.launches == n0 + 2
            assert (got[0] is None) != want_iou and (got[3] is None) != want_col
            for a, a2, w in zip(got, again, want):
                if a is not None:
                    assert a.dtype == w.dtype and torch.equal(a, w), (case, want_col, want_iou)
                    assert torch.equal(a, a2)
    if case == "ties":
        assert int(want[3][0, 0]) == 260
    if case == "lane_warp_block_ties":
        assert (want[3][:, 3] == 40).all() and (want[1][:, [40, 70, 200]] == 3).all()
    if case == "nonfinite":
        assert torch.isfinite(want[0]).all() and (want[0][0, :5] <= 0).all()


# ------------------------------------------------------------ ROIAlign backward


def _roi_backward_cases(dev):
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


def _training_reaches_the_trunk_through_roi_align_cuda(dev):
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
    host = collate([trainer.dataset[i] for i in range(2)])
    batch = trainer.stage_batch(host)
    model = trainer.model
    n0, b0 = roi_kernel.launches, roi_kernel.backward_launches
    total, _ = compute_losses(model, cfg, batch, trainer.state.generator)
    total.backward()
    torch.cuda.synchronize()
    assert roi_kernel.launches == n0 + 1 and roi_kernel.backward_launches == b0 + 1
    grad = model.trunk.conv1.weight.grad
    assert grad is not None and torch.isfinite(grad).all() and float(grad.abs().sum()) > 0
    assert float(model.rpn.cls.weight.grad.abs().sum()) == 0.0
    # the eager graph above holds the parameters' gradient accumulators, made
    # on the default stream: drop it before the trainer captures its step on
    # a side stream (a capture may not make the default stream wait)
    del total
    metrics = trainer.train_one_batch(host)  # device scalars: read on the host here
    assert np.isfinite(float(metrics["loss"])) and float(metrics["skipped"]) == 0.0


def _multilevel_cases(dev):
    """The FPN's multi-level ROIAlign kernels against the plain version on
    small pyramids of odd level sizes: C not a multiple of 8 (the scalar
    paths), multiples over one channel tile or two, float32 and bfloat16
    features and outputs, rois on every level and outside the image, a
    batch of one, no rois; then at the 600x600 pyramid (no side a multiple
    of the backward's 8-pixel tiles): elongated rois (about 600 x 20 and 20
    x 600 image pixels), 128 rois about one spot (more than 32 in a tile,
    none on P3-P5), R = 300 and R = 1000 at b1 (not multiples of 32), and
    s = 3 with out 5 (the generic sample loops). The forward bitwise; the
    backward twice bitwise, through autograd bitwise the direct call,
    within tolerance of the plain VJP on float32 copies
    (``chip_smoke.ROI_BWD_TOL``'s) and exactly zero on a level no roi
    lands on. First, the levels both kernels read: ``roi_levels`` on the
    card equal to the CPU's (held to the operation-by-operation JAX by
    test_torch_fpn.py) for squares of every float32 side within 4,096 ulps
    of 56, 112, 224, 448."""
    from replication_faster_rcnn_tpu_torch.models.fpn import roi_levels
    from replication_faster_rcnn_tpu_torch.ops.cuda import roi_kernel

    sides = torch.from_numpy(np.concatenate([
        (np.float32(v).view(np.int32) + np.arange(-4096, 4097, dtype=np.int32)).view(np.float32)
        for v in (56.0, 112.0, 224.0, 448.0)]))
    squares = torch.stack([torch.zeros_like(sides)] * 2 + [sides] * 2, dim=-1)
    assert torch.equal(roi_levels(squares.to(dev)).cpu(), roi_levels(squares))

    rng = np.random.default_rng(3)

    def pyramid(n, c, shapes, dtype):
        return [torch.from_numpy(rng.normal(0, 1, (n, h, w, c)).astype(np.float32))
                .to(dev).to(dtype) for h, w in shapes]

    for dtype in (torch.float32, torch.bfloat16):
        for c, n, r, shapes in [(3, 2, 37, ((20, 17), (10, 9), (5, 5), (3, 3))),
                                (16, 1, 60, ((38, 38), (19, 19), (10, 10), (5, 5))),
                                (264, 2, 25, ((13, 11), (7, 6), (4, 3), (2, 2))),
                                (8, 2, 0, ((8, 8), (4, 4), (2, 2), (1, 1)))]:
            feats = pyramid(n, c, shapes, dtype)
            p1 = rng.uniform(-50, 600, (n, r, 2))
            rois = torch.from_numpy(np.concatenate([p1, p1 + rng.uniform(0, 600, (n, r, 2))], -1)
                                    .astype(np.float32)).to(dev)
            if r:
                assert set(roi_levels(rois).reshape(-1).tolist()) == {0, 1, 2, 3}
            _multilevel_case(dev, feats, rois, (torch.float32, torch.bfloat16))
    fpn = ((150, 150), (75, 75), (38, 38), (19, 19))
    p16 = pyramid(2, 256, fpn, torch.bfloat16)
    k = 40  # long and thin rois among random ones, half wide, half tall
    y, x = rng.uniform(-20, 600, (2, k)), rng.uniform(-40, 40, (2, k))
    long_side, short_side = rng.uniform(560, 640, (2, k)), rng.uniform(12, 24, (2, k))
    wide = np.arange(k) < k // 2
    y, x = np.where(wide, y, x), np.where(wide, x, y)
    h, w = np.where(wide, short_side, long_side), np.where(wide, long_side, short_side)
    p1 = rng.uniform(0, 600, (2, 300, 2))
    rois = np.concatenate([p1, p1 + rng.uniform(8, 500, (2, 300, 2))], -1)
    rois[:, :k] = np.stack([y, x, y + h, x + w], -1)
    _multilevel_case(dev, p16, torch.from_numpy(rois.astype(np.float32)).to(dev),
                     (torch.bfloat16,))
    centre = rng.uniform(150, 450, (2, 1, 2)) + rng.normal(0, 4, (2, 128, 2))
    half = rng.uniform(30, 50, (2, 128, 2))
    dense = torch.from_numpy(np.concatenate([centre - half, centre + half], -1)
                             .astype(np.float32)).to(dev)
    assert set(roi_levels(dense).reshape(-1).tolist()) == {0}
    _multilevel_case(dev, p16, dense, (torch.bfloat16,))
    p1 = rng.uniform(0, 600, (1, 1000, 2))
    many = np.concatenate([p1, p1 + rng.uniform(8, 500, (1, 1000, 2))], -1).astype(np.float32)
    _multilevel_case(dev, [f[:1] for f in p16], torch.from_numpy(many).to(dev), (torch.bfloat16,))
    _multilevel_case(dev, pyramid(2, 16, ((20, 17), (10, 9), (5, 5), (3, 3)), torch.float32),
                     torch.from_numpy(rois[:, k:k + 60].astype(np.float32)).to(dev),
                     (torch.float32,), out_size=5, s=3)
    rois = torch.zeros(1, 4, 4, device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient to the rois"):
        roi_kernel.multilevel_roi_align_cuda([torch.zeros(1, 4, 4, 8, device=dev)] * 4, rois,
                                             64.0, 64.0)


def _multilevel_case(dev, feats, rois, out_dtypes, out_size=7, s=2):
    """One pyramid and its rois through both multi-level kernels (see
    ``_multilevel_cases``)."""
    from replication_faster_rcnn_tpu_torch.models.fpn import (
        multilevel_roi_align_plain,
        roi_levels,
    )
    from replication_faster_rcnn_tpu_torch.ops.cuda import roi_kernel

    tol = {torch.float32: dict(atol=1e-4, rtol=1e-5), torch.bfloat16: dict(atol=1e-4, rtol=2**-7)}
    dtype = feats[0].dtype
    n, r, c = rois.shape[0], rois.shape[1], feats[0].shape[-1]
    for out_dtype in out_dtypes:
        got = roi_kernel.multilevel_roi_align_cuda(feats, rois, 600.0, 600.0, out_size, s,
                                                   out_dtype)
        want = multilevel_roi_align_plain(feats, rois, 600.0, 600.0, out_size, s).to(out_dtype)
        assert got.dtype == out_dtype and torch.equal(got, want), (dtype, c, out_dtype)
    g = torch.from_numpy(np.random.default_rng(r).normal(0, 1, (n, r, out_size, out_size, c))
                         .astype(np.float32)).to(dev)
    levels = roi_levels(rois)
    shapes4 = [tuple(f.shape) for f in feats]
    a = roi_kernel.multilevel_roi_align_backward_cuda(g, rois, levels, shapes4, dtype,
                                                      600.0, 600.0, out_size, s)
    b = roi_kernel.multilevel_roi_align_backward_cuda(g, rois, levels, shapes4, dtype,
                                                      600.0, 600.0, out_size, s)
    leaves = [f.detach().clone().requires_grad_(True) for f in feats]
    out = roi_kernel.multilevel_roi_align_cuda(leaves, rois, 600.0, 600.0, out_size, s, dtype)
    via = torch.autograd.grad(out, leaves, g.to(dtype)) if r else a
    with torch.enable_grad():
        f32 = [f.detach().float().requires_grad_(True) for f in feats]
        plain = multilevel_roi_align_plain(f32, rois, 600.0, 600.0, out_size, s)
        want = torch.autograd.grad(plain, f32, g, allow_unused=True)
    counts = torch.bincount(levels.reshape(-1).long(), minlength=4).tolist()
    for li, (ga, gb, gv, gw) in enumerate(zip(a, b, via, want)):
        assert ga.dtype == dtype and torch.equal(ga, gb)
        if dtype == torch.float32:  # autograd hands the kernel float32 gradients
            assert torch.equal(ga, gv)
        if counts[li] == 0:
            assert not ga.any(), (li, counts)
        gw = torch.zeros_like(gw) if gw is None else gw
        assert torch.allclose(ga.float(), gw.to(dtype).float(), **tol[dtype]), (
            dtype, c, float((ga.float() - gw).abs().max()))


# -------------------------------------------------------------- int8 kernels


def test_int8_kernels_bitwise(dev):
    """The int8 GEMM at M around its 16-row MMA and 32-row block tiles, N
    around the 8-column MMA tile and the head's 21 and 84, and K not a
    multiple of 16 (byte-filled tiles), a multiple (cp.async copies) or
    longer than the 512 bytes staged at once (the two-stage ring), over the
    whole int8 range; every preset's head shape (K up to 4096, N up to
    324); non-contiguous operands (copied by the wrapper) and a
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
    # every preset's int8 head: K = 1024 (FPN fc7), 2048 (ResNet50 layer4),
    # 4096 (VGG16 fc7), N = 21 / 84 and 81 / 324 (three 128-column blocks),
    # b1 and b8 rois, as the head calls it (a Linear weight [N, K] seen as
    # [K, N])
    for m in (300, 2400):
        for k in (1024, 2048, 4096):
            x = int8((m, k))
            for n in (21, 81, 84, 324):
                w = int8((n, k)).t()
                got = quant_kernel.int8_matmul_cuda(x, w)
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
    _dequantize_many_cases(dev, rng, int8)


def _dequantize_many_cases(dev, rng, int8):
    """The grouped dequantize: every output bitwise equal to
    ``dequantize_plain`` of its leaf, one launch per call (none when no
    leaf has an element), over the model's 23 conv weights, mixed ranks and
    axes, a source one byte off alignment, a zero-element leaf, a single
    leaf and an empty list; a table built once (as ``build_infer_variables``
    keeps one per resident tree) serves repeated calls."""
    from replication_faster_rcnn_tpu_torch import get_config
    from replication_faster_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN
    from replication_faster_rcnn_tpu_torch.ops import quant_ops
    from replication_faster_rcnn_tpu_torch.ops.cuda import quant_kernel

    def leaf(shape, axis=0, w=None):
        w = int8(shape) if w is None else w
        scale = torch.from_numpy(rng.uniform(1e-4, 0.1, w.shape[axis]).astype(np.float32))
        return w, scale.to(dev), axis

    def check(leaves, dtype, run=None):
        n0 = quant_kernel.dequantize_launches
        got = run() if run is not None else quant_ops.dequantize_many(leaves, dtype)
        torch.cuda.synchronize()
        launched = int(any(w.numel() for w, _, _ in leaves))
        assert quant_kernel.dequantize_launches == n0 + launched
        assert len(got) == len(leaves)
        for out, (w, s, axis) in zip(got, leaves):
            want = quant_ops.dequantize_plain(w, s, axis, dtype)
            assert out.dtype == dtype and out.shape == w.shape and torch.equal(out, want)
            assert out.data_ptr() % 256 == 0 or out.numel() == 0
        return got

    model = FasterRCNN(get_config("voc12_resnet18_align"), device="meta")
    convs = [leaf(tuple(v.shape)) for v in model.state_dict().values() if v.dim() == 4]
    assert len(convs) == 23
    buf = int8((3 * 3 * 64 * 64 + 1,))
    misaligned = buf[1:].view(3, 3, 64, 64)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16
    half = buf[4:4 + 8 * 600].view(8, 600)  # 4- but not 8-byte aligned: vectors in float32 only
    assert half.data_ptr() % 8 == 4
    w = int8((3, 3, 16, 24))
    mixed = [leaf((7,)), leaf((21, 512), -1), leaf((0, 5), -1), leaf((5, 1, 1, 3)),
             leaf(None, -1, misaligned), leaf((4097,)), leaf((33, 17), 0), leaf(None, 0, half),
             leaf(None, 1, w.transpose(0, 3)), leaf((1,))]  # the last but one is copied
    for dtype in (torch.float32, torch.bfloat16):
        for leaves in (convs, mixed, mixed[:1], mixed[2:3], mixed[4:5], []):
            check(leaves, dtype)
        table = quant_kernel.DequantizeTable(convs, dtype)
        first = check(convs, dtype, table)
        second = check(convs, dtype, table)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        assert first[0].data_ptr() != second[0].data_ptr()  # a fresh arena per call
        with ops_reference():
            n0 = quant_kernel.dequantize_launches
            check_plain = quant_ops.dequantize_many(convs, dtype)
            assert quant_kernel.dequantize_launches == n0
            assert all(torch.equal(a, b) for a, b in zip(check_plain, first))
    with pytest.raises(TypeError):
        quant_ops.dequantize_many(convs, torch.float16)
    # the int8 flush's reconstruction: one launch per call through the table
    # that the first call builds and keeps with the tree
    from replication_faster_rcnn_tpu_torch.quant import build_infer_variables

    keys = [f"conv{i}.weight" for i in range(len(convs))]
    qvars = {"params": {k: w for k, (w, _, _) in zip(keys, convs)},
             "qscales": {k: s for k, (_, s, _) in zip(keys, convs)}}
    tables = []
    for _ in range(2):
        n0 = quant_kernel.dequantize_launches
        got = build_infer_variables(qvars, compute_dtype=torch.bfloat16)["params"]
        torch.cuda.synchronize()
        assert quant_kernel.dequantize_launches == n0 + 1
        tables.append(qvars["dequantize_tables"][torch.bfloat16])
        for k, (w, s, _) in zip(keys, convs):
            assert torch.equal(got[k], quant_ops.dequantize_plain(w, s, 0, torch.bfloat16))
    assert tables[0] is tables[1] and list(qvars["dequantize_tables"]) == [torch.bfloat16]


def ops_reference():
    from replication_faster_rcnn_tpu_torch import ops

    return ops.reference_scope()


# -------------------------------------------------------------- image kernels


def test_image_kernels_match_plain(dev):
    """The data path's resize and image pass bitwise their plain versions
    (the image pass fed the plain fills, so float32 is bitwise too) at odd
    and non-square sizes, one-axis resizes, strong downsampling, uint8 rows
    whose byte length is not a multiple of 4 or 16, a cache gather whose
    idx repeats an image, rows translated to the edge (|dy| = h - 1, |dx| =
    w - 1) and past it; every flipped row against ``torch.flip`` and the
    identity gather against ``torch.index_select``; one launch per call. The
    geometry and the prepare kernel (geometry + fills in one launch) against
    ``augment_prepare_plain``: odd h and w, w not a multiple of 16, n = 1 and
    n = 5, G = 0 and G = 100, translations at and past the edge (an empty
    window), the cache's rows by an idx that repeats one: geometry, boxes,
    labels and masks bitwise, uint8 fills bitwise, float32 fills within 1
    ulp and bitwise across launches; the fills alone bitwise the prepare
    launch's."""
    _resize_cases(dev)
    _image_pass_cases(dev)
    _prepare_cases(dev)


def _resize_cases(dev):
    from replication_faster_rcnn_tpu_torch.ops import image as image_ops
    from replication_faster_rcnn_tpu_torch.ops.cuda import image_kernel

    rng = np.random.default_rng(17)
    for n, (ih, iw), (h, w) in [(3, (375, 500), (301, 433)), (2, (600, 600), (600, 480)),
                                (2, (600, 600), (480, 600)), (2, (600, 600), (240, 240)),
                                (2, (600, 600), (720, 720)), (1, (37, 41), (53, 19)),
                                (3, (301, 433), (375, 500))]:
        for dtype in ("uint8", "float32"):
            if dtype == "uint8":
                images = torch.from_numpy(rng.integers(0, 256, (n, ih, iw, 3), dtype=np.uint8))
            else:
                images = torch.from_numpy(rng.normal(0, 50, (n, ih, iw, 3)).astype(np.float32))
            images = images.to(dev)
            boxes = _boxes(rng, (n, 7), float(min(ih, iw))).to(dev)
            n0 = image_kernel.resize_launches
            got, got_boxes = image_kernel.resize_aa_cuda(images, boxes, (h, w))
            torch.cuda.synchronize()
            assert image_kernel.resize_launches == n0 + 1
            with ops_reference():
                want, want_boxes = image_ops.resize_batch_with_boxes(images, boxes, (h, w))
            assert got.dtype == want.dtype and torch.equal(got, want), (ih, iw, h, w, dtype)
            assert torch.equal(got_boxes, want_boxes), (ih, iw, h, w, dtype)


def _image_pass_cases(dev):
    from replication_faster_rcnn_tpu_torch.ops import image as image_ops
    from replication_faster_rcnn_tpu_torch.ops.cuda import image_kernel as k

    rng = np.random.default_rng(19)
    dev = torch.empty(0, device=dev).device  # with its index, as the wrappers compare

    def held(images, geom, idx=None, use_fills=True):
        batch = images[idx.long()] if idx is not None else images
        with ops_reference():
            want = image_ops.augment_images_plain(batch, geom)
            fills = image_ops.image_fills_plain(batch, geom).contiguous()
        n0 = k.image_launches
        got = k.augment_image_cuda(images, geom, fills if use_fills else None, idx)
        torch.cuda.synchronize()
        assert k.image_launches == n0 + 1
        assert got.dtype == want.dtype and torch.equal(got, want), (
            tuple(images.shape), geom.tolist(), float((got.float() - want.float()).abs().max()))
        return got

    for (h, w), dtype in [((375, 433), "uint8"), ((600, 600), "uint8"), ((41, 37), "uint8"),
                          ((375, 433), "float32"), ((600, 600), "float32")]:
        m = 5
        if dtype == "uint8":
            cache = torch.from_numpy(rng.integers(0, 256, (m, h, w, 3), dtype=np.uint8)).to(dev)
        else:
            cache = torch.from_numpy(rng.normal(0, 50, (m, h, w, 3)).astype(np.float32)).to(dev)
        n = 4
        images = cache[:n].contiguous()
        flip = torch.tensor([True, False, True, True], device=dev)
        shifts = torch.tensor([[h - 1, 0], [-(h - 1), w - 1], [3, -(w - 1)], [h + 2, -w - 5]],
                              dtype=torch.int32, device=dev)
        jitter = torch.tensor([[h, w, 0, 0], [h * 3 // 4, w * 5 // 4, -7, 11],
                               [h * 5 // 4, w * 3 // 4, h // 3, -(w // 4)], [1, 2, 0, -1]],
                              dtype=torch.int32, device=dev)
        for kw in (dict(flip=flip), dict(shifts=shifts), dict(jitter=jitter),
                   dict(flip=flip, shifts=shifts, jitter=jitter)):
            *_, geom, _ = k.augment_geometry_cuda(None, None, None, n, h, w, device=dev,
                                                  resample="all", **kw)
            held(images, geom)
        aug = torch.from_numpy(np.stack([rng.integers(0, 5011, n), rng.integers(0, 50, n)],
                                        -1).astype(np.int32)).to(dev)
        *_, geom, _ = k.augment_geometry_cuda(None, None, None, n, h, w, aug=aug, seed=5,
                                              hflip=True, scale_range=(0.75, 1.25),
                                              translate=0.1, resample="all")
        held(images, geom)
        # the cache gather, idx repeating an image
        idx = torch.tensor([2, 0, 2, 4], dtype=torch.int32, device=dev)
        *_, geom, _ = k.augment_geometry_cuda(None, None, None, n, h, w, idx=idx, flip=flip,
                                              jitter=jitter, resample="all", device=dev)
        held(cache, geom, idx)
        # every row flipped; the identity gather
        *_, geom, _ = k.augment_geometry_cuda(None, None, None, n, h, w, device=dev,
                                              flip=torch.ones(n, dtype=torch.bool, device=dev))
        assert torch.equal(held(images, geom, use_fills=False), torch.flip(images, [2]))
        *_, geom, _ = k.augment_geometry_cuda(None, None, None, n, h, w, idx=idx, device=dev)
        assert torch.equal(held(cache, geom, idx, use_fills=False),
                           torch.index_select(cache, 0, idx.long()))


def _prepare_cases(dev):
    from replication_faster_rcnn_tpu_torch.ops import image as image_ops
    from replication_faster_rcnn_tpu_torch.ops.cuda import image_kernel as k

    rng = np.random.default_rng(23)
    dev = torch.empty(0, device=dev).device

    def decisions(kind, n, h, w, rows):
        if kind == "aug":
            aug = np.stack([rng.integers(0, 5011, n), rng.integers(0, 50, n)], -1)
            return dict(aug=torch.from_numpy(aug.astype(np.int32)).to(dev), seed=7, hflip=True,
                        scale_range=(0.5, 1.5), translate=0.2)
        edge = [[h - 1, 0], [-(h - 1), w - 1], [h + 2, -w - 5], [3, -(w - 1)], [0, w]]
        shifts = torch.tensor([edge[i % 5] for i in range(n)], dtype=torch.int32, device=dev)
        jitter = torch.tensor([[h, w, 0, 0], [h * 3 // 4 + 1, w * 5 // 4, -7, 11],
                               [h * 5 // 4, w * 3 // 4, h // 3, -(w // 4)], [1, 2, 0, -1],
                               [h // 2 + 1, w, 0, 0]][:n], dtype=torch.int32, device=dev)
        flip = torch.from_numpy(rng.uniform(size=n) < 0.5).to(dev)
        if kind == "host":
            return dict(flip=flip, shifts=shifts, jitter=jitter)
        idx = torch.from_numpy(rng.integers(0, rows, n).astype(np.int32)).to(dev)
        idx[-1] = idx[0]
        return dict(idx=idx, flip=flip, jitter=jitter, resample="all")

    for (h, w), dtype, n, g in [((375, 433), "uint8", 5, 32), ((41, 37), "uint8", 1, 100),
                                ((600, 600), "uint8", 5, 0), ((37, 41), "float32", 5, 100),
                                ((375, 433), "float32", 1, 32), ((600, 600), "float32", 5, 0)]:
        for kind in ("aug", "host", "cache"):
            rows = 7 if kind == "cache" else n
            if dtype == "uint8":
                images = torch.from_numpy(rng.integers(0, 256, (rows, h, w, 3), dtype=np.uint8))
            else:
                images = torch.from_numpy(rng.normal(0, 50, (rows, h, w, 3)).astype(np.float32))
            images = images.to(dev)
            boxes = _boxes(rng, (rows, g), float(min(h, w))).to(dev)
            labels = torch.from_numpy(rng.integers(-1, 20, (rows, g)).astype(np.int32)).to(dev)
            mask = labels >= 0
            kw = decisions(kind, n, h, w, rows)
            with ops_reference():
                want = image_ops.augment_prepare_plain(images, boxes, labels, mask, **kw)
            n0, g0 = k.prepare_launches, k.geometry_launches
            got = k.augment_prepare_cuda(images, boxes, labels, mask, **kw)
            again = k.augment_prepare_cuda(images, boxes, labels, mask, **kw)
            alone = k.augment_geometry_cuda(boxes, labels, mask, n, h, w, device=dev, **kw)
            torch.cuda.synchronize()
            assert k.prepare_launches == n0 + 2 and k.geometry_launches == g0 + 1
            case = (h, w, dtype, n, g, kind)
            for i, what in enumerate(("boxes", "labels", "mask", "geom")):
                if g or what == "geom":
                    assert torch.equal(got[i], want[i]), (what,) + case
                    assert torch.equal(alone[i], want[i]), ("geometry kernel", what) + case
            fills, plain = got[4], want[4]
            if dtype == "uint8":
                assert torch.equal(fills, plain), case
            else:
                ulp = torch.from_numpy(np.spacing(plain.abs().cpu().numpy())).to(dev)
                assert bool(((fills - plain).abs() <= ulp).all()), case
            assert torch.equal(again[4].view(torch.int32), fills.view(torch.int32)), case
            f0 = k.fill_launches
            only = k.image_fill_cuda(images, got[3], kw.get("idx"))
            torch.cuda.synchronize()
            assert k.fill_launches == f0 + 1
            assert torch.equal(only.view(torch.int32), fills.view(torch.int32)), case
