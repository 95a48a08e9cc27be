"""Parity of the PyTorch port's IoU matching, sampling, target assignment and
ROIAlign backward with the JAX package at a small size, on the CPU.

Inputs are made with numpy from a seed. The JAX functions run eagerly (op by
op, strict IEEE float32: jitted XLA:CPU may contract products into FMAs).
The JAX side draws its sampling uniforms with threefry, which PyTorch cannot
reproduce, so each test computes the same uniforms in JAX from the same keys
and injects them into the port. Tolerances, with their reasons:

* IoU matching (all four outputs), sampling masks, pack order, labels and
  sampled rois: bitwise.
* Regression targets: within 2 ulps — ``log`` in ``encode`` rounds
  differently in PyTorch and XLA (observed: 1 ulp).
* ROIAlign backward against ``jax.vjp`` of the einsum formulation: atol
  1e-5 / rtol 1e-5 in float32 (the two sum the same products in different
  orders); in bfloat16, 1 bfloat16 ulp (rtol 2**-7) of the float32 sum
  rounded once.
"""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from replication_faster_rcnn_tpu.config import AnchorConfig as JAnchorConfig
from replication_faster_rcnn_tpu.config import ROITargetConfig as JROITargetConfig
from replication_faster_rcnn_tpu.config import RPNTargetConfig as JRPNTargetConfig
from replication_faster_rcnn_tpu.ops import anchors as j_anchors
from replication_faster_rcnn_tpu.ops import boxes as j_boxes
from replication_faster_rcnn_tpu.ops import roi_ops as j_roi
from replication_faster_rcnn_tpu.targets import sampling as j_sampling
from replication_faster_rcnn_tpu_torch import ops
from replication_faster_rcnn_tpu_torch.config import ROITargetConfig, RPNTargetConfig
from replication_faster_rcnn_tpu_torch.ops import iou_match
from replication_faster_rcnn_tpu_torch.ops import roi_ops as t_roi
from replication_faster_rcnn_tpu_torch.ops.cuda.iou_kernel import match_boxes_cuda
from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import roi_align_cuda
from replication_faster_rcnn_tpu_torch.targets import (
    anchor_targets,
    batched_anchor_targets,
    batched_proposal_targets,
    pack_by_priority,
    proposal_targets,
    random_subset_mask,
    topk_subset_mask,
)

# the JAX package's targets/__init__ re-exports functions under the module names
j_anchor_targets = importlib.import_module("replication_faster_rcnn_tpu.targets.anchor_targets")
j_proposal_targets = importlib.import_module("replication_faster_rcnn_tpu.targets.proposal_targets")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def rand_boxes(rng, shape, size=80.0, min_wh=4.0, max_wh=40.0):
    p1 = rng.uniform(0, size, shape + (2,))
    wh = rng.uniform(min_wh, max_wh, shape + (2,))
    return np.concatenate([p1, p1 + wh], axis=-1).astype(np.float32)


def padded_gt(rng, n, g, counts):
    """gt [n, g, 4] padded with -1 boxes, labels [n, g], mask [n, g]."""
    boxes = np.full((n, g, 4), -1.0, np.float32)
    labels = np.full((n, g), -1, np.int32)
    for i, k in enumerate(counts):
        boxes[i, :k] = rand_boxes(rng, (k,), 60.0, 8.0, 40.0)
        labels[i, :k] = rng.integers(1, 21, k)
    return boxes, labels, labels >= 0


def jax_match(boxes, gt, mask):
    """The jnp matching of targets/anchor_targets.py:67-75, eagerly."""
    ious = j_boxes.iou(jnp.asarray(boxes), jnp.asarray(gt))
    ious = jnp.where(jnp.asarray(mask)[None, :], ious, -1.0)
    return (np.asarray(ious), np.asarray(jnp.argmax(ious, axis=1)),
            np.asarray(jnp.max(jnp.maximum(ious, 0.0), axis=1)),
            np.asarray(jnp.argmax(ious, axis=0)))


# ------------------------------------------------------------ IoU matching


def _match_case(name):
    rng = np.random.default_rng(len(name))
    n, m, g = 3, 57, 5
    boxes = rand_boxes(rng, (n, m))
    gt, _, mask = padded_gt(rng, n, g, [5, 3, 2])
    if name == "no_gt":
        mask[1] = False
    elif name == "all_padded":
        mask[:] = False
    elif name == "ties":
        # equal IoUs across rows (duplicate boxes) and across columns
        boxes[:, 10] = boxes[:, 3]
        boxes[:, 40] = boxes[:, 3]
        gt[:, 1] = gt[:, 0]
        boxes[:, 20] = gt[:, 2]
        boxes[:, 21] = gt[:, 2]
    elif name == "g1":
        gt, mask = gt[:, :1], mask[:, :1]
        mask[:] = True
    elif name == "zero_area":
        boxes[:, :6] = np.array([5, 5, 5, 9], np.float32)
        gt[0, 0] = np.array([5, 5, 5, 9], np.float32)
    return boxes, gt, mask


def test_match_boxes_bitwise():
    # one test id walks the cases (each test id costs the fast tier's budget)
    for case in ("random", "no_gt", "all_padded", "ties", "g1", "zero_area"):
        _assert_match_case(case)


def _assert_match_case(case):
    boxes, gt, mask = _match_case(case)
    for shared in (False, True):  # per-image boxes, and one set for every image
        b = boxes[:1] if shared else boxes
        ious, argmax, max_iou, col = iou_match.match_boxes(t(b), t(gt), t(mask))
        for i in range(gt.shape[0]):
            want = jax_match(b[0 if shared else i], gt[i], mask[i])
            for got, w in zip((ious[i], argmax[i], max_iou[i], col[i]), want):
                np.testing.assert_array_equal(got.numpy(), w)
        # the kernel wrapper and the dispatch run the same plain version here
        k_ious, k_argmax, k_max, k_col = match_boxes_cuda(t(b), t(gt), t(mask))
        assert all(torch.equal(x, y) for x, y in
                   zip((k_ious, k_argmax, k_max, k_col), (ious, argmax, max_iou, col)))
        a_argmax, a_max, a_col = iou_match.match_boxes_auto(t(b), t(gt), t(mask), want_col=False)
        assert a_col is None and torch.equal(a_argmax, argmax) and torch.equal(a_max, max_iou)
        assert argmax.dtype == col.dtype == torch.int64
        if case == "ties" and not shared:
            assert mask[:2, 2].all() and not mask[2, 2]
            # rows 20 and 21 tie exactly (IoU 1); the first wins. A padded column is 0.
            np.testing.assert_array_equal(col.numpy()[:, 2], [20, 20, 0])
            assert not (argmax.numpy() == 1).any()  # gt 1 == gt 0: column 0 always wins


# ---------------------------------------------------------------- sampling


def _uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape))


def test_random_subset_mask_bitwise():
    for k, k_max in [(0, None), (3, None), (7, 10), (40, 64), (10, 10)]:
        rng = np.random.default_rng(k)
        member = rng.uniform(size=(4, 50)) > 0.4
        member[3] = False
        keys = jax.random.split(jax.random.PRNGKey(k), 4)
        u = np.stack([_uniform(key, (50,)) for key in keys])
        got = random_subset_mask(t(u), t(member), k, k_max=k_max).numpy()
        for i in range(4):
            want = np.asarray(
                j_sampling.random_subset_mask(keys[i], jnp.asarray(member[i]), k, k_max))
            np.testing.assert_array_equal(got[i], want, err_msg=f"k={k} k_max={k_max}")
        assert (got.sum(1) == np.minimum(k, member.sum(1))).all()

    # a per-row budget, and the deterministic top-k variant with ties at the cut
    rng = np.random.default_rng(5)
    member = rng.uniform(size=(3, 40)) > 0.3
    score = rng.integers(0, 6, (3, 40)).astype(np.float32) / 5  # ties at the cut
    budget = np.array([0, 4, 31])
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    u = np.stack([_uniform(key, (40,)) for key in keys])
    got_r = random_subset_mask(t(u), t(member), t(budget), k_max=32).numpy()
    got_t = topk_subset_mask(t(member), t(score), t(budget), k_max=32).numpy()
    for i in range(3):
        kk = jnp.asarray(budget[i], jnp.int32)
        np.testing.assert_array_equal(got_r[i], np.asarray(
            j_sampling.random_subset_mask(keys[i], jnp.asarray(member[i]), kk, 32)))
        np.testing.assert_array_equal(got_t[i], np.asarray(
            j_sampling.topk_subset_mask(jnp.asarray(member[i]), jnp.asarray(score[i]), kk, 32)))
    with pytest.raises(ValueError, match="exceeds"):
        random_subset_mask(t(u), t(member), 33, k_max=32)


def test_pack_by_priority_bitwise():
    rng = np.random.default_rng(6)
    priority = rng.integers(0, 3, (3, 64))
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    u = np.stack([_uniform(key, (64,)) for key in keys])
    u[0, :5] = np.float32(1.0) - np.float32(2**-24)  # priority + u rounds up to the next integer
    got = pack_by_priority(t(u), t(priority), 20).numpy()
    for i in range(3):
        key = jnp.asarray(priority[i]).astype(jnp.float32) + jnp.asarray(u[i])
        want = np.asarray(jnp.argsort(key))[:20]
        np.testing.assert_array_equal(got[i], want)
    want_1 = np.asarray(j_sampling.pack_by_priority(keys[1], jnp.asarray(priority[1]), 20))
    np.testing.assert_array_equal(got[1], want_1)


# ------------------------------------------------------------------ targets


def _anchor_draws(keys, a):
    pos, neg = [], []
    for key in keys:
        kp, kn = jax.random.split(key)
        pos.append(_uniform(kp, (a,)))
        neg.append(_uniform(kn, (a,)))
    return np.stack(pos), np.stack(neg)


def _assert_reg_close(got, want):
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


def _anchor_targets_case(n_sample):
    rng = np.random.default_rng(n_sample)
    anchors = j_anchors.make_anchors(JAnchorConfig(), (6, 6))  # 324 anchors, 96x96
    gt, _, mask = padded_gt(rng, 4, 4, [4, 2, 0, 3])
    gt[0, 1] = gt[0, 0]  # two gts share their best anchor: the later one wins
    gt[3, 2] = np.array([0, 0, 96, 96], np.float32)
    cfg = RPNTargetConfig(n_sample=n_sample)
    jcfg = JRPNTargetConfig(n_sample=n_sample)
    keys = jax.random.split(jax.random.PRNGKey(n_sample), 4)
    u_pos, u_neg = _anchor_draws(keys, anchors.shape[0])
    reg, labels = batched_anchor_targets(t(gt), t(mask), t(anchors), cfg, t(u_pos), t(u_neg))
    for i in range(4):
        w_reg, w_lab = j_anchor_targets.anchor_targets(
            keys[i], jnp.asarray(gt[i]), jnp.asarray(mask[i]), jnp.asarray(anchors), jcfg)
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(w_lab))
        _assert_reg_close(reg[i].numpy(), np.asarray(w_reg))
    one = anchor_targets(t(gt[3]), t(mask[3]), t(anchors), cfg, t(u_pos[3]), t(u_neg[3]))
    assert torch.equal(one[0], reg[3]) and torch.equal(one[1], labels[3])
    lab = labels.numpy()
    assert (lab[2] != 1).all() and (reg[2] == 0).all()  # no gt: no positives, zero targets
    assert ((lab == 1).sum(1) <= n_sample // 2).all() and ((lab >= 0).sum(1) <= n_sample).all()
    assert (lab == 1).sum() > 0 and (lab == 0).sum() > 0


def test_anchor_targets_bitwise():
    for n_sample in (64, 256):
        _anchor_targets_case(n_sample)


def _proposal_targets_case(strategy):
    rng = np.random.default_rng(7)
    n, r, g = 3, 40, 4
    gt, labels, mask = padded_gt(rng, n, g, [3, 1, 0])
    rois = rand_boxes(rng, (n, r), 60.0, 8.0, 40.0)
    rois[:, :6] = gt[:, :1] + rng.normal(0, 2, (n, 6, 4)).astype(np.float32)  # positives
    valid = rng.uniform(size=(n, r)) > 0.2
    cfg = ROITargetConfig(n_sample=16)
    jcfg = JROITargetConfig(n_sample=16)
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    draws = []
    for key in keys:
        draws.append([_uniform(k, (r + g,)) for k in jax.random.split(key, 3)])
    u_pos, u_neg, u_pack = (np.stack(d) for d in zip(*draws))
    got = batched_proposal_targets(t(rois), t(valid), t(gt), t(labels), t(mask), cfg,
                                   t(u_pos), t(u_neg), t(u_pack), strategy)
    for i in range(n):
        want = j_proposal_targets.proposal_targets(
            keys[i], *(jnp.asarray(x[i]) for x in (rois, valid, gt, labels, mask)), jcfg,
            strategy=strategy)
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        _assert_reg_close(got[1][i].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
    one = proposal_targets(*(t(x[1]) for x in (rois, valid, gt, labels, mask)), cfg,
                           t(u_pos[1]), t(u_neg[1]), t(u_pack[1]), strategy)
    assert all(torch.equal(a, b[1]) for a, b in zip(one, got))
    lab = got[2].numpy()
    assert lab.shape == (n, 16) and (lab[0] > 0).sum() > 0 and (lab[2] <= 0).all()


def test_proposal_targets_bitwise():
    for strategy in ("random", "topk_iou"):
        _proposal_targets_case(strategy)


# --------------------------------------------------------- ROIAlign backward


def _roi_inputs(rng, n=2, h=9, w=11, c=5, r=7):
    feat = rng.normal(0, 1, (n, h, w, c)).astype(np.float32)
    rois = rand_boxes(rng, (n, r), 10.0, 0.5, 8.0)
    rois[:, :4] = np.array([[-0.9, -0.9, 3.0, 3.0],           # crosses the top-left border
                            [h - 3.0, w - 4.0, h + 2.0, w + 3.0],  # crosses the bottom-right
                            [2.2, 2.2, 2.2, 2.2],             # zero area -> 1 px
                            [-5.0, -5.0, -2.0, -1.5]], np.float32)  # out of range
    g = rng.normal(0, 1, (n, r, 7, 7, c)).astype(np.float32)
    return feat, rois, g


def _jax_vjp(feat, rois, g, scale, dtype=jnp.float32):
    out = []
    for i in range(feat.shape[0]):
        _, vjp = jax.vjp(
            lambda f: j_roi.roi_align(f, jnp.asarray(rois[i]), 7, 2, scale, method="einsum"),
            jnp.asarray(feat[i], dtype))
        out.append(np.asarray(vjp(jnp.asarray(g[i]))[0].astype(jnp.float32)))
    return np.stack(out)


def test_roi_align_backward_matches_jax_vjp():
    for scale in (1.0, 0.5):
        _roi_align_backward_case(scale)


def _roi_align_backward_case(scale):
    rng = np.random.default_rng(21)
    feat, rois, g = _roi_inputs(rng)
    rois = rois / scale
    want = _jax_vjp(feat, rois, g, scale)
    got = t_roi.roi_align_backward(t(g), t(rois), feat.shape, torch.float32, 7, 2, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # the autograd Function around the kernel wrapper (plain versions on the CPU)
    f = t(feat).requires_grad_()
    out = roi_align_cuda(f, t(rois), 7, 2, scale)
    (out * t(g)).sum().backward()
    np.testing.assert_array_equal(f.grad.numpy(), got.numpy())
    # and the gather formulation's own autograd agrees
    f2 = t(feat).requires_grad_()
    (t_roi.roi_align(f2, t(rois), 7, 2, scale, method="gather") * t(g)).sum().backward()
    np.testing.assert_allclose(f2.grad.numpy(), want, atol=1e-5, rtol=1e-5)


def test_roi_align_backward_bf16():
    rng = np.random.default_rng(22)
    feat, rois, g = _roi_inputs(rng, c=8)
    want = _jax_vjp(feat, rois, g, 1.0, jnp.bfloat16)
    f = t(feat).to(torch.bfloat16).requires_grad_()
    out = roi_align_cuda(f, t(rois), 7, 2)
    assert out.dtype == torch.float32
    out.backward(t(g))
    assert f.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(f.grad.float().numpy(), want, rtol=2**-7, atol=1e-6)
    # a bfloat16 output hands the backward a bfloat16 gradient: the same
    # gradient as the float32 output given that gradient upcast, bit for bit
    g16 = t(g).to(torch.bfloat16)
    f16 = t(feat).to(torch.bfloat16).requires_grad_()
    out16 = roi_align_cuda(f16, t(rois), 7, 2, out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16 and torch.equal(out16, out.to(torch.bfloat16))
    out16.backward(g16)
    f32 = t(feat).to(torch.bfloat16).requires_grad_()
    roi_align_cuda(f32, t(rois), 7, 2).backward(g16.float())
    assert f16.grad.dtype == torch.bfloat16 and torch.equal(f16.grad, f32.grad)
    _case_roi_align_function_refuses_roi_gradients()


def _case_roi_align_function_refuses_roi_gradients():
    rng = np.random.default_rng(23)
    feat, rois, _ = _roi_inputs(rng)
    r = t(rois).requires_grad_()
    with pytest.raises(ValueError, match="no gradient to the rois"):
        roi_align_cuda(t(feat).requires_grad_(), r, 7, 2)
    with torch.no_grad():  # no gradient wanted: fine
        roi_align_cuda(t(feat), r, 7, 2)
    with ops.reference_scope():  # the plain path differentiates through gather
        out = t_roi.extract_roi_features(t(feat).requires_grad_(), t(rois))
    assert out.requires_grad
