"""Parity of the PyTorch port's detection ops with the JAX package.

Inputs are made with numpy from a seed and go through both. Tolerances:

* ``iou``, ``clip``, anchors, ROIPool and every NMS selection: bitwise.
  (The JAX ``boxes.iou`` is called eagerly, op by op, as strict IEEE
  float32; the port computes the same way on every device.)
* ``decode``: atol 1e-4 px on boxes up to ~200 px — ``exp`` rounds
  differently in PyTorch and XLA, and XLA:CPU may contract the
  ``d * h + c`` products into FMAs.
* ROIAlign: atol 2e-5 / rtol 1e-5 against the JAX einsum path (the
  tolerance the JAX package pins its Pallas kernel to): the summation
  order of the two formulations differs.

The CUDA kernels themselves need the card; ``chip_smoke.py`` holds them
against these plain versions there.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from replication_faster_rcnn_tpu.config import AnchorConfig as JAnchorConfig
from replication_faster_rcnn_tpu.ops import anchors as j_anchors
from replication_faster_rcnn_tpu.ops import boxes as j_boxes
from replication_faster_rcnn_tpu.ops import nms as j_nms
from replication_faster_rcnn_tpu.ops import nms_tiled as j_nms_tiled
from replication_faster_rcnn_tpu.ops import roi_ops as j_roi
from replication_faster_rcnn_tpu_torch import ops
from replication_faster_rcnn_tpu_torch.config import AnchorConfig
from replication_faster_rcnn_tpu_torch.ops import anchors as t_anchors
from replication_faster_rcnn_tpu_torch.ops import boxes as t_boxes
from replication_faster_rcnn_tpu_torch.ops import nms as t_nms
from replication_faster_rcnn_tpu_torch.ops import roi_ops as t_roi
from replication_faster_rcnn_tpu_torch.ops.cuda.nms_kernel import nms_fixed_cuda
from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import roi_align_cuda
from replication_faster_rcnn_tpu_torch.ops.nms_tiled import nms_fixed_tiled


def rand_boxes(n, rng, size=100.0):
    p1 = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(1, size / 2, (n, 2))
    return np.concatenate([p1, p1 + wh], axis=1).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------- geometry


def test_iou_bitwise():
    rng = np.random.default_rng(0)
    a = rand_boxes(300, rng, 200.0)
    b = rand_boxes(400, rng, 200.0)
    b[:5] = b[5:10] = np.array([10, 10, 10, 30], np.float32)  # zero-area
    want = np.asarray(j_boxes.iou(jnp.asarray(a), jnp.asarray(b)))
    got = t_boxes.iou(t(a), t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    _case_clip_bitwise()


def _case_clip_bitwise():
    rng = np.random.default_rng(1)
    b = rng.uniform(-50, 250, (500, 4)).astype(np.float32)
    want = np.asarray(j_boxes.clip(jnp.asarray(b), 180.0, 200.0))
    np.testing.assert_array_equal(t_boxes.clip(t(b), 180.0, 200.0).numpy(), want)


def test_decode_encode_close():
    rng = np.random.default_rng(2)
    anchors = rand_boxes(2000, rng, 150.0)
    deltas = rng.normal(0, 0.3, (2000, 4)).astype(np.float32)
    want = np.asarray(j_boxes.decode(jnp.asarray(anchors), jnp.asarray(deltas)))
    got = t_boxes.decode(t(anchors), t(deltas)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    boxes = rand_boxes(2000, rng, 150.0)
    want = np.asarray(j_boxes.encode(jnp.asarray(anchors), jnp.asarray(boxes)))
    np.testing.assert_allclose(
        t_boxes.encode(t(anchors), t(boxes)).numpy(), want, rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(
        t_boxes.area(t(boxes)).numpy(), np.asarray(j_boxes.area(jnp.asarray(boxes)))
    )


@pytest.mark.parametrize("feat_size", [(38, 38), (4, 5), (7, 3)])
def test_anchors_bitwise(feat_size):
    cfg = AnchorConfig()
    jcfg = JAnchorConfig()
    np.testing.assert_array_equal(
        t_anchors.make_anchors(cfg, feat_size), j_anchors.make_anchors(jcfg, feat_size)
    )


# --------------------------------------------------------------------- NMS


def _jax_nms(boxes, scores, thresh, max_out, mask=None, tile=512, assume_sorted=False):
    m = None if mask is None else jnp.asarray(mask)
    idx, valid = j_nms_tiled.nms_fixed_tiled(
        jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out, mask=m,
        tile=tile, assume_sorted=assume_sorted,
    )
    return np.asarray(idx), np.asarray(valid)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy(), want[0])


@pytest.mark.parametrize("n", [1, 9, 65, 700])
def test_nms_tiled_matches_jax(n):
    # the tiles are cases of one id per n (each test id costs the fast
    # tier's budget)
    rng = np.random.default_rng(100 + n)
    boxes = rand_boxes(n, rng, size=60.0)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    for tile in (17, 64, 512):
        for thresh in (0.3, 0.7):
            want = _jax_nms(boxes, scores, thresh, 50, tile=tile)
            _assert_same(nms_fixed_tiled(t(boxes), t(scores), thresh, 50, tile=tile), want)


def test_nms_mask_ties_nonfinite_and_sorted():
    rng = np.random.default_rng(5)
    boxes = rand_boxes(300, rng, size=50.0)
    scores = (rng.integers(0, 6, 300) / 6.0).astype(np.float32)  # many ties
    scores[7] = np.nan
    scores[13] = np.inf
    mask = rng.uniform(size=300) > 0.2
    want = _jax_nms(boxes, scores, 0.5, 80, mask=mask, tile=64)
    _assert_same(nms_fixed_tiled(t(boxes), t(scores), 0.5, 80, mask=t(mask), tile=64), want)
    order = np.argsort(-np.where(np.isfinite(scores), scores, -np.inf), kind="stable")
    sb, ss = boxes[order], np.sort(np.where(np.isfinite(scores), scores, -np.inf))[::-1]
    ss = np.ascontiguousarray(ss)
    want = _jax_nms(sb, ss, 0.5, 80, mask=np.isfinite(ss), tile=64, assume_sorted=True)
    got = nms_fixed_tiled(t(sb), t(ss), 0.5, 80, mask=t(np.isfinite(ss)), tile=64,
                          assume_sorted=True)
    _assert_same(got, want)
    _case_nms_all_invalid_and_max_out_exceeds_n()


def _case_nms_all_invalid_and_max_out_exceeds_n():
    rng = np.random.default_rng(6)
    boxes = rand_boxes(10, rng)
    idx, valid = nms_fixed_tiled(t(boxes), torch.full((10,), float("-inf")), 0.5, 5)
    assert not valid.any() and (idx == 0).all()
    boxes = rand_boxes(6, rng, size=500.0)
    scores = rng.uniform(0, 1, 6).astype(np.float32)
    _assert_same(nms_fixed_tiled(t(boxes), t(scores), 0.5, 20),
                 _jax_nms(boxes, scores, 0.5, 20))


@pytest.mark.parametrize(
    "n,max_out,thresh,sorted_",
    [(3000, 300, 0.7, True), (6300, 100, 0.3, False)],
    ids=["proposal_3000_300", "detection_6300_100"],
)
def test_nms_main_path_budgets_batched(n, max_out, thresh, sorted_):
    """The two serving call sites, three images at once against the JAX
    version image by image."""
    rng = np.random.default_rng(n)
    boxes = np.stack([rand_boxes(n, rng, size=600.0) for _ in range(3)])
    scores = rng.uniform(0, 1, (3, n)).astype(np.float32)
    mask = None
    if sorted_:
        scores = -np.sort(-scores, axis=1)
    else:
        mask = rng.uniform(size=(3, n)) > 0.3
    got = nms_fixed_tiled(t(boxes), t(scores), thresh, max_out,
                          mask=None if mask is None else t(mask), assume_sorted=sorted_)
    for i in range(3):
        want = _jax_nms(boxes[i], scores[i], thresh, max_out,
                        mask=None if mask is None else mask[i], assume_sorted=sorted_)
        np.testing.assert_array_equal(got[1][i].numpy(), want[1])
        np.testing.assert_array_equal(got[0][i].numpy(), want[0])
        assert want[1].sum() > 10  # suppression leaves real selections


def test_nms_loop_matches_jax_loop_and_tiled():
    rng = np.random.default_rng(8)
    boxes = rand_boxes(200, rng, size=40.0)
    scores = rng.uniform(0, 1, 200).astype(np.float32)
    mask = rng.uniform(size=200) > 0.1
    jidx, jvalid = j_nms.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 60,
                                   mask=jnp.asarray(mask))
    got = t_nms.nms_fixed(t(boxes), t(scores), 0.5, 60, mask=t(mask))
    _assert_same(got, (np.asarray(jidx), np.asarray(jvalid)))
    _assert_same(nms_fixed_tiled(t(boxes), t(scores), 0.5, 60, mask=t(mask), tile=32),
                 (np.asarray(jidx), np.asarray(jvalid)))


def test_batched_nms_class_offsets_match_jax():
    rng = np.random.default_rng(9)
    r, c = 40, 5
    boxes = np.repeat(rand_boxes(r, rng, size=80.0)[:, None], c, axis=1).reshape(r * c, 4)
    scores = rng.uniform(0, 1, r * c).astype(np.float32)
    class_ids = np.tile(np.arange(c, dtype=np.int32), r)
    mask = class_ids > 0
    jidx, jvalid = j_nms.batched_nms_fixed(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(class_ids), 0.3, 100,
        mask=jnp.asarray(mask),
    )
    got = t_nms.batched_nms_fixed(t(boxes), t(scores), t(class_ids).long(), 0.3, 100,
                                  mask=t(mask))
    _assert_same(got, (np.asarray(jidx), np.asarray(jvalid)))


def test_cpu_dispatch_runs_plain_versions():
    """On CPU tensors the kernel wrappers run the plain versions and count
    no launch; inside reference_scope the dispatch skips the wrappers."""
    from replication_faster_rcnn_tpu_torch.ops.cuda import nms_kernel, roi_kernel

    rng = np.random.default_rng(10)
    boxes = t(rand_boxes(100, rng, size=50.0))
    scores = t(rng.uniform(0, 1, 100).astype(np.float32))
    before = (nms_kernel.launches, roi_kernel.launches)
    want = nms_fixed_tiled(boxes, scores, 0.5, 30)
    for got in (nms_fixed_cuda(boxes, scores, 0.5, 30),
                t_nms.nms_fixed_auto(boxes, scores, 0.5, 30)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    feat = torch.randn(1, 9, 9, 4, generator=torch.Generator().manual_seed(0))
    rois = torch.tensor([[[1.0, 1.0, 6.0, 7.0]]])
    plain = t_roi.roi_align(feat, rois, 3, 2, method="gather")
    assert torch.equal(roi_align_cuda(feat, rois, 3, 2), plain)
    with ops.reference_scope():
        assert ops.reference_requested()
        assert torch.equal(t_roi.extract_roi_features(feat, rois, "align", 3, 2), plain)
    assert not ops.reference_requested()
    assert (nms_kernel.launches, roi_kernel.launches) == before
    # ROIPool: the wrapper and the dispatch run the masked maxes on the CPU,
    # forward and backward, and count no launch
    pool_before = (roi_kernel.pool_launches, roi_kernel.pool_backward_launches)
    leaf = feat.clone().requires_grad_(True)
    got = t_roi.extract_roi_features(leaf, rois, "pool", 3)
    assert torch.equal(got, t_roi.roi_pool(feat, rois, 3))
    assert torch.equal(roi_kernel.roi_pool_cuda(feat, rois, 3), got.detach())
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    got.backward(g)
    assert torch.equal(leaf.grad, t_roi.roi_pool_backward(g, feat, rois, 3))
    assert torch.equal(roi_kernel.roi_pool_backward_cuda(g, feat, rois, 3), leaf.grad)
    assert (roi_kernel.pool_launches, roi_kernel.pool_backward_launches) == pool_before


# ---------------------------------------------------------------- ROI ops


def _rois_with_edge_cases(rng, h, w, n):
    p1r, p1c = rng.uniform(0, h - 2, (n, 1)), rng.uniform(0, w - 2, (n, 1))
    hh, ww = rng.uniform(1, h / 2, (n, 1)), rng.uniform(1, w / 2, (n, 1))
    rois = np.concatenate([p1r, p1c, p1r + hh, p1c + ww], axis=1).astype(np.float32)
    edge = np.array(
        [
            [-0.9, -0.9, 3.0, 3.0],  # crosses the top-left border
            [h - 3.0, w - 4.0, h + 2.0, w + 3.0],  # crosses the bottom-right
            [2.2, 2.2, 2.2, 2.2],  # zero area
            [2.2, 2.2, 2.3, 2.3],  # sub-pixel
            [-5.0, -5.0, -2.0, -1.5],  # entirely out of range
            [0.0, 0.0, float(h), float(w)],  # the whole map
        ],
        np.float32,
    )
    return np.concatenate([rois, edge])


@pytest.mark.parametrize("method", ["einsum", "gather"])
def test_roi_align_matches_jax_einsum(method):
    rng = np.random.default_rng(11)
    n, h, w, c = 2, 11, 9, 6
    feat = rng.normal(0, 1, (n, h, w, c)).astype(np.float32)
    rois = np.stack([_rois_with_edge_cases(rng, h, w, 8) for _ in range(n)])
    got = t_roi.roi_align(t(feat), t(rois), 7, 2, 0.5, method=method).numpy()
    for i in range(n):
        want = np.asarray(
            j_roi.roi_align(jnp.asarray(feat[i]), jnp.asarray(rois[i]), 7, 2, 0.5,
                            method="einsum")
        )
        np.testing.assert_allclose(got[i], want, atol=2e-5, rtol=1e-5)
    assert got.dtype == np.float32
    # bf16 features. s = 2: the same tolerance. s = 3: JAX's XLA path rounds
    # its sample offsets ((arange + 0.5) / s) to the features' dtype, the
    # port (like the Pallas kernel) keeps them float32; the port then equals
    # JAX on the same values in float32 and diverges from JAX in bf16.
    fb = t(feat).to(torch.bfloat16)
    fb32 = fb.float().numpy()
    for s in (2, 3):
        got = t_roi.roi_align(fb, t(rois), 7, s, 0.5, method=method).numpy()
        assert got.dtype == np.float32
        for i in range(n):
            j_bf16 = np.asarray(j_roi.roi_align(jnp.asarray(fb32[i]).astype(jnp.bfloat16),
                                                jnp.asarray(rois[i]), 7, s, 0.5, method="einsum"))
            j_f32 = np.asarray(j_roi.roi_align(jnp.asarray(fb32[i]), jnp.asarray(rois[i]), 7, s,
                                               0.5, method="einsum"))
            np.testing.assert_allclose(got[i], j_f32, atol=2e-5, rtol=1e-5)
            if s == 2:
                np.testing.assert_allclose(got[i], j_bf16, atol=2e-5, rtol=1e-5)
            else:
                assert j_bf16.dtype == np.float32
                assert np.abs(got[i] - j_bf16).max() > 1e-3


def test_roi_align_bf16_features_promote_to_f32():
    rng = np.random.default_rng(12)
    feat = rng.normal(0, 1, (1, 8, 8, 4)).astype(np.float32)
    rois = _rois_with_edge_cases(rng, 8, 8, 4)[None]
    fb = t(feat).to(torch.bfloat16)
    got = t_roi.roi_align(fb, t(rois), 7, 2, method="gather")
    assert got.dtype == torch.float32
    want = t_roi.roi_align(fb.float(), t(rois), 7, 2, method="gather")
    assert torch.equal(got, want)  # bf16 -> f32 is exact
    # out_dtype: the float32 result rounded once, on every CPU path
    assert t_roi.extract_roi_features(fb, t(rois), "align", 7, 2).dtype == torch.float32
    for f in (fb, t(feat)):
        cast = t_roi.roi_align(f, t(rois), 7, 2, method="gather").to(torch.bfloat16)
        for out in (t_roi.extract_roi_features(f, t(rois), "align", 7, 2,
                                               out_dtype=torch.bfloat16),
                    roi_align_cuda(f, t(rois), 7, 2, out_dtype=torch.bfloat16)):
            assert out.dtype == torch.bfloat16 and torch.equal(out, cast)
        with ops.reference_scope():
            out = t_roi.extract_roi_features(f, t(rois), "align", 7, 2, out_dtype=torch.bfloat16)
        assert out.dtype == torch.bfloat16 and torch.equal(out, cast)


def _bf16_ulp(x):
    """One bfloat16 ulp at each |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.where(x != 0, np.ldexp(np.float32(1), e - 8), np.float32(2.0**-133))


def test_roi_pool_bitwise():
    """ROIPool forward bitwise against the JAX ``roi_pool``: float32 and
    bfloat16 features, integer-valued features (exact ties), NaN and +-inf
    in the map, empty, degenerate and out-of-map rois, spatial scales 1/2 and
    1/16. The gradient (``roi_ops.roi_pool_backward``, autograd of the masked
    maxes on float32 copies) against ``jax.vjp`` of the JAX ``roi_pool``:
    float32 within atol 1e-5 / rtol 1e-6 (the same terms summed in another
    order; measured 9.5e-7 at |g| <= 15.5). bfloat16: the port's gradient is
    the float32 one on the same values rounded once (bitwise), and JAX's VJP
    lies within one bfloat16 ulp of each value plus one of the sum of its
    terms' magnitudes: JAX rounds each partial sum to bfloat16, and no partial
    sum exceeds that sum (measured here: at most half an ulp of it beyond the
    value's ulp, on up to 36 entries an image). Both split a tied
    maximum's gradient evenly, rows first, then columns. With NaN in the map
    both VJPs divide 0 by 0 at the same places."""
    rng = np.random.default_rng(13)
    n, h, w, c = 2, 12, 14, 5
    normal = rng.normal(0, 1, (n, h, w, c)).astype(np.float32)
    ties = rng.integers(-3, 4, (n, h, w, c)).astype(np.float32)
    bad = normal.copy()
    bad[0, 3, 4, 1], bad[0, 7, 2, 3], bad[1, 5, 5, 0] = np.nan, np.inf, -np.inf
    bad[1, 0, :, 2] = -np.inf  # a whole row: some bins are all -inf
    rois = np.stack([_rois_with_edge_cases(rng, h, w, 6) for _ in range(n)])
    rois[0, 0] = [np.nan, 1.0, 5.0, 5.0]  # a diverged proposal
    for feat in (normal, ties, bad):
        for dtype in (jnp.float32, jnp.bfloat16):
            for scale in (0.5, 1.0 / 16):
                _roi_pool_case(feat, rois / scale, scale, dtype)


def _roi_pool_case(feat, rois, scale, dtype):
    f = np.array(jnp.asarray(feat).astype(dtype).astype(jnp.float32))  # the dtype's values
    tf = t(f) if dtype == jnp.float32 else t(f).to(torch.bfloat16)
    got = t_roi.roi_pool(tf, t(rois), 7, scale)
    assert got.dtype == tf.dtype
    g = np.random.default_rng(1).normal(0, 1, got.shape).astype(np.float32)
    tg = t(g).to(tf.dtype)
    grad = t_roi.roi_pool_backward(tg, tf, t(rois), 7, scale)
    assert grad.dtype == tf.dtype and grad.shape == tf.shape
    once = t_roi.roi_pool_backward(tg.float(), tf.float(), t(rois), 7, scale).to(tf.dtype)
    assert torch.equal(grad.isnan(), once.isnan())
    assert torch.equal(torch.nan_to_num(grad), torch.nan_to_num(once))
    for i in range(f.shape[0]):
        jf = jnp.asarray(f[i]).astype(dtype)
        want, vjp = jax.vjp(lambda x: j_roi.roi_pool(x, jnp.asarray(rois[i]), 7, scale), jf)
        np.testing.assert_array_equal(got[i].float().numpy(), np.asarray(want, np.float32))
        (jg,) = vjp(jnp.asarray(g[i]).astype(dtype))
        jg = np.asarray(jg, np.float32)
        tg_i = grad[i].float().numpy()
        np.testing.assert_array_equal(np.isnan(tg_i), np.isnan(jg))
        if dtype == jnp.float32:
            np.testing.assert_allclose(tg_i, jg, atol=1e-5, rtol=1e-6)
        else:
            mag = t_roi.roi_pool_backward(tg.float().abs(), tf.float(), t(rois), 7, scale)
            mag = mag[i].numpy()  # the sum of the terms' magnitudes, entry by entry
            fin = np.isfinite(jg)
            tol = _bf16_ulp(jg[fin]) + _bf16_ulp(mag[fin])
            assert (np.abs(tg_i - jg)[fin] <= tol).all()
