"""Parity of the PyTorch port's FPN (``voc_resnet50_fpn``'s wiring) with the
JAX package on the CPU, at the JAX FPN tests' small size: ResNet18 + FPN,
float32, 136x136 (C2..C5 34, 17, 9, 5 and P6 3: the top-down sum crops an
odd level twice), batch 2. The weights are the port's seeded init as a flax
tree (``models/convert.py::to_flax_variables``; held to the tree, shapes and
dtypes of the JAX ``init`` by ``jax.eval_shape``, which skips the JAX
init's 26 s forward), BatchNorm statistics, biases and the RPN/head kernels
randomised with numpy, carried into both models.

Tolerances, with their reasons:

* The plain multi-level ROIAlign against the JAX ``method="flat"`` run
  operation by operation (``jax.disable_jit()``): bitwise, float32 and
  bfloat16 features (the plain version repeats its operations in order and
  sums each bin's samples in the order XLA's mean reduces them). Against the
  jitted ``flat`` and against ``blend``: atol 1e-4 / rtol 1e-5, JAX's own
  flat-against-blend tolerance (measured: jitted 0, blend 8.7e-6), on every
  roi but those the jitted programs put on another level: rois within a few
  float32 ulps of a level-boundary area (asserted; measured: sqrt(area) two
  ulps under 112, which XLA's compiled ``roi_levels`` puts on P2 where the
  operation-by-operation JAX and the port round 4 + log2 up to 3, P3).
* ``roi_levels``: equal to JAX's run operation by operation, at
  sqrt(area) = 56, 112, 224, 448 and two float32 ulps either side, and at
  squares of every float32 side within 4,096 ulps of those.
* The gradient of every level against ``jax.vjp`` of ``flat``: atol 1e-5 /
  rtol 1e-5 (the same float32 terms scatter-added in another order).
* Features, RPN logits/deltas, head cls/reg, each stage fed the JAX stage's
  output: rtol 1e-4 and atol 1e-5 of the largest entry (XLA:CPU and oneDNN
  sum convolutions in other orders; the RPN logits reach ~100 here, its
  256-channel 3x3 conv summing 2,304 products, so an absolute 1e-4 would
  ask for more than float32 sums in two orders agree to). Anchors bitwise.
* The whole forward from the images: RPN logits/deltas as above, anchors
  bitwise, ``valid`` equal, rois within 1e-3 px plus rtol 2e-4 (the port's
  decode convention, on deltas that now carry the trunk's differences: the
  decode scales them by anchors of up to 512 px; measured 0.011 px on an 80
  px coordinate); cls/reg within rtol 1e-3 and atol 2e-4 of the largest
  entry (their crops come from those rois; the logits reach 66 here,
  measured 7.0e-3 apart).
* One train step's four losses with the JAX step's draws injected: within
  ``__graft_entry__._assert_losses_agree``'s 1e-3 (relative, at least 1
  absolute).
* The weights bridge on the FPN tree (``trunk.layer4``, ``neck.lateral*``
  / ``smooth*``, ``head.fc6`` / ``fc7``): bitwise both ways.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from replication_faster_rcnn_tpu import config as jconfig
from replication_faster_rcnn_tpu.data.loader import collate as j_collate
from replication_faster_rcnn_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from replication_faster_rcnn_tpu.models import fpn as jfpn
from replication_faster_rcnn_tpu.models.faster_rcnn import FasterRCNN as JFasterRCNN
from replication_faster_rcnn_tpu.models.rpn import batched_proposals as j_batched_proposals
from replication_faster_rcnn_tpu.train.train_step import compute_losses as j_compute_losses
from replication_faster_rcnn_tpu_torch import config as tconfig
from replication_faster_rcnn_tpu_torch import ops
from replication_faster_rcnn_tpu_torch.data.loader import collate
from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from replication_faster_rcnn_tpu_torch.models import fpn as tfpn
from replication_faster_rcnn_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model
from replication_faster_rcnn_tpu_torch.models.rpn import batched_proposals
from replication_faster_rcnn_tpu_torch.ops.cuda.roi_kernel import multilevel_roi_align_cuda
from replication_faster_rcnn_tpu_torch.train.train_step import (
    DRAW_NAMES,
    TrainState,
    make_optimizer,
    make_train_step,
)
from tests.test_torch_model import _randomise

SIZE = (136, 136)
LOSSES = ("loss", "rpn_cls_loss", "rpn_reg_loss", "head_cls_loss", "head_reg_loss")


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, err_msg=""):
    """rtol 1e-4, atol 1e-5 of the largest entry (see the module's docstring)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()), err_msg=err_msg)


def _boundary_rois():
    """Squares of sqrt(area) 56, 112, 224, 448 and two float32 ulps either
    side."""
    out = []
    for side in (56.0, 112.0, 224.0, 448.0):
        v = np.float32(side)
        for step in (-2, -1, 0, 1, 2):
            s = v
            for _ in range(abs(step)):
                s = np.nextafter(s, np.float32(np.inf if step > 0 else -np.inf), dtype=np.float32)
            out.append([3.0, 5.0, 3.0 + float(s), 5.0 + float(s)])
    return np.asarray(out, np.float32)


def _level_sweep():
    """Squares whose side is every float32 within 4,096 ulps of 56, 112, 224
    and 448: every float32 sqrt(area) / 224 near a level boundary."""
    sides = np.concatenate([
        (np.float32(v).view(np.int32) + np.arange(-4096, 4097, dtype=np.int32)).view(np.float32)
        for v in (56.0, 112.0, 224.0, 448.0)])
    zero = np.zeros_like(sides)
    return np.stack([zero, zero, sides, sides], axis=-1)


def _case_roi_levels():
    for rois in (_boundary_rois(), _level_sweep()):
        with jax.disable_jit():
            want = np.asarray(jfpn.roi_levels(jnp.asarray(rois)))
        got = tfpn.roi_levels(t(rois)).numpy()
        np.testing.assert_array_equal(got, want)
        assert sorted(set(got.tolist())) == [0, 1, 2, 3]


def _case_multilevel(dtype):
    rng = np.random.default_rng(7)
    n, r, c = 2, 64, 8
    shapes = [(64, 48), (32, 24), (16, 12), (8, 6)]
    feats = [rng.normal(0, 1, (n, h, w, c)).astype(np.float32) for h, w in shapes]
    # rois spanning every level, degenerate, outside the image, at the
    # level-boundary areas
    p1 = rng.uniform(-20.0, 200.0, (n, r, 2))
    size = rng.uniform(0.0, 400.0, (n, r, 2))
    rois = np.concatenate([p1, p1 + size], axis=-1).astype(np.float32)
    rois[:, :20] = _boundary_rois()
    rois[:, 20:24] = [[10, 10, 10, 10], [-50, -60, -10, -20], [250, 180, 300, 260],
                      [-300, -300, 700, 700]]
    jfeats = [jnp.asarray(f, dtype) for f in feats]
    tfeats = [t(np.asarray(f)) for f in jfeats] if dtype == jnp.float32 else [
        t(f).to(torch.bfloat16) for f in feats]
    jrois, trois = jnp.asarray(rois), t(rois)
    with jax.disable_jit():
        eager = np.asarray(jfpn.multilevel_roi_align(jfeats, jrois, 256.0, 192.0))
    got = tfpn.multilevel_roi_align_plain(tfeats, trois, 256.0, 192.0)
    np.testing.assert_array_equal(got.numpy(), eager)
    # the jitted JAX program may put a roi within a few ulps of a level
    # boundary on the other level (see the module's docstring); such rois
    # are held apart, every other roi compared
    jit_levels = np.asarray(jax.jit(jfpn.roi_levels)(jrois))
    same = jit_levels == tfpn.roi_levels(trois).numpy()
    side = np.sqrt((rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1]))
    near = np.min(np.abs(side[..., None] / [56.0, 112.0, 224.0, 448.0] - 1.0), axis=-1) < 1e-6
    assert np.all(near[~same]) and same.sum() >= same.size - 4, side[~same]
    for method in ("flat", "blend"):
        want = jax.jit(lambda f, b, m=method: jfpn.multilevel_roi_align(f, b, 256.0, 192.0,
                                                                        method=m))(jfeats, jrois)
        np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same], atol=1e-4,
                                   rtol=1e-5, err_msg=method)
    # the dispatch seam and the kernel wrapper on CPU tensors: the plain
    # version, cast to the output dtype
    assert torch.equal(tfpn.multilevel_roi_align(tfeats, trois, 256.0, 192.0), got)
    with ops.reference_scope():
        assert torch.equal(tfpn.multilevel_roi_align(tfeats, trois, 256.0, 192.0), got)
    assert torch.equal(multilevel_roi_align_cuda(tfeats, trois, 256.0, 192.0, 7, 2, torch.bfloat16),
                       got.to(torch.bfloat16))
    if dtype != jnp.float32:
        return
    # the gradient of every level against jax.vjp of flat
    g = rng.normal(0, 1, got.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *f: jfpn.multilevel_roi_align(list(f), jrois, 256.0, 192.0),
                     *jfeats)
    jgrads = vjp(jnp.asarray(g))
    leaves = [x.clone().requires_grad_(True) for x in tfeats]
    out = tfpn.multilevel_roi_align(leaves, trois, 256.0, 192.0)
    tgrads = torch.autograd.grad(out, leaves, t(g))
    for li, (a, b) in enumerate(zip(tgrads, jgrads)):
        assert bool(np.any(np.asarray(b) != 0)), li  # every level owns a roi
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5,
                                   err_msg=f"P{li + 2}")


def test_multilevel_roi_align_matches_jax():
    _case_roi_levels()
    _case_multilevel(jnp.float32)
    _case_multilevel(jnp.bfloat16)


def _small(mod):
    cfg = mod.get_config("voc_resnet50_fpn")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, backbone="resnet18", compute_dtype="float32"),
        data=mod.DataConfig(dataset="synthetic", image_size=SIZE, max_boxes=4),
        proposals=mod.ProposalConfig(pre_nms_train=192, post_nms_train=48),
        rpn_targets=mod.RPNTargetConfig(n_sample=64),
        roi_targets=mod.ROITargetConfig(n_sample=16),
        train=mod.TrainConfig(batch_size=2, lr=1e-4),
    )


def _same_tree(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), k


def _draws(rng, n, a, rg):
    """The uniforms JAX's ``compute_losses`` consumes under ``rng``, by the
    port's draw names."""
    rng_at, rng_pt, _ = jax.random.split(rng, 3)
    out = {name: [] for name in DRAW_NAMES}
    for i in range(n):
        for name, key in zip(DRAW_NAMES[:2], jax.random.split(jax.random.fold_in(rng_at, i))):
            out[name].append(np.asarray(jax.random.uniform(key, (a,))))
        for name, key in zip(DRAW_NAMES[2:], jax.random.split(jax.random.fold_in(rng_pt, i), 3)):
            out[name].append(np.asarray(jax.random.uniform(key, (rg,))))
    return {k: t(np.stack(v)) for k, v in out.items()}


def test_fpn_model_matches_jax():
    jcfg, tcfg = _small(jconfig), _small(tconfig)
    jmodel = JFasterRCNN(jcfg)
    rng = np.random.default_rng(0)
    # the port's seeded init, randomised, as a flax tree; its structure,
    # shapes and dtypes are the JAX model's own
    seeded = to_flax_variables(build_model(tcfg, device="cpu").state_dict())
    variables = _randomise(seeded, rng)
    want = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                              jnp.zeros((1,) + SIZE + (3,)), train=False))
    assert jax.tree_util.tree_structure(dict(want)) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(dict(want)), jax.tree_util.tree_leaves(variables)):
        assert a.shape == b.shape and a.dtype == b.dtype
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    state = from_flax_variables(variables)
    tmodel = build_model(tcfg, device="cpu", state_dict=state)

    # the weights bridge on the FPN tree, both ways
    assert {"trunk.layer4.1.conv2.weight", "neck.lateral3.weight", "neck.smooth0.weight",
            "head.fc6.weight", "head.fc7.bias"} <= set(state)
    assert "layer4.0" in variables["params"]["trunk"] and "tail" not in variables["params"]["head"]
    _same_tree(to_flax_variables(tmodel.state_dict()), variables)
    again = from_flax_variables(to_flax_variables(state))
    assert set(again) == set(state) and all(torch.equal(again[k], state[k]) for k in state)

    # the odd-size crop of the top-down upsample, at the 600x600 pyramid's sizes
    for fine, coarse in ((75, 38), (38, 19), (19, 10), (10, 5)):
        x = rng.normal(0, 1, (1, coarse, coarse + 1, 3)).astype(np.float32)
        want = jfpn._upsample_nearest(jnp.asarray(x), (fine, fine + 1))
        got = tfpn._upsample_nearest(t(x).permute(0, 3, 1, 2), (fine, fine + 1))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))

    # stages, each fed the JAX stage's output
    h, w = SIZE
    images = rng.integers(0, 256, (2,) + SIZE + (3,), dtype=np.uint8)
    jfeat = jmodel.apply(jvars, jnp.asarray(images), method=JFasterRCNN.extract_features)
    with torch.inference_mode():
        tfeat = tmodel.extract_features(t(images))
    assert [tuple(f.shape) for f in tfeat] == [(2, s, s, 256) for s in (34, 17, 9, 5, 3)]
    for a, b in zip(tfeat, jfeat):
        close(a, b)
    feat_np = [np.array(f) for f in jfeat]
    jl, jd, ja = jmodel.apply(jvars, jfeat, method=JFasterRCNN.rpn_forward)
    with torch.inference_mode():
        tl, td, ta = tmodel.rpn_forward([t(f) for f in feat_np])
    assert ta.shape == (3 * (34**2 + 17**2 + 9**2 + 5**2 + 3**2), 4)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    close(tl, jl)
    close(td, jd)
    jrois, jvalid = j_batched_proposals(ja, jl, jd, float(h), float(w), jcfg.proposals, False)
    trois, tvalid = batched_proposals(t(np.asarray(ja)), t(np.asarray(jl)), t(np.asarray(jd)),
                                      float(h), float(w), tcfg.proposals, False)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(trois.numpy(), np.asarray(jrois), atol=1e-3, rtol=0)
    jc, jr = jmodel.apply(jvars, jfeat, jrois, float(h), float(w),
                          method=JFasterRCNN.head_forward)
    with torch.inference_mode():
        tc, tr = tmodel.head_forward([t(f) for f in feat_np], t(np.asarray(jrois)),
                                     float(h), float(w))
    close(tc, jc)
    close(tr, jr)

    # the whole forward from the images
    jout = jmodel.apply(jvars, jnp.asarray(images))
    with torch.inference_mode():
        tout = tmodel(t(images))
    for i, name in enumerate(("rpn_logits", "rpn_deltas")):
        close(tout[i], jout[i], name)
    np.testing.assert_array_equal(tout[6].numpy(), np.asarray(jout[6]))
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), atol=1e-3, rtol=2e-4)
    for i, name in ((4, "cls"), (5, "reg")):
        want = np.asarray(jout[i])
        np.testing.assert_allclose(tout[i].numpy(), want, rtol=1e-3,
                                   atol=2e-4 * float(np.abs(want).max()), err_msg=name)

    # one train step's losses with the JAX step's draws injected
    jbatch = j_collate([JSyntheticDataset(jcfg.data, length=2)[i] for i in range(2)])
    batch = collate([SyntheticDataset(tcfg.data, length=2)[i] for i in range(2)])
    assert all(np.array_equal(batch[k], jbatch[k]) for k in batch)
    key = jax.random.PRNGKey(3)
    jmetrics = jax.jit(lambda p, s, b: j_compute_losses(jmodel, jcfg, p, s, b, key)[1][0])(
        jvars["params"], jvars["batch_stats"], {k: jnp.asarray(v) for k, v in jbatch.items()})
    model = build_model(tcfg, device="cpu", state_dict=state)
    ts = TrainState(model, make_optimizer(tcfg, model.parameters(), 1)[0],
                    torch.Generator().manual_seed(0))
    draws = _draws(key, 2, ta.shape[0], 48 + 4)
    metrics = make_train_step(tcfg)(ts, {k: t(batch[k]) for k in ("image", "boxes", "labels",
                                                                   "mask")}, draws=draws)
    for k in LOSSES:  # __graft_entry__._assert_losses_agree
        want = float(jmetrics[k])
        assert abs(float(metrics[k]) - want) <= 1e-3 * max(1.0, abs(want)), (k, float(metrics[k]),
                                                                           want)
    assert float(metrics["n_pos_rpn"]) == float(jmetrics["n_pos_rpn"]) > 0
    assert float(metrics["n_pos_head"]) == float(jmetrics["n_pos_head"]) > 0
