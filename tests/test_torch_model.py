"""Parity of the PyTorch port's model, proposals and decode with the JAX
package at a small size: ResNet18 at 96x96, batch 2, compute in float32,
weights from the JAX ``init_variables`` (BatchNorm statistics and affines
randomised with numpy so the bridge's mapping is exercised) bridged with
``models/convert.py::from_flax_variables``.

Tolerances, with their reasons:

* Trunk features, RPN logits/deltas, head cls/reg: rtol 1e-4 / atol 1e-4
  (values reach ~30 in magnitude here). XLA:CPU and PyTorch (oneDNN) sum the
  convolutions in different orders; each stage is fed the JAX stage's own
  output so errors do not compound across stages.
* Proposals: on inputs where decode is exact (zero deltas) rois and valid
  are bitwise equal. On the model's own logits and deltas, ``valid`` is
  equal and rois agree to 1e-3 px: ``exp`` in the softmax and the box
  decode rounds differently in the two frameworks (a few ulps).
* Detections on shared inputs: ``classes`` and ``valid`` equal; boxes to
  1e-3 px, scores to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from replication_faster_rcnn_tpu import config as jconfig
from replication_faster_rcnn_tpu.eval import detect as j_detect
from replication_faster_rcnn_tpu.eval.evaluator import make_infer_fn as j_make_infer_fn
from replication_faster_rcnn_tpu.models.faster_rcnn import FasterRCNN as JFasterRCNN
from replication_faster_rcnn_tpu.models.faster_rcnn import init_variables
from replication_faster_rcnn_tpu.models.rpn import batched_proposals as j_batched_proposals
from replication_faster_rcnn_tpu.ops import anchors as j_anchors
from replication_faster_rcnn_tpu_torch import config as tconfig
from replication_faster_rcnn_tpu_torch.eval import detect as t_detect
from replication_faster_rcnn_tpu_torch.eval.evaluator import make_infer_fn
from replication_faster_rcnn_tpu_torch.models.convert import from_flax_variables, to_flax_variables
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model
from replication_faster_rcnn_tpu_torch.models.rpn import batched_proposals

SIZE = (96, 96)


def _randomise(variables, rng):
    """Random BatchNorm statistics/affines, biases, and livelier RPN/head
    weights (their N(0, 0.01) inits give near-constant scores)."""
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif k == "mean":
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            elif k == "bias":
                out[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)
            elif k == "kernel" and (p[1] == "rpn" or p[1:3] in (("head", "cls"), ("head", "reg"))):
                out[k] = (v * 20.0).astype(np.float32)
            else:
                out[k] = v
        return out
    return walk(variables, ())


@pytest.fixture(scope="module")
def models():
    jcfg = jconfig.get_config("voc12_resnet18_align")
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, compute_dtype="float32"),
        data=dataclasses.replace(jcfg.data, image_size=SIZE),
    )
    tcfg = tconfig.get_config("voc12_resnet18_align")
    tcfg = tcfg.replace(
        model=dataclasses.replace(tcfg.model, compute_dtype="float32"),
        data=dataclasses.replace(tcfg.data, image_size=SIZE),
    )
    jmodel, variables = init_variables(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    variables = _randomise(jax.tree_util.tree_map(np.array, dict(variables)), rng)
    tmodel = build_model(tcfg, device="cpu", state_dict=from_flax_variables(variables))
    images = rng.integers(0, 256, (2,) + SIZE + (3,), dtype=np.uint8)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    return jcfg, tcfg, jmodel, jvars, tmodel, images


def _apply(jmodel, jvars, *args, method):
    return jmodel.apply(jvars, *args, method=method)


def test_stages_match(models):
    jcfg, tcfg, jmodel, jvars, tmodel, images = models
    jfeat = _apply(jmodel, jvars, jnp.asarray(images), method=JFasterRCNN.extract_features)
    with torch.inference_mode():
        tfeat = tmodel.extract_features(torch.from_numpy(images))
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), rtol=1e-4, atol=1e-4)
    assert tfeat.shape == (2, 6, 6, 256)

    jl, jd, ja = _apply(jmodel, jvars, jfeat, method=JFasterRCNN.rpn_forward)
    feat_np = np.array(jfeat)
    with torch.inference_mode():
        tl, td, ta = tmodel.rpn_forward(torch.from_numpy(feat_np))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))

    jrois, jvalid = j_batched_proposals(ja, jl, jd, 96.0, 96.0, jcfg.proposals, False)
    jc, jr = _apply(jmodel, jvars, jfeat, jrois, 96.0, 96.0, method=JFasterRCNN.head_forward)
    with torch.inference_mode():
        tc, tr = tmodel.head_forward(
            torch.from_numpy(feat_np), torch.from_numpy(np.array(jrois)), 96.0, 96.0
        )
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-4)
    # the proposal and decode stages on shared inputs (one test id: each id
    # costs the fast tier's budget)
    _case_propose_exact_when_decode_is_exact(models)
    _case_decode_on_shared_inputs(models)


def _case_propose_exact_when_decode_is_exact(models):
    """Zero deltas decode to the anchors themselves, so both frameworks see
    the same boxes: rois and valid are bitwise equal."""
    jcfg, tcfg, *_ = models
    rng = np.random.default_rng(1)
    anchors = j_anchors.make_anchors(jcfg.anchors, (6, 6))
    logits = rng.normal(0, 2, (2, anchors.shape[0], 2)).astype(np.float32)
    deltas = np.zeros((2, anchors.shape[0], 4), np.float32)
    jrois, jvalid = j_batched_proposals(
        jnp.asarray(anchors), jnp.asarray(logits), jnp.asarray(deltas), 96.0, 96.0,
        jcfg.proposals, False,
    )
    trois, tvalid = batched_proposals(
        torch.from_numpy(anchors), torch.from_numpy(logits), torch.from_numpy(deltas),
        96.0, 96.0, tcfg.proposals, False,
    )
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(trois.numpy(), np.asarray(jrois))
    assert np.asarray(jvalid).sum() > 5
    _case_propose_on_model_outputs(models)


def _case_propose_on_model_outputs(models):
    jcfg, tcfg, jmodel, jvars, tmodel, images = models
    jl, jd, jrois, jvalid, *_ , ja = jmodel.apply(jvars, jnp.asarray(images))
    trois, tvalid = batched_proposals(
        torch.from_numpy(np.array(ja)), torch.from_numpy(np.array(jl)),
        torch.from_numpy(np.array(jd)), 96.0, 96.0, tcfg.proposals, False,
    )
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(trois.numpy(), np.asarray(jrois), rtol=0, atol=1e-3)


def _case_decode_on_shared_inputs(models):
    jcfg, tcfg, jmodel, jvars, tmodel, images = models
    _, _, jrois, jvalid, jc, jr, _ = jmodel.apply(jvars, jnp.asarray(images))
    want = j_detect.batched_decode(jrois, jvalid, jc, jr, 96.0, 96.0, jcfg.eval, jcfg.roi_targets)
    got = t_detect.batched_decode(
        *(torch.from_numpy(np.array(x)) for x in (jrois, jvalid, jc, jr)),
        96.0, 96.0, tcfg.eval, tcfg.roi_targets,
    )
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-6)
    assert np.asarray(want["valid"]).sum() > 0
    one = t_detect.decode_detections(
        *(torch.from_numpy(np.array(x)[1]) for x in (jrois, jvalid, jc, jr)),
        96.0, 96.0, tcfg.eval, tcfg.roi_targets,
    )
    assert all(torch.equal(one[k], got[k][1]) for k in got)


def test_make_infer_fn_matches_jax(models):
    """The whole program (forward + decode) on uint8 images."""
    jcfg, tcfg, jmodel, jvars, tmodel, images = models
    want = jax.jit(j_make_infer_fn(jmodel, jcfg))(jvars, jnp.asarray(images))
    got = make_infer_fn(tmodel, tcfg)(torch.from_numpy(images))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-2)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-4)
    assert np.asarray(want["valid"]).sum() > 0


# ------------------------------------------------------- the other presets


def _preset_pair(name, rng):
    """The JAX model and bridged variables of preset ``name`` at 96x96 in
    float32 (BatchNorm statistics, biases and the RPN/head weights
    randomised as in ``models``), and the port's model from them."""
    jcfg = jconfig.get_config(name)
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, compute_dtype="float32"),
        data=dataclasses.replace(jcfg.data, image_size=SIZE),
    )
    tcfg = tconfig.get_config(name)
    tcfg = tcfg.replace(
        model=dataclasses.replace(tcfg.model, compute_dtype="float32"),
        data=dataclasses.replace(tcfg.data, image_size=SIZE),
    )
    jmodel, variables = init_variables(jcfg, jax.random.PRNGKey(0))
    raw = jax.tree_util.tree_map(np.array, dict(variables))
    variables = _randomise(raw, rng)
    tmodel = build_model(tcfg, device="cpu", state_dict=from_flax_variables(variables))
    return jcfg, tcfg, jmodel, raw, variables, tmodel


def _assert_round_trip(raw, name):
    back = to_flax_variables(from_flax_variables(raw))
    for coll in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(raw.get(coll, {}))
        got = dict(jax.tree_util.tree_leaves_with_path(back.get(coll, {})))
        assert len(got) == len(want), (name, coll)
        for path, leaf in want:
            assert got[path].dtype == leaf.dtype and np.array_equal(got[path], leaf), (name, path)


def _close(got, want, name):
    """rtol 1e-4, and atol 1e-5 of the array's largest magnitude: the two
    frameworks sum the convolutions in other orders, so the error scales
    with the largest operands (values reach ~40 here; measured up to 1.2e-4
    absolute on an RPN delta of 0.2)."""
    want = np.asarray(want)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=name)


def _assert_stages(jmodel, jvars, tmodel, images, name):
    """Each stage fed the JAX stage's own output, compared with ``_close``."""
    jfeat = _apply(jmodel, jvars, jnp.asarray(images), method=JFasterRCNN.extract_features)
    with torch.inference_mode():
        tfeat = tmodel.extract_features(torch.from_numpy(images))
    _close(tfeat.numpy(), jfeat, name)
    jl, jd, ja = _apply(jmodel, jvars, jfeat, method=JFasterRCNN.rpn_forward)
    feat_np = np.array(jfeat)
    with torch.inference_mode():
        tl, td, ta = tmodel.rpn_forward(torch.from_numpy(feat_np))
    _close(tl.numpy(), jl, name)
    _close(td.numpy(), jd, name)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    jrois, _ = j_batched_proposals(ja, jl, jd, 96.0, 96.0, jmodel.config.proposals, False)
    jc, jr = _apply(jmodel, jvars, jfeat, jrois, 96.0, 96.0, method=JFasterRCNN.head_forward)
    with torch.inference_mode():
        tc, tr = tmodel.head_forward(torch.from_numpy(feat_np), torch.from_numpy(np.array(jrois)),
                                     96.0, 96.0)
    _close(tc.numpy(), jc, name)
    _close(tr.numpy(), jr, name)
    return tc


def test_presets_match_jax():
    """The presets beside ``voc12_resnet18_align`` at 96x96 in float32 from
    bridged weights (tolerances as in the module docstring): the flagship
    ``voc_resnet18`` (ROIPool head) stage by stage and its whole program
    against JAX ``make_infer_fn``; ``voc_resnet50`` (Bottleneck, ROIPool),
    ``coco_resnet50`` (ROIAlign, 81 classes) and ``coco_vgg16`` (VGG16
    trunk, 512-wide RPN, 12 anchors, fc6/fc7 tail, ROIPool, 81 classes)
    stage by stage in eval mode (``_close``; detections as in
    ``test_make_infer_fn_matches_jax``); ``voc_resnet50_fpn``'s sections
    equal JAX's over the port's fields; the weight bridge round-trips every
    preset's JAX tree bitwise; and the VGG16 tail's dropout is the identity
    in eval mode and drops about half from a seeded generator in train
    mode."""
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (2,) + SIZE + (3,), dtype=np.uint8)
    # voc_resnet50_fpn: every section equals JAX's over the port's fields
    # (its model is held against JAX's in tests/test_torch_fpn.py)
    for section in ("model", "anchors", "data", "serving", "fleet", "telemetry"):
        tsec = getattr(tconfig.get_config("voc_resnet50_fpn"), section)
        jsec = getattr(jconfig.get_config("voc_resnet50_fpn"), section)
        for field in dataclasses.fields(tsec):
            assert getattr(tsec, field.name) == getattr(jsec, field.name), (section, field.name)
    assert tconfig.get_config("voc_resnet50_fpn").model.fpn
    heads = {}
    for name in ("voc_resnet18", "voc_resnet50", "coco_resnet50", "coco_vgg16",
                 "voc12_resnet18_align"):
        # the preset's data pipeline is JAX's, field for field (the flip, the
        # root_dir), over the fields the port has
        jdata, tdata = jconfig.get_config(name).data, tconfig.get_config(name).data
        for field in dataclasses.fields(tdata):
            assert getattr(tdata, field.name) == getattr(jdata, field.name), (name, field.name)
        # and its serving, fleet and telemetry settings, over the port's fields
        for section in ("serving", "fleet", "telemetry"):
            tsec = getattr(tconfig.get_config(name), section)
            jsec = getattr(jconfig.get_config(name), section)
            for field in dataclasses.fields(tsec):
                assert getattr(tsec, field.name) == getattr(jsec, field.name), (
                    name, section, field.name)
        jcfg, tcfg, jmodel, raw, variables, tmodel = _preset_pair(name, rng)
        _assert_round_trip(raw, name)
        if name == "voc12_resnet18_align":  # its stages: test_stages_match
            continue
        jvars = jax.tree_util.tree_map(jnp.asarray, variables)
        heads[name] = _assert_stages(jmodel, jvars, tmodel, images, name)
        if name == "voc_resnet18":
            want = jax.jit(j_make_infer_fn(jmodel, jcfg))(jvars, jnp.asarray(images))
            got = make_infer_fn(tmodel, tcfg)(torch.from_numpy(images))
            np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
            np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
            np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0,
                                       atol=1e-2)
            np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0,
                                       atol=1e-4)
            assert np.asarray(want["valid"]).sum() > 0
        if name == "coco_vgg16":
            _assert_vgg_dropout(tmodel.head.tail)
        del jmodel, raw, variables, tmodel
    assert heads["coco_resnet50"].shape[-1] == 81 and heads["coco_vgg16"].shape[-1] == 81
    assert heads["voc_resnet50"].shape[-1] == 21


def _assert_vgg_dropout(tail):
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (6, 7, 7, 512)).astype(np.float32))
    plain = F.relu(tail.fc7(F.relu(tail.fc6(x.reshape(6, -1)))))
    with torch.no_grad():
        assert torch.equal(tail.eval()(x), plain)
        tail.train()
        with pytest.raises(ValueError):
            tail(x)
        out = tail(x, torch.Generator().manual_seed(5))
        assert torch.equal(out, tail(x, torch.Generator().manual_seed(5)))
        gen = torch.Generator().manual_seed(5)  # the same draws, by hand
        h = F.relu(tail.fc6(x.reshape(6, -1)))
        keep6 = torch.rand(h.shape, generator=gen) < 0.5
        h = F.relu(tail.fc7(torch.where(keep6, h / 0.5, 0.0)))
        keep7 = torch.rand(h.shape, generator=gen) < 0.5
        assert torch.equal(out, torch.where(keep7, h / 0.5, 0.0))
    for keep in (keep6, keep7):
        assert abs(keep.float().mean().item() - 0.5) < 0.01
    tail.eval()
