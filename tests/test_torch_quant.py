"""Parity of the PyTorch port's int8 serving slice with the JAX package on the
CPU, on inputs made from numpy seeds: the int8 ops against the JAX package's
Pallas kernels run in interpret mode, calibration and the sidecar against
the JAX ``quant`` package, and the int8 inference function (and the engine's
int8 mode) against the JAX ``make_int8_infer_fn``.

``ops/pallas/__init__.py`` does not import under this jax, so
``quant_kernel.py`` is loaded by its file path (it imports only jax, jnp and
pallas); nothing in the JAX package changes for that.

Tolerances, with their reasons:

* ``int8_matmul`` and ``dequantize``: bitwise (integer products do not
  round; the dequantize is one float32 multiply).
* ``quantize_activation``: bitwise (a true division and round half to even
  on both sides). ``quant_dense``: rtol/atol 1e-6, the JAX test's own:
  jitted XLA:CPU may contract the rescale and the bias add into an FMA.
* Calibration: weight scales and int8 leaves bitwise (the same numpy
  arithmetic on the same bits); the activation range rtol 1e-5 (the trunk's
  convolutions sum in other orders in oneDNN and XLA:CPU).
* The int8 forward: rois to 1e-3 px and ``valid`` equal, as in
  ``test_torch_model.py``. cls/reg within 1e-4 plus two activation
  quantization steps: the embeddings differ by convolution summation order,
  so an element on a rounding boundary of ``x / x_scale`` can quantize one
  step apart, which moves an output by at most
  ``x_scale * max|w_q * w_scale|``.
* Sensitivity: the same plan; recon errors within rtol 1e-3.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replication_faster_rcnn_tpu import config as jconfig
from replication_faster_rcnn_tpu import quant as jquant
from replication_faster_rcnn_tpu.models.faster_rcnn import init_variables
from replication_faster_rcnn_tpu.ops import quant_ops as jquant_ops
from replication_faster_rcnn_tpu.quant.sensitivity import sweep as j_sweep
from replication_faster_rcnn_tpu.train.warmup import make_int8_infer_fn as j_make_int8_infer_fn
from replication_faster_rcnn_tpu_torch import config as tconfig
from replication_faster_rcnn_tpu_torch import quant as tquant
from replication_faster_rcnn_tpu_torch.data.native_ops import resize_normalize
from replication_faster_rcnn_tpu_torch.eval.evaluator import make_int8_infer_fn
from replication_faster_rcnn_tpu_torch.models.convert import (
    from_flax_variables,
    kernel_to_flax,
    to_flax_variables,
)
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import (
    FasterRCNN,
    build_model,
    functional_forward,
)
from replication_faster_rcnn_tpu_torch.ops import quant_ops
from replication_faster_rcnn_tpu_torch.quant.calibrate import (
    activation_ranges,
    flatten_params,
    path_key,
    state_key,
)
from replication_faster_rcnn_tpu_torch.serving.engine import InferenceEngine
from tests.test_torch_model import _randomise

REPO = Path(__file__).resolve().parents[1]
SIZE = (64, 64)


def _pallas_quant_kernel():
    spec = importlib.util.spec_from_file_location(
        "_pallas_quant_kernel", REPO / "replication_faster_rcnn_tpu/ops/pallas/quant_kernel.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _int8(rng, shape):
    x = rng.integers(-128, 128, shape, dtype=np.int8)
    x.flat[:2] = (-128, 127)  # both extremes
    return x


def test_int8_ops_match_pallas_kernels():
    pk = _pallas_quant_kernel()
    rng = np.random.default_rng(0)
    # int8 GEMM: the odd shape of the JAX test and the serving head's b1 cls
    # and b8 reg shapes, over the whole int8 range
    for m, k, n in [(17, 70, 33), (300, 512, 21), (2400, 512, 84)]:
        x, w = _int8(rng, (m, k)), _int8(rng, (k, n))
        want = np.asarray(pk.quant_matmul_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True))
        np.testing.assert_array_equal(want, x.astype(np.int64) @ w.astype(np.int64))
        got = quant_ops.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # the port's Linear layout: w as the .t() view of an [N, K] weight
        wt = torch.from_numpy(np.ascontiguousarray(w.T))
        np.testing.assert_array_equal(quant_ops.int8_matmul(torch.from_numpy(x), wt.t()).numpy(),
                                      want)
    # dequantize: HWIO conv and [in, out] dense weights (channel last, the
    # Pallas contract), and the same weights in the port's OIHW / [out, in]
    for shape in [(3, 3, 64, 64), (7, 7, 3, 64), (512, 84), (1, 1, 128, 256)]:
        w_q = _int8(rng, shape)
        scale = rng.uniform(1e-4, 0.1, shape[-1]).astype(np.float32)
        want = np.array(pk.dequantize_pallas(jnp.asarray(w_q), jnp.asarray(scale),
                                             interpret=True))
        got = quant_ops.dequantize(torch.from_numpy(w_q), torch.from_numpy(scale))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        port = torch.from_numpy(np.ascontiguousarray(np.moveaxis(w_q, -1, 0)))
        for dtype in (torch.float32, torch.bfloat16):
            out = quant_ops.dequantize(port, torch.from_numpy(scale), channel_axis=0,
                                       out_dtype=dtype)
            assert out.dtype == dtype
            np.testing.assert_array_equal(
                np.moveaxis(out.float().numpy(), 0, -1),
                torch.from_numpy(want).to(dtype).float().numpy(),
            )
    with pytest.raises(ValueError):
        quant_ops.dequantize(torch.from_numpy(_int8(rng, (4, 5))), torch.ones(4))
    # dequantize_many: leaf by leaf the Pallas kernel's output, in the JAX
    # layout and in the port's (a zero-element leaf and mixed ranks among them)
    shapes = [(3, 3, 64, 64), (7,), (512, 84), (0, 5), (1, 1, 128, 256), (5, 1, 1, 3)]
    w_qs = [_int8(rng, shape) if np.prod(shape) else np.zeros(shape, np.int8) for shape in shapes]
    scales = [rng.uniform(1e-4, 0.1, shape[-1]).astype(np.float32) for shape in shapes]
    wants = [np.array(pk.dequantize_pallas(jnp.asarray(w), jnp.asarray(s), interpret=True))
             if w.size else np.zeros(w.shape, np.float32) for w, s in zip(w_qs, scales)]
    got = quant_ops.dequantize_many(
        [(torch.from_numpy(w), torch.from_numpy(s), -1) for w, s in zip(w_qs, scales)])
    for out, want in zip(got, wants):
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), want)
    port = [(torch.from_numpy(np.ascontiguousarray(np.moveaxis(w, -1, 0))), torch.from_numpy(s), 0)
            for w, s in zip(w_qs, scales)]
    for dtype in (torch.float32, torch.bfloat16):
        for out, want in zip(quant_ops.dequantize_many(port, dtype), wants):
            assert out.dtype == dtype
            np.testing.assert_array_equal(np.moveaxis(out.float().numpy(), 0, -1),
                                          torch.from_numpy(want).to(dtype).float().numpy())
    assert quant_ops.dequantize_many([]) == []
    # activation quantization bitwise, quant_dense within the JAX test's 1e-6
    j_quant_dense = jax.jit(jquant_ops.quant_dense)
    for lead, k, n in [((300,), 512, 21), ((3, 5), 16, 6), ((2400,), 512, 84)]:
        x = rng.normal(0, 2, lead + (k,)).astype(np.float32)
        w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
        bias = rng.normal(0, 0.1, n).astype(np.float32)
        w_q, w_scale = jquant_ops.quantize_channelwise(jnp.asarray(w))
        tw_q, tw_scale = quant_ops.quantize_channelwise(torch.from_numpy(w))
        np.testing.assert_array_equal(tw_q.numpy(), np.asarray(w_q))
        np.testing.assert_array_equal(tw_scale.numpy(), np.asarray(w_scale))
        x_scale = np.float32(max(float(np.abs(x).max()), 1e-12) / 127.0)
        np.testing.assert_array_equal(
            quant_ops.quantize_activation(torch.from_numpy(x), x_scale).numpy(),
            np.asarray(jquant_ops.quantize_activation(jnp.asarray(x), jnp.float32(x_scale))),
        )
        want = np.asarray(j_quant_dense(jnp.asarray(x), w_q, w_scale, jnp.float32(x_scale),
                                        jnp.asarray(bias)))
        got = quant_ops.quant_dense(torch.from_numpy(x), torch.from_numpy(np.array(w_q)),
                                    tw_scale, torch.tensor(x_scale), torch.from_numpy(bias))
        assert got.shape == lead + (n,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # weight-only quantized conv: the JAX NHWC/HWIO op against the port's
    # NCHW/OIHW one (the same dequantized weights; convolution sums in
    # other orders, so float tolerance)
    x = rng.normal(0, 1, (2, 9, 7, 16)).astype(np.float32)
    w_q, w_scale = _int8(rng, (3, 3, 16, 8)), rng.uniform(1e-3, 0.02, 8).astype(np.float32)
    want = np.asarray(jquant_ops.quant_conv(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_scale)))
    got = quant_ops.quant_conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                               torch.from_numpy(np.ascontiguousarray(w_q.transpose(3, 2, 0, 1))),
                               torch.from_numpy(w_scale), padding=1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the slice


def _configs():
    jcfg = jconfig.get_config("voc12_resnet18_align")
    jcfg = jcfg.replace(
        model=dataclasses.replace(jcfg.model, compute_dtype="float32"),
        data=dataclasses.replace(jcfg.data, image_size=SIZE),
    )
    tcfg = tconfig.get_config("voc12_resnet18_align")
    tcfg = tcfg.replace(
        model=dataclasses.replace(tcfg.model, compute_dtype="float32"),
        data=dataclasses.replace(tcfg.data, image_size=SIZE),
        serving=dataclasses.replace(tcfg.serving, resolutions=(SIZE,), batch_sizes=(1, 2),
                                    params_dtype="int8", max_delay_ms=500.0),
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tiny():
    """ResNet18/align at 64x64 with float32 compute: JAX weights (BatchNorm
    statistics and head weights randomised with numpy, as in
    test_torch_model.py) bridged to the port, and the JAX calibration
    artifact over two synthetic batches."""
    jcfg, tcfg = _configs()
    jmodel, variables = init_variables(jcfg, jax.random.PRNGKey(0))
    variables = _randomise(jax.tree_util.tree_map(np.array, dict(variables)),
                           np.random.default_rng(0))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    state = from_flax_variables(variables)
    batches = jquant.synthetic_calibration_batches(jcfg, batches=2, batch_size=1)
    artifact = jquant.calibrate(jmodel, jvars, batches, jcfg)
    tmodel = build_model(tcfg, device="cpu", state_dict=state)
    return {"jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel, "jvars": jvars, "state": state,
            "tmodel": tmodel, "batches": batches, "artifact": artifact}


def test_calibration_and_sidecar_match_jax(tiny, tmp_path):
    state, artifact = tiny["state"], tiny["artifact"]
    # weight scales and the calibration artifact: the JAX package's keys and bits
    params = to_flax_variables(state)["params"]
    scales = tquant.weight_scales(params)
    assert sorted(scales) == sorted(artifact["weight_scales"])
    for key, s in scales.items():
        np.testing.assert_array_equal(s, artifact["weight_scales"][key])
    port_art = tquant.calibrate(tiny["tmodel"], state, tiny["batches"], tiny["tcfg"])
    assert port_art["groups"] == artifact["groups"] and port_art["plan"] == artifact["plan"]
    assert port_art["calib"] == artifact["calib"]
    for key, s in port_art["weight_scales"].items():
        np.testing.assert_array_equal(s, artifact["weight_scales"][key])
    key = tquant.EMBED_RANGE_KEY
    np.testing.assert_allclose(port_art["activation_ranges"][key],
                               artifact["activation_ranges"][key], rtol=1e-5)
    assert sum(len(v) for v in artifact["groups"].values()) == 25

    # the resident tree: int8 leaves, scales and quant entries bitwise; the
    # other float leaves rounded to bfloat16 as the JAX tree is
    jres = jquant.quantize_variables(tiny["jvars"], artifact)
    tres = tquant.quantize_variables(state, artifact)
    jflat = dict(flatten_params(jax.tree_util.tree_map(np.asarray, jres["params"])))
    n_int8 = 0
    for path, leaf in jflat.items():
        if leaf.dtype == np.int8:
            n_int8 += 1
            got = tres["params"][state_key(path)]
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(kernel_to_flax(got.numpy()), leaf)
            if path[-2] in ("cls", "reg"):
                entry = tres["quant"]["head"][path[-2]]
                jentry = jres["quant"]["head"][path[-2]]
                np.testing.assert_array_equal(entry["w_scale"].numpy(), np.asarray(jentry["w_scale"]))
                assert entry["x_scale"].dtype == torch.float32
                assert float(entry["x_scale"]) == float(jentry["x_scale"])
            else:
                np.testing.assert_array_equal(tres["qscales"][state_key(path)].numpy(),
                                              np.asarray(jres["qscales"][path_key(path)]))
    assert n_int8 == 25 and len(tres["qscales"]) == 23
    back = to_flax_variables({k: v.float() for k, v in tres["params"].items()})
    for collection in ("params", "batch_stats"):
        want = dict(flatten_params(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jres[collection])))
        got = dict(flatten_params(back[collection]))
        assert sorted(got) == sorted(want)
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path], leaf)
    assert all(v.dtype in (torch.int8, torch.bfloat16) for v in tres["params"].values())
    f32_bytes = sum(v.numel() * 4 for v in state.values())
    assert tquant.quantized_params_bytes(tres) == jquant.quantized_params_bytes(jres)
    assert tquant.quantized_params_bytes(tres) < 0.4 * f32_bytes

    # the sidecar, both ways: identical bytes for the same artifact dict
    j_path, t_path = tmp_path / "jax.json", tmp_path / "port.json"
    jquant.save_artifact(str(j_path), artifact)
    tquant.save_artifact(str(t_path), artifact)
    assert j_path.read_bytes() == t_path.read_bytes()
    for loaded in (tquant.load_artifact(str(j_path)), jquant.load_artifact(str(t_path))):
        assert loaded["plan"] == artifact["plan"] and loaded["groups"] == artifact["groups"]
        assert loaded["activation_ranges"] == artifact["activation_ranges"]
        for k, s in artifact["weight_scales"].items():
            np.testing.assert_array_equal(loaded["weight_scales"][k], s)
    again = tmp_path / "again.json"
    tquant.save_artifact(str(again), tquant.load_artifact(str(j_path)))
    assert again.read_bytes() == j_path.read_bytes()
    # a flipped CRC and a missing sidecar raise, in the loader and the engine
    bad = tmp_path / "bad.json"
    bad.write_text(t_path.read_text().replace('"crc32":', '"crc32":1', 1))
    with pytest.raises(tquant.QuantArtifactError, match="CRC"):
        tquant.load_artifact(str(bad))
    with pytest.raises(tquant.QuantArtifactError, match="frcnn quantize"):
        tquant.load_artifact(str(tmp_path / "missing.json"))
    for path in (bad, tmp_path / "missing.json"):
        with pytest.raises(tquant.QuantArtifactError):
            InferenceEngine(tiny["tcfg"], device="cpu", state_dict=state, artifact_path=str(path))

    # int8 FPN is not ported: calibration, quantize and the int8 engine of an
    # FPN model refuse it by name (the model has no head.tail to hook)
    fcfg = tiny["tcfg"].replace(model=dataclasses.replace(
        tconfig.get_config("voc_resnet50_fpn").model, backbone="resnet18",
        compute_dtype="float32"), anchors=tconfig.get_config("voc_resnet50_fpn").anchors)
    fpn = build_model(fcfg, device="cpu")
    fstate = fpn.state_dict()
    for refused in (lambda: tquant.calibrate(fpn, fstate, tiny["batches"][:1], fcfg),
                    lambda: activation_ranges(fpn, fstate, tiny["batches"][:1]),
                    lambda: tquant.quantize_variables(fstate, artifact),
                    lambda: InferenceEngine(fcfg, device="cpu", state_dict=fstate,
                                            artifact_path=str(t_path))):
        with pytest.raises(ValueError, match="int8 serving of an FPN model is not ported"):
            refused()


def test_int8_slice_matches_jax(tiny, tmp_path):
    jcfg, tcfg, state, artifact = tiny["jcfg"], tiny["tcfg"], tiny["state"], tiny["artifact"]
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (2,) + SIZE + (3,), dtype=np.uint8)
    jres = jquant.quantize_variables(tiny["jvars"], artifact)
    tres = tquant.quantize_variables(state, artifact)
    meta = FasterRCNN(tcfg, device="meta")

    # the forward from the reconstructed variables: rois, valid, cls, reg
    jinfer_vars = jquant.build_infer_variables(jres, jcfg)
    jout = jax.jit(lambda v, x: tiny["jmodel"].apply(v, x, train=False))(
        jinfer_vars, jnp.asarray(images))
    tvars = tquant.build_infer_variables(tres, tcfg)
    assert "dequantize_tables" not in tres  # the CPU path keeps no kernel table
    assert all(v.dtype != torch.int8 or k in ("head.cls.weight", "head.reg.weight")
               for k, v in tvars["params"].items())
    tout = functional_forward(meta, tvars["params"], torch.from_numpy(images), tvars["quant"])
    _, _, jrois, jvalid, jcls, jreg, _ = (np.asarray(a) for a in jout)
    _, _, trois, tvalid, tcls, treg, _ = (a.numpy() for a in tout)
    np.testing.assert_array_equal(tvalid, jvalid)
    np.testing.assert_allclose(trois, jrois, rtol=0, atol=1e-3)
    x_scale = float(tres["quant"]["head"]["cls"]["x_scale"])
    for name, got, want in (("cls", tcls, jcls), ("reg", treg, jreg)):
        q = tres["quant"]["head"][name]
        w = tres["params"][f"head.{name}.weight"].float() * q["w_scale"][:, None]
        step = x_scale * float(w.abs().max())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 + 2 * step)
        assert np.mean(np.abs(got - want) > 1e-4) < 0.01, name

    # the whole program against the JAX make_int8_infer_fn
    want = jax.jit(j_make_int8_infer_fn(tiny["jmodel"], jcfg))(jres, jnp.asarray(images))
    infer = make_int8_infer_fn(meta, tcfg)
    got = infer(tres, torch.from_numpy(images))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-2)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-4)
    assert np.asarray(want["valid"]).sum() > 0

    # the engine's int8 mode: the resident tree, params_bytes, and the same
    # detections as the inference function on the same padded batch
    path = tmp_path / "quant_artifact.json"
    jquant.save_artifact(str(path), artifact)
    with InferenceEngine(tcfg, device="cpu", state_dict=state, artifact_path=str(path)) as eng:
        assert eng.params_dtype == "int8" and eng.model.trunk.conv1.weight.is_meta
        assert eng.params_bytes == tquant.quantized_params_bytes(tres)
        assert eng.params_bytes < 0.4 * sum(v.numel() * 4 for v in state.values())
        served = eng.predict(list(images))
        ref = eng.predict(list(images), reference=True)
    assert [n for _, n in eng.flush_log] == [2, 2]
    batch = np.stack([resize_normalize(img, SIZE, tcfg.data.pixel_mean, tcfg.data.pixel_std)
                      for img in images])
    direct = infer(tres, torch.from_numpy(batch))
    for i, (res, plain) in enumerate(zip(served, ref)):
        for k in ("boxes", "scores", "classes", "valid"):
            np.testing.assert_array_equal(res[k], direct[k][i].numpy())
            np.testing.assert_array_equal(plain[k], res[k])

    # the sensitivity sweep: the same plan as JAX's, the hostile head (its
    # calibrated scales poisoned x1000, the JAX test's injection) to bfloat16
    hostile = dict(artifact)
    hostile["weight_scales"] = dict(artifact["weight_scales"])
    for p in hostile["groups"]["head"]:
        hostile["weight_scales"][p] = hostile["weight_scales"][p] * 1000.0
    jplan = j_sweep(tiny["jmodel"], tiny["jvars"], dict(hostile), tiny["batches"][:1], jcfg)
    tplan = tquant.sweep(tiny["tmodel"], state, dict(hostile), tiny["batches"][:1], tcfg)
    assert tplan["plan"] == jplan["plan"] and tplan["plan"]["head"] == "bfloat16"
    assert "int8" in tplan["plan"].values()
    for group, rec in jplan["sensitivity"].items():
        np.testing.assert_allclose(tplan["sensitivity"][group]["recon_rel_err"],
                                   rec["recon_rel_err"], rtol=1e-3)
    # the plan reaches the resident tree: the head stays bfloat16, no GEMM
    demoted = tquant.quantize_variables(state, tplan)
    assert "quant" not in demoted and demoted["params"]["head.cls.weight"].dtype == torch.bfloat16
