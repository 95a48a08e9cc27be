"""The PyTorch port's serving layer on the CPU at tiny buckets: bucket
routing, padding and un-padding, box de-normalisation, micro-batch
coalescing, the host resize against the JAX package's numpy spec, and the
flax <-> torch weights bridge round trip (bitwise)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from replication_faster_rcnn_tpu import config as jconfig
from replication_faster_rcnn_tpu.data.native_ops import _resize_normalize_numpy
from replication_faster_rcnn_tpu.models.faster_rcnn import init_variables
from replication_faster_rcnn_tpu.serving.engine import select_bucket as j_select_bucket
from replication_faster_rcnn_tpu_torch import config as tconfig
from replication_faster_rcnn_tpu_torch.data.native_ops import resize_normalize
from replication_faster_rcnn_tpu_torch.eval.evaluator import make_infer_fn
from replication_faster_rcnn_tpu_torch.models.convert import (
    from_flax_variables,
    to_flax_variables,
)
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model
from replication_faster_rcnn_tpu_torch.serving.batcher import DeadlineExceeded, MicroBatcher
from replication_faster_rcnn_tpu_torch.serving.engine import (
    InferenceEngine,
    OversizedImageError,
    select_bucket,
)

BUCKETS = ((32, 32), (64, 64))


def _cfg(params_dtype="float32", max_delay_ms=500.0):
    cfg = tconfig.get_config("voc12_resnet18_align")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, image_size=(64, 64)),
        serving=dataclasses.replace(
            cfg.serving, resolutions=BUCKETS, batch_sizes=(1, 2, 4),
            params_dtype=params_dtype, max_delay_ms=max_delay_ms,
        ),
    )


@pytest.fixture(scope="module")
def engine():
    eng = InferenceEngine(_cfg(), device="cpu", seed=3)
    yield eng
    eng.close()


def _images(rng, shapes):
    return [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in shapes]


def test_select_bucket_matches_jax():
    # one test id walks the cases (each test id costs the fast tier's budget)
    for hw, want in [((20, 30), (32, 32)), ((32, 32), (32, 32)), ((33, 10), (64, 64)),
                     ((64, 64), (64, 64)), ((90, 40), (64, 64))]:
        assert select_bucket(BUCKETS, *hw) == want == j_select_bucket(BUCKETS, *hw), hw


def test_select_bucket_reject():
    with pytest.raises(OversizedImageError):
        select_bucket(BUCKETS, 65, 10, oversize="reject")


def test_resize_normalize_matches_jax_spec():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    want = _resize_normalize_numpy(
        img, (64, 48), np.asarray(mean, np.float32), np.asarray(std, np.float32)
    )
    np.testing.assert_array_equal(resize_normalize(img, (64, 48), mean, std), want)


def test_engine_coalesces_pads_and_denormalises(engine):
    """Three 64-bucket requests coalesce into one flush padded to 4; each
    result equals the inference function on that padded batch with boxes
    scaled back to the request's own size."""
    rng = np.random.default_rng(1)
    shapes = [(50, 60), (64, 64), (40, 64)]
    imgs = _images(rng, shapes)
    log0, stats0 = len(engine.flush_log), engine.stats
    results = engine.predict(imgs)
    assert engine.flush_log[log0:] == [(((64, 64), False), 3)]
    stats = engine.stats
    assert stats["flushes"] - stats0["flushes"] == 1
    assert stats["padded_slots"] - stats0["padded_slots"] == 1

    cfg = engine.config
    batch = np.zeros((4, 64, 64, 3), np.float32)
    for i, img in enumerate(imgs):
        batch[i] = resize_normalize(img, (64, 64), cfg.data.pixel_mean, cfg.data.pixel_std)
    want = make_infer_fn(engine.model, cfg, (64, 64))(torch.from_numpy(batch))
    for i, ((h, w), res) in enumerate(zip(shapes, results)):
        back = np.asarray([h / 64, w / 64, h / 64, w / 64], np.float32)
        np.testing.assert_array_equal(res["boxes"], want["boxes"][i].numpy() * back)
        np.testing.assert_array_equal(res["scores"], want["scores"][i].numpy())
        np.testing.assert_array_equal(res["classes"], want["classes"][i].numpy())
        np.testing.assert_array_equal(res["valid"], want["valid"][i].numpy())
        assert res["boxes"].shape == (cfg.eval.max_detections, 4)
        assert (res["boxes"][:, 0::2] <= h + 1e-4).all() and (res["boxes"][:, 1::2] <= w + 1e-4).all()


def test_engine_routes_buckets_and_reference_key(engine):
    rng = np.random.default_rng(2)
    small, big = _images(rng, [(20, 30), (60, 33)])
    log0 = len(engine.flush_log)
    f_small = engine.submit(small)
    f_big = engine.submit(big, reference=True)
    r_small, r_big = f_small.result(timeout=60), f_big.result(timeout=60)
    assert sorted(engine.flush_log[log0:]) == [(((32, 32), False), 1), (((64, 64), True), 1)]
    plain = engine.predict([big])[0]  # CPU tensors run the plain versions anyway
    for k in plain:
        np.testing.assert_array_equal(plain[k], r_big[k])
    assert r_small["scores"].shape == (engine.config.eval.max_detections,)


def test_engine_float_input_and_validation(engine):
    rng = np.random.default_rng(3)
    with pytest.raises(ValueError, match="matches no serving bucket"):
        engine.submit(np.zeros((40, 40, 3), np.float32))
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        engine.submit(np.zeros((40, 40), np.uint8))
    cfg = engine.config
    img = resize_normalize(_images(rng, [(32, 32)])[0], (32, 32), cfg.data.pixel_mean,
                           cfg.data.pixel_std)
    res = engine.submit(img, orig_size=(64, 96)).result(timeout=60)
    raw = make_infer_fn(engine.model, cfg, (32, 32))(torch.from_numpy(img[None]))
    np.testing.assert_array_equal(
        res["boxes"], raw["boxes"][0].numpy() * np.asarray([2, 3, 2, 3], np.float32)
    )


def test_engine_bf16_residency():
    eng = InferenceEngine(_cfg(params_dtype="bfloat16"), device="cpu", seed=3)
    try:
        assert all(p.dtype == torch.bfloat16 for p in eng.model.parameters())
        f32 = InferenceEngine(_cfg(), device="cpu", seed=3)
        f32.close()
        assert eng.params_bytes * 2 == f32.params_bytes
        res = eng.predict(_images(np.random.default_rng(4), [(64, 64)]))[0]
        assert np.isfinite(res["boxes"]).all() and np.isfinite(res["scores"]).all()
    finally:
        eng.close()


# ------------------------------------------------------------- batcher


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_batcher_size_and_deadline_flushes():
    clock = _Clock()
    seen = []
    b = MicroBatcher(lambda k, items: seen.append((k, list(items))) or [i * 10 for i in items],
                     max_batch=3, max_delay_s=1.0, clock=clock, start=False)
    futs = [b.submit("a", i) for i in range(3)] + [b.submit("b", 7)]
    for _ in range(4):
        b._service_once(block=False)
    assert seen == [("a", [0, 1, 2])]  # size trigger
    clock.t = 2.0
    b._service_once(block=False)
    assert seen[-1] == ("b", [7])  # deadline trigger
    assert [f.result() for f in futs] == [0, 10, 20, 70]
    assert b.flush_log == [("a", 3), ("b", 1)]
    b.close()


def test_batcher_deadline_drop_and_error_relay():
    clock = _Clock()

    def process(key, items):
        if key == "bad":
            raise ValueError("boom")
        return items

    b = MicroBatcher(process, max_batch=2, max_delay_s=5.0, clock=clock, start=False)
    late = b.submit("x", 1, deadline_s=1.0)
    bad = [b.submit("bad", 1), b.submit("bad", 2)]
    clock.t = 10.0
    for _ in range(3):
        b._service_once(block=False)
    with pytest.raises(DeadlineExceeded):
        late.result()
    for f in bad:
        with pytest.raises(ValueError, match="boom"):
            f.result()
    assert b.expired_total == 1
    b.close()
    with pytest.raises(RuntimeError):
        b.submit("x", 1)


def test_batcher_threaded_close_drains():
    b = MicroBatcher(lambda k, items: items, max_batch=100, max_delay_s=60.0)
    futs = [b.submit("k", i) for i in range(5)]
    b.close()
    assert [f.result(timeout=10) for f in futs] == list(range(5))


# --------------------------------------------------------------- bridge


def test_bridge_round_trip_bitwise():
    """flax -> torch -> flax numpy is bitwise, and the torch side loads
    strictly into the port's model (every name and shape matches)."""
    jcfg = jconfig.get_config("voc12_resnet18_align")
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, image_size=(64, 64)))
    _, variables = init_variables(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    flax_np = jax.tree_util.tree_map(
        lambda x: rng.normal(0, 1, np.shape(x)).astype(np.float32), dict(variables)
    )
    state = from_flax_variables(flax_np)
    model = build_model(_cfg(), device="cpu", state_dict=state)
    assert set(model.state_dict()) == set(state)
    back = to_flax_variables(model.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(flax_np)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
