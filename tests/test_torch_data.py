"""Parity of the PyTorch port's training data path with the JAX package, on
the CPU, at small sizes (batches of 2-4, 64x80 and 96x96 canvases, uint8
and float32), inputs made with numpy from seeds. Two test ids: each walks
its cases in a loop (every test id costs the fast tier's budget).

Tolerances, with their reasons:

* ``data/augment.py``, ``data/cache.py``, ``data/coco.py``, the uint8
  samples of ``data/voc.py`` and ``data/synthetic.py``, the loader's
  augmented batches, ``CachedSampler`` and ``DevicePrefetcher``: bitwise
  (the same numpy; the JAX side resizes with its numpy specification, which
  the port's C++ resize matches bitwise).
* ``ops/image.py`` against JAX ``ops/image.py``, the jitter and
  ``augment_batch`` run op by op under ``jax.disable_jit()`` (the draws,
  the flip and the translation, which have no product to contract, jitted):
  draws, flip bits, geometry, boxes, labels and masks bitwise; uint8 images within 1 count (the fills: JAX's float32 mean
  against the port's exact int64 sum), and bitwise where no fill is read;
  float32 images within rtol 1e-6 / atol 1e-6 (the fills: XLA's float32
  mean against the port's float64 sum). Against the jitted JAX
  ``augment_batch`` the same but float32 images within atol 2e-5 (XLA:CPU
  contracts the bilinear's products and sums into FMAs; ROADMAP Queue C),
  and the rows whose geometry differs are counted and pinned (it may
  contract ``lo + (hi - lo) * u`` too).
* ``augment_prepare_plain`` (the prepare kernel's plain version) against
  the op-by-op JAX ``augment_batch``: boxes, labels and masks bitwise; its
  fills against JAX's float32 means of the flipped and the translated image
  within 1 count (uint8) or rtol 1e-6 / atol 1e-6 (float32), the image
  tolerances' reasons.
* The bucket resample against ``jax.image.resize``: float32 within 1e-5 of
  the batch's largest magnitude, uint8 within 1 count; boxes bitwise.
* ``materialize_batch`` against JAX's: bitwise.
* The loader's process workers (``worker_mode="process"``) against the
  thread loader and JAX's process loader, and ``fetch_sample``'s retry,
  substitution and skip budget against JAX's: the same batches bitwise, the
  same ``on_skip`` calls and error texts.
* Trainer runs on the CPU: prefetch on and off, a resume with prefetch, the
  cached and the loader-fed ``augment_scale_device`` runs, the process and
  the thread loader: bitwise in the whole state. The ``augment_device`` step against JAX's jitted step on the
  same batch with the JAX step's draws injected: the losses within rtol
  1e-5, the step tolerance of ``tests/test_torch_train.py``.
"""

import dataclasses
import json
import os
import signal
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replication_faster_rcnn_tpu import config as jconfig
from replication_faster_rcnn_tpu.data import augment as j_augment
from replication_faster_rcnn_tpu.data import native_ops as j_native
from replication_faster_rcnn_tpu.data.cache import CachedView as JCachedView
from replication_faster_rcnn_tpu.data.coco import COCODataset as JCOCODataset
from replication_faster_rcnn_tpu.data.device_cache import CachedSampler as JCachedSampler
from replication_faster_rcnn_tpu.data.device_cache import DeviceCache as JDeviceCache
from replication_faster_rcnn_tpu.data.device_cache import materialize_batch as j_materialize
from replication_faster_rcnn_tpu.data.device_cache import stack_selections as j_stack
from replication_faster_rcnn_tpu.data.loader import DataLoader as JDataLoader
from replication_faster_rcnn_tpu.data.loader import collate as j_collate
from replication_faster_rcnn_tpu.data.loader import fetch_sample as j_fetch_sample
from replication_faster_rcnn_tpu.faultlib import failpoints as j_failpoints
from replication_faster_rcnn_tpu.data.prefetch_device import DevicePrefetcher as JPrefetcher
from replication_faster_rcnn_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from replication_faster_rcnn_tpu.data.voc import VOCDataset as JVOCDataset
from replication_faster_rcnn_tpu.ops import image as j_image
from replication_faster_rcnn_tpu.train import create_train_state
from replication_faster_rcnn_tpu.train.train_step import make_optimizer as j_make_optimizer
from replication_faster_rcnn_tpu.train.train_step import make_train_step as j_make_train_step
from replication_faster_rcnn_tpu.train.trainer import Trainer as JTrainer
from replication_faster_rcnn_tpu.telemetry import spans as j_spans
from replication_faster_rcnn_tpu_torch import config as tconfig
from replication_faster_rcnn_tpu_torch.data import augment as t_augment
from replication_faster_rcnn_tpu_torch.data import native_ops as t_native
from replication_faster_rcnn_tpu_torch.data import prefetch_device
from replication_faster_rcnn_tpu_torch.data.cache import CachedView
from replication_faster_rcnn_tpu_torch.data.coco import COCODataset
from replication_faster_rcnn_tpu_torch.data.device_cache import (
    CachedSampler,
    DeviceCache,
    materialize_batch,
    stack_selections,
)
from replication_faster_rcnn_tpu_torch.data.loader import (
    DataLoader,
    collate,
    fetch_sample,
    make_dataset,
)
from replication_faster_rcnn_tpu_torch.faultlib import failpoints
from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from replication_faster_rcnn_tpu_torch.data.voc import VOCDataset
from replication_faster_rcnn_tpu_torch.models.convert import from_flax_variables
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model
from replication_faster_rcnn_tpu_torch.ops import image as t_image
from replication_faster_rcnn_tpu_torch.telemetry import report, spans
from replication_faster_rcnn_tpu_torch.train import fault
from replication_faster_rcnn_tpu_torch.train.train_step import (
    DRAW_NAMES,
    TrainState,
    make_optimizer,
    make_train_step,
)
from replication_faster_rcnn_tpu_torch.train.trainer import Trainer

# rows whose jitter geometry the jitted JAX augment_batch computes
# differently from its op-by-op run, over _augment_inputs' cases (pinned)
JITTED_GEOMETRY_ROWS = 5


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _equal(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _same_sample(got, want, what):
    assert set(got) == set(want), (what, set(got), set(want))
    for k in want:
        _equal(got[k], want[k], f"{what}[{k}]")


def _image_close(got, want, what, fill_free=None, atol=1e-6):
    """uint8 within 1 count (bitwise where ``fill_free``), float32 within
    rtol 1e-6 / ``atol``."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == np.uint8:
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max(initial=0) <= 1, what
        if fill_free is not None:
            assert not diff[fill_free].any(), what
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol, err_msg=what)


def _images(rng, n, h, w, dtype):
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    return rng.normal(size=(n, h, w, 3)).astype(np.float32)


def _boxes(rng, n, g, h, w):
    p1 = rng.uniform(0, 0.8, (n, g, 2)) * [h, w]
    wh = rng.uniform(0.3, 0.5, (n, g, 2)) * [h, w]
    boxes = np.concatenate([p1, np.minimum(p1 + wh, [h, w])], -1).astype(np.float32)
    labels = rng.integers(1, 5, (n, g)).astype(np.int32)
    labels[:, -2:] = -1
    boxes[:, -2:] = -1.0
    boxes[0, 0] = [3.0, 4.0, 3.5, 30.0]  # sub-pixel tall: collapses under any jitter
    mask = labels >= 0
    mask[1, 1] = False  # a difficult box: keeps its geometry, out of the mask
    return boxes, labels, mask


def _sample(rng, h, w, dtype, g=5):
    image = _images(rng, 1, h, w, dtype)[0]
    boxes, labels, mask = _boxes(rng, 2, g, h, w)
    return {"image": image, "boxes": boxes[1], "labels": labels[1], "mask": mask[1],
            "difficult": np.zeros(g, bool)}


def _small(mod, **data):
    cfg = mod.get_config("voc_resnet18")
    cfg = cfg.replace(
        data=mod.DataConfig(dataset="synthetic", image_size=(96, 96), max_boxes=4, **data),
        model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        proposals=mod.ProposalConfig(pre_nms_train=192, post_nms_train=48),
        rpn_targets=mod.RPNTargetConfig(n_sample=64),
        roi_targets=mod.ROITargetConfig(n_sample=16),
        train=mod.TrainConfig(batch_size=2, n_epoch=2, checkpoint_every_epochs=100),
    )
    return cfg.replace(mesh=mod.MeshConfig(num_data=1)) if mod is jconfig else cfg


# ------------------------------------------------------------ module cases


def _case_augment_module(rng):
    """data/augment.py: every function, both dtypes, bitwise."""
    for dtype in (np.uint8, np.float32):
        s = _sample(rng, 64, 80, dtype)
        _same_sample(t_augment.hflip_sample(s), j_augment.hflip_sample(s), "hflip_sample")
        for oh, ow in ((50, 70), (90, 100)):
            _equal(t_augment._resize_bilinear(s["image"], oh, ow),
                   j_augment._resize_bilinear(s["image"], oh, ow), "_resize_bilinear")
        for scale, oy, ox in ((0.75, 0.2, 0.9), (1.25, 0.5, 0.0), (1.0004, 0.3, 0.3),
                              (0.5, 1.3, -0.2)):
            geom = t_augment.jitter_geometry(64, 80, scale, oy, ox)
            assert geom == j_augment.jitter_geometry(64, 80, scale, oy, ox)
            _same_sample(t_augment.jitter_boxes(s, geom, 64, 80),
                         j_augment.jitter_boxes(s, geom, 64, 80), "jitter_boxes")
            _same_sample(t_augment.scale_jitter_sample(s, scale, oy, ox),
                         j_augment.scale_jitter_sample(s, scale, oy, ox), "scale_jitter_sample")
        for dy, dx in ((0, 0), (5, -7), (-64, 3), (20, 79)):
            _same_sample(t_augment.translate_sample(s, dy, dx),
                         j_augment.translate_sample(s, dy, dx), "translate_sample")
    for seed, epoch, idx in ((0, 0, 0), (7, 3, 1234), (2**40 + 3, 99, 5)):
        assert t_augment._splitmix(seed + idx) == j_augment._splitmix(seed + idx)
        for rng_range in (None, (0.75, 1.25)):
            assert (t_augment.draw_decisions(seed, epoch, idx, rng_range)
                    == j_augment.draw_decisions(seed, epoch, idx, rng_range))
        got, want = (t_augment.device_decisions(seed, epoch, idx),
                     j_augment.device_decisions(seed, epoch, idx))
        assert got[0] == want[0] and all(np.float32(a) == b for a, b in zip(got[1:], want[1:]))
        for n_buckets, chunk in ((1, 1), (3, 1), (3, 2)):
            assert [t_augment.bucket_index(seed, epoch, b, n_buckets, chunk) for b in range(8)] \
                == [j_augment.bucket_index(seed, epoch, b, n_buckets, chunk) for b in range(8)]
    # the views: tag, host mode (jitter then flip), device mode (flip, geometry)
    for dtype in (np.uint8, np.float32):
        cfg = tconfig.DataConfig(image_size=(64, 80), max_boxes=5,
                                 device_normalize=dtype == np.uint8)
        jcfg = jconfig.DataConfig(image_size=(64, 80), max_boxes=5,
                                  device_normalize=dtype == np.uint8)
        ds, jds = SyntheticDataset(cfg, length=6), JSyntheticDataset(jcfg, length=6)
        views = [(t_augment.AugmentTagView(ds, 2), j_augment.AugmentTagView(jds, 2))]
        for hflip, sr, dev in ((True, None, False), (True, (0.6, 1.4), False),
                               (False, (0.6, 1.4), True), (True, (0.6, 1.4), True)):
            views.append((t_augment.AugmentedView(ds, 5, 1, hflip, sr, dev),
                          j_augment.AugmentedView(jds, 5, 1, hflip, sr, dev)))
        for tv, jv in views:
            assert len(tv) == len(jv)
            for i in range(len(tv)):
                _same_sample(tv[i], jv[i], f"{type(tv).__name__}[{i}]")


def _case_native_uint8(rng, tmp_path):
    """data/native_ops.py's uint8 resize and JPEG decode, bitwise."""
    from PIL import Image

    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for hw in ((64, 48), (20, 90)):
        _equal(t_native.resize_u8(img, hw), j_native.resize_u8(img, hw), "resize_u8")
    path = tmp_path / "noise.jpg"
    Image.fromarray(img).save(path, quality=90)
    data = path.read_bytes()
    got = t_native.decode_jpeg_resize_u8(data, (64, 48))
    want = j_native.decode_jpeg_resize_u8(data, (64, 48))
    if got is not None and want is not None:
        _equal(got[0], want[0], "decode_jpeg_resize_u8")
        assert got[1:] == want[1:]
    assert t_native.decode_jpeg_resize_u8(b"not a jpeg", (8, 8)) is None


def _write_voc(root, rng):
    from PIL import Image

    for sub in ("ImageSets/Main", "JPEGImages", "Annotations"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    ids = ["a", "b"]
    with open(os.path.join(root, "ImageSets/Main/train.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    for img_id, (w, h) in zip(ids, ((100, 50), (70, 90))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, "JPEGImages", img_id + ".jpg"))
        ann = ET.Element("annotation")
        for name, diff in (("dog", "0"), ("cat", "1")):
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = name
            ET.SubElement(obj, "difficult").text = diff
            bnd = ET.SubElement(obj, "bndbox")
            for k, v in (("xmin", 10), ("ymin", 5), ("xmax", 60), ("ymax", 45)):
                ET.SubElement(bnd, k).text = str(v)
        ET.ElementTree(ann).write(os.path.join(root, "Annotations", img_id + ".xml"))


def _write_coco(root, rng):
    from PIL import Image

    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, "val2017"), exist_ok=True)
    for name, (w, h) in (("a.jpg", (100, 50)), ("b.jpg", (80, 40)), ("c.jpg", (64, 64))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, "val2017", name))
    ann = {
        "images": [{"id": 7, "file_name": "a.jpg", "width": 100, "height": 50},
                   {"id": 9, "file_name": "b.jpg", "width": 80, "height": 40},
                   {"id": 11, "file_name": "c.jpg", "width": 64, "height": 64}],
        "categories": [{"id": 3, "name": "car"}, {"id": 17, "name": "cat"},
                       {"id": 90, "name": "toothbrush"}],
        "annotations": [
            {"image_id": 7, "category_id": 17, "bbox": [10, 5, 50, 40], "iscrowd": 0},
            {"image_id": 7, "category_id": 3, "bbox": [0, 0, 99, 49], "iscrowd": 1},
            {"image_id": 9, "category_id": 3, "bbox": [8, 4, 16, 8], "iscrowd": 0},
            {"image_id": 9, "category_id": 90, "bbox": [40, 20, 20, 10], "iscrowd": 0},
            {"image_id": 9, "category_id": 90, "bbox": [79, 39, 0, 5], "iscrowd": 0},
            {"image_id": 11, "category_id": 3, "bbox": [1, 1, 10, 10], "iscrowd": 1},
        ],
    }
    with open(os.path.join(root, "annotations", "instances_val2017.json"), "w") as f:
        json.dump(ann, f)


def _case_datasets(rng, tmp_path):
    """COCODataset on a written fixture (float32 bitwise; uint8 equal in
    value to the JAX reader's float32 cast), VOC and synthetic uint8 samples
    bitwise, make_dataset's COCO split map, CachedView."""
    coco = str(tmp_path / "coco")
    _write_coco(coco, rng)
    for norm in (False, True):
        kw = dict(dataset="coco", root_dir=coco, image_size=(64, 64), max_boxes=5,
                  device_normalize=norm)
        for keep_empty in (False, True):
            ds = COCODataset(tconfig.DataConfig(**kw), "val2017", keep_empty=keep_empty)
            jds = JCOCODataset(jconfig.DataConfig(**kw), "val2017", keep_empty=keep_empty)
            assert len(ds) == len(jds) and ds.classes == jds.classes
            for i in range(len(ds)):
                got, want = ds[i], jds[i]
                if norm:  # the JAX reader casts the uint8 image to float32 0..255
                    assert got["image"].dtype == np.uint8
                    got = dict(got, image=got["image"].astype(np.float32))
                _same_sample(got, want, f"coco[{i}]")
        assert len(make_dataset(tconfig.DataConfig(**kw), "val")) == 2
    voc = str(tmp_path / "VOC")
    _write_voc(voc, rng)
    for norm in (False, True):
        kw = dict(dataset="voc", root_dir=voc, image_size=(64, 48), max_boxes=4,
                  device_normalize=norm)
        ds, jds = VOCDataset(tconfig.DataConfig(**kw)), JVOCDataset(jconfig.DataConfig(**kw))
        for i in range(len(jds)):
            _same_sample(ds[i], jds[i], f"voc[{i}] device_normalize={norm}")
            assert ds[i]["image"].dtype == (np.uint8 if norm else np.float32)
    for norm in (False, True):
        kw = dict(image_size=(64, 80), max_boxes=5, device_normalize=norm)
        ds = SyntheticDataset(tconfig.DataConfig(**kw), length=4)
        jds = JSyntheticDataset(jconfig.DataConfig(**kw), length=4)
        cached, jcached = CachedView(ds), JCachedView(jds)
        for i in (0, 3, 0):
            _same_sample(ds[i], jds[i], f"synthetic[{i}]")
            _same_sample(cached[i], jcached[i], f"CachedView[{i}]")
        assert cached.nbytes == jcached.nbytes and cached.length == 4
        small = CachedView(ds, max_bytes=cached.nbytes // 2 + 1)
        jsmall = JCachedView(jds, max_bytes=cached.nbytes // 2 + 1)
        for i in range(4):
            _same_sample(small[i], jsmall[i], f"capped CachedView[{i}]")
        assert small.nbytes == jsmall.nbytes == cached.nbytes // 2


def _augment_inputs(rng):
    for dtype, (n, h, w) in ((np.uint8, (4, 64, 80)), (np.float32, (2, 96, 96))):
        images = _images(rng, n, h, w, dtype)
        boxes, labels, mask = _boxes(rng, n, 6, h, w)
        aug = np.stack([rng.integers(0, 5000, n), rng.integers(0, 9, n)], -1).astype(np.int32)
        yield images, boxes, labels, mask, aug


def _fill_free(images, shifts, geom):
    """Pixels of the final images that read no fill: in the translation's
    window and, for jittered rows, inside the content window with every tap
    inside the translation window (conservatively: inside both windows)."""
    n, h, w = images.shape[:3]
    out = np.zeros((n, h, w, 3), bool)
    for i in range(n):
        dy, dx = shifts[i]
        ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
        ch, cw, shy, shx = geom[i]
        if (ch, cw, shy, shx) == (h, w, 0, 0):
            ok = (ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
        else:
            iy, ix = ys + shy, xs + shx
            ok = (iy >= 0) & (iy < ch) & (ix >= 0) & (ix < cw)
            sy = np.floor((iy + 0.5) * h / ch - 0.5)
            sx = np.floor((ix + 0.5) * w / cw - 0.5)
            for ty in (sy - 1, sy, sy + 1, sy + 2):
                for tx in (sx - 1, sx, sx + 1, sx + 2):
                    ty_c, tx_c = np.clip(ty, 0, h - 1), np.clip(tx, 0, w - 1)
                    ok &= (ty_c + dy >= 0) & (ty_c + dy < h) & (tx_c + dx >= 0) & (tx_c + dx < w)
        out[i] = ok[..., None]
    return out


def _case_image_ops(rng):
    """ops/image.py's plain versions against JAX ops/image.py, op by op and
    jitted; the prepare kernel's wrapper refuses CPU tensors."""
    from replication_faster_rcnn_tpu_torch.ops.cuda import image_kernel

    differing_rows = 0
    for images, boxes, labels, mask, aug in _augment_inputs(rng):
        n, h, w = images.shape[:3]
        ti = [t(x) for x in (images, boxes, labels, mask, aug)]
        ji = [jnp.asarray(x) for x in (images, boxes, labels, mask, aug)]
        seed = int(rng.integers(0, 2**31))
        # draws (integer math and exact scalings: the jitted run is the op-by-op one)
        got = t_image.augment_draws(seed, ti[4][:, 1], ti[4][:, 0])
        jitted = jax.jit(j_image.augment_draws, static_argnums=0)(seed, ji[4][:, 1], ji[4][:, 0])
        for a, b in zip(got, jitted):
            _equal(a, b, "augment_draws")
        for i in range(n):
            o = t_augment.device_decisions(seed, int(aug[i, 1]), int(aug[i, 0]))
            assert bool(got[0][i]) == o[0] and all(
                np.float32(got[k + 1][i]) == o[k + 1] for k in range(5))
        # flip, translation, box jitter, scale jitter
        flip = rng.uniform(size=n) < 0.5
        shifts = np.stack([rng.integers(-h // 3, h // 3, n), rng.integers(-w // 3, w // 3, n)],
                          -1).astype(np.int32)
        shifts[0] = 0
        geom = np.asarray([[h, w, 0, 0]] + [[int(h * s), int(w * s), int(sy), int(sx)]
                          for s, sy, sx in zip(rng.uniform(0.6, 1.4, n - 1),
                                               rng.integers(-9, 9, n - 1),
                                               rng.integers(-9, 9, n - 1))], np.int32)
        apply = np.any(geom != [h, w, 0, 0], -1)
        # flip and translation have no product to contract: jitted; the jitter
        # op by op
        jf = jax.jit(j_image.hflip_batch_with_boxes)(ji[0], ji[1], ji[2], jnp.asarray(flip))
        jt = jax.jit(j_image.translate_batch_with_boxes)(*ji[:4], jnp.asarray(shifts))
        with jax.disable_jit():
            jj = j_image.jitter_boxes_batch(ji[1], ji[2], ji[3], jnp.asarray(geom), h, w,
                                            jnp.asarray(apply))
            js = j_image.batched_scale_jitter(ji[0], jnp.asarray(geom))
        tf = t_image.hflip_batch_with_boxes(ti[0], ti[1], ti[2], t(flip))
        _equal(tf[0], jf[0], "hflip images")
        _equal(tf[1], jf[1], "hflip boxes")
        tt = t_image.translate_batch_with_boxes(*ti[:4], t(shifts))
        _image_close(tt[0], jt[0], "translate images",
                     _fill_free(images, shifts, np.tile([h, w, 0, 0], (n, 1))))
        for a, b, what in zip(tt[1:], jt[1:], ("boxes", "labels", "mask")):
            _equal(a, b, f"translate {what}")
        for a, b, what in zip(t_image.jitter_boxes_batch(ti[1], ti[2], ti[3], t(geom), h, w,
                                                         t(apply)), jj, ("boxes", "labels", "mask")):
            _equal(a, b, f"jitter_boxes_batch {what}")
        _image_close(t_image.batched_scale_jitter(ti[0], t(geom)), js, "batched_scale_jitter",
                     _fill_free(images, np.zeros((n, 2), int), geom))
        _image_close(t_image.scale_jitter_image(ti[0][1], t(geom[1])), js[1], "scale_jitter_image")
        # the whole augmentation, op by op and jitted
        for kw in (dict(hflip=True), dict(hflip=True, scale_range=(0.75, 1.25), translate=0.1),
                   dict(scale_range=(0.5, 1.5)), dict(translate=0.2)):
            got = t_image.augment_batch(*ti, seed=seed, **kw)
            with jax.disable_jit():
                want = j_image.augment_batch(*ji, seed=seed, **kw)
            refs = [(want, "op by op")]
            if kw.get("translate") and kw.get("hflip"):  # one compile per input shape
                refs.append((jax.jit(lambda *a, kw=kw: j_image.augment_batch(
                    *a, seed=seed, **kw))(*ji), "jitted"))
            for ref, tag in refs:
                rows = np.zeros(n, bool)
                for a, b in zip(got[1:], ref[1:]):
                    a, b = a.numpy(), np.asarray(b)
                    rows |= (a != b).reshape(n, -1).any(-1)
                if tag == "op by op":
                    assert not rows.any(), kw
                else:
                    differing_rows += int(rows.sum())
                keep = ~rows
                _image_close(got[0].numpy()[keep], np.asarray(ref[0])[keep],
                             f"augment_batch {kw} {tag}", atol=1e-6 if tag == "op by op" else 2e-5)
            # the prepare launch's plain version: JAX's boxes, labels and masks
            # bitwise; its fills (the means of the flipped and of the translated
            # image) within 1 count / rtol 1e-6 of JAX's float32 means
            pb, pl, pm, pgeom, pfills = t_image.augment_prepare_plain(
                ti[0], *ti[1:4], aug=ti[4], seed=seed, **kw)
            for a, b, what in zip((pb, pl, pm), want[1:], ("boxes", "labels", "mask")):
                _equal(a, b, f"augment_prepare_plain {what} {kw}")
            g = pgeom.numpy()
            flipped = j_image.hflip_batch_with_boxes(ji[0], ji[1], ji[2],
                                                     jnp.asarray(g[:, 0] != 0))[0]
            moved = j_image.translate_batch_with_boxes(flipped, *ji[1:4],
                                                       jnp.asarray(g[:, 1:3]))[0]
            jfills = np.stack([np.asarray(x.astype(jnp.float32).mean(axis=(1, 2)))
                               for x in (flipped, moved)], 1)
            if images.dtype == np.uint8:
                jfills = np.clip(np.round(jfills), 0, 255)
                assert np.abs(pfills.numpy() - jfills).max() <= 1, kw
            else:
                np.testing.assert_allclose(pfills.numpy(), jfills, rtol=1e-6, atol=1e-6,
                                           err_msg=f"augment_prepare_plain fills {kw}")
        with pytest.raises(ValueError, match="CUDA"):
            image_kernel.augment_prepare_cuda(ti[0], *ti[1:4], aug=ti[4], seed=seed)
        # the bucket resample
        for hw in ((h * 3 // 4, w * 3 // 4), (h, w * 5 // 4), (h, w)):
            got = t_image.resize_batch_with_boxes(ti[0], ti[1], hw)
            want = j_image.resize_batch_with_boxes(ji[0], ji[1], hw)
            _equal(got[1], want[1], f"resize boxes {hw}")
            a, b = got[0].numpy(), np.asarray(want[0])
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.dtype == np.uint8:
                assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1, hw
            else:
                scale = np.abs(b).max()
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale, err_msg=str(hw))
    assert differing_rows == JITTED_GEOMETRY_ROWS, differing_rows


def _case_device_cache(rng):
    """CachedSampler selections, stack_selections, materialize_batch (with
    and without the resample), DeviceCache's accounting and byte guard."""
    for norm in (False, True):
        kw = dict(image_size=(64, 80), max_boxes=5, device_normalize=norm)
        ds = SyntheticDataset(tconfig.DataConfig(**kw), length=9)
        jds = JSyntheticDataset(jconfig.DataConfig(**kw), length=9)
        cache = DeviceCache(ds, device="cpu", keep_host_meta=True)
        jcache = JDeviceCache(jds, keep_host_meta=True)
        assert (cache.nbytes, cache.n, cache.image_hw) == (jcache.nbytes, jcache.n,
                                                           jcache.image_hw)
        _same_sample(cache.host_meta, jcache.host_meta, "host_meta")
        for k, v in jcache.arrays.items():
            _equal(cache.arrays[k], v, f"cache[{k}]")
        for hflip, sr in ((False, None), (True, None), (True, (0.6, 1.4)), (False, (0.8, 1.2))):
            sampler = CachedSampler(9, (64, 80), 4, seed=3, hflip=hflip, scale_range=sr,
                                    train_resolutions=((64, 64), (32, 48)), bucket_chunk=2)
            jsampler = JCachedSampler(9, (64, 80), 4, seed=3, hflip=hflip, scale_range=sr,
                                      train_resolutions=((64, 64), (32, 48)), bucket_chunk=2)
            for epoch, start in ((0, 0), (1, 1)):
                sampler.set_epoch(epoch, start)
                jsampler.set_epoch(epoch, start)
                sels, jsels = list(sampler), list(jsampler)
                assert len(sels) == len(jsels) == 2 - start and len(sampler) == len(jsampler)
                assert [sampler.bucket_of(b) for b in range(6)] == [
                    jsampler.bucket_of(b) for b in range(6)]
                for s, js in zip(sels, jsels):
                    _same_sample(s, js, "selection")
                    for resample in (False, True):
                        got = materialize_batch(cache.arrays, {k: t(v) for k, v in s.items()},
                                                resample=resample)
                        want = j_materialize(jcache.arrays, js)
                        if resample and "jitter" in want:
                            # the fills: JAX's float32 mean (see _image_close)
                            want = dict(want, image=j_image.batched_scale_jitter(
                                want["image"], want.pop("jitter")))
                            _image_close(got.pop("image"), want.pop("image"),
                                         "materialize_batch resample")
                        _same_sample(got, want, f"materialize_batch resample={resample}")
                _same_sample(stack_selections(sels), j_stack(jsels), "stack_selections")
    with pytest.raises(ValueError) as got:
        DeviceCache(ds, device="cpu", max_bytes=1000)
    with pytest.raises(ValueError) as want:
        JDeviceCache(jds, max_bytes=1000)
    assert str(got.value) == str(want.value) and "GiB cap" in str(got.value)


def _case_loader(rng):
    """The loader's batches over two epochs, every augmentation mode, the
    RAM cache and the bucket sequence: bitwise the JAX loader's."""
    for norm in (False, True):
        kw = dict(image_size=(64, 80), max_boxes=5, device_normalize=norm)
        ds = SyntheticDataset(tconfig.DataConfig(**kw), length=7)
        jds = JSyntheticDataset(jconfig.DataConfig(**kw), length=7)
        modes = (dict(), dict(augment_hflip=True), dict(augment_scale=(0.7, 1.3)),
                 dict(augment_hflip=True, augment_scale=(0.7, 1.3), augment_scale_device=True),
                 dict(augment_hflip=True, augment_device=True, augment_translate=0.1),
                 dict(augment_hflip=True, cache_ram=True))
        for mode in modes:
            common = dict(batch_size=3, shuffle=True, seed=4, prefetch=1, num_workers=2,
                          train_resolutions=((32, 40), (64, 80), (48, 60)), bucket_chunk=2, **mode)
            loader = DataLoader(ds, **common)
            jloader = JDataLoader(jds, sample_skip_budget=0, **common)
            # process mode (forked workers) on both sides: the thread loader's batches
            loaders = [loader, jloader, DataLoader(ds, worker_mode="process", **common),
                       JDataLoader(jds, worker_mode="process", **common)]
            for epoch, start in ((0, 0), (1, 1)):
                outs = []
                for one in loaders:
                    one.set_epoch(epoch, start)
                    outs.append(list(one))
                assert all(len(out) == len(loader) - start for out in outs)
                for other in outs[1:]:
                    for a, b in zip(outs[0], other):
                        _same_sample(a, b, f"loader {mode}")
                assert [loader.bucket_of(b) for b in range(5)] == [
                    jloader.bucket_of(b) for b in range(5)]


class _Faulty:
    """A map-style dataset whose reads raise at chosen indices: ``permanent``
    always, ``transient`` on the first read only (the retry succeeds)."""

    def __init__(self, base, permanent=(), transient=(), exc=OSError):
        self.base, self.permanent, self.exc = base, set(permanent), exc
        self.pending = set(transient)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        i = int(i)
        if i in self.permanent:
            raise self.exc(f"unreadable sample {i}")
        if i in self.pending:
            self.pending.discard(i)
            raise self.exc(f"transient read error at {i}")
        return self.base[i]


def _case_fetch_sample():
    """``fetch_sample`` against JAX's on a dataset that raises at chosen
    indices: the same samples, the same ``on_skip`` calls; the epoch's skip
    budget in thread and process modes (the same error); a worker's
    exception re-raised with its traceback; ``ioerror`` faults injected at
    ``loader.fetch`` ride the same containment on both sides (the same
    faults, the same substitution)."""
    kw = dict(image_size=(32, 40), max_boxes=3, device_normalize=True)
    ds = SyntheticDataset(tconfig.DataConfig(**kw), length=8)
    jds = JSyntheticDataset(jconfig.DataConfig(**kw), length=8)
    faults = dict(permanent=(2, 3, 7), transient=(5,))
    skips, jskips = [], []
    tf, jf = _Faulty(ds, **faults), _Faulty(jds, **faults)
    for i in range(8):
        got = fetch_sample(tf, i, lambda idx, e: skips.append((idx, str(e))))
        want = j_fetch_sample(jf, i, lambda idx, e: jskips.append((idx, str(e))))
        _same_sample(got, want, f"fetch_sample {i}")
    assert skips == jskips and [i for i, _ in skips] == [2, 3, 7]
    for mod in (fetch_sample, j_fetch_sample):  # every index fails: the last error
        with pytest.raises(OSError, match="unreadable"):
            mod(_Faulty(ds, permanent=range(8)), 1)

    for mode in ("thread", "process"):
        # one thread builds the samples in order, so the budget's error names
        # the same index on both sides; process mode forks two workers
        common = dict(batch_size=4, shuffle=False, prefetch=1,
                      num_workers=1 if mode == "thread" else 2)
        # within the budget: the substituted epoch, as JAX's
        for budget in (3, 1):
            got, want = [], []
            for cls, base, out in ((DataLoader, ds, got), (JDataLoader, jds, want)):
                loader = cls(_Faulty(base, permanent=(2, 3, 7)), sample_skip_budget=budget,
                             worker_mode=mode, **common)
                try:
                    out.extend(loader)
                except RuntimeError as e:
                    out.append(str(e).splitlines()[-1] if mode == "process" else str(e))
            assert len(got) == len(want), (mode, budget)
            for a, b in zip(got, want):
                if isinstance(b, str):
                    assert a == b and "sample-skip budget exhausted" in a, (a, b)
                else:
                    _same_sample(a, b, f"{mode} budget {budget}")
            assert isinstance(got[-1], str) == (budget == 1), (mode, budget, got[-1])
        # containment off: the worker's own exception, with its traceback
        for cls, base in ((DataLoader, ds), (JDataLoader, jds)):
            loader = cls(_Faulty(base, permanent=(1,), exc=ValueError), sample_skip_budget=0,
                         worker_mode=mode, **common)
            with pytest.raises((RuntimeError, ValueError)) as e:
                list(loader)
            if mode == "process":
                assert e.type is RuntimeError and "Traceback" in str(e.value)
                assert "ValueError: unreadable sample 1" in str(e.value)
            else:
                assert e.type is ValueError
    # the thread loader's budget is per epoch (set_epoch resets it)
    loader = DataLoader(_Faulty(ds, permanent=(2,)), sample_skip_budget=1, batch_size=4,
                        shuffle=False)
    for epoch in range(3):
        loader.set_epoch(epoch)
        assert len(list(loader)) == 2
    # the failpoint: an ioerror on the first three reads (index 0, its retry,
    # the probe of index 1) rides the containment in both packages: index 0
    # costs one substitution, by index 2
    results = []
    for mod, fp, base in ((fetch_sample, failpoints, ds), (j_fetch_sample, j_failpoints, jds)):
        events = []
        fp.configure("loader.fetch:ioerror:1.0:3:0:3:0", sink=events.append)
        calls = []
        try:
            out = [mod(base, i, lambda idx, e: calls.append(idx)) for i in (0, 4)]
        finally:
            fp.disarm()
        results.append((out, calls, [(e["seq"], e["index"]) for e in events]))
    (got, gcalls, gevents), (want, wcalls, wevents) = results
    for a, b in zip(got, want):
        _same_sample(a, b, "loader.fetch ioerror")
    assert gcalls == wcalls == [0] and gevents == wevents == [(0, 0), (1, 0), (2, 1)]
    _same_sample(got[0], ds[2], "substituted by the next index that loads")


def _case_prefetcher():
    """DevicePrefetcher against JAX's on the same feed: order, skip, chunked
    tail, depth, and the error re-raised at the failed item."""
    feed = [{"idx": np.arange(2) + 2 * i} for i in range(7)]
    for chunk, skip in ((1, 0), (2, 0), (3, 2)):
        runs = []
        for cls in (prefetch_device.DevicePrefetcher, JPrefetcher):
            items = list(cls(iter(feed), lambda bs: [b["idx"].tolist() for b in bs], depth=2,
                             chunk=chunk, skip=skip))
            runs.append([(it[0], it[1] if it[0] == "staged" else it[1]["idx"].tolist(),
                          *it[2:]) for it in items])
        assert runs[0] == runs[1], (chunk, skip)

    def failing():
        yield feed[0]
        raise OSError("bad sample")

    for cls in (prefetch_device.DevicePrefetcher, JPrefetcher):
        it = cls(failing(), lambda bs: bs, depth=1)
        assert next(it)[0] == "staged"
        with pytest.raises(OSError, match="bad sample"):
            next(it)
        it.close()
    blocked = prefetch_device.DevicePrefetcher(iter(feed), lambda bs: bs, depth=2)
    import time

    deadline = time.time() + 10
    while blocked.queue_depth() < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert blocked.queue_depth() == 2  # bounded: the producer waits
    blocked.close()
    with pytest.raises(StopIteration):
        next(blocked)
    staged, event = prefetch_device.PinnedStager("cpu").stage({"a": np.ones((2, 3), np.uint8)})
    assert event is None and prefetch_device.consume((staged, event))["a"].sum() == 6


def _case_config():
    """The data fields' defaults and validation, as JAX's."""
    fields = [f.name for f in dataclasses.fields(tconfig.DataConfig)]
    jdefault, tdefault = jconfig.DataConfig(), tconfig.DataConfig()
    for name in fields:
        assert getattr(tdefault, name) == getattr(jdefault, name), name
    bad = (dict(prefetch_device=-1), dict(augment_scale=(0.05, 1.0)),
           dict(augment_scale_device=True), dict(augment_translate=0.1),
           dict(augment_device=True), dict(augment_translate=1.5, augment_device=True),
           dict(augment_device=True, augment_hflip=True, augment_scale=(0.8, 1.2),
                augment_scale_device=True),
           dict(augment_device=True, augment_hflip=True, cache_device=True),
           dict(train_resolutions=((0, 5),)), dict(train_resolutions=((5, 5), (5, 5))))
    for kw in bad:
        with pytest.raises(ValueError) as got:
            tconfig.DataConfig(**kw)
        with pytest.raises(ValueError) as want:
            jconfig.DataConfig(**kw)
        assert str(got.value) == str(want.value), kw
    kw = dict(augment_scale=[0.8, 1.2], train_resolutions=[(96, 96), (64, 80)])
    got, want = tconfig.DataConfig(**kw), jconfig.DataConfig(**kw)
    assert (got.augment_scale, got.train_resolutions) == (want.augment_scale,
                                                          want.train_resolutions)


def test_data_path_matches_jax(tmp_path, monkeypatch):
    # the JAX package's numpy specification of the resize, which the port's
    # C++ resize matches bitwise (the JAX C++ takes its sample positions in
    # float32: tests/test_torch_eval.py)
    monkeypatch.setattr(j_native, "_load_lib", lambda: None)
    rng = np.random.default_rng(13)
    _case_config()
    _case_augment_module(rng)
    _case_native_uint8(rng, tmp_path)
    _case_datasets(rng, tmp_path)
    _case_image_ops(rng)
    _case_device_cache(rng)
    _case_loader(rng)
    _case_fetch_sample()
    _case_prefetcher()
    _case_resize_tile_spans()


def _case_resize_tile_spans():
    """The resize kernel's host table: every tile's staged input span holds
    each of its outputs' taps ``start[o] .. start[o] + taps - 1``, starts on
    a vector boundary, ends inside the row and fits the staged channel plane; a
    resize block and an image-pass block fit the shared-memory budget; the
    horizontal halo stays under 15% of the rows pass at the buckets."""
    from replication_faster_rcnn_tpu_torch.ops.cuda import image_kernel as k

    ty, tx = k.RESIZE_TILE
    for (ih, iw), (h, w) in [((600, 600), (480, 480)), ((600, 600), (720, 720)),
                             ((480, 480), (600, 600)), ((600, 600), (600, 480)),
                             ((600, 600), (480, 600)), ((375, 500), (301, 433)),
                             ((600, 600), (240, 240)), ((301, 433), (375, 500))]:
        row_taps = col_taps = plane = 0
        if ih != h:
            row_taps = t_image.resize_band(ih, h)[1].shape[1]
        if iw != w:
            start, weight = t_image.resize_band(iw, w)
            col_taps = weight.shape[1]
            spans, plane = k.resize_tile_spans(start, col_taps, iw, tx)
            align = k.RESIZE_ALIGN
            assert spans.shape == (-(-w // tx), 2)
            assert (spans[:, 0] % align == 0).all() and (spans[:, 1] <= iw * 3).all()
            assert ((-(-spans[:, 1] // 3) - spans[:, 0] // 3) <= plane).all()
            for o in range(w):
                first, end = spans[o // tx]
                assert first <= start[o] * 3 and (start[o] + col_taps) * 3 <= end, (iw, w, o)
            if (ih, iw) in ((600, 600), (480, 480)) and w == h:
                halo = float((spans[:, 1] - spans[:, 0]).sum()) / (iw * 3) - 1.0
                assert halo <= 0.15, (iw, w, halo)
        for itemsize in (1, 4):
            assert k.resize_smem_bytes((ty, tx), plane, row_taps, col_taps,
                                       itemsize) <= k.SMEM_BUDGET
        for dtype in (torch.uint8, torch.float32):
            assert k.image_smem_bytes(iw, dtype) <= k.SMEM_BUDGET


# ------------------------------------------------------------ trainer cases


def _state_equal(a, b, what):
    la = dict(fault._leaves_with_path(a._host_state()))
    lb = dict(fault._leaves_with_path(b._host_state()))
    assert la.keys() == lb.keys(), what
    diff = [k for k in la if not (torch.equal(la[k], lb[k]) if isinstance(la[k], torch.Tensor)
                                  else la[k] == lb[k])]
    assert not diff, (what, diff[:5])


def _quiet(trainer):
    from replication_faster_rcnn_tpu_torch.utils.logging import MetricLogger

    trainer.logger = MetricLogger(stream=open(os.devnull, "w"))
    return trainer


def _trainer(tmp_path, tag, ds, telemetry=False, **data):
    cfg = _small(tconfig, **data)
    tel = str(tmp_path / f"tel_{tag}") if telemetry else None
    return _quiet(Trainer(cfg, ds, device="cpu", workdir=str(tmp_path / tag), telemetry_dir=tel))


def _case_prefetch_and_resume(tmp_path):
    """prefetch_device=2 bitwise prefetch off over 2 epochs (3 steps an
    epoch), and a run preempted after step 2 (mid-epoch) and resumed, both
    with prefetch, bitwise the uninterrupted run."""
    ds = SyntheticDataset(tconfig.DataConfig(image_size=(96, 96), max_boxes=4,
                                             device_normalize=True), length=6)
    aug = dict(device_normalize=True, augment_hflip=True)
    off = _trainer(tmp_path, "off", ds, **aug)
    off.train(log_every=5)
    on = _trainer(tmp_path, "on", ds, prefetch_device=2, **aug)
    on.train(log_every=5)
    _state_equal(on, off, "prefetch on vs off")
    assert on.state.step == off.state.step == 6
    killed = _trainer(tmp_path, "killed", ds, prefetch_device=2, **aug)
    step_fn = killed.train_one_batch

    def train_one_batch(*args, **kw):
        out = step_fn(*args, **kw)
        if killed.state.step == 2:
            signal.raise_signal(signal.SIGTERM)
        return out

    killed.train_one_batch = train_one_batch
    with pytest.raises(fault.Preempted) as e:
        killed.train(log_every=5)
    assert e.value.step == 2
    resumed = _trainer(tmp_path, "killed", ds, prefetch_device=2, **aug)
    resumed.train(log_every=5, resume=True)
    _state_equal(resumed, off, "resumed with prefetch vs uninterrupted")


def _case_cached_vs_fed(tmp_path):
    """The cached run (cache_device, flip + scale) bitwise the loader-fed
    augment_scale_device run over the same epochs."""
    aug = dict(device_normalize=True, augment_hflip=True, augment_scale=(0.75, 1.25))
    ds = SyntheticDataset(tconfig.DataConfig(image_size=(96, 96), max_boxes=4,
                                             device_normalize=True), length=6)
    fed = _trainer(tmp_path, "fed", ds, augment_scale_device=True, **aug)
    fed.train(log_every=4)
    cached = _trainer(tmp_path, "cached", ds, cache_device=True, prefetch_device=1, **aug)
    assert cached.device_cache is not None and cached.loader is None
    cached.train(log_every=4)
    _state_equal(cached, fed, "cached vs loader-fed")


def _jax_draws(state, n, a, rg):
    rng_at, rng_pt, _ = jax.random.split(jax.random.fold_in(state.rng, state.step), 3)
    out = {name: [] for name in DRAW_NAMES}
    for i in range(n):
        for name, key in zip(DRAW_NAMES[:2], jax.random.split(jax.random.fold_in(rng_at, i))):
            out[name].append(np.asarray(jax.random.uniform(key, (a,))))
        for name, key in zip(DRAW_NAMES[2:], jax.random.split(jax.random.fold_in(rng_pt, i), 3)):
            out[name].append(np.asarray(jax.random.uniform(key, (rg,))))
    return {k: t(np.stack(v)) for k, v in out.items()}


def _case_augment_device_losses():
    """The augment_device step (flip, scale, translation drawn in the step)
    against JAX's jitted step on the same batch with the JAX draws."""
    aug = dict(augment_device=True, augment_hflip=True, augment_scale=(0.75, 1.25),
               augment_translate=0.1)
    jcfg, tcfg = _small(jconfig, **aug), _small(tconfig, **aug)
    tx, _ = j_make_optimizer(jcfg, steps_per_epoch=1)
    jmodel, state = create_train_state(jcfg, jax.random.PRNGKey(0), tx)
    jds = j_augment.AugmentTagView(JSyntheticDataset(jcfg.data, length=2), 3)
    ds = t_augment.AugmentTagView(SyntheticDataset(tcfg.data, length=2), 3)
    jbatch = j_collate([jds[i] for i in range(2)])
    batch = collate([ds[i] for i in range(2)])
    _same_sample(batch, jbatch, "tagged batch")
    _, jmetrics = jax.jit(j_make_train_step(jmodel, jcfg, tx))(state, jbatch)
    np_vars = {"params": jax.tree_util.tree_map(np.asarray, state.params),
               "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}
    model = build_model(tcfg, device="cpu", state_dict=from_flax_variables(np_vars))
    optimizer, _ = make_optimizer(tcfg, model.parameters(), 1)
    ts = TrainState(model, optimizer, torch.Generator().manual_seed(0))
    draws = _jax_draws(state, 2, 6 * 6 * 9, 48 + 4)
    tbatch = {k: t(batch[k]) for k in ("image", "boxes", "labels", "mask", "aug")}
    metrics = make_train_step(tcfg)(ts, tbatch, draws=draws)
    for k in ("loss", "rpn_cls_loss", "rpn_reg_loss", "head_cls_loss", "head_reg_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)


def _case_buckets(tmp_path):
    """Each dispatch trains at the bucket JAX's loader assigns (K=2: the
    buckets follow the chunks; the card's run checks K=1 and K=2), at the
    bucket's shape."""
    ds = SyntheticDataset(tconfig.DataConfig(image_size=(96, 96), max_boxes=4), length=8)
    jds = JSyntheticDataset(jconfig.DataConfig(image_size=(96, 96), max_boxes=4), length=8)
    res = ((64, 64), (96, 96), (80, 112))
    for k in (2,):
        tr = _trainer(tmp_path, f"buckets{k}", ds, train_resolutions=res)
        res = tr.config.data.train_resolutions  # the canonical order: by area
        tr.config = tr.config.replace(train=dataclasses.replace(tr.config.train,
                                                                steps_per_dispatch=k))
        tr.steps_per_dispatch = k
        tr.loader.bucket_chunk = k
        seen = []
        step_fn = tr.step_fn

        def record(state, batch, resolution=None, _fn=step_fn, **kw):
            seen.append(resolution)
            return _fn(state, batch, resolution=resolution, **kw)

        def record_chunk(state, batches, resolution=None, _fn=step_fn):
            seen.extend([resolution] * len(batches))
            return _fn.chunk(state, batches, resolution=resolution)

        record.chunk = record_chunk
        tr.step_fn = record
        tr.train(log_every=4)
        jloader = JDataLoader(jds, batch_size=2, seed=0, train_resolutions=res, bucket_chunk=k)
        want = []
        for epoch in range(2):
            jloader.set_epoch(epoch)
            want += [res[jloader.bucket_of(b)] for b in range(4)]
        assert seen == want and len(set(want)) > 1, (k, seen, want)
    batch = {k: t(v) for k, v in j_collate([jds[i] for i in range(2)]).items()}
    for hw in res:
        images, boxes, _, _ = __import__(
            "replication_faster_rcnn_tpu_torch.train.train_step", fromlist=["x"]
        ).augment_prologue(_small(tconfig), batch, hw)
        assert images.shape == (2,) + hw + (3,) and boxes.shape == (2, 4, 4)


def _case_span_names(tmp_path):
    """The port's trainer with prefetch_device and cache_device records the
    span names the JAX trainer records with them."""
    names = {}
    data = dict(device_normalize=True, augment_hflip=True, cache_device=True, prefetch_device=1)
    ds = SyntheticDataset(tconfig.DataConfig(image_size=(96, 96), max_boxes=4,
                                             device_normalize=True), length=4)
    tr = _trainer(tmp_path, "spans", ds, telemetry=True, **data)
    tr.train(log_every=2)
    spans.set_tracer(None)
    jcfg = _small(jconfig, **data)
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, n_epoch=1))
    JTrainer(jcfg, workdir=str(tmp_path / "jspans"),
             dataset=JSyntheticDataset(jcfg.data, length=4),
             telemetry_dir=str(tmp_path / "jtel")).train(log_every=2)
    j_spans.set_tracer(None)
    for tag, d in (("port", tmp_path / "tel_spans"), ("jax", tmp_path / "jtel")):
        events = report.load_trace_events(os.path.join(d, "trace.json"))
        names[tag] = {ev["name"] for ev in events if ev["ph"] == "X"}
    data_spans = {"data/fetch", "data/device_put", "data/cache_upload", "step/dispatch",
                  "step/sync"}
    assert data_spans <= names["port"] and data_spans <= names["jax"], names
    assert {n for n in names["port"] if n.startswith("data/")} == {
        n for n in names["jax"] if n.startswith("data/")}, names


def _case_process_loader_trainer(tmp_path):
    """A trainer fed by the process loader (``loader_mode="process"``, two
    forked workers) bitwise the thread-fed run over 2 steps (two epochs of
    one batch, the workers forked anew each epoch), losses included."""
    ds = SyntheticDataset(tconfig.DataConfig(image_size=(96, 96), max_boxes=4,
                                             device_normalize=True), length=2)
    runs = {}
    for mode in ("thread", "process"):
        tr = _trainer(tmp_path, f"mode_{mode}", ds, device_normalize=True, augment_hflip=True,
                      loader_mode=mode, loader_workers=2)
        assert tr.loader.worker_mode == mode
        rows = []
        step = tr.train_one_batch
        tr.train_one_batch = lambda *a, **k: rows.append(step(*a, **k)) or rows[-1]
        tr.train(log_every=5)
        runs[mode] = (tr, [{k: float(v) for k, v in r.items()} for r in rows])
    assert runs["process"][0].state.step == 2 and len(runs["process"][1]) == 2
    assert runs["process"][1] == runs["thread"][1]
    _state_equal(runs["process"][0], runs["thread"][0], "process vs thread loader")


def test_data_path_trainer_matches_jax(tmp_path):
    _case_process_loader_trainer(tmp_path)
    _case_prefetch_and_resume(tmp_path)
    _case_cached_vs_fed(tmp_path)
    _case_augment_device_losses()
    _case_buckets(tmp_path)
    _case_span_names(tmp_path)
