"""Parity of the PyTorch port's evaluation slice with the JAX package, on the
CPU: the VOC and COCO metrics, the host resize and box scaling, the VOC
reader, the threaded loader, the flip-TTA decode and the evaluator end to
end. One test id walks the cases in order (each new test id costs the
fast tier's budget 2 s).

Tolerances, with their reasons:

* Metrics: bitwise (``==`` on every float). The port's ``voc_eval`` and
  ``coco_eval`` are copies that keep float64 and the same sort orders.
* Resize: the C++ resize is bitwise equal to the port's numpy
  specification and to the JAX package's (the same float32 operations in
  the same order, no fused multiply-adds), and within atol 2e-5 of the JAX
  package's C++ ``resize_normalize`` at the sizes where that holds for the
  JAX pair itself (``tests/test_native.py`` pins it at 64x64 and below; its
  C++ folds the normalize into one multiply-add and takes the sample
  positions in float32).
  ``scale_boxes``: equal.
* VOC reader: images within atol 2e-5 (the resize above); boxes, labels,
  masks and difficult flags equal.
* Loader: batches equal to ``collate`` of the same indices; the shuffled
  epoch order (3 epochs, several ``set_epoch`` start batches) equal to the
  JAX ``DataLoader``'s; ``make_dataset``'s datasets equal to the JAX
  factory's.
* TTA decode on shared head outputs: boxes to 1e-3 px, scores to 1e-6,
  classes and valid equal (``tests/test_torch_model.py``).
* ``summary_scalars``: equal to the JAX function's on the same result.
* Evaluator end to end, from the same bridged weights (the RPN and head
  layers tempered, see ``_case_evaluator``): detections within the decode's
  tolerances above, classes and valid equal; then every score of the
  result within 1e-6. A detection whose IoU lies within 1e-2 of a
  threshold, where a match may flip, is listed in the failure message.
* The evaluator's cached feeds (``cache_device``, ``loader_cache_ram``) and
  a uint8 set: every score within 1e-6 of the loader feed's and JAX's
  (``_evaluate_cached`` for the device cache); a second call with the same
  dataset equal to the first and reusing the cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from replication_faster_rcnn_tpu import config as jconfig
from replication_faster_rcnn_tpu.data import native_ops as j_native
from replication_faster_rcnn_tpu.data.loader import DataLoader as JDataLoader
from replication_faster_rcnn_tpu.data.loader import make_dataset as j_make_dataset
from replication_faster_rcnn_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from replication_faster_rcnn_tpu.data.voc import VOCDataset as JVOCDataset
from replication_faster_rcnn_tpu.eval import coco_eval as j_coco
from replication_faster_rcnn_tpu.eval import detect as j_detect
from replication_faster_rcnn_tpu.eval import voc_eval as j_voc
from replication_faster_rcnn_tpu.eval.evaluator import Evaluator as JEvaluator
from replication_faster_rcnn_tpu.eval.evaluator import summary_scalars as j_summary_scalars
from replication_faster_rcnn_tpu.models.faster_rcnn import init_variables
from replication_faster_rcnn_tpu_torch import config as tconfig
from replication_faster_rcnn_tpu_torch import ops
from replication_faster_rcnn_tpu_torch.data import native_ops
from replication_faster_rcnn_tpu_torch.data.loader import DataLoader, collate, make_dataset
from replication_faster_rcnn_tpu_torch.data.synthetic import SyntheticDataset
from replication_faster_rcnn_tpu_torch.data.voc import VOCDataset
from replication_faster_rcnn_tpu_torch.eval import coco_eval, detect, voc_eval
from replication_faster_rcnn_tpu_torch.eval.evaluator import Evaluator, summary_scalars
from replication_faster_rcnn_tpu_torch.models.convert import from_flax_variables
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import build_model
from tests.test_torch_model import _randomise
from tests.test_voc_contract import _write_voc_tree

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
SIZE = (128, 128)


def _same(a, b, what):
    """Bitwise equality of two metric results (floats, arrays, NaNs equal)."""
    assert set(a) == set(b), f"{what}: keys {sorted(a)} vs {sorted(b)}"
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True), (
            f"{what}[{k!r}]: port {a[k]!r} vs JAX {b[k]!r}")


def _metric_sets(rng, n_img=6, num_classes=8, oracle=False):
    """Seeded ground truth (classes 1..5, so 6 and 7 have none; some gt
    ignored) and detections: random boxes with scores on a 0.1 grid (ties),
    or, with ``oracle``, the gt jittered by up to 2 px scored above 0.5 plus
    random false positives below it."""
    gts, dets = [], []
    for _ in range(n_img):
        g = rng.integers(1, 6)
        tl = rng.uniform(0, 80, (g, 2))
        gb = np.concatenate([tl, tl + rng.uniform(20, 60, (g, 2))], 1).astype(np.float32)
        gl = rng.integers(1, 6, g).astype(np.int32)
        gts.append({"boxes": gb, "labels": gl, "ignore": rng.uniform(size=g) < 0.2})
        d = rng.integers(0, 12)
        tl = rng.uniform(0, 100, (d, 2))
        db = np.concatenate([tl, tl + rng.uniform(10, 60, (d, 2))], 1).astype(np.float32)
        dc = rng.integers(1, num_classes, d).astype(np.int32)
        if oracle:
            ds = rng.uniform(0.0, 0.5, d).astype(np.float32)
            db = np.concatenate([gb + rng.uniform(-2, 2, gb.shape).astype(np.float32), db])
            dc = np.concatenate([gl, dc])
            ds = np.concatenate([rng.uniform(0.5, 1.0, g).astype(np.float32), ds])
        else:
            ds = (np.round(rng.uniform(0, 1, d) * 10) / 10).astype(np.float32)
        dets.append({"boxes": db, "scores": ds, "classes": dc})
    return dets, gts


def _case_metrics():
    for seed, oracle in ((0, False), (1, False), (2, True), (3, True)):
        dets, gts = _metric_sets(np.random.default_rng(seed), oracle=oracle)
        for use_07 in (False, True):
            for thr in (0.5, 0.7):
                got = voc_eval.voc_ap(dets, gts, 8, iou_thresh=thr, use_07_metric=use_07)
                want = j_voc.voc_ap(dets, gts, 8, iou_thresh=thr, use_07_metric=use_07)
                _same(got, want, f"voc_ap seed {seed} 07={use_07} thr={thr}")
                assert np.isnan(got["ap_per_class"][[0, 6, 7]]).all()  # classes without gt
                if oracle and thr == 0.5:
                    assert got["mAP"] > 0.9, f"oracle detections score mAP {got['mAP']}"
        _same(voc_eval.coco_map(dets, gts, 8), j_voc.coco_map(dets, gts, 8), f"coco_map {seed}")
        for kw in ({}, {"max_dets": 3}, {"iou_thresholds": [0.5]}):
            got = coco_eval.coco_summary(dets, gts, 8, **kw)
            _same(got, j_coco.coco_summary(dets, gts, 8, **kw), f"coco_summary {seed} {kw}")
            if oracle and not kw:
                assert got["AP50"] > 0.9, f"oracle detections score AP50 {got['AP50']}"
    # no detections at all, and an image without ground truth
    dets, gts = _metric_sets(np.random.default_rng(4))
    empty = [{"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32),
              "classes": np.zeros(0, np.int32)} for _ in dets]
    gts[0] = {"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int32)}
    for d in (empty, dets):
        _same(voc_eval.voc_ap(d, gts, 8), j_voc.voc_ap(d, gts, 8), "voc_ap empty")
        _same(coco_eval.coco_summary(d, gts, 8), j_coco.coco_summary(d, gts, 8), "coco empty")


def _case_resize(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    mean, std = np.asarray(MEAN, np.float32), np.asarray(STD, np.float32)
    for src, out in (((37, 53), (64, 48)), ((20, 30), (64, 48)), ((200, 300), (32, 32)),
                     ((1, 1), (3, 5)), ((375, 500), SIZE), ((333, 500), (600, 600))):
        img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
        got = native_ops.resize_normalize(img, out, MEAN, STD)
        plain = native_ops.resize_normalize_plain(img, out, MEAN, STD)
        assert got.shape == out + (3,) and got.dtype == np.float32
        np.testing.assert_array_equal(got, plain, err_msg=f"C++ vs numpy {src} -> {out}")
        np.testing.assert_array_equal(got, j_native._resize_normalize_numpy(img, out, mean, std))
        if out != (600, 600):
            # the JAX C++ takes its sample positions in float32: at 600x600
            # it leaves its own numpy specification by up to ~2.6e-4
            np.testing.assert_allclose(got, j_native.resize_normalize(img, out, MEAN, STD),
                                       rtol=0, atol=2e-5, err_msg=f"port vs JAX {src} -> {out}")
        with ops.reference_scope():
            np.testing.assert_array_equal(native_ops.resize_normalize(img, out, MEAN, STD), plain)
    boxes = np.asarray([[0.5, 1.5, 2.5, 3.5], [10.0, 20.0, 50.0, 70.0], [-1, -1, -1, -1],
                        [3.0, 7.0, 33.0, 47.0]], np.float32)
    labels = np.asarray([3, 1, -1, 7], np.int32)
    for rs, cs in ((1.0, 1.0), (0.5, 1.5), (128 / 375, 128 / 500), (1.6, 1.28)):
        got = native_ops.scale_boxes(boxes, labels, rs, cs)
        np.testing.assert_array_equal(got, native_ops.scale_boxes_plain(boxes, labels, rs, cs))
        np.testing.assert_array_equal(got, j_native.scale_boxes(boxes, labels, rs, cs))
    if native_ops.has_jpeg():
        assert native_ops.decode_jpeg_resize_normalize(b"not a jpeg", SIZE, MEAN, STD) is None
    else:  # built with -DFRCNN_NO_JPEG (no jpeglib.h): the reader decodes with PIL
        with pytest.raises(RuntimeError, match="libjpeg"):
            native_ops.decode_jpeg_resize_normalize(b"not a jpeg", SIZE, MEAN, STD)
    # a compiler that fails raises with its output; no numpy result comes back
    monkeypatch.setattr(native_ops, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(native_ops, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match=r"building the host library .* failed"):
        native_ops.resize_normalize(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8), (4, 4),
                                    MEAN, STD)
    assert not list((tmp_path / "host").glob("*.so"))
    monkeypatch.undo()


def _case_voc_reader(root):
    for use_difficult in (False, True):
        tcfg = tconfig.DataConfig(root_dir=root, image_size=SIZE, use_difficult=use_difficult)
        jcfg = jconfig.DataConfig(root_dir=root, image_size=SIZE, use_difficult=use_difficult)
        tds, jds = VOCDataset(tcfg, "val"), JVOCDataset(jcfg, "val")
        assert tds.ids == jds.ids and len(tds) == 3
        for i in range(len(tds)):
            got, want = tds[i], jds[i]
            assert set(got) == set(want)
            np.testing.assert_allclose(got["image"], want["image"], rtol=0, atol=2e-5)
            for k in ("boxes", "labels", "mask", "difficult"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"sample {i} {k}")
    assert tds[1]["difficult"].any()
    _case_make_dataset(root)


def _case_make_dataset(root):
    for kind, kw in (("voc", {}), ("synthetic", {"length": 3})):
        tcfg = tconfig.DataConfig(dataset=kind, root_dir=root, image_size=SIZE)
        jcfg = jconfig.DataConfig(dataset=kind, root_dir=root, image_size=SIZE)
        for split in ("train", "val"):
            tds, jds = make_dataset(tcfg, split, **kw), j_make_dataset(jcfg, split, **kw)
            assert type(tds).__name__ == type(jds).__name__ and len(tds) == len(jds) > 0
            for k, v in jds[len(jds) - 1].items():
                np.testing.assert_allclose(tds[len(tds) - 1][k], v, rtol=0, atol=2e-5)
    # the COCO reader, as JAX's, looks for the split's annotations under
    # root_dir (here a VOC tree: none)
    for mk, mod in ((make_dataset, tconfig), (j_make_dataset, jconfig)):
        with pytest.raises(FileNotFoundError, match="instances_train2017.json"):
            mk(mod.DataConfig(dataset="coco", root_dir=root), "train")
    with pytest.raises(ValueError, match="unknown dataset"):
        make_dataset(tconfig.DataConfig(dataset="imagenet"), "train")


def _case_loader():
    cfg = tconfig.DataConfig(image_size=(32, 32), max_boxes=4)
    ds = SyntheticDataset(cfg, length=7)
    jds = JSyntheticDataset(jconfig.DataConfig(image_size=(32, 32), max_boxes=4), length=7)
    for prefetch in (0, 2):
        loader = DataLoader(ds, batch_size=3, shuffle=False, drop_last=False, num_workers=2,
                            prefetch=prefetch)
        batches = list(loader)
        assert [len(b["image"]) for b in batches] == [3, 3, 1] and len(loader) == 3
        for b, idx in zip(batches, ([0, 1, 2], [3, 4, 5], [6])):
            want = collate([ds[i] for i in idx])
            assert all(np.array_equal(b[k], want[k]) for k in want)
        # the tail dropped, against the JAX loader's batches
        got = list(DataLoader(ds, batch_size=2, shuffle=False, num_workers=2,
                              prefetch=prefetch))
        want = list(JDataLoader(jds, batch_size=2, shuffle=False, num_workers=2,
                                prefetch=prefetch))
        assert len(got) == len(want) == 3
        for b, jb in zip(got, want):
            for k in jb:
                np.testing.assert_array_equal(b[k], jb[k])
        # the shuffled epoch order, from a mid-epoch start too
        loader = DataLoader(ds, batch_size=2, seed=3, num_workers=2, prefetch=prefetch)
        jloader = JDataLoader(jds, batch_size=2, seed=3, num_workers=2, prefetch=prefetch)
        orders = set()
        for epoch in range(3):
            for start in (0, 1, 2, 3):
                loader.set_epoch(epoch, start_batch=start)
                jloader.set_epoch(epoch, start_batch=start)
                got, want = list(loader), list(jloader)
                assert len(got) == len(want) == 3 - start
                for b, jb in zip(got, want):
                    for k in jb:
                        np.testing.assert_array_equal(b[k], jb[k])
                if start == 0:
                    orders.add(tuple(float(b["image"][i, 0, 0, 0]) for b in got
                                     for i in range(2)))
        assert len(orders) == 3  # each epoch its own order
    with pytest.raises(ValueError):
        loader.set_epoch(0, start_batch=-1)
    # a failing sample raises on the consumer's thread when the containment is off
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise OSError("truncated file")
            return ds[i]

    with pytest.raises(OSError, match="truncated"):
        list(DataLoader(Broken(), batch_size=2, num_workers=2, sample_skip_budget=0))
    # with the default containment (JAX's): retried, then the next index
    got = list(DataLoader(Broken(), batch_size=2, num_workers=2, shuffle=False))
    assert np.array_equal(got[1]["image"][0], ds[3]["image"])


def _case_tta_decode(tcfg, jcfg):
    rng = np.random.default_rng(6)
    n, r, c = 2, 48, 21

    def head_outputs():
        tl = rng.uniform(0, 100, (n, r, 2))
        rois = np.concatenate([tl, tl + rng.uniform(8, 60, (n, r, 2))], -1).astype(np.float32)
        valid = rng.uniform(size=(n, r)) < 0.9
        cls = rng.normal(0, 3, (n, r, c)).astype(np.float32)
        reg = rng.normal(0, 1, (n, r, c * 4)).astype(np.float32)
        return rois, valid, cls, reg

    plain, mirrored = head_outputs(), head_outputs()
    h, w = map(float, SIZE)
    want = j_detect.batched_decode_tta(tuple(map(jnp.asarray, plain)),
                                       tuple(map(jnp.asarray, mirrored)),
                                       h, w, jcfg.eval, jcfg.roi_targets)
    t = lambda arrs: tuple(torch.from_numpy(a) for a in arrs)  # noqa: E731
    got = detect.batched_decode_tta(t(plain), t(mirrored), h, w, tcfg.eval, tcfg.roi_targets)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0,
                               atol=1e-6)
    assert np.asarray(want["valid"]).sum() > 20
    # the one-image form, image by image, against JAX's decode_detections_tta
    for i in range(n):
        args = [a[i] for a in plain + mirrored]
        want = j_detect.decode_detections_tta(*map(jnp.asarray, args), h, w, jcfg.eval,
                                              jcfg.roi_targets)
        got = detect.decode_detections_tta(*t(args), h, w, tcfg.eval, tcfg.roi_targets)
        np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
        np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
        np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0,
                                   atol=1e-6)


def _near_threshold(dets, gts, thresholds):
    """(image, class, IoU) of every detection whose IoU with a gt of its
    class lies within 1e-2 of a threshold: where a match may flip."""
    near = []
    for i, (d, g) in enumerate(zip(dets, gts)):
        for box, cls in zip(d["boxes"], d["classes"]):
            sel = g["labels"] == cls
            if sel.any():
                for iou in j_voc._iou_one_to_many(box, g["boxes"][sel]):
                    if np.min(np.abs(np.asarray(thresholds) - iou)) < 1e-2:
                        near.append((i, int(cls), float(iou)))
    return near


def _case_evaluator(root):
    def cfgs(mod):
        cfg = mod.get_config("voc12_resnet18_align")
        return cfg.replace(
            model=dataclasses.replace(cfg.model, compute_dtype="float32"),
            data=dataclasses.replace(cfg.data, root_dir=root, image_size=SIZE),
            proposals=mod.ProposalConfig(pre_nms_train=192, post_nms_train=48,
                                         pre_nms_test=192, post_nms_test=48),
        )

    jcfg, tcfg = cfgs(jconfig), cfgs(tconfig)
    jmodel, variables = init_variables(jcfg, jax.random.PRNGKey(0))
    variables = _randomise(jax.tree_util.tree_map(np.array, dict(variables)),
                           np.random.default_rng(7))
    # temper the RPN and head outputs: with one class at ~0.99 the NMS leaves
    # one detection per image, and large deltas magnify the frameworks' rounding
    for layer in (variables["params"]["head"]["cls"], variables["params"]["head"]["reg"],
                  *variables["params"]["rpn"].values()):
        layer["kernel"] = (layer["kernel"] * 0.1).astype(np.float32)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    tmodel = build_model(tcfg, device="cpu", state_dict=from_flax_variables(variables))
    tds, jds = VOCDataset(tcfg.data, "val"), JVOCDataset(jcfg.data, "val")
    for tta in (False, True):
        jcfg_m = jcfg.replace(eval=dataclasses.replace(jcfg.eval, tta_hflip=tta))
        tcfg_m = tcfg.replace(eval=dataclasses.replace(tcfg.eval, tta_hflip=tta))
        jev, tev = JEvaluator(jcfg_m, jmodel), Evaluator(tcfg_m, device="cpu")
        jout, tout = [], []
        j_predict, t_predict = jev.predict_batch, tev._predict
        jev.predict_batch = lambda *a, **k: jout.append(j_predict(*a, **k)) or jout[-1]
        tev._predict = lambda *a, **k: tout.append(t_predict(*a, **k)) or tout[-1]
        for metric in ("voc", "coco"):
            # the same compiled program, scored by the other metric
            jev.config = jcfg_m.replace(eval=dataclasses.replace(jcfg_m.eval, metric=metric))
            tev.config = tcfg_m.replace(eval=dataclasses.replace(tcfg_m.eval, metric=metric))
            want = jev.evaluate(jvars, jds, batch_size=2)
            got = tev.evaluate(tmodel, tds, batch_size=2)
            # per-image detections (the JAX tail batch is padded to 2, the port's is not)
            dets, gts = [], []
            for tb, jb in zip(tout, jout):
                for i in range(len(tb["valid"])):
                    what = f"tta={tta} {metric} image {len(dets)}"
                    np.testing.assert_array_equal(tb["valid"][i], jb["valid"][i], err_msg=what)
                    np.testing.assert_array_equal(tb["classes"][i], jb["classes"][i],
                                                  err_msg=what)
                    np.testing.assert_allclose(tb["boxes"][i], jb["boxes"][i], rtol=0,
                                               atol=1e-3, err_msg=what)
                    np.testing.assert_allclose(tb["scores"][i], jb["scores"][i], rtol=0,
                                               atol=1e-6, err_msg=what)
                    v = tb["valid"][i]
                    dets.append({k: tb[k][i][v] for k in ("boxes", "scores", "classes")})
            assert len(dets) == 3 and sum(len(d["scores"]) for d in dets) >= 30
            for j in range(len(jds)):
                s = jds[j]
                real = s["labels"] >= 0
                gts.append({"boxes": s["boxes"][real], "labels": s["labels"][real]})
            scalars = summary_scalars(got, tcfg.model.num_classes)
            assert scalars == j_summary_scalars(got, jcfg.model.num_classes)
            assert "mAP" in scalars and any(k.startswith("AP/") for k in scalars)
            thresholds = [0.5] if metric == "voc" else list(j_coco.IOU_THRESHOLDS)
            near = _near_threshold(dets, gts, thresholds)
            assert set(got) == set(want)
            for k in want:
                x, y = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
                assert np.allclose(x, y, rtol=0, atol=1e-6, equal_nan=True), (
                    f"tta={tta} {metric} {k}: port {got[k]} vs JAX {want[k]}; detections "
                    f"within 1e-2 of an IoU threshold (image, class, IoU): {near}")
            jout.clear()
            tout.clear()
        # from a state dict: the evaluator builds its model at the first one
        fresh = Evaluator(tev.config, device="cpu")
        assert fresh.model is None
        _same(fresh.evaluate(tmodel.state_dict(), tds, batch_size=2), got, f"tta={tta} state dict")
    _case_cached_feeds(jcfg, tcfg, jmodel, jvars, tmodel, jds, tds)


def _case_cached_feeds(jcfg, tcfg, jmodel, jvars, tmodel, jds, tds):
    """The evaluator's cached feeds on the same weights: ``cache_device``
    (the set on the device once, a gather per batch, the 3-image set's tail
    padded to the batch of 2) and ``loader_cache_ram`` (the view kept across
    calls) against the loader-fed evaluation and JAX's ``_evaluate_cached``,
    and a uint8 (``device_normalize``) set through both port feeds against
    JAX's loader feed:
    every score within 1e-6 (the padded tail runs at batch 2 where the
    loader feed runs it at 1, and the CPU's convolutions may sum a batch of
    another size in another order)."""
    def with_data(cfg, **data):
        return cfg.replace(data=dataclasses.replace(cfg.data, **data))

    fed = Evaluator(tcfg, device="cpu").evaluate(tmodel, tds, batch_size=2)
    jev = JEvaluator(with_data(jcfg, cache_device=True), jmodel)
    want = jev.evaluate(jvars, jds, batch_size=2)
    assert jev._device_cache is not None  # JAX's _evaluate_cached ran
    tev = Evaluator(with_data(tcfg, cache_device=True), device="cpu")
    gathered = []
    t_predict = tev._predict
    tev._predict = lambda model, images, *a: gathered.append(images.shape) or t_predict(
        model, images, *a)
    got = tev.evaluate(tmodel, tds, batch_size=2)
    cache = tev._device_cache
    assert cache is not None and cache.host_meta is not None and gathered == [(2,) + SIZE + (3,)] * 2
    again = tev.evaluate(tmodel, tds, batch_size=2)
    assert tev._device_cache is cache  # uploaded once per dataset
    _same(again, got, "cache_device, second call")
    ram = Evaluator(with_data(tcfg, loader_cache_ram=True), device="cpu")
    got_ram = ram.evaluate(tmodel, tds, batch_size=2)
    view = ram._cached_view
    assert view is not None and view.nbytes > 0
    _same(ram.evaluate(tmodel, tds, batch_size=2), got_ram, "loader_cache_ram, second call")
    assert ram._cached_view is view
    _same(got_ram, fed, "loader_cache_ram vs loader-fed")
    # a uint8 set (device_normalize): the model normalizes the batch, as on
    # the JAX side, through the loader feed and through the device cache
    u8 = dict(device_normalize=True)
    tds8 = VOCDataset(with_data(tcfg, **u8).data, "val")
    jds8 = JVOCDataset(with_data(jcfg, **u8).data, "val")
    assert tds8[0]["image"].dtype == np.uint8
    want8 = JEvaluator(with_data(jcfg, **u8), jmodel).evaluate(jvars, jds8, batch_size=2)
    fed8 = Evaluator(with_data(tcfg, **u8), device="cpu").evaluate(tmodel, tds8, batch_size=2)
    got8 = Evaluator(with_data(tcfg, cache_device=True, **u8), device="cpu").evaluate(
        tmodel, tds8, batch_size=2)
    for name, a, b in (("cache_device vs loader-fed", got, fed),
                       ("cache_device vs JAX cached", got, want),
                       ("JAX cached vs loader-fed", want, fed),
                       ("uint8 loader-fed vs JAX", fed8, want8),
                       ("uint8 cache_device vs JAX", got8, want8)):
        assert set(a) == set(b), name
        for k in b:
            x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
            assert np.allclose(x, y, rtol=0, atol=1e-6, equal_nan=True), (name, k, x, y)


def test_eval_slice_matches_jax(tmp_path, monkeypatch):
    root = str(tmp_path / "voc")
    _write_voc_tree(root)
    _case_metrics()
    _case_resize(tmp_path, monkeypatch)
    _case_voc_reader(root)
    _case_loader()
    tcfg, jcfg = tconfig.get_config("voc12_resnet18_align"), jconfig.get_config(
        "voc12_resnet18_align")
    _case_tta_decode(tcfg, jcfg)
    _case_evaluator(root)
