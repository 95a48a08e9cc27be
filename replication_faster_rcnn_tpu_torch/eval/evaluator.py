"""The inference program and the dataset evaluator (counterpart of the JAX
package's ``eval/evaluator.py`` and of ``train/warmup.py::make_int8_infer_fn``).

:func:`make_infer_fn` is forward + decode as one function, with flip
test-time augmentation when ``eval.tta_hflip`` is set; the serving engine
builds one per bucket. :class:`Evaluator` runs it over a dataset and scores
the detections on the host: VOC mAP@``eval.iou_thresh`` or the COCO
summary. Its feed is chosen as the JAX evaluator's: with
``data.cache_device`` the evaluation set is uploaded to the card once per
dataset (``data/device_cache.py::DeviceCache`` with ``keep_host_meta``) and
each batch gathers its images there (the image kernels), the ground truth
read from the host copy of the boxes and labels; otherwise the thread
loader builds the batches on the host, over a ``data/cache.py::CachedView``
kept across calls when ``data.loader_cache_ram`` is set. Evaluation always
uses thread workers, as JAX's does: forking a process that holds a CUDA
context in the middle of training is what ``data/loader.py`` warns about.
:func:`summary_scalars` flattens a result into the scalars the trainer logs.

Not ported: the data-parallel eval mesh and the strict-mode gate.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from replication_faster_rcnn_tpu_torch import ops
from replication_faster_rcnn_tpu_torch.config import COCO_CLASSES, VOC_CLASSES, FasterRCNNConfig
from replication_faster_rcnn_tpu_torch.data.loader import DataLoader
from replication_faster_rcnn_tpu_torch.device import DeviceLike, resolve_device
from replication_faster_rcnn_tpu_torch.eval.coco_eval import coco_summary
from replication_faster_rcnn_tpu_torch.eval.detect import batched_decode, batched_decode_tta
from replication_faster_rcnn_tpu_torch.eval.voc_eval import voc_ap
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN, functional_forward
from replication_faster_rcnn_tpu_torch.quant.apply import build_infer_variables
from replication_faster_rcnn_tpu_torch.telemetry import spans as tspans

Tensor = torch.Tensor
Outputs = Tuple[Tensor, Tensor, Tensor, Tensor]  # rois, roi_valid, cls, reg


def _check_size(images: Tensor, h: int, w: int) -> None:
    if tuple(images.shape[1:3]) != (h, w):
        raise ValueError(f"expected [N, {h}, {w}, 3] images, got {tuple(images.shape)}")


def _detect(forward: Callable[[Tensor], Outputs], images: Tensor, h: int, w: int,
            config: FasterRCNNConfig) -> Dict[str, Tensor]:
    """Forward + decode; with ``eval.tta_hflip`` a second forward on the
    images mirrored along W (NHWC dim 2), whose candidates the decode
    reflects back and merges."""
    plain = forward(images)
    if config.eval.tta_hflip:
        mirrored = forward(torch.flip(images, dims=[2]))
        return batched_decode_tta(plain, mirrored, float(h), float(w),
                                  config.eval, config.roi_targets)
    return batched_decode(*plain, float(h), float(w), config.eval, config.roi_targets)


def make_infer_fn(
    model: FasterRCNN,
    config: FasterRCNNConfig,
    image_size: Optional[Tuple[int, int]] = None,
) -> Callable[..., Dict[str, Tensor]]:
    """``infer(images, reference=False) -> detections`` for NHWC images of
    ``image_size`` (default ``config.data.image_size``) and a model in
    inference mode. ``reference=True`` runs the plain PyTorch versions of
    the kernels (:class:`ops.reference_scope`)."""
    h, w = image_size if image_size is not None else config.data.image_size

    def infer(images: Tensor, reference: bool = False) -> Dict[str, Tensor]:
        _check_size(images, h, w)
        with torch.inference_mode(), ops.reference_scope(reference):
            return _detect(lambda x: model(x)[2:6], images, h, w, config)

    return infer


def make_int8_infer_fn(
    model: FasterRCNN,
    config: FasterRCNNConfig,
    image_size: Optional[Tuple[int, int]] = None,
) -> Callable[..., Dict[str, Tensor]]:
    """``infer(qvars, images, reference=False) -> detections``: the int8
    serving program. Each call reconstructs the weights from the resident
    int8 tree ``qvars`` (``quant/apply.py::build_infer_variables``: one
    grouped dequantize of every int8 conv weight, straight into the compute
    dtype), then runs the same forward and decode as :func:`make_infer_fn`
    through ``torch.func.functional_call``, with the cls/reg layers as int8
    GEMMs.
    ``model`` supplies only the structure, so it may live on ``meta``."""
    h, w = image_size if image_size is not None else config.data.image_size

    def infer(qvars: Dict[str, Any], images: Tensor, reference: bool = False
              ) -> Dict[str, Tensor]:
        _check_size(images, h, w)
        with torch.inference_mode(), ops.reference_scope(reference):
            variables = build_infer_variables(qvars, config)

            def forward(x: Tensor) -> Outputs:
                return functional_forward(
                    model, variables["params"], x, variables.get("quant"))[2:6]

            return _detect(forward, images, h, w, config)

    return infer


def summary_scalars(result: Dict[str, Any], num_classes: int) -> Dict[str, float]:
    """Flatten an :meth:`Evaluator.evaluate` result into flat floats, the
    same schema for the VOC and COCO metrics: every scalar aggregate
    (``mAP``, and for COCO ``AP50``, ``AP75``, ``AP_small``, ...) plus one
    ``AP/<class name>`` per class that has ground truth. Names come from
    the VOC or COCO vocabulary when ``num_classes`` matches one, else the
    class index."""
    names = {
        len(VOC_CLASSES): VOC_CLASSES,
        len(COCO_CLASSES): COCO_CLASSES,
    }.get(num_classes, tuple(str(i) for i in range(num_classes)))
    out = {
        k: float(v)
        for k, v in result.items()
        if np.isscalar(v) or getattr(v, "ndim", None) == 0
    }
    aps = result.get("ap_per_class")
    if aps is not None:
        for c in range(1, num_classes):
            if np.isfinite(aps[c]):
                out[f"AP/{names[c]}"] = float(aps[c])
    return out


ModelOrParams = Union[nn.Module, Dict[str, Tensor]]


class Evaluator:
    """``Evaluator(config, model=None, device=None)``: the device defaults to
    ``cuda`` (raising without a GPU). ``model`` receives the weights when
    :meth:`evaluate` is given a state dict instead of a model; without one,
    the first state dict builds a :class:`FasterRCNN` on the device."""

    def __init__(self, config: FasterRCNNConfig, model: Optional[FasterRCNN] = None,
                 device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.model = model
        # the evaluation set's caches, kept across calls for the same dataset
        self._device_cache_base = self._device_cache = None
        self._cached_base = self._cached_view = None

    def _model(self, model_or_params: ModelOrParams) -> nn.Module:
        if isinstance(model_or_params, nn.Module):
            return model_or_params
        if self.model is None:
            self.model = FasterRCNN(self.config, device=self.device)
        self.model.load_state_dict(model_or_params)
        return self.model

    @contextlib.contextmanager
    def _inference(self, model_or_params: ModelOrParams):
        """The model in inference mode (BatchNorm on its running statistics)
        for the block; a model that was training is switched back after."""
        model = self._model(model_or_params)
        was_training = model.training
        model.eval()
        try:
            yield model
        finally:
            model.train(was_training)

    def _predict(self, model: nn.Module, images, reference: bool = False
                 ) -> Dict[str, np.ndarray]:
        """Detections of an NHWC batch: a numpy array (uint8 images are
        normalized by the model, as on the JAX side) or a tensor on the
        model's device."""
        dev = next(model.parameters()).device
        batch = images if isinstance(images, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(images)).to(dev)
        h, w = batch.shape[1:3]
        out = make_infer_fn(model, self.config, (h, w))(batch, reference=reference)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def predict_batch(self, model_or_params: ModelOrParams, images: np.ndarray,
                      reference: bool = False) -> Dict[str, np.ndarray]:
        """Detections of one NHWC batch (float32, or uint8 normalized by the
        model), as numpy arrays of [N, D, ...]."""
        with self._inference(model_or_params) as model:
            return self._predict(model, images, reference)

    def _score(self, detections: List[Dict[str, np.ndarray]],
               gts: List[Dict[str, np.ndarray]]) -> Dict[str, Any]:
        if self.config.eval.metric == "coco":
            return coco_summary(detections, gts, self.config.model.num_classes,
                                max_dets=self.config.eval.max_detections)
        return voc_ap(detections, gts, self.config.model.num_classes,
                      iou_thresh=self.config.eval.iou_thresh,
                      use_07_metric=self.config.eval.use_07_metric)

    def _evaluate_cached(self, model: nn.Module, dataset, batch_size: int,
                         max_images: Optional[int]) -> Dict[str, Any]:
        """The device-resident sweep (JAX ``_evaluate_cached``): the images
        go to the card once per dataset, then each batch costs the host an
        index vector; the gather runs on the card (the image kernels through
        ``materialize_batch``). The tail is padded to ``batch_size`` with
        its last index, as JAX pads it, and only its real rows are scored.
        Ground truth comes from the cache's ``host_meta``."""
        from replication_faster_rcnn_tpu_torch.data.device_cache import (
            DeviceCache,
            materialize_batch,
        )

        if self._device_cache_base is not dataset:
            self._device_cache_base = dataset
            self._device_cache = DeviceCache(dataset, device=self.device, keep_host_meta=True)
        cache = self._device_cache
        meta = cache.host_meta
        dev = cache.arrays["image"].device
        tracer = tspans.current_tracer()
        detections: List[Dict[str, np.ndarray]] = []
        gts: List[Dict[str, np.ndarray]] = []
        for start in range(0, len(cache), batch_size):
            idxs = np.arange(start, min(start + batch_size, len(cache)), dtype=np.int32)
            k = len(idxs)
            if k < batch_size:  # pad the tail to the batch
                idxs = np.concatenate([idxs, np.full(batch_size - k, idxs[-1], np.int32)])
            with tracer.span("eval/infer", cat="eval", feed="device_cache"):
                sel = {"idx": torch.from_numpy(idxs).to(dev)}
                out = self._predict(model, materialize_batch(cache.arrays, sel)["image"])
            for i in range(k):
                j = start + i
                valid = out["valid"][i]
                detections.append({key: out[key][i][valid] for key in ("boxes", "scores",
                                                                        "classes")})
                lab = meta["labels"][j]
                diff = meta.get("difficult")
                diff = diff[j] if diff is not None else np.zeros_like(lab, bool)
                real = lab >= 0
                gts.append({"boxes": meta["boxes"][j][real], "labels": lab[real],
                            "ignore": diff[real]})
            if max_images is not None and len(detections) >= max_images:
                break
        return self._score(detections, gts)

    def evaluate(self, model_or_params: ModelOrParams, dataset, batch_size: int = 8,
                 max_images: Optional[int] = None) -> Dict[str, Any]:
        """Detect over ``dataset`` in order and score against its ground
        truth: ``{'mAP', 'ap_per_class', ...}`` as the JAX evaluator returns
        it. The feed follows the config (the module docstring): the device
        cache, or the loader over the dataset or its RAM cache. In the
        loader feed a short tail batch runs at its own size (the outputs of
        an image do not depend on the others in its batch, so nothing is
        padded). Difficult objects are ground truth marked ``ignore``."""
        data = self.config.data
        if data.cache_device:
            with self._inference(model_or_params) as model:
                return self._evaluate_cached(model, dataset, batch_size, max_images)
        if data.loader_cache_ram:
            # kept across calls: in-training evaluation passes the same
            # dataset every time, and a cache made per call saves nothing
            if self._cached_base is not dataset:
                from replication_faster_rcnn_tpu_torch.data.cache import CachedView

                self._cached_base = dataset
                self._cached_view = CachedView(dataset)
            dataset = self._cached_view
        loader = DataLoader(dataset, batch_size=batch_size, shuffle=False, drop_last=False,
                            prefetch=data.loader_prefetch, num_workers=data.loader_workers,
                            worker_mode="thread")
        detections: List[Dict[str, np.ndarray]] = []
        gts: List[Dict[str, np.ndarray]] = []
        tracer = tspans.current_tracer()
        with self._inference(model_or_params) as model:
            for batch in loader:
                with tracer.span("eval/infer", cat="eval", feed="loader"):
                    out = self._predict(model, batch["image"])
                for i in range(len(batch["image"])):
                    valid = out["valid"][i]
                    detections.append({k: out[k][i][valid] for k in ("boxes", "scores", "classes")})
                    lab = batch["labels"][i]
                    diff = batch.get("difficult")
                    diff = diff[i] if diff is not None else np.zeros_like(lab, bool)
                    real = lab >= 0
                    gts.append({"boxes": batch["boxes"][i][real], "labels": lab[real],
                                "ignore": diff[real]})
                if max_images is not None and len(detections) >= max_images:
                    break
        return self._score(detections, gts)
