"""Bucketed, micro-batched inference engine (a reduced counterpart of the JAX
package's ``serving/engine.py``).

* **Shape buckets.** Requests are routed to the smallest resolution bucket
  that contains them (``select_bucket``); each bucket has one inference
  function (``eval/evaluator.py::make_infer_fn``) and a flush pads to the
  smallest of ``serving.batch_sizes`` that fits.
* **Resident params.** The model's parameters and buffers are cast once to
  ``serving.params_dtype`` and stay on the device; requests ship images.
  Under ``params_dtype="int8"`` the resident tree is the quantized one
  (``quant/apply.py``: int8 weights + per-channel scales, the rest bfloat16,
  driven by the CRC-checked calibration sidecar); every flush reconstructs
  the compute-dtype weights with one launch of the grouped dequantize
  kernel (its descriptor table built at the first flush) and runs the
  detection head's cls/reg layers as int8 GEMMs. No float copy of the
  weights stays on the device, and nothing reconstructed is kept between
  flushes.
* **Continuous micro-batching.** ``MicroBatcher`` groups requests by
  (bucket, reference) and flushes on size or ``serving.max_delay_ms``;
  each request's boxes are de-normalised back to its original image size.

Hot-swap, fleet, SLO control and admission control are not ported yet.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from replication_faster_rcnn_tpu_torch.config import FasterRCNNConfig
from replication_faster_rcnn_tpu_torch.data.native_ops import resize_normalize
from replication_faster_rcnn_tpu_torch.device import DeviceLike, resolve_device
from replication_faster_rcnn_tpu_torch.eval.evaluator import make_infer_fn, make_int8_infer_fn
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN, build_model
from replication_faster_rcnn_tpu_torch.quant import (
    default_artifact_path,
    load_artifact,
    quantize_variables,
    quantized_params_bytes,
)
from replication_faster_rcnn_tpu_torch.quant.apply import tree_to
from replication_faster_rcnn_tpu_torch.serving.batcher import MicroBatcher

__all__ = ["InferenceEngine", "OversizedImageError", "select_bucket"]


class OversizedImageError(ValueError):
    """Request larger than every bucket under ``serving.oversize="reject"``."""


def select_bucket(
    resolutions: Sequence[Tuple[int, int]],
    orig_h: int,
    orig_w: int,
    oversize: str = "downscale",
) -> Tuple[int, int]:
    """The smallest bucket that contains (orig_h, orig_w). Images bigger
    than every bucket follow the oversize policy: route to the largest
    bucket (lossy downscale) or refuse."""
    ordered = sorted(resolutions, key=lambda r: (r[0] * r[1], r))
    if not ordered:
        raise ValueError("no serving resolutions configured")
    for h, w in ordered:
        if orig_h <= h and orig_w <= w:
            return (h, w)
    if oversize == "reject":
        raise OversizedImageError(
            f"image {orig_h}x{orig_w} exceeds every serving bucket "
            f"{list(ordered)} and serving.oversize='reject'"
        )
    return ordered[-1]


class InferenceEngine:
    """Micro-batched detector serving for one config on one device (default
    ``cuda``), with the weights of ``state_dict`` (e.g. bridged from the JAX
    package by ``models/convert.py``) or a seeded random init.

    ``params_dtype="int8"`` needs the calibration sidecar: ``artifact_path``,
    else ``quant.artifact``, else ``./quant_artifact.json``
    (``quant/artifact.py::default_artifact_path``); a missing or corrupt one
    raises :class:`QuantArtifactError` before anything is built."""

    def __init__(
        self,
        config: FasterRCNNConfig,
        device: DeviceLike = None,
        state_dict: Optional[dict] = None,
        seed: int = 0,
        artifact_path: Optional[str] = None,
    ) -> None:
        self.config = config
        self.params_dtype = config.serving.params_dtype
        self.buckets = config.serving.bucket_resolutions(config.data.image_size)
        self.batch_sizes = tuple(sorted(set(config.serving.batch_sizes)))
        self.quant_artifact_path: Optional[str] = None
        if self.params_dtype == "int8":
            self.quant_artifact_path = artifact_path or default_artifact_path(config)
            artifact = load_artifact(self.quant_artifact_path)
            self.device = resolve_device(device)
            if state_dict is None:  # the seeded init, drawn on the serving device
                state_dict = build_model(config, device=self.device, seed=seed).state_dict()
            # the structure only: the weights come from the resident tree per flush
            self.model = FasterRCNN(config, device="meta")
            self.qvars = tree_to(quantize_variables(state_dict, artifact), self.device)
            del state_dict
            self.params_bytes = quantized_params_bytes(self.qvars)
            self._infer = {
                b: functools.partial(make_int8_infer_fn(self.model, config, b), self.qvars)
                for b in self.buckets
            }
        else:
            model = build_model(config, device=device, seed=seed, state_dict=state_dict)
            self.device = model.device
            self.model = model.to(getattr(torch, self.params_dtype))
            self.params_bytes = sum(
                t.numel() * t.element_size()
                for t in list(self.model.parameters()) + list(self.model.buffers())
            )
            self._infer = {b: make_infer_fn(self.model, config, b) for b in self.buckets}
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "flushes": 0, "padded_slots": 0}
        # wall seconds of recent flushes (transfer + forward + decode + copy back)
        self.flush_seconds: "collections.deque[float]" = collections.deque(maxlen=1024)
        self._batcher = MicroBatcher(
            self._process_bucket,
            max_batch=self.batch_sizes[-1],
            max_delay_s=config.serving.max_delay_ms / 1000.0,
            depth=config.serving.queue_depth,
            name="serving-micro-batcher",
        )

    # ------------------------------------------------------------- requests

    def _prepare(self, image: np.ndarray, orig_size: Optional[Tuple[int, int]]):
        """-> (bucket, (float32 image at bucket size, orig_h, orig_w))."""
        image = np.asarray(image)
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"expected [H, W, 3] image, got {image.shape}")
        if image.dtype == np.uint8:
            orig_h, orig_w = image.shape[:2]
            bucket = select_bucket(self.buckets, orig_h, orig_w, self.config.serving.oversize)
            image = resize_normalize(
                image, bucket, self.config.data.pixel_mean, self.config.data.pixel_std
            )
        else:
            bucket = tuple(image.shape[:2])
            if bucket not in set(self.buckets):
                raise ValueError(
                    f"float image shape {image.shape[:2]} matches no serving "
                    f"bucket {list(self.buckets)}; pass uint8 for automatic routing"
                )
            orig_h, orig_w = orig_size if orig_size else bucket
        return bucket, (np.asarray(image, np.float32), int(orig_h), int(orig_w))

    def submit(
        self,
        image: np.ndarray,
        orig_size: Optional[Tuple[int, int]] = None,
        timeout: Optional[float] = None,
        reference: bool = False,
    ) -> Future:
        """Enqueue one image; the Future resolves to a detection dict
        (``boxes`` [D, 4] in ORIGINAL image coordinates, ``scores``,
        ``classes``, ``valid``). uint8 [H, W, 3] input of any size is
        bucket-routed and resized on the caller's thread; float32 input must
        match a bucket exactly (``orig_size`` is then its pre-resize size).
        ``reference=True`` serves it through the kernels' plain versions."""
        bucket, item = self._prepare(image, orig_size)
        return self._batcher.submit((bucket, bool(reference)), item, timeout=timeout)

    def predict(self, images: Sequence[np.ndarray], reference: bool = False
                ) -> List[Dict[str, np.ndarray]]:
        """Resize every image first, then enqueue them back to back (so they
        coalesce into as few flushes as the batch sizes allow) and wait."""
        prepared = [self._prepare(img, None) for img in images]
        futures = [
            self._batcher.submit((bucket, bool(reference)), item)
            for bucket, item in prepared
        ]
        return [f.result() for f in futures]

    # ---------------------------------------------------------------- flush

    def _process_bucket(self, key, items: List[Any]) -> List[Dict[str, np.ndarray]]:
        """One micro-batch: pad to the smallest batch size that fits, run
        the bucket's inference function, un-pad, de-normalise boxes."""
        (h, w), reference = key
        n = len(items)
        bn = next((b for b in self.batch_sizes if b >= n), self.batch_sizes[-1])
        batch = np.zeros((bn, h, w, 3), np.float32)
        for i, (image, _, _) in enumerate(items):
            batch[i] = image
        t0 = time.perf_counter()
        out = self._infer[(h, w)](torch.from_numpy(batch).to(self.device), reference)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        self.flush_seconds.append(time.perf_counter() - t0)
        with self._stats_lock:
            self._stats["requests"] += n
            self._stats["flushes"] += 1
            self._stats["padded_slots"] += bn - n
        results = []
        for i, (_, orig_h, orig_w) in enumerate(items):
            back = np.asarray([orig_h / h, orig_w / w, orig_h / h, orig_w / w], np.float32)
            results.append(
                {
                    "boxes": out["boxes"][i] * back,
                    "scores": out["scores"][i],
                    "classes": out["classes"][i],
                    "valid": out["valid"][i],
                }
            )
        return results

    # ------------------------------------------------------------ lifecycle

    @property
    def stats(self) -> Dict[str, int]:
        with self._stats_lock:
            return dict(self._stats)

    @property
    def flush_log(self) -> List[Tuple[Any, int]]:
        """((bucket, reference), n_requests) per flush, oldest first."""
        return self._batcher.flush_log

    def close(self) -> None:
        self._batcher.close()

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
