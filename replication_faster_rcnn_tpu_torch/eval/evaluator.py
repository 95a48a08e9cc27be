"""The inference program: forward + decode as one function (counterpart of
the JAX package's ``eval/evaluator.py::make_infer_fn`` and of
``train/warmup.py::make_int8_infer_fn``; the mAP evaluator is not ported
yet)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from replication_faster_rcnn_tpu_torch import ops
from replication_faster_rcnn_tpu_torch.config import FasterRCNNConfig
from replication_faster_rcnn_tpu_torch.eval.detect import batched_decode
from replication_faster_rcnn_tpu_torch.models.faster_rcnn import FasterRCNN, functional_forward
from replication_faster_rcnn_tpu_torch.quant.apply import build_infer_variables

Tensor = torch.Tensor


def _check_size(images: Tensor, h: int, w: int) -> None:
    if tuple(images.shape[1:3]) != (h, w):
        raise ValueError(f"expected [N, {h}, {w}, 3] images, got {tuple(images.shape)}")


def make_infer_fn(
    model: FasterRCNN,
    config: FasterRCNNConfig,
    image_size: Optional[Tuple[int, int]] = None,
) -> Callable[..., Dict[str, Tensor]]:
    """``infer(images, reference=False) -> detections`` for NHWC images of
    ``image_size`` (default ``config.data.image_size``; the serving engine
    builds one per bucket). ``reference=True`` runs the plain PyTorch
    versions of the kernels (:class:`ops.reference_scope`)."""
    h, w = image_size if image_size is not None else config.data.image_size

    def infer(images: Tensor, reference: bool = False) -> Dict[str, Tensor]:
        _check_size(images, h, w)
        with torch.inference_mode(), ops.reference_scope(reference):
            _, _, rois, valid, cls, reg, _ = model(images)
            return batched_decode(
                rois, valid, cls, reg, float(h), float(w),
                config.eval, config.roi_targets,
            )

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
            _, _, rois, valid, cls, reg, _ = functional_forward(
                model, variables["params"], images, variables.get("quant")
            )
            return batched_decode(
                rois, valid, cls, reg, float(h), float(w),
                config.eval, config.roi_targets,
            )

    return infer
