"""Image prediction (counterpart of the JAX package's ``eval/predict.py``):
detections for image files, thresholded and named.

Requests go through the serving engine (``serving/engine.py::get_engine``):
it keeps the weights resident on the card, replays one captured graph per
bucket and batch size, and coalesces the paths of one call into
micro-batches. The engine maps boxes back to each image's own coordinates;
this module thresholds them and attaches class names.

Drawing the boxes onto the image (JAX ``draw_detections``, ``predict
--output``) needs ``utils/viz.py``, which the port does not have yet
(ROADMAP Queue A item 9): :func:`draw_detections` raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from replication_faster_rcnn_tpu_torch.config import VOC_CLASSES, FasterRCNNConfig
from replication_faster_rcnn_tpu_torch.device import DeviceLike
from replication_faster_rcnn_tpu_torch.serving.engine import get_engine

DRAW_NOT_PORTED = ("drawing detections needs utils/viz.py, which the port does not have yet "
                   "(ROADMAP Queue A item 9)")


def _class_names(config: FasterRCNNConfig) -> List[str]:
    return list(
        VOC_CLASSES
        if config.model.num_classes == len(VOC_CLASSES)
        else [str(i) for i in range(config.model.num_classes)]
    )


def _to_detections(out: Dict[str, Any], thresh: float, names) -> List[Dict]:
    """Engine result (boxes already in original-image coords) ->
    thresholded, score-sorted list of detection dicts."""
    results = []
    for i in range(out["valid"].shape[0]):
        if not out["valid"][i] or out["scores"][i] < thresh:
            continue
        cls = int(out["classes"][i])
        results.append(
            {
                "box": out["boxes"][i].tolist(),
                "score": float(out["scores"][i]),
                "class_id": cls,
                "class_name": names[cls],
            }
        )
    results.sort(key=lambda d: -d["score"])
    return results


def predict_images(
    config: FasterRCNNConfig,
    model,
    image_paths: Sequence[str],
    score_thresh: Optional[float] = None,
    engine=None,
    device: DeviceLike = None,
) -> List[List[Dict[str, Any]]]:
    """Detections for many images as one micro-batched engine pass.

    ``model`` is a :class:`FasterRCNN` holding the weights (the JAX
    function's ``model`` and ``variables`` in one); ``engine`` reuses a
    caller's :class:`InferenceEngine`, else the cached one for (config,
    weights, device) serves, in ``config.serving.params_dtype``. Every path
    is submitted before any result is awaited, so same-bucket images share
    flushes. Returns one list per path of ``{'box' [4] in the image's own coordinates (row
    first), 'score', 'class_id', 'class_name'}``, sorted by score."""
    eng = engine if engine is not None else get_engine(config, model.state_dict(),
                                                       device=device)
    futures = [eng.submit_path(p) for p in image_paths]
    thresh = config.eval.score_thresh if score_thresh is None else score_thresh
    names = _class_names(config)
    return [_to_detections(f.result(), thresh, names) for f in futures]


def predict_image(
    config: FasterRCNNConfig,
    model,
    image_path: str,
    score_thresh: Optional[float] = None,
    engine=None,
    device: DeviceLike = None,
) -> List[Dict[str, Any]]:
    """:func:`predict_images` for one image."""
    return predict_images(config, model, [image_path], score_thresh, engine, device)[0]


def draw_detections(image_path: str, detections, out_path: str) -> None:
    """Not ported yet: raises NotImplementedError (``DRAW_NOT_PORTED``)."""
    raise NotImplementedError(DRAW_NOT_PORTED)
