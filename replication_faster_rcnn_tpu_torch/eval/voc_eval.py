"""VOC-style mAP@IoU evaluator (numpy, host-side): a copy of the JAX
package's ``eval/voc_eval.py``, kept verbatim (float64, the same sort
orders) so the two packages score the same detections bitwise alike.

The reference contains no evaluation at all (SURVEY.md §2.1 #15), so this
implements the standard Pascal VOC protocol from its published definition:
per-class ranked matching of detections to gt at an IoU threshold, each gt
matched at most once, precision/recall curve summarized either by the
VOC2007 11-point interpolation or the VOC2010+ area-under-curve (both
offered; EvalConfig.use_07_metric selects).

Inputs are plain numpy accumulated across the eval set — metric math stays
off-device (tiny, branchy, once per epoch).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _ap_from_pr(recall: np.ndarray, precision: np.ndarray, use_07: bool) -> float:
    if use_07:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    # VOC2010+: area under the monotonically-decreasing precision envelope
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    changed = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[changed + 1] - mrec[changed]) * mpre[changed + 1]))


def _iou_one_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    tl = np.maximum(box[:2], boxes[:, :2])
    br = np.minimum(box[2:], boxes[:, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = a + b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def _class_iou_rows(detections, ground_truths, cls):
    """Per-class matching state shared by both metrics: score-sorted
    [(score, img_i, iou_row)] with the FULL IoU vector against that image's
    gts kept per detection, plus per-image ignore masks and the non-ignored
    gt count. The VOC devkit path freezes each detection's argmax from the
    row; the COCO sweep re-matches per threshold."""
    gt_boxes = []
    gt_ignore = []
    n_gt = 0
    for g in ground_truths:
        sel = g["labels"] == cls
        ig = np.asarray(g.get("ignore", np.zeros(len(g["labels"]), bool)))[sel]
        gt_boxes.append(g["boxes"][sel])
        gt_ignore.append(ig)
        n_gt += int((~ig).sum())

    recs = []
    for img_i, d in enumerate(detections):
        sel = d["classes"] == cls
        for b, s in zip(d["boxes"][sel], d["scores"][sel]):
            gts = gt_boxes[img_i]
            iou_row = _iou_one_to_many(b, gts) if len(gts) else np.zeros(0)
            recs.append((float(s), img_i, iou_row))
    recs.sort(key=lambda t: -t[0])
    return recs, n_gt, gt_ignore


def _pr_tail(tp, fp, n_gt, use_07_metric):
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-9)
    return _ap_from_pr(recall, precision, use_07_metric)


def _ap_devkit(recs, n_gt, gt_ignore, iou_thresh, use_07_metric):
    """AP at one threshold with VOC-devkit semantics: each detection is
    pinned to its argmax-IoU gt; if that gt clears the threshold it is a TP
    once and an FP on re-detection; ignored (difficult) gt -> neither."""
    if n_gt == 0:
        return np.nan
    if not recs:
        return 0.0
    matched = [np.zeros(len(ig), bool) for ig in gt_ignore]
    tp = np.zeros(len(recs))
    fp = np.zeros(len(recs))
    for k, (_, img_i, iou_row) in enumerate(recs):
        j = int(iou_row.argmax()) if len(iou_row) else -1
        if j >= 0 and iou_row[j] >= iou_thresh:
            if gt_ignore[img_i][j]:
                pass  # difficult gt: neither TP nor FP
            elif not matched[img_i][j]:
                tp[k] = 1
                matched[img_i][j] = True
            else:
                fp[k] = 1
        else:
            fp[k] = 1
    return _pr_tail(tp, fp, n_gt, use_07_metric)


def voc_ap(
    detections: Sequence[Dict[str, np.ndarray]],
    ground_truths: Sequence[Dict[str, np.ndarray]],
    num_classes: int,
    iou_thresh: float = 0.5,
    use_07_metric: bool = False,
) -> Dict[str, float]:
    """Compute per-class AP and mAP.

    Args (parallel lists over images):
      detections[i]: {'boxes' [D,4], 'scores' [D], 'classes' [D]} (valid only)
      ground_truths[i]: {'boxes' [G,4], 'labels' [G], optional 'ignore' [G]}
        — 'ignore' marks VOC "difficult" objects: excluded from the gt count
        and detections matching them score as neither TP nor FP (official
        devkit semantics).

    Returns {'mAP': float, 'ap_per_class': [num_classes] (nan where no gt)}.
    """
    aps = np.full(num_classes, np.nan)
    for cls in range(1, num_classes):
        recs, n_gt, gt_ignore = _class_iou_rows(detections, ground_truths, cls)
        aps[cls] = _ap_devkit(recs, n_gt, gt_ignore, iou_thresh, use_07_metric)

    valid = ~np.isnan(aps[1:])
    m_ap = float(aps[1:][valid].mean()) if valid.any() else 0.0
    return {"mAP": m_ap, "ap_per_class": aps}


def _ap_greedy(recs, n_gt, gt_ignore, iou_thresh, use_07_metric):
    """AP at one threshold with pycocotools matching semantics: each
    detection (in score order) takes the highest-IoU *still-unmatched,
    non-ignored* gt with IoU >= t; if none, an ignored gt with IoU >= t
    absorbs it (neither TP nor FP, and ignored gts may absorb several);
    otherwise FP."""
    if n_gt == 0:
        return np.nan
    if not recs:
        return 0.0
    matched = [np.zeros(len(ig), bool) for ig in gt_ignore]
    tp, fp = [], []
    for score, img_i, iou_row in recs:
        ok = iou_row >= iou_thresh
        real = ok & ~gt_ignore[img_i] & ~matched[img_i]
        if real.any():
            j = int(np.where(real, iou_row, -1.0).argmax())
            matched[img_i][j] = True
            tp.append(1.0)
            fp.append(0.0)
        elif (ok & gt_ignore[img_i]).any():
            continue  # matched an ignored gt: excluded from the PR curve
        else:
            tp.append(0.0)
            fp.append(1.0)
    return _pr_tail(np.asarray(tp), np.asarray(fp), n_gt, use_07_metric)


def coco_map(
    detections: Sequence[Dict[str, np.ndarray]],
    ground_truths: Sequence[Dict[str, np.ndarray]],
    num_classes: int,
    iou_thresholds: Optional[Sequence[float]] = None,
) -> Dict[str, float]:
    """COCO-style mAP: mean AP over IoU thresholds .50:.05:.95 (for the
    COCO-2017 config, BASELINE.json #5). Per-class IoU rows are computed
    once; each threshold re-runs the greedy best-unmatched-gt assignment
    (pycocotools semantics — a detection may match different gts at
    different thresholds, unlike the VOC devkit's frozen argmax)."""
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)
    per_class = {
        cls: _class_iou_rows(detections, ground_truths, cls)
        for cls in range(1, num_classes)
    }
    per_thresh = []
    per_thresh_cls = []
    for t in iou_thresholds:
        aps = np.asarray(
            [
                _ap_greedy(*per_class[cls], float(t), False)
                for cls in range(1, num_classes)
            ]
        )
        per_thresh_cls.append(aps)
        valid = ~np.isnan(aps)
        per_thresh.append(float(aps[valid].mean()) if valid.any() else 0.0)
    out = {"mAP": float(np.mean(per_thresh))}
    # per-class AP averaged over the threshold sweep. A class's AP is NaN
    # iff it has no gt, which is threshold-independent, so plain mean is
    # exact: columns are either all-NaN (propagates) or all-finite.
    ap_per_class = np.full(num_classes, np.nan)
    ap_per_class[1:] = np.stack(per_thresh_cls).mean(axis=0)
    out["ap_per_class"] = ap_per_class
    for t, v in zip(iou_thresholds, per_thresh):
        if abs(t - 0.5) < 1e-9:
            out["AP50"] = v
        if abs(t - 0.75) < 1e-9:
            out["AP75"] = v
    return out
