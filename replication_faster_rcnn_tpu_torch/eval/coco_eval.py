"""COCO-protocol detection evaluator (numpy, host-side, dependency-free): a
copy of the JAX package's ``eval/coco_eval.py``, kept verbatim so the two
packages score the same detections bitwise alike.

pycocotools is not in this image (data/coco.py parses annotations with
stdlib json for the same reason), so this reimplements COCOeval's bbox
protocol from its published definition:

* AP is the mean of interpolated precision sampled at 101 recall points
  (np.linspace(0, 1, 101)), not the area under the raw PR curve that
  `voc_eval.coco_map` computes — the two differ by the sampling grid.
* mAP@[.5:.95] averages that AP over the 10 IoU thresholds .50:.05:.95.
* Per-detection matching is greedy in score order: the best-IoU
  *still-unmatched* gt above the threshold wins, non-ignored gts
  preferred over ignored ones; a detection whose only match is an
  ignored gt is excluded from the PR curve (neither TP nor FP).
* Area-range breakdowns (small < 32^2 <= medium < 96^2 <= large) reuse
  the same machinery with out-of-range gts marked ignored and unmatched
  out-of-range detections excluded — COCOeval's aRng ignore semantics.
  Areas are box areas in the evaluated coordinate frame (the resized
  canvas); COCO's own numbers use segmentation areas at native
  resolution, so absolute breakdowns shift, but the semantics are the
  COCO ones and self-consistent across runs.
* maxDets=100 detections per image per class (score-ranked) by default.

Aggregates mirror COCOeval's convention of -1 when a slice has no
ground truth at all (instead of NaN, which JSON records cannot hold);
per-class entries stay NaN so downstream consumers can mask them.

Matching semantics are pinned against hand-computed oracles in
tests/test_eval.py (TestCocoEval101), which is what "COCO-style" means
here — exact, not approximate.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from replication_faster_rcnn_tpu_torch.eval.voc_eval import _iou_one_to_many

# the 10-threshold sweep .50:.05:.95 and the 101-point recall grid
IOU_THRESHOLDS: np.ndarray = np.linspace(0.5, 0.95, 10)
RECALL_POINTS: np.ndarray = np.linspace(0.0, 1.0, 101)
# (name, lo, hi): gt/detections with box area outside [lo, hi] are
# ignored for that slice (COCOeval areaRng, in resized-canvas pixels^2)
AREA_RANGES = (
    ("all", 0.0, float("inf")),
    ("small", 0.0, 32.0 ** 2),
    ("medium", 32.0 ** 2, 96.0 ** 2),
    ("large", 96.0 ** 2, float("inf")),
)


def _box_areas(boxes: np.ndarray) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros(0)
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def _gather_class(detections, ground_truths, cls: int, max_dets: int):
    """Per-image matching state for one class: the det x gt IoU matrix
    plus det scores/areas (score-sorted, top max_dets per image) and gt
    base-ignore flags/areas. Computed once per class; every (threshold,
    area range) cell re-runs only the greedy assignment over it."""
    per_img = []
    for d, g in zip(detections, ground_truths):
        dsel = d["classes"] == cls
        dbox = np.asarray(d["boxes"])[dsel]
        dsc = np.asarray(d["scores"])[dsel]
        order = np.argsort(-dsc, kind="stable")[:max_dets]
        dbox, dsc = dbox[order], dsc[order]
        gsel = g["labels"] == cls
        gbox = np.asarray(g["boxes"])[gsel]
        gig = np.asarray(
            g.get("ignore", np.zeros(len(g["labels"]), bool))
        )[gsel].astype(bool)
        if len(dbox) and len(gbox):
            iou = np.stack([_iou_one_to_many(b, gbox) for b in dbox])
        else:
            iou = np.zeros((len(dbox), len(gbox)))
        per_img.append(
            {
                "scores": dsc,
                "det_areas": _box_areas(dbox),
                "iou": iou,
                "gt_ignore": gig,
                "gt_areas": _box_areas(gbox),
            }
        )
    return per_img


def _match_class(per_img, iou_t: float, lo: float, hi: float):
    """COCOeval's per-image greedy assignment at one (threshold, area
    range): each detection takes the highest-IoU unmatched gt clearing
    the threshold, preferring non-ignored gts (never trading a found
    real match for an ignored one); unlike the VOC-devkit rule a gt is
    consumed even when ignored. Returns the concatenated (scores, tp,
    det_ignore) across images plus the non-ignored gt count."""
    all_scores: List[np.ndarray] = []
    all_tp: List[np.ndarray] = []
    all_ig: List[np.ndarray] = []
    n_gt = 0
    thresh = min(iou_t, 1.0 - 1e-10)
    for rec in per_img:
        gig = (
            rec["gt_ignore"]
            | (rec["gt_areas"] < lo)
            | (rec["gt_areas"] > hi)
        )
        n_gt += int((~gig).sum())
        gt_order = np.argsort(gig, kind="stable")  # real gts first
        n_d = len(rec["scores"])
        matched = np.zeros(len(gig), bool)
        d_tp = np.zeros(n_d, bool)
        d_ig = np.zeros(n_d, bool)
        for di in range(n_d):
            best, best_iou = -1, thresh
            for gi in gt_order:
                if matched[gi]:
                    continue
                if best >= 0 and not gig[best] and gig[gi]:
                    break  # a real match stands; ignored gts can't take it
                if rec["iou"][di, gi] < best_iou:
                    continue
                best_iou = rec["iou"][di, gi]
                best = gi
            if best >= 0:
                matched[best] = True
                if gig[best]:
                    d_ig[di] = True  # absorbed by an ignored gt
                else:
                    d_tp[di] = True
            else:
                # unmatched detection outside the area range: not this
                # slice's problem (it would be an FP only at "all")
                area = rec["det_areas"][di] if n_d else 0.0
                d_ig[di] = bool(area < lo or area > hi)
        all_scores.append(rec["scores"])
        all_tp.append(d_tp)
        all_ig.append(d_ig)
    return (
        np.concatenate(all_scores) if all_scores else np.zeros(0),
        np.concatenate(all_tp) if all_tp else np.zeros(0, bool),
        np.concatenate(all_ig) if all_ig else np.zeros(0, bool),
        n_gt,
    )


def _ap_101(scores, tp, det_ignore, n_gt) -> float:
    """101-point interpolated AP from one class's matched detections:
    global score sort, cumulate TP/FP over non-ignored detections, take
    the monotone precision envelope, sample it at RECALL_POINTS. NaN
    when the class has no (non-ignored) gt in this slice."""
    if n_gt == 0:
        return float("nan")
    keep = ~det_ignore
    order = np.argsort(-scores[keep], kind="stable")
    tp_sorted = tp[keep][order]
    if len(tp_sorted) == 0:
        return 0.0
    ctp = np.cumsum(tp_sorted)
    cfp = np.cumsum(~tp_sorted)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-9)
    for i in range(len(precision) - 1, 0, -1):
        if precision[i] > precision[i - 1]:
            precision[i - 1] = precision[i]
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    q = np.zeros(len(RECALL_POINTS))
    hit = idx < len(precision)
    q[hit] = precision[idx[hit]]
    return float(q.mean())


def _agg(values: np.ndarray) -> float:
    """COCOeval summary rule: mean over finite entries, -1.0 when every
    entry is NaN (no gt anywhere in the slice)."""
    finite = np.isfinite(values)
    return float(values[finite].mean()) if finite.any() else -1.0


def coco_summary(
    detections: Sequence[Dict[str, np.ndarray]],
    ground_truths: Sequence[Dict[str, np.ndarray]],
    num_classes: int,
    iou_thresholds: Optional[Sequence[float]] = None,
    max_dets: int = 100,
) -> Dict[str, object]:
    """Full COCO-style summary over parallel per-image lists.

    Args:
      detections[i]: {'boxes' [D,4], 'scores' [D], 'classes' [D]}
      ground_truths[i]: {'boxes' [G,4], 'labels' [G], optional
        'ignore' [G]} — base ignores (VOC 'difficult') compose with the
        area-range ignores.
      num_classes: including background (class 0 is never scored).
      iou_thresholds: override the .50:.05:.95 sweep (tests use [0.5]).
      max_dets: score-ranked detection budget per image per class.

    Returns
      {'mAP', 'AP50', 'AP75', 'AP_small', 'AP_medium', 'AP_large':
       float (-1.0 where the slice has no gt),
       'ap_per_class': [num_classes] float (threshold-averaged, at area
       range "all"; NaN where the class has no gt)}.
    """
    thresholds = np.asarray(
        IOU_THRESHOLDS if iou_thresholds is None else iou_thresholds, float
    )
    n_cls = num_classes - 1
    # ap[area, threshold, class]
    ap = np.full((len(AREA_RANGES), len(thresholds), n_cls), np.nan)
    for ci, cls in enumerate(range(1, num_classes)):
        per_img = _gather_class(detections, ground_truths, cls, max_dets)
        for ai, (_, lo, hi) in enumerate(AREA_RANGES):
            for ti, t in enumerate(thresholds):
                ap[ai, ti, ci] = _ap_101(
                    *_match_class(per_img, float(t), lo, hi)
                )

    out: Dict[str, object] = {"mAP": _agg(ap[0])}
    for ti, t in enumerate(thresholds):
        if abs(float(t) - 0.5) < 1e-9:
            out["AP50"] = _agg(ap[0, ti])
        if abs(float(t) - 0.75) < 1e-9:
            out["AP75"] = _agg(ap[0, ti])
    for ai, (name, _, _) in enumerate(AREA_RANGES):
        if name != "all":
            out[f"AP_{name}"] = _agg(ap[ai])
    # a class's NaN-ness at "all" is threshold-independent (no gt), so
    # the plain threshold mean is exact: all-NaN or all-finite columns
    ap_per_class = np.full(num_classes, np.nan)
    if n_cls:
        ap_per_class[1:] = ap[0].mean(axis=0)
    out["ap_per_class"] = ap_per_class
    return out
