"""Object-detection mAP evaluators (host-side numpy).

The counterpart of ``mvlpt_tpu/evaluation/detection.py``, line for line,
except that a class's AP takes ``evaluation.metrics.
_binary_average_precision`` (the port's numpy copy of scikit-learn's,
which the GPU host lacks) where the JAX package calls
``sklearn.metrics.average_precision_score``. It rebuilds the detection
tail of the reference's evaluator zoo
(trainers/vision_benchmark/datasets/metrics.py):

* ``detection_map_single_iou`` — MeanAveragePrecisionEvaluatorForSingleIOU
  (metrics.py:565-688): per-class greedy matching of score-sorted
  detections to ground-truth boxes at one IoU threshold, AP =
  sklearn average-precision of the correctness sequence scaled by recall,
  mAP = mean over classes seen in predictions or ground truth.
* ``detection_map_multi_iou`` — ...ForMultipleIOUs (metrics.py:692-702):
  the same at several thresholds, one report.
* ``detection_map_coco`` — CocoMeanAveragePrecisionEvaluator
  (metrics.py:704-840) rebuilt without pycocotools: COCO-protocol AP
  (101-point interpolated precision envelope, averaged over recall
  samples and IoU thresholds).  The reference's own class cannot run
  in-tree — its ``from pycocotools.cocoeval import Params, COCOeval``
  is commented out (metrics.py:11-12) — so this is a functional numpy
  rebuild of the protocol rather than a wrapper.

Data model matches the reference exactly (metrics.py:577-583):

* ``predictions``: per image, a list of ``[label, score, L, T, R, B]``.
* ``targets``:     per image, a list of ``[label, L, T, R, B]``.

Boxes are corner-coordinate rectangles; IoU uses the reference's
+1e-5 side padding (metrics.py:611-614) so degenerate boxes do not
divide by zero.
"""

from __future__ import annotations

import numpy as np

from mvlpt_torch.evaluation.metrics import _binary_average_precision

__all__ = [
    "detection_map_single_iou",
    "detection_map_multi_iou",
    "detection_map_coco",
]


def _area(rect) -> float:
    # metrics.py:611-614 — 1e-5 padding, zero for inverted rects.
    w = rect[2] - rect[0] + 1e-5
    h = rect[3] - rect[1] + 1e-5
    return float(w * h) if w > 0 and h > 0 else 0.0


def _iou(a, b) -> float:
    inter = [max(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), min(a[3], b[3])]
    ai = _area(inter)
    return ai / (_area(a) + _area(b) - ai)


def _group_by_class(predictions, targets):
    """Split the per-image lists into per-class detection/GT pools
    (metrics.py:585-600 layout)."""
    preds = {}   # label -> list of (img_idx, score, box)
    gts = {}     # label -> {img_idx: [box, ...]}
    for img_idx, boxes in enumerate(predictions):
        for b in boxes:
            preds.setdefault(int(b[0]), []).append(
                (img_idx, float(b[1]), [float(v) for v in b[2:6]]))
    for img_idx, boxes in enumerate(targets):
        for b in boxes:
            gts.setdefault(int(b[0]), {}).setdefault(img_idx, []).append(
                [float(v) for v in b[1:5]])
    return preds, gts


def _match_class(class_preds, class_gts, iou_thr):
    """Greedy matching in descending score order; each GT box may be
    claimed once (metrics.py:627-664). Returns (is_correct, scores)."""
    order = sorted(class_preds, key=lambda p: -p[1])
    claimed = set()
    is_correct, scores = [], []
    for img_idx, score, box in order:
        ok = False
        gt_boxes = class_gts.get(img_idx)
        if gt_boxes:
            ious = np.array([_iou(box, g) for g in gt_boxes])
            best = int(np.argmax(ious))
            if ious[best] >= iou_thr and (img_idx, best) not in claimed:
                claimed.add((img_idx, best))
                ok = True
        is_correct.append(ok)
        scores.append(score)
    return np.array(is_correct, bool), np.array(scores)


def _match_class_coco(class_preds, class_gts, iou_thr):
    """COCO matching (pycocotools cocoeval.py evaluateImg): per
    detection in descending score order, match the UNCLAIMED GT with the
    highest IoU >= thr — unlike the VOC greedy argmax, a detection whose
    best-IoU GT is already claimed may still match another GT."""
    order = sorted(class_preds, key=lambda p: -p[1])
    claimed = {}
    is_correct, scores = [], []
    for img_idx, score, box in order:
        ok = False
        gt_boxes = class_gts.get(img_idx)
        if gt_boxes:
            used = claimed.setdefault(img_idx, set())
            best_iou, best = iou_thr, -1
            for gi, g in enumerate(gt_boxes):
                if gi in used:
                    continue
                v = _iou(box, g)
                if v >= best_iou:
                    best_iou, best = v, gi
            if best >= 0:
                used.add(best)
                ok = True
        is_correct.append(ok)
        scores.append(score)
    return np.array(is_correct, bool), np.array(scores)


def _ap_sklearn(is_correct, scores, true_num) -> float:
    """AP of one class, reference semantics (metrics.py:666-673):
    scikit-learn's average precision over the correctness sequence (here
    ``_binary_average_precision``, its numpy copy), scaled by the fraction
    of GT boxes recovered."""
    if true_num == 0 or is_correct.size == 0 or not is_correct.any():
        return 0.0
    recall = float(is_correct.sum()) / true_num
    return float(_binary_average_precision(is_correct, scores)) * recall


def detection_map_single_iou(predictions, targets, iou=0.5,
                             report_tag_wise=False):
    """VOC-style detection mAP at one IoU threshold.

    Returns ``{"mAP_<iou*100>": value}`` (+ ``tag_wise_AP_<...>`` list
    when requested), matching
    MeanAveragePrecisionEvaluatorForSingleIOU.get_report
    (metrics.py:675-688).
    """
    assert len(predictions) == len(targets)
    preds, gts = _group_by_class(predictions, targets)
    aps = {}
    for cls in sorted(set(preds) | set(gts)):
        is_correct, scores = _match_class(
            preds.get(cls, []), gts.get(cls, {}), iou)
        true_num = sum(len(v) for v in gts.get(cls, {}).values())
        aps[cls] = _ap_sklearn(is_correct, scores, true_num)
    mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    report = {f"mAP_{int(iou * 100)}": mean_ap}
    if report_tag_wise:
        report[f"tag_wise_AP_{int(iou * 100)}"] = [aps[c] for c in aps]
    return report


def detection_map_multi_iou(predictions, targets,
                            ious=(0.3, 0.5, 0.75, 0.9),
                            report_tag_wise=None):
    """mAP at several IoU thresholds, merged into one report
    (metrics.py:692-702 + EvaluatorAggregator)."""
    if report_tag_wise is None:
        report_tag_wise = [False] * len(ious)
    assert len(ious) == len(report_tag_wise)
    report = {}
    for iou, tag_wise in zip(ious, report_tag_wise):
        report.update(detection_map_single_iou(
            predictions, targets, iou=iou, report_tag_wise=tag_wise))
    return report


def _ap_coco(is_correct, scores, true_num) -> float:
    """COCO-protocol AP: precision envelope sampled at 101 recall points
    (pycocotools accumulate()/summarize() semantics)."""
    if true_num == 0 or is_correct.size == 0:
        return 0.0
    tp = np.cumsum(is_correct)
    fp = np.cumsum(~is_correct)
    recall = tp / true_num
    precision = tp / np.maximum(tp + fp, 1e-12)
    # Monotone non-increasing precision envelope (right-to-left max).
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    samples = np.linspace(0.0, 1.0, 101)
    idx = np.searchsorted(recall, samples, side="left")
    sampled = np.where(idx < precision.size, precision[np.minimum(idx, precision.size - 1)], 0.0)
    return float(sampled.mean())


def detection_map_coco(predictions, targets, ious=(0.3, 0.5, 0.75, 0.9),
                       report_tag_wise=None, max_dets=300):
    """COCO-style detection mAP report.

    Matches CocoMeanAveragePrecisionEvaluator.get_report's keys
    (metrics.py:819-834): ``avg_mAP`` (mean over IoUs) plus
    ``mAP_<iou*100>`` per threshold and optional per-class
    ``tag_wise_AP_<...>`` dicts keyed by original label ids.
    """
    assert len(predictions) == len(targets)
    if report_tag_wise is None:
        report_tag_wise = [False] * len(ious)
    assert len(ious) == len(report_tag_wise)

    # Cap detections per (image, category) by score — pycocotools
    # truncates each per-category list to maxDets, not the whole image.
    capped = []
    for boxes in predictions:
        by_cls: dict = {}
        for b in boxes:
            by_cls.setdefault(int(b[0]), []).append(b)
        kept = []
        for cls_boxes in by_cls.values():
            if len(cls_boxes) > max_dets:
                cls_boxes = sorted(
                    cls_boxes, key=lambda b: -float(b[1]))[:max_dets]
            kept.extend(cls_boxes)
        capped.append(kept)

    preds, gts = _group_by_class(capped, targets)
    classes = sorted(set(preds) | set(gts))
    per_iou = {}
    tag_wise = {}
    for iou, want_tags in zip(ious, report_tag_wise):
        aps = {}
        for cls in classes:
            is_correct, scores = _match_class_coco(
                preds.get(cls, []), gts.get(cls, {}), iou)
            true_num = sum(len(v) for v in gts.get(cls, {}).values())
            if true_num == 0:
                continue  # COCO skips classes absent from GT (-1 entries)
            aps[cls] = _ap_coco(is_correct, scores, true_num)
        per_iou[iou] = float(np.mean(list(aps.values()))) if aps else 0.0
        if want_tags:
            tag_wise[iou] = dict(aps)

    report = {"avg_mAP": float(np.mean(list(per_iou.values()))) if per_iou else 0.0}
    for iou in ious:
        report[f"mAP_{int(iou * 100)}"] = per_iou[iou]
    for iou, aps in tag_wise.items():
        report[f"tag_wise_AP_{int(iou * 100)}"] = aps
    return report
