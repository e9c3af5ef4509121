"""Image-matting evaluators (host-side numpy).

The counterpart of ``mvlpt_tpu/evaluation/matting.py``, line for line
(scipy's ``ndimage``, which the GPU host has). Rebuilds the matting tail
of the reference's evaluator zoo
(trainers/vision_benchmark/datasets/metrics.py:990-1162):

* ``matting_mean_iou``            — MeanIOUEvaluator (:1038-1066)
* ``matting_foreground_iou``      — ForegroundIOUEvaluator (:1069-1101)
* ``matting_boundary_mean_iou``   — BoundaryMeanIOUEvaluator (:1104-1119)
* ``matting_boundary_foreground_iou`` — BoundaryForegroundIOUEvaluator
  (:1122-1137)
* ``matting_l1_error``            — L1ErrorEvaluator (:1140-1162)

Inputs are sequences of per-image masks (PIL images or arrays, any
integer dtype); masks are binarized at >=128 exactly as the reference's
``_convert2binary`` (metrics.py:1005-1007).

Boundary variants: the reference builds its boundary band with OpenCV
contour drawing (``cv2.findContours`` + ``drawContours(thickness=10)``,
metrics.py:1017-1032) — dead code in-tree, since the ``import cv2`` at
metrics.py:10 is commented out.  Here the band is the morphological
boundary neighborhood: pixels within ``thickness/2`` (Chebyshev
distance) of the ground-truth mask's binary edge, computed with
``scipy.ndimage`` binary dilation.  Identical intent (score only the
band around the GT contour), deterministic, and no OpenCV dependency;
pixel membership can differ from polygonal contour rasterization by
<= 1 px along diagonal edges.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "matting_mean_iou",
    "matting_foreground_iou",
    "matting_boundary_mean_iou",
    "matting_boundary_foreground_iou",
    "matting_l1_error",
]


def _binarize(mask, threshold=128):
    m = np.asarray(mask)
    return (m >= threshold).astype(np.int64)


def _confusion_iou(gt_bin, pred_bin):
    """Per-image 2-class confusion-matrix IoU (metrics.py:1056-1063)."""
    label = 2 * gt_bin.astype(np.int64) + pred_bin
    count = np.bincount(label.ravel(), minlength=4)
    cm = count.reshape(2, 2)
    denom = cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm) + 1e-10
    return np.diag(cm) / denom, cm


def _boundary_band(gt_bin, thickness=10):
    """Band of pixels within thickness/2 of the GT mask's binary edge —
    the morphological equivalent of the reference's drawn contour mask
    (metrics.py:1017-1032)."""
    from scipy.ndimage import binary_dilation, binary_erosion

    gt = gt_bin.astype(bool)
    edge = gt ^ binary_erosion(gt, border_value=0)
    radius = max(1, thickness // 2)
    structure = np.ones((3, 3), bool)  # Chebyshev ball
    return binary_dilation(edge, structure=structure, iterations=radius)


def _band_masks(pred_bin, gt_bin, thickness=10):
    band = _boundary_band(gt_bin, thickness).astype(np.int64)
    return pred_bin * band, gt_bin * band


def matting_mean_iou(predictions, targets) -> dict:
    """Mean IoU over the two matting classes, averaged over images
    (MeanIOUEvaluator, metrics.py:1038-1066)."""
    assert len(predictions) == len(targets)
    total = 0.0
    for pred, gt in zip(predictions, targets):
        iou, cm = _confusion_iou(_binarize(gt), _binarize(pred))
        valid = cm.sum(axis=1) > 0
        total += float(np.nanmean(iou[valid]))
    n = len(predictions)
    return {"mIOU": total / n if n else 0.0}


def matting_foreground_iou(predictions, targets) -> dict:
    """Foreground-class IoU averaged over images (ForegroundIOUEvaluator,
    metrics.py:1069-1101). All-background GT scores 1 iff the prediction
    is also all-background."""
    assert len(predictions) == len(targets)
    total = 0.0
    for pred, gt in zip(predictions, targets):
        gt_bin, pred_bin = _binarize(gt), _binarize(pred)
        if not gt_bin.any():
            total += 1.0 if not pred_bin.any() else 0.0
            continue
        iou, _ = _confusion_iou(gt_bin, pred_bin)
        total += float(iou[1])
    n = len(predictions)
    return {"fgIOU": total / n if n else 0.0}


def matting_boundary_mean_iou(predictions, targets, thickness=10) -> dict:
    """Mean IoU restricted to the GT boundary band
    (BoundaryMeanIOUEvaluator, metrics.py:1104-1119)."""
    assert len(predictions) == len(targets)
    total = 0.0
    for pred, gt in zip(predictions, targets):
        pred_b, gt_b = _band_masks(_binarize(pred), _binarize(gt), thickness)
        iou, cm = _confusion_iou(gt_b, pred_b)
        valid = cm.sum(axis=1) > 0
        total += float(np.nanmean(iou[valid]))
    n = len(predictions)
    return {"b_mIOU": total / n if n else 0.0}


def matting_boundary_foreground_iou(predictions, targets, thickness=10) -> dict:
    """Foreground IoU restricted to the GT boundary band
    (BoundaryForegroundIOUEvaluator, metrics.py:1122-1137)."""
    assert len(predictions) == len(targets)
    total = 0.0
    for pred, gt in zip(predictions, targets):
        pred_b, gt_b = _band_masks(_binarize(pred), _binarize(gt), thickness)
        if not gt_b.any():
            total += 1.0 if not pred_b.any() else 0.0
            continue
        iou, _ = _confusion_iou(gt_b, pred_b)
        total += float(iou[1])
    n = len(predictions)
    return {"b_fgIOU": total / n if n else 0.0}


def matting_l1_error(predictions, targets) -> dict:
    """Mean absolute per-pixel error on the raw (non-binarized) masks
    (L1ErrorEvaluator, metrics.py:1140-1162)."""
    assert len(predictions) == len(targets)
    total = 0.0
    for pred, gt in zip(predictions, targets):
        p = np.asarray(pred, dtype=np.float64)
        g = np.asarray(gt, dtype=np.float64)
        total += float(np.abs(p - g).mean())
    n = len(predictions)
    return {"L1Err": total / n if n else 0.0}
