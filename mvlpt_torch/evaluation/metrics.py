"""Evaluation metrics (numpy, host-side).

The counterpart of ``mvlpt_tpu/evaluation/metrics.py``: the same
``_METRICS`` table and ``get_metric``, the same values. The GPU host has
no scikit-learn, so the ranking metrics the JAX package takes from it
(``precision_recall_curve`` for 11-point mAP, ``roc_auc_score``,
``average_precision_score``) are written here in numpy as scikit-learn
1.9 computes them: thresholds at the distinct scores, the precision-recall
curve's appended (recall 0, precision 1) end point, the ROC curve's
collinear points dropped, and the same errors and warnings on degenerate
input (one class present in ``roc_auc`` gives nan with a warning; a
multiclass target with class scores raises). Macro-F1 is the evaluator's
numpy one.

All functions take (y_true, y_pred) where y_pred is (N, C) scores and
y_true is (N,) int labels or (N, C) {0,1} indicators, as the MVLPT test
loop feeds them (the reference's mvlpt.py:1047-1061).
"""

from __future__ import annotations

import warnings

import numpy as np

from mvlpt_torch.evaluation.evaluator import macro_f1 as _macro_f1


class UndefinedMetricWarning(UserWarning):
    """A metric is undefined on this input (scikit-learn's warning of the
    same name)."""


def _as_int_labels(y_true) -> np.ndarray:
    y = np.asarray(y_true)
    return y if y.ndim == 1 else np.argmax(y, axis=-1)


def accuracy(y_true, y_pred) -> float:
    """Top-1 accuracy, y_pred (N, C) scores (metrics.py:1254-1262)."""
    return top_k_accuracy(y_true, y_pred, k=1)


def top_k_accuracy(y_true, y_pred, k: int = 1) -> float:
    y = _as_int_labels(y_true)
    topk = np.argsort(-np.asarray(y_pred), axis=-1)[:, :k]
    return float((topk == y[:, None]).any(axis=-1).mean())


def balanced_accuracy(y_true, y_pred) -> float:
    """Mean per-class recall ('mean-per-class', metrics.py:839-850)."""
    y = _as_int_labels(y_true)
    pred = np.argmax(np.asarray(y_pred), axis=-1)
    classes = np.unique(y)
    recalls = [(pred[y == c] == c).mean() for c in classes]
    return float(np.mean(recalls))


# ------------------------------------------------------------ ranking curves
#
# scikit-learn's target typing, curves and averaging, for dense numpy input.


def _type_of_target(y) -> str:
    """'binary', 'multiclass', 'multilabel-indicator', 'continuous' or a
    '-multioutput' form, as ``sklearn.utils.multiclass.type_of_target``
    names a dense numeric array."""
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] > 1 and y.size:
        labels = np.unique(y)
        if len(labels) < 3 and (y.dtype.kind in "biu" or (
                y.dtype.kind == "f" and np.all(labels == labels.astype(np.int64)))):
            return "multilabel-indicator"
    if y.ndim not in (1, 2):
        return "unknown"
    if not min(y.shape):
        return "binary" if y.ndim == 1 else "unknown"
    suffix = "-multioutput" if y.ndim == 2 and y.shape[1] > 1 else ""
    if y.dtype.kind == "f" and np.any(y != y.astype(np.int64).astype(y.dtype)):
        _assert_all_finite(y)
        return "continuous" + suffix
    if np.unique(y).shape[0] > 2 or (y.ndim == 2 and y.shape[1] > 1):
        return "multiclass" + suffix
    return "binary"


def _assert_all_finite(a) -> None:
    a = np.asarray(a)
    if a.dtype.kind == "f" and not np.isfinite(a).all():
        what = "NaN" if np.isnan(a).any() else f"infinity or a value too large for {a.dtype!r}"
        raise ValueError(f"Input contains {what}.")


def _column_or_1d(a, name: str) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim == 1:
        return a
    if a.ndim == 2 and a.shape[1] == 1:
        return a.ravel()
    raise ValueError(f"{name} should be a 1d array, got an array of shape {a.shape} instead.")


def _pos_label(y_true, pos_label):
    if pos_label is not None:
        return pos_label
    classes = np.unique(y_true)
    if classes.shape[0] > 2 or not any(
            classes.shape == np.asarray(c).shape and np.all(classes == c)
            for c in ([0, 1], [-1, 1], [0], [-1], [1])):
        raise ValueError(
            f"y_true takes value in {{{', '.join(repr(c) for c in classes.tolist())}}} and "
            "pos_label is not specified: either make y_true take value in {0, 1} or "
            "{-1, 1} or pass pos_label explicitly.")
    return 1


def _clf_curve(y_true, y_score, pos_label=None):
    """(fps, tps, thresholds) at each distinct score, from the highest
    down (sklearn's ``confusion_matrix_at_thresholds``)."""
    y_type = _type_of_target(y_true)
    if not (y_type == "binary" or (y_type == "multiclass" and pos_label is not None)):
        raise ValueError(f"{y_type} format is not supported")
    pos_label = _pos_label(y_true, pos_label)
    y_true = (np.asarray(y_true) == pos_label).astype(np.int32)
    if len(y_true) != len(y_score):
        raise ValueError("Found input variables with inconsistent numbers of samples: "
                         f"[{len(y_true)}, {len(y_score)}]")
    y_true = _column_or_1d(y_true, "y")
    y_score = _column_or_1d(y_score, "y")
    _assert_all_finite(y_true)
    _assert_all_finite(y_score)
    # a stable descending sort (array_api_compat's, which sklearn calls)
    order = y_score.size - 1 - np.argsort(y_score[::-1], kind="stable")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    threshold_idxs = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true.astype(np.float64), dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    return fps, tps, y_score[threshold_idxs]


def precision_recall_curve(y_true, y_score, pos_label=None):
    """(precision, recall, thresholds), recall decreasing, with the end
    point (recall 0, precision 1) appended; every threshold kept."""
    fps, tps, thresholds = _clf_curve(y_true, y_score, pos_label)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    if tps[-1] == 0:
        warnings.warn("No positive class found in y_true, recall is set to one for all "
                      "thresholds.")
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]
    return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thresholds[::-1])


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) from (0, 0) up, collinear points dropped."""
    fps, tps, thresholds = _clf_curve(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    if fps[-1] <= 0:
        warnings.warn("No negative samples in y_true, false positive value should be "
                      "meaningless", UndefinedMetricWarning)
        fpr = np.full(fps.shape, np.nan)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        warnings.warn("No positive samples in y_true, true positive value should be "
                      "meaningless", UndefinedMetricWarning)
        tpr = np.full(tps.shape, np.nan)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def _trapezoid(y, x) -> float:
    d = np.diff(x)
    return float(np.add.reduce(d * (y[1:] + y[:-1]) / 2.0))


def _auc(x, y) -> float:
    if x.shape[0] < 2:
        raise ValueError("At least 2 points are needed to compute area under curve, but "
                         f"x.shape = {x.shape[0]}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
    return float(direction * _trapezoid(y, x))


def _binary_roc_auc(y_true, y_score) -> float:
    if len(np.unique(y_true)) != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score is not defined in "
                      "that case.", UndefinedMetricWarning)
        return np.nan
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return _auc(fpr, tpr)


def _binary_average_precision(y_true, y_score) -> float:
    precision, recall, _ = precision_recall_curve(y_true, y_score, pos_label=1)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _check_array(a) -> np.ndarray:
    a = np.asarray(a)
    if a.size == 0:
        raise ValueError(f"Found array with 0 sample(s) (shape={a.shape}) while a minimum of "
                         "1 is required.")
    _assert_all_finite(a)
    return a


def _average_binary_score(metric, y_true, y_score) -> float:
    """Macro average of ``metric`` over the columns of a multilabel target;
    a binary target is scored as one column."""
    y_type = _type_of_target(y_true)
    if y_type not in ("binary", "multilabel-indicator"):
        raise ValueError(f"{y_type} format is not supported")
    if y_type == "binary":
        return metric(y_true, y_score)
    y_true, y_score = _check_array(y_true), _check_array(y_score)
    if len(y_true) != len(y_score):
        raise ValueError("Found input variables with inconsistent numbers of samples: "
                         f"[{len(y_true)}, {len(y_score)}]")
    y_true = y_true.reshape(-1, 1) if y_true.ndim == 1 else y_true
    y_score = y_score.reshape(-1, 1) if y_score.ndim == 1 else y_score
    score = np.zeros((y_score.shape[1],))
    for c in range(y_score.shape[1]):
        score[c] = metric(y_true[:, c], y_score[:, c])
    return float(np.mean(score))


def _label_binarize(y, classes) -> np.ndarray:
    """sklearn's ``label_binarize`` for a 1-D target: one {0, 1} column a
    class, or one column for two classes (the second is positive)."""
    y = np.asarray(y)
    if len(classes) == 1:
        return np.zeros((len(y), 1), dtype=np.int64)
    out = (y[:, None] == np.asarray(classes)[None, :]).astype(np.int64)
    return out[:, -1:] if len(classes) == 2 else out


def _interp_precision(scores, targets, recall_thresholds) -> np.ndarray:
    """11-point interpolated precision at descending recall thresholds
    (metrics.py:862-880 semantics over the precision-recall curve)."""
    precision, recall, _ = precision_recall_curve(targets, scores)
    out = np.empty(len(recall_thresholds))
    idx, best = 0, 0.0
    for i, thr in enumerate(recall_thresholds):
        while idx < len(recall) and thr <= recall[idx]:
            best = max(best, precision[idx])
            idx += 1
        out[i] = best
    return out


def map_11_points(y_true, y_pred) -> float:
    """11-point interpolated mAP over classes (VOC2007 protocol,
    metrics.py:884-896)."""
    y = np.asarray(y_true)
    p = np.asarray(y_pred)
    if y.ndim == 1:
        y = np.eye(p.shape[1], dtype=np.int64)[y]
    thresholds = np.linspace(1, 0, 11, endpoint=True).tolist()
    aps = [np.mean(_interp_precision(p[:, c], y[:, c], thresholds)) for c in range(p.shape[1])]
    return float(np.mean(aps))


def roc_auc(y_true, y_pred) -> float:
    """ROC-AUC, macro over classes; binary tasks may pass (N, 2) class
    logits (the trainer feeds full per-task logit slices): the positive
    class's margin is the score."""
    y = np.asarray(y_true)
    p = np.asarray(y_pred)
    if p.ndim == 2 and p.shape[1] == 2 and (y.ndim == 1 or y.shape[1] == 2):
        if y.ndim == 2:
            y = np.argmax(y, axis=-1)
        p = p[:, 1] - p[:, 0]
    y_type = _type_of_target(y)
    y, p = _check_array(y), _check_array(p)
    if y_type == "multiclass" or (y_type == "binary" and p.ndim == 2 and p.shape[1] > 2):
        raise ValueError("multi_class must be in ('ovo', 'ovr')")
    if y_type == "binary":
        y = _label_binarize(y, np.unique(y))[:, 0]
    return float(_average_binary_score(_binary_roc_auc, y, p))


def threshold_accuracy(y_true, y_pred, threshold: float = 0.5) -> float:
    """Sample-based intersection-over-union accuracy of thresholded
    multilabel predictions (ThresholdAccuracyEvaluator,
    metrics.py:293-333): per sample, |pred ∩ target| / |pred ∪ target|
    (denominator clamped to 1 when both are empty), averaged over
    samples. (N,) multiclass targets are one-hot expanded; the filter is
    ``>= threshold``."""
    p = np.asarray(y_pred)
    y = np.asarray(y_true)
    if y.ndim == 1:
        y = np.eye(p.shape[1], dtype=np.int64)[y]
    over = (p >= threshold).astype(np.int64)
    n_correct = (over * y).sum(axis=1)
    n_total = ((over + y) >= 1).sum(axis=1)
    n_total[n_total == 0] = 1
    return float((n_correct / n_total).mean())


def macro_f1(y_true, y_pred) -> float:
    y = _as_int_labels(y_true)
    pred = np.argmax(np.asarray(y_pred), axis=-1)
    return _macro_f1(y, pred)


def average_precision(y_true, y_pred) -> float:
    """Uninterpolated average precision, macro over classes; a multiclass
    (N,) target is binarised over the classes present."""
    y = np.asarray(y_true)
    p = np.asarray(y_pred)
    y_type = _type_of_target(y)
    present = np.unique(y)
    if y_type == "binary":
        if present.shape[0] == 2 and 1 not in present:
            raise ValueError(f"pos_label=1 is not a valid label. It should be one of {present}")
    elif y_type == "multiclass":
        y = _label_binarize(y, present)
        if p.shape != y.shape:
            raise ValueError("`y_score` needs to be of shape `(n_samples, n_classes)`, since "
                             f"`y_true` contains multiple classes. Got `y_score.shape={p.shape}`.")
    return float(_average_binary_score(_binary_average_precision, y, p))


def tag_wise_accuracy(y_true, y_pred) -> float:
    """Per-class recall for multiclass predictions: argmax the scores,
    build the confusion matrix over all classes, row-normalise, take the
    diagonal with nan -> 0 (TagWiseAccuracyEvaluator, metrics.py:431-460);
    the mean of the per-class list."""
    y = _as_int_labels(y_true)
    p = np.asarray(y_pred)
    n_cls = p.shape[1]
    pred = np.argmax(p, axis=1)
    cm = np.zeros((n_cls, n_cls), np.int64)
    np.add.at(cm, (y, pred), 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        per_class = np.nan_to_num(cm.diagonal() / cm.sum(axis=1))
    return float(per_class.mean())


def ece_loss(y_true, y_pred, n_bins: int = 15) -> float:
    """Expected calibration error (metrics.py:485-527)."""
    y = _as_int_labels(y_true)
    p = np.asarray(y_pred, np.float64)
    p = np.exp(p - p.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    conf = p.max(-1)
    pred = p.argmax(-1)
    correct = (pred == y).astype(np.float64)
    ece = 0.0
    edges = np.linspace(0, 1, n_bins + 1)
    for lo, hi in zip(edges[:-1], edges[1:]):
        mask = (conf > lo) & (conf <= hi)
        if mask.any():
            ece += abs(correct[mask].mean() - conf[mask].mean()) * mask.mean()
    return float(ece)


def mean_lp_error(y_true, y_pred, p: int = 1) -> float:
    """Mean Lp regression error: ``(sum |pred-true|^p)^(1/p) / N``
    (MeanLpErrorEvaluator, metrics.py:1211-1248)."""
    if p <= 0:
        raise ValueError(f"p must be positive, got {p}")
    y = np.asarray(y_true, np.float64)
    pr = np.asarray(y_pred, np.float64)
    if y.shape != pr.shape or y.ndim != 1:
        raise ValueError(f"shapes {y.shape} and {pr.shape}: want two equal 1-D shapes")
    if y.size == 0:
        return 0.0
    total = float(np.sum(np.abs(pr - y) ** p))
    return float(total ** (1.0 / p) / y.size)


def group_wise(metric_fn, y_true, y_pred, groups) -> dict:
    """``metric_fn(y_true, y_pred)`` on each group separately
    (GroupWiseEvaluator, metrics.py:1163-1208): ``{"group_wise_metrics":
    {group: value}}``."""
    y = np.asarray(y_true)
    p = np.asarray(y_pred)
    groups = list(groups)
    if not len(groups) == len(y) == len(p):
        raise ValueError(f"{len(groups)} groups for {len(y)} targets and {len(p)} scores")
    by_group: dict = {}
    for i, g in enumerate(groups):
        by_group.setdefault(g, []).append(i)
    return {"group_wise_metrics": {g: metric_fn(y[idx], p[idx]) for g, idx in by_group.items()}}


_METRICS = {
    "accuracy": accuracy,
    "mean-per-class": balanced_accuracy,
    "11point_mAP": map_11_points,
    "roc_auc": roc_auc,
    "threshold_accuracy": threshold_accuracy,
    "macro_f1": macro_f1,
    "average_precision": average_precision,
    "tag_wise_accuracy": tag_wise_accuracy,
    "ece": ece_loss,
}


def get_metric(metric_name: str):
    """Metric dispatch (metrics.py:1281-1294)."""
    if metric_name not in _METRICS:
        raise KeyError(f"Undefined metric {metric_name!r}; known: {sorted(_METRICS)}")
    return _METRICS[metric_name]
