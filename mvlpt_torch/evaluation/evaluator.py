"""Dassl-style Classification evaluator for the CoOp universe.

The counterpart of ``mvlpt_tpu/evaluation/evaluator.py``: accumulates
(logits, labels) batches and reports accuracy / error / macro-F1 (plus
optional per-class accuracy), the evaluator the reference gets from
Dassl and copies per task in its multitask test loop (mvlpt.py:1013-1020).
Macro-F1 is computed in numpy, as ``sklearn.metrics.f1_score(...,
average="macro", zero_division=0)`` computes it (the GPU host has no
scikit-learn).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def macro_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """The unweighted mean over the labels present in either array of each
    label's F1 = 2 tp / (2 tp + fp + fn); 0 for a label with no tp, fp
    or fn."""
    labels = np.union1d(y_true, y_pred)
    if labels.size == 0:
        return 0.0
    t = np.searchsorted(labels, y_true)
    p = np.searchsorted(labels, y_pred)
    n = labels.size
    tp = np.bincount(t[t == p], minlength=n).astype(np.float64)
    fp = np.bincount(p, minlength=n) - tp
    fn = np.bincount(t, minlength=n) - tp
    denom = 2 * tp + fp + fn
    f1 = np.divide(2 * tp, denom, out=np.zeros(n), where=denom > 0)
    return float(f1.mean())


class ClassificationEvaluator:
    def __init__(self, lab2cname=None, per_class: bool = False):
        self._lab2cname = lab2cname
        self._per_class = per_class
        self.reset()

    def reset(self):
        self._correct = 0
        self._total = 0
        self._y_true: list[np.ndarray] = []
        self._y_pred: list[np.ndarray] = []
        self._per_class_res = defaultdict(list) if self._per_class else None

    def clone(self):
        return ClassificationEvaluator(self._lab2cname, self._per_class)

    def process(self, logits, labels):
        logits = np.asarray(logits)
        labels = np.asarray(labels)
        if labels.ndim > 1:
            labels = labels.argmax(-1)
        pred = logits.argmax(-1)
        matches = (pred == labels).astype(np.int64)
        self._correct += int(matches.sum())
        self._total += len(labels)
        self._y_true.append(labels)
        self._y_pred.append(pred)
        if self._per_class_res is not None:
            for label, ok in zip(labels, matches):
                self._per_class_res[int(label)].append(int(ok))

    def evaluate(self) -> dict:
        y_true = np.concatenate(self._y_true) if self._y_true else np.zeros(0)
        y_pred = np.concatenate(self._y_pred) if self._y_pred else np.zeros(0)
        acc = 100.0 * self._correct / max(1, self._total)
        results = {
            "accuracy": acc,
            "error_rate": 100.0 - acc,
            "macro_f1": 100.0 * macro_f1(y_true, y_pred) if self._total else 0.0,
        }
        if self._per_class_res is not None:
            accs = [100.0 * np.mean(v) for v in self._per_class_res.values() if v]
            results["perclass_accuracy"] = float(np.mean(accs)) if accs else 0.0
        return results
