"""The port's evaluation metrics (``mvlpt_torch.evaluation.metrics``,
numpy only) against the JAX package's (``mvlpt_tpu.evaluation.metrics``,
partly scikit-learn): every metric of ``_METRICS`` to 1e-12 on random
scores with forced ties, for int and k-hot targets, and the same results,
warnings and exceptions on degenerate input."""

import warnings

import numpy as np
import pytest

from mvlpt_tpu.evaluation import metrics as jm

from mvlpt_torch.evaluation import metrics as tm


def _scores(rng, n, c, ties: bool):
    p = rng.randn(n, c)
    if ties:
        # few distinct values a column: ties inside and across classes
        p = np.round(p * 2) / 2
    return p.astype(np.float32)


def _same(a, b):
    if np.isnan(b):
        assert np.isnan(a)
    else:
        assert abs(a - b) <= 1e-12, (a, b)


@pytest.mark.parametrize("name", sorted(jm._METRICS))
@pytest.mark.parametrize("target", ["int", "k-hot", "binary"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_every_metric_matches_jax(name, target, ties):
    assert sorted(tm._METRICS) == sorted(jm._METRICS)
    for seed in range(4):
        rng = np.random.RandomState(seed)
        n, c = 37, (2 if target == "binary" else 6)
        p = _scores(rng, n, c, ties)
        if target == "k-hot":
            y = (rng.rand(n, c) < 0.3).astype(np.float32)
            y[np.arange(n), rng.randint(0, c, n)] = 1.0
            if name in ("accuracy", "mean-per-class", "tag_wise_accuracy", "ece",
                        "macro_f1"):
                y = y.argmax(-1)  # the trainer's argmax for these
        else:
            y = rng.randint(0, c, n)
        results = []
        for mod in (tm, jm):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                try:
                    results.append(("ok", mod.get_metric(name)(y, p)))
                except ValueError as e:
                    results.append(("raises", type(e)))
        (t_kind, t_val), (j_kind, j_val) = results
        assert t_kind == j_kind, (name, target, seed, results)
        if t_kind == "ok":
            _same(t_val, j_val)
        else:
            assert t_val is j_val


@pytest.mark.parametrize("seed", range(6))
def test_curves_match_sklearn(seed):
    """The precision-recall and ROC curves themselves, point for point,
    with ties and with the appended end point."""
    from sklearn.metrics import precision_recall_curve, roc_curve

    rng = np.random.RandomState(seed)
    n = 5 + 11 * seed
    y = rng.randint(0, 2, n)
    s = np.round(rng.randn(n) * (1 + seed % 3)).astype(np.float32)
    for got, want in ((tm.precision_recall_curve(y, s), precision_recall_curve(y, s)),
                      (tm.roc_curve(y, s), roc_curve(y, s))):
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _outcome(fn, *args):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            value = ("ok", fn(*args))
        except (ValueError, KeyError, IndexError) as e:
            value = ("raises", type(e))
    return value, sorted({issubclass(w.category, UserWarning) for w in caught})


def _degenerate():
    rng = np.random.RandomState(0)
    p2 = rng.randn(8, 2).astype(np.float32)
    p3 = rng.randn(8, 3).astype(np.float32)
    one_class = np.zeros(8, np.int64)
    khot_empty = np.zeros((8, 3), np.float32)
    khot_empty[:, 0] = 1
    nan_p = p2.copy()
    nan_p[3, 1] = np.nan
    return {
        "roc_auc one class": ("roc_auc", one_class, p2),
        "roc_auc multiclass": ("roc_auc", rng.randint(0, 3, 8), p3),
        "roc_auc binary with 3 columns": ("roc_auc", np.r_[[0, 1] * 4], p3),
        "roc_auc k-hot with an empty column": ("roc_auc", khot_empty, p3),
        "roc_auc nan score": ("roc_auc", np.r_[[0, 1] * 4], nan_p),
        "average_precision wrong shape": ("average_precision", rng.randint(0, 3, 8),
                                          rng.randn(8, 4)),
        "average_precision labels 0 and 2": ("average_precision", np.r_[[0, 2] * 4],
                                             rng.randn(8)),
        "average_precision k-hot with an empty column": ("average_precision", khot_empty, p3),
        "11point_mAP empty column": ("11point_mAP", khot_empty, p3),
        "11point_mAP all ties": ("11point_mAP", rng.randint(0, 3, 8), np.zeros((8, 3))),
        "unknown metric": ("nope", one_class, p2),
    }


@pytest.mark.parametrize("case", sorted(_degenerate()))
def test_degenerate_input_matches_jax(case):
    name, y, p = _degenerate()[case]

    def call(mod):
        return lambda y, p: mod.get_metric(name)(y, p)

    (t_val, t_warn), (j_val, j_warn) = _outcome(call(tm), y, p), _outcome(call(jm), y, p)
    assert t_val[0] == j_val[0] and t_warn == j_warn, (t_val, j_val, t_warn, j_warn)
    if t_val[0] == "ok":
        _same(t_val[1], j_val[1])
    else:
        assert t_val[1] is j_val[1]
