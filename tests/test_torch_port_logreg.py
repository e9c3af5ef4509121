"""The port's logistic regression (``evaluation/logreg.py``) against
scikit-learn's ``LogisticRegression(solver="lbfgs", max_iter=1000, C)``,
the fit the JAX package's lpclip probe makes, on the CPU.

- The objective and its gradient against scikit-learn's
  ``LinearModelLoss.loss_gradient`` at random float64 iterates on float32
  features: 1e-5 relative, for the multinomial (10 classes) and the
  binomial (2) loss.
- Fits at every C of lpclip's 7-point grid, on few-shot data balanced
  as lpclip samples it: the predictions on held-out data within one
  sample of scikit-learn's accuracy; ``coef_`` and ``intercept_`` within
  1e-3 x max|ref| where scikit-learn's fit meets its gradient tolerance
  (max |gradient| <= tol at its solution, by its own loss) in fewer than
  max_iter iterations. Elsewhere scikit-learn's float32 objective stops
  its L-BFGS where f no longer decreases in float32, short of the
  optimum: at C = 1e-4 its refit on the same rows in another order lands
  up to 1.0 x max|ref| from its first fit, and its float64 fit 3e-2 (2
  classes) and 1.05 (10 classes) away. There the port's solution must be
  at least as good: its objective, in float64, no more than 1e-7
  relative above scikit-learn's.
"""

import warnings

import numpy as np
import pytest
import torch

from mvlpt_torch.cli.lpclip import C_GRID

pytest.importorskip("sklearn")


def _data(seed: int, k: int, shots: int, d: int = 32, noise: float = 1.5):
    """Balanced few-shot features (``shots`` a class) and a held-out set."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d)
    y = np.arange(k * shots) % k
    x = (centers[y] + rng.randn(len(y), d) * noise).astype(np.float32)
    ye = rng.randint(0, k, 200)
    xe = (centers[ye] + rng.randn(len(ye), d) * noise).astype(np.float32)
    return x, y, xe, ye


def _sk_loss(k: int):
    from sklearn._loss.loss import HalfBinomialLoss, HalfMultinomialLoss
    from sklearn.linear_model._linear_loss import LinearModelLoss

    base = HalfBinomialLoss() if k == 2 else HalfMultinomialLoss(n_classes=k)
    return LinearModelLoss(base_loss=base, fit_intercept=True)


@pytest.mark.parametrize("k", [10, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_objective_and_gradient_match_sklearn(k, seed):
    from mvlpt_torch.evaluation.logreg import loss_gradient

    x, y, _, _ = _data(seed, k, 8)
    n, d = x.shape
    target = (y == 1).astype(np.float32) if k == 2 else y.astype(np.float32)
    rng = np.random.RandomState(100 + seed)
    coef = rng.randn(d + 1) if k == 2 else rng.randn(k * (d + 1))
    l2 = 1.0 / (rng.choice(C_GRID) * n)
    want_f, want_g = _sk_loss(k).loss_gradient(coef, x, target, None, l2)
    got_f, got_g = loss_gradient(coef, torch.from_numpy(x), torch.from_numpy(target), l2, k)
    assert isinstance(got_f, float) and got_g.dtype == np.float64
    assert got_g.shape == want_g.shape
    assert abs(got_f - want_f) <= 1e-5 * abs(want_f)
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=1e-5 * np.abs(want_g).max())


@pytest.mark.parametrize("k", [10, 2])
@pytest.mark.parametrize("c", C_GRID)
def test_fit_matches_sklearn(k, c, capsys):
    from sklearn.linear_model import LogisticRegression as SkLR

    from mvlpt_torch.evaluation.logreg import LogisticRegression

    x, y, xe, ye = _data(0, k, 8 if k == 10 else 20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # scikit-learn's ConvergenceWarning at large C
        ref = SkLR(solver="lbfgs", max_iter=1000, C=c).fit(x, y)
    got = LogisticRegression(C=c, max_iter=1000, device="cpu").fit(x, y)
    assert np.array_equal(got.classes_, ref.classes_)
    assert got.coef_.shape == ref.coef_.shape and got.intercept_.shape == ref.intercept_.shape
    acc_ref = float((ref.predict(xe) == ye).mean())
    acc = float((got.predict(xe) == ye).mean())
    assert abs(acc - acc_ref) <= 1.0 / len(ye) + 1e-12, (acc, acc_ref)

    w_ref = np.concatenate([ref.coef_, ref.intercept_[:, None]], axis=1)
    w = np.concatenate([got.coef_, got.intercept_[:, None]], axis=1)
    gap = np.abs(w - w_ref).max() / np.abs(w_ref).max()
    target = (y == 1).astype(np.float32) if k == 2 else y.astype(np.float32)
    flat = w_ref.reshape(-1) if k == 2 else w_ref.ravel(order="F")
    _, grad = _sk_loss(k).loss_gradient(flat, x, target, None, 1.0 / (c * len(y)))
    determined = np.abs(grad).max() <= 1e-4 and ref.n_iter_[0] < 1000
    with capsys.disabled():
        print(f"\nC={c:g} k={k}: n_iter_ sklearn {ref.n_iter_[0]} port {got.n_iter_[0]}, "
              f"coef gap {gap:.2e} x max|ref|, sklearn at its tolerance: {determined}")
    if determined:
        assert gap <= 1e-3
    else:
        exact = _sk_loss(k).loss
        t64, x64, l2 = target.astype(np.float64), x.astype(np.float64), 1.0 / (c * len(y))
        f_ref = exact(flat, x64, t64, None, l2)
        f_got = exact(w.reshape(-1) if k == 2 else w.ravel(order="F"), x64, t64, None, l2)
        assert f_got <= f_ref + 1e-7 * abs(f_ref), (f_got, f_ref)


def test_predict_takes_classes_and_refuses_one_class():
    from mvlpt_torch.evaluation.logreg import LogisticRegression

    x, y, xe, _ = _data(3, 2, 10)
    labels = np.array([7, 42])[y]
    clf = LogisticRegression(C=1.0, device="cpu").fit(x, labels)
    assert set(np.unique(clf.predict(xe))) <= {7, 42}
    assert clf.decision_function(xe).shape == (len(xe),)
    with pytest.raises(ValueError, match="at least 2 classes"):
        LogisticRegression(device="cpu").fit(x, np.zeros(len(x), int))


def test_logreg_runs_on_the_card_unless_asked(monkeypatch):
    from mvlpt_torch.evaluation.logreg import LogisticRegression

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LogisticRegression()
