"""L2-regularised logistic regression, as scikit-learn's
``LogisticRegression(solver="lbfgs", C=C, max_iter=1000, tol=1e-4)`` fits
it (scikit-learn 1.9, ``linear_model/_logistic.py:
_logistic_regression_path``). The linear probe (``cli/lpclip.py``) fits
with it: the GPU host has scipy but no scikit-learn.

- The objective is ``LinearModelLoss``'s: the mean of the half
  multinomial loss (with exactly two classes the half binomial loss on one
  coefficient row, ``classes_[1]`` positive) plus ``l2 / 2 ||W||²``, with
  ``l2 = 1 / (C n)``; the intercept is not penalised.
- ``w0`` is zeros, raveled in Fortran order for the multinomial, so one
  feature's classes lie together in the iterate.
- ``scipy.optimize.minimize(method="L-BFGS-B", jac=True)`` takes the
  steps, with scikit-learn's options (``maxls`` 50, ``gtol`` tol,
  ``ftol`` 64 eps).
- The objective and its gradient run in torch on the fit's device, in
  the dtypes scikit-learn computes them in for float32 features and
  scipy's float64 iterate: the coefficients cast to float32, the raw
  predictions and the pointwise gradients in float32 (each pointwise loss
  and probability through float64), the penalty and its gradient in
  float64. TF32 stays off for the products.
- Predictions are the argmax of the float64 decision function over
  ``classes_ = np.unique(y)`` (its sign for two classes).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from scipy import optimize

from mvlpt_torch.utils.device import resolve_device


@contextlib.contextmanager
def _solver_scope(device: torch.device):
    """TF32 off for the products; on the CPU one intra-op thread, since
    waking the thread pool for each of the objective's small ops between
    the solver's steps costs more than the ops."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads()
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cpu":
        torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_num_threads(prev[1])


def loss_gradient(coef: np.ndarray, x: torch.Tensor, target: torch.Tensor, l2: float,
                  n_classes: int) -> tuple[float, np.ndarray]:
    """scikit-learn's ``LinearModelLoss.loss_gradient`` with an intercept:
    ``coef`` the float64 iterate ((d + 1,) for two classes, else (K (d +
    1),) raveled in Fortran order), ``x`` the (n, d) features, ``target``
    the 0/1 labels of classes_[1] for two classes, else the class indices,
    in x's dtype. Returns (loss, float64 gradient shaped as coef). The
    coefficients go to the device, and the loss and gradient back, as one
    copy each (in x's dtype, as scikit-learn computes them)."""
    n, d = x.shape
    binary = n_classes == 2
    rows = coef.reshape((1 if binary else n_classes, d + 1), order="F")
    weights = rows[:, :-1]
    w = torch.from_numpy(rows.astype(np.float32 if x.dtype == torch.float32 else np.float64))
    w = w.to(x.device)
    raw = x @ w[:, :-1].t() + w[:, -1]
    raw64 = raw.double()
    if binary:
        t = target.double()[:, None]
        loss = (torch.nn.functional.softplus(raw64) - t * raw64).to(x.dtype)
        grad_point = (torch.sigmoid(raw64) - t).to(x.dtype)
    else:
        picked = raw64.gather(1, target.long()[:, None])
        loss = (torch.logsumexp(raw64, dim=1, keepdim=True) - picked).to(x.dtype)
        grad_point = torch.softmax(raw64, dim=1).to(x.dtype)
        grad_point[torch.arange(n, device=x.device), target.long()] -= 1
    grad_point = grad_point / n
    packed = torch.cat([(loss.sum() / n).reshape(1),
                        torch.cat([grad_point.t() @ x, grad_point.sum(dim=0)[:, None]],
                                  dim=1).reshape(-1)])
    out = packed.cpu().numpy().astype(np.float64)
    value = float(out[0]) + float(0.5 * l2 * np.sum(weights * weights))
    grad = out[1:].reshape(rows.shape)
    grad[:, :-1] += l2 * weights
    return value, (grad.reshape(-1) if binary else grad.ravel(order="F"))


class LogisticRegression:
    """``fit(x, y)``, ``decision_function(x)``, ``predict(x)`` and
    ``coef_`` (K, d) (one row for two classes), ``intercept_``, ``classes_``
    and ``n_iter_`` as scikit-learn's estimator has them, the objective on
    ``device`` (the card unless the caller asks for the CPU). ``timing_``
    holds the last fit's host seconds, those spent in the objective, and
    its evaluations; the rest is scipy's solver."""

    def __init__(self, C: float = 1.0, max_iter: int = 1000, tol: float = 1e-4,
                 device="cuda"):
        self.C, self.max_iter, self.tol = C, max_iter, tol
        self.device = resolve_device(device)

    def _features(self, x) -> torch.Tensor:
        x = np.asarray(x)
        dtype = torch.float32 if x.dtype == np.float32 else torch.float64
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    def fit(self, x, y) -> "LogisticRegression":
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        k = len(self.classes_)
        if k < 2:
            raise ValueError("This solver needs samples of at least 2 classes in the data, but "
                             f"the data contains only one class: {self.classes_[0]!r}")
        xt = self._features(x)
        n, d = xt.shape
        if k == 2:
            target = torch.as_tensor(y == self.classes_[1], dtype=xt.dtype).to(self.device)
            w0 = np.zeros(d + 1, np.float64)
        else:
            target = torch.as_tensor(np.searchsorted(self.classes_, y),
                                     dtype=xt.dtype).to(self.device)
            w0 = np.zeros((k, d + 1), np.float64, order="F").ravel(order="F")
        evals = []

        def objective(coef, *args):
            t0 = time.perf_counter()
            out = loss_gradient(coef, *args)  # ends in copies to the host: synchronised
            evals.append(time.perf_counter() - t0)
            return out

        t0 = time.perf_counter()
        with _solver_scope(self.device):
            res = optimize.minimize(
                objective, w0, method="L-BFGS-B", jac=True,
                args=(xt, target, 1.0 / (self.C * n), k),
                options={"maxiter": self.max_iter, "maxls": 50, "gtol": self.tol,
                         "ftol": 64 * np.finfo(float).eps})
        self.timing_ = {"fit_s": time.perf_counter() - t0, "objective_s": sum(evals),
                        "evaluations": len(evals)}
        self.n_iter_ = np.asarray([min(res.nit, self.max_iter)], np.int32)
        if k == 2:
            self.coef_, self.intercept_ = res.x[:-1][None, :], res.x[-1:]
        else:
            w = res.x.reshape((k, d + 1), order="F")
            self.coef_, self.intercept_ = w[:, :-1], w[:, -1]
        return self

    def decision_function(self, x) -> torch.Tensor:
        """float64 scores on the device: (n,) for two classes, else (n, K)."""
        xt = self._features(x).double()
        coef = torch.from_numpy(np.ascontiguousarray(self.coef_)).to(self.device)
        scores = xt @ coef.t() + torch.from_numpy(self.intercept_).to(self.device)
        return scores[:, 0] if scores.shape[1] == 1 else scores

    def predict(self, x) -> np.ndarray:
        scores = self.decision_function(x)
        idx = (scores > 0).long() if scores.dim() == 1 else scores.argmax(dim=1)
        return self.classes_[idx.cpu().numpy()]
