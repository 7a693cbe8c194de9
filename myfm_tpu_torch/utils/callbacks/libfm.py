"""Memory-light streaming evaluation callbacks.

Counterpart of ``myfm_tpu/utils/callbacks/libfm.py``: the callbacks
accumulate a *running* posterior-mean prediction over test data without
storing samples (the "n_kept_samples=1 + callback" mode of libFM), track
per-iteration metrics (plus ``*_this`` and ``*_all_but_5`` variants),
and optionally dump a CSV trace.

The trainers hand a callback a lazy view whose weights still live on the
device (``trainer.LazyFMView``, its state as ``_state``).  The callback
scores the test set there: it compiles the test design once
(``design.compile_design(..., for_training=False)`` on the state's
device, in its dtype) and runs ``ops/forward.predict_score`` each sweep,
so the only value a sweep copies to the host is the test score.  A plain
``FM`` (no ``_state``) is scored by its numpy forward.  A failure on the
device raises.
"""

from __future__ import annotations

import csv
import os
from abc import ABC, abstractmethod
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy import sparse as sps
from scipy.special import ndtr

from ...base import REAL, check_data_consistency
from ...design import compile_design
from ...ops.forward import predict_score
from ...relational import RelationBlock

_BURN_IN = 5  # iterations excluded from the *_all_but_5 running mean


def _write_trace(path: str, rows: List[Dict[str, float]]) -> None:
    """The trace as ``pd.DataFrame(rows).to_csv(path, index=False)``
    writes it (every row has the first row's keys): floats in their
    shortest repr, NaN as an empty field."""

    def field(v):
        return "" if isinstance(v, (float, np.floating)) and np.isnan(v) \
            else v

    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator=os.linesep)
        writer.writerow(list(rows[0]))
        for row in rows:
            writer.writerow([field(v) for v in row.values()])


class LibFMLikeCallbackBase(ABC):
    """Per-iteration test scoring with running posterior averaging."""

    # The callbacks read model state strictly inside the callback (the
    # lazy views the trainer passes), so the trainer may keep its
    # pipelined trace harvest: per sweep the only forced sync is this
    # callback's own test-score fetch (trainer.callback_allows_async).
    allow_async_trace = True

    def __init__(
        self,
        n_iter: int,
        X_test,
        X_rel_test: List[RelationBlock],
        y_test: np.ndarray,
        trace_path: Optional[str] = None,
    ):
        self.n_test_data = check_data_consistency(X_test, X_rel_test)
        self.n_iter = n_iter
        if X_test is not None:
            self.X_test = sps.csr_matrix(X_test, dtype=REAL)
        else:
            self.X_test = sps.csr_matrix((self.n_test_data, 0), dtype=REAL)
        self.X_rel_test = X_rel_test
        self.y_test = y_test
        self.result_trace: List[Dict[str, float]] = []
        self.trace_path = trace_path
        self.n_samples = 0

    @abstractmethod
    def _measure_score(
        self, i: int, fm, hyper
    ) -> Tuple[str, Dict[str, float]]:
        raise NotImplementedError  # pragma: no cover

    def __call__(self, i, fm, hyper, history) -> Tuple[bool, Optional[str]]:
        description, trace_result = self._measure_score(i, fm, hyper)
        self.result_trace.append(trace_result)
        if self.trace_path is not None:
            _write_trace(self.trace_path, self.result_trace)
        return False, description

    # the compiled test design, built at the first device score
    _device_plan = None

    def _score_on_device(self, fm) -> Optional[np.ndarray]:
        """The test score of a view over device state, computed on its
        device; None for a plain FM."""
        state = getattr(fm, "_state", None)
        if state is None:
            return None
        if self._device_plan is None:
            self._device_plan = compile_design(
                self.X_test,
                self.X_rel_test,
                dtype=torch.empty(0, dtype=state.w.dtype).numpy().dtype,
                for_training=False,
                device=state.w.device,
            )
        score = predict_score(self._device_plan, state.w0, state.w, state.V)
        return score.cpu().numpy().astype(np.float64)

    def _test_score(self, fm) -> np.ndarray:
        score = self._score_on_device(fm)
        if score is None:
            score = fm.predict_score(self.X_test, self.X_rel_test)
        return score

    def __getstate__(self):
        # the device plan is a cache, not state
        state = dict(self.__dict__)
        state.pop("_device_plan", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._device_plan = None


class RegressionCallback(LibFMLikeCallbackBase):
    def __init__(
        self,
        n_iter: int,
        X_test,
        y_test: np.ndarray,
        X_rel_test: List[RelationBlock] = [],
        clip_min: Optional[float] = None,
        clip_max: Optional[float] = None,
        trace_path: Optional[str] = None,
    ):
        super().__init__(n_iter, X_test, X_rel_test, y_test, trace_path)
        self.predictions = np.zeros(self.n_test_data, dtype=np.float64)
        self.prediction_all_but_5 = np.zeros(
            self.n_test_data, dtype=np.float64
        )
        self.clip_min = clip_min
        self.clip_max = clip_max

    def clip_value(self, arr: np.ndarray) -> None:
        if self.clip_min is not None:
            np.clip(arr, self.clip_min, None, out=arr)
        if self.clip_max is not None:
            np.clip(arr, None, self.clip_max, out=arr)

    def _rmse(self, pred: np.ndarray) -> float:
        return float(((self.y_test - pred) ** 2).mean() ** 0.5)

    def _measure_score(self, i, fm, hyper):
        score = self._test_score(fm)
        self.predictions += score
        self.n_samples += 1
        mean = self.predictions / self.n_samples
        self.clip_value(mean)
        if i >= _BURN_IN:
            self.prediction_all_but_5 += score
            mean_ab5 = self.prediction_all_but_5 / (i + 1 - _BURN_IN)
            self.clip_value(mean_ab5)
            rmse_all_but_5 = self._rmse(mean_ab5)
        else:
            rmse_all_but_5 = float("nan")
        rmse = self._rmse(mean)
        rmse_this = self._rmse(score)
        description = (
            "alpha={0:.4f}, rmse_mean={1:.4f}, rmse_this={2:.4f}, "
            "rmse_all_but_5={3:.4f}"
        ).format(hyper.alpha, rmse, rmse_this, rmse_all_but_5)
        return description, OrderedDict(
            [
                ("alpha", hyper.alpha),
                ("rmse", rmse),
                ("rmse_this", rmse_this),
                ("rmse_all_but_5", rmse_all_but_5),
            ]
        )


class ClassificationCallback(LibFMLikeCallbackBase):
    def __init__(
        self,
        n_iter: int,
        X_test,
        y_test: np.ndarray,
        X_rel_test: List[RelationBlock] = [],
        eps: Optional[float] = 1e-15,
        trace_path: Optional[str] = None,
    ):
        super().__init__(n_iter, X_test, X_rel_test, y_test, trace_path)
        self.predictions = np.zeros(self.n_test_data, dtype=np.float64)
        self.prediction_all_but_5 = np.zeros(
            self.n_test_data, dtype=np.float64
        )
        self.eps = eps

    def clip_value(self, arr: np.ndarray) -> None:
        if self.eps is not None:
            np.clip(arr, self.eps, 1 - self.eps, out=arr)

    def _log_loss(self, arr: np.ndarray) -> float:
        pos = np.log(arr[self.y_test == 1]).sum()
        neg = np.log(1 - arr[self.y_test == 0]).sum()
        return -float(pos + neg)

    def _accuracy(self, arr: np.ndarray) -> float:
        return float((self.y_test == (arr >= 0.5)).mean())

    def _measure_score(self, i, fm, hyper):
        prob_this = ndtr(self._test_score(fm))
        self.predictions += prob_this
        self.n_samples += 1
        mean = self.predictions / self.n_samples
        self.clip_value(mean)
        if i >= _BURN_IN:
            self.prediction_all_but_5 += prob_this
            mean_ab5 = self.prediction_all_but_5 / (i + 1 - _BURN_IN)
            self.clip_value(mean_ab5)
            ll_all_but_5 = self._log_loss(mean_ab5)
            acc_all_but_5 = self._accuracy(mean_ab5)
        else:
            ll_all_but_5 = float("nan")
            acc_all_but_5 = float("nan")
        ll = self._log_loss(mean)
        acc = self._accuracy(mean)
        ll_this = self._log_loss(np.clip(prob_this, 1e-15, 1 - 1e-15))
        acc_this = self._accuracy(prob_this)
        description = (
            "ll_mean={0:.4f}, ll_this={1:.4f}, ll_all_but_5={2:.4f}"
        ).format(ll, ll_this, ll_all_but_5)
        return description, OrderedDict(
            [
                ("log_loss", ll),
                ("log_loss_this", ll_this),
                ("log_loss_all_but_5", ll_all_but_5),
                ("accuracy", acc),
                ("accuracy_this", acc_this),
                ("accuracy_all_but_5", acc_all_but_5),
            ]
        )


class OrderedProbitCallback(LibFMLikeCallbackBase):
    def __init__(
        self,
        n_iter: int,
        X_test,
        y_test: np.ndarray,
        n_class: int,
        X_rel_test: List[RelationBlock] = [],
        eps: Optional[float] = 1e-15,
        trace_path: Optional[str] = None,
    ):
        super().__init__(n_iter, X_test, X_rel_test, y_test, trace_path)
        self.predictions = np.zeros(
            (self.n_test_data, n_class), dtype=np.float64
        )
        self.prediction_all_but_5 = np.zeros(
            (self.n_test_data, n_class), dtype=np.float64
        )
        self.n_class = n_class
        self.eps = eps
        self.y_test = np.asarray(self.y_test).astype(np.int32)
        if self.y_test.min() < 0 or self.y_test.max() > n_class - 1:
            raise ValueError(f"y_test must lie in 0..{n_class - 1}.")

    def _log_loss(self, arr: np.ndarray) -> float:
        ps = arr[np.arange(self.y_test.shape[0]), self.y_test].copy()
        np.clip(ps, self.eps, None, out=ps)
        return -float(np.log(ps).sum())

    def _accuracy(self, arr: np.ndarray) -> float:
        return float((self.y_test == arr.argmax(axis=1)).mean())

    def _rmse(self, arr: np.ndarray) -> float:
        expected = arr.dot(np.arange(self.n_class))
        return float(((self.y_test - expected) ** 2).mean()) ** 0.5

    def _measure_score(self, i, fm, hyper):
        score = self._score_on_device(fm)
        if score is None:
            prob_this = fm.oprobit_predict_proba(
                self.X_test, self.X_rel_test, 0
            )
        else:
            gamma = np.asarray(fm.cutpoints[0], dtype=np.float64)
            cdf = ndtr(gamma[None, :] - score[:, None])
            prob_this = np.empty(
                (score.shape[0], gamma.shape[0] + 1)
            )
            prob_this[:, 0] = cdf[:, 0]
            prob_this[:, 1:-1] = np.diff(cdf, axis=1)
            prob_this[:, -1] = 1.0 - cdf[:, -1]
        self.predictions += prob_this
        self.n_samples += 1
        mean = self.predictions / self.n_samples
        if i >= _BURN_IN:
            self.prediction_all_but_5 += prob_this
            mean_ab5 = self.prediction_all_but_5 / (i + 1 - _BURN_IN)
            ll_all_but_5 = self._log_loss(mean_ab5)
            acc_all_but_5 = self._accuracy(mean_ab5)
            rmse_all_but_5 = self._rmse(mean_ab5)
        else:
            ll_all_but_5 = float("nan")
            acc_all_but_5 = float("nan")
            rmse_all_but_5 = float("nan")
        description = (
            "ll_mean={0:.4f}, ll_this={1:.4f}, ll_all_but_5={2:.4f}"
        ).format(
            self._log_loss(mean), self._log_loss(prob_this), ll_all_but_5
        )
        return description, OrderedDict(
            [
                ("log_loss", self._log_loss(mean)),
                ("log_loss_this", self._log_loss(prob_this)),
                ("log_loss_all_but_5", ll_all_but_5),
                ("accuracy", self._accuracy(mean)),
                ("accuracy_this", self._accuracy(prob_this)),
                ("accuracy_all_but_5", acc_all_but_5),
                ("rmse", self._rmse(mean)),
                ("rmse_this", self._rmse(prob_this)),
                ("rmse_all_but_5", rmse_all_but_5),
            ]
        )
