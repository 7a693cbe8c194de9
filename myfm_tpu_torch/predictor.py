"""Posterior-predictive averaging over kept Gibbs samples, and scoring
with the converged variational weights.

PyTorch counterpart of ``myfm_tpu/predictor.py`` ``Predictor`` and
``VariationalPredictor``.  Gibbs samples are stacked on the device in
memory-bounded chunks and scored with ops/forward_categorical when every
table is one-hot or entity+attribute, else with the row-space forward
(ops/forward.py) over a compiled design; both scorers serve the
regression mean, the probit classifier's Φ and the ordered probit's
class probabilities.  The
variational weight set is scored on the device with the row-space
forward.  ``n_workers`` is accepted for API parity and ignored.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from scipy import sparse as sps

from .base import std_cdf
from .containers import FM, VariationalFM
from .design import compile_design
from .design_categorical import torch_dtype
from .ops.forward import predict_score
from .ops.forward_categorical import (
    compile_categorical_inference,
    oprobit_class_probs,
    scores_samples_reduce,
    serving_row_chunk,
)
from .relational import RelationBlock

ArrayLike = Union[np.ndarray, sps.spmatrix]

TASK_CLASSIFICATION = "classification"

_CHUNK_ELEMENTS = 1 << 26


class Predictor:
    """Holds kept posterior samples; averages the posterior predictive
    on ``device``."""

    def __init__(self, rank: int, n_features: int, task: str,
                 dtype=np.float32, device="cuda"):
        self.rank = rank
        self.n_features = n_features
        self.task = task
        self.dtype = np.dtype(dtype)
        self.device = torch.device(device)
        self.samples: List[FM] = []

    def _sample_chunks(self):
        """Stacked (w0s, ws, Vs) device tensors per memory-bounded
        sample chunk."""
        per_sample = max(1, self.n_features * max(self.rank, 1))
        chunk = max(1, min(len(self.samples), _CHUNK_ELEMENTS // per_sample))
        tdtype = torch_dtype(self.dtype)
        for s0 in range(0, len(self.samples), chunk):
            part = self.samples[s0 : s0 + chunk]

            def up(a):
                return torch.as_tensor(
                    np.asarray(a), dtype=tdtype, device=self.device
                )

            yield (
                part,
                up([s.w0 for s in part]),
                up(np.stack([s.w for s in part])),
                up(np.stack([s.V for s in part])),
            )

    def predict(
        self,
        X: Optional[ArrayLike],
        X_rel: Sequence[RelationBlock] = (),
        n_workers: Optional[int] = None,
    ) -> np.ndarray:
        """Posterior-predictive mean (probit-squashed per sample for
        classification, then averaged)."""
        mode = "probit_sum" if self.task == TASK_CLASSIFICATION else "sum"
        return self._reduce(X, X_rel, mode, None)

    def predict_parallel_oprobit(
        self,
        X: Optional[ArrayLike],
        X_rel: Sequence[RelationBlock] = (),
        n_workers: Optional[int] = None,
        cutpoint_index: int = 0,
    ) -> np.ndarray:
        """Per-class probabilities [N, K] averaged over the kept samples,
        each sample's on its cutpoint group ``cutpoint_index``."""
        return self._reduce(X, X_rel, "oprobit_sum", cutpoint_index)

    def _reduce(self, X, X_rel, mode: str, cutpoint_index) -> np.ndarray:
        """The posterior sum of ``mode`` over every kept sample, on the
        entity-space scorer when the design compiles to its plan and on
        the row-space one otherwise, divided by the sample count."""
        if not self.samples:
            raise RuntimeError("Predictor has no samples.")
        fast = compile_categorical_inference(
            X, X_rel, self.dtype, self.device
        )
        plan = None
        if fast is None:
            plan = compile_design(X, X_rel, dtype=self.dtype,
                                  for_training=False, device=self.device)
        total = None
        for part, w0s, ws, vs in self._sample_chunks():
            cps = None
            if mode == "oprobit_sum":
                cps = torch.as_tensor(
                    np.stack([s.cutpoints[cutpoint_index] for s in part]),
                    dtype=ws.dtype, device=self.device,
                )
            if fast is not None:
                out = scores_samples_reduce(
                    fast, w0s, ws, vs, mode=mode, cutpoints=cps,
                    row_chunk=serving_row_chunk(len(part), self.rank),
                )
            else:
                out = _rows_reduce(plan, w0s, ws, vs, mode, cps)
            out = out.double().cpu().numpy()
            total = out if total is None else total + out
        return total / len(self.samples)


def _rows_reduce(plan, w0s, ws, vs, mode: str, cutpoints):
    """The row-space scorer's sum of ``mode`` over one sample chunk:
    each sample scored with predict_score."""
    acc = None
    for k in range(ws.shape[0]):
        sc = predict_score(plan, w0s[k], ws[k], vs[k])
        if mode == "probit_sum":
            sc = torch.special.ndtr(sc)
        elif mode == "oprobit_sum":
            sc = oprobit_class_probs(sc[:, None], cutpoints[k : k + 1])[:, 0]
        acc = sc if acc is None else acc + sc
    return acc


class VariationalPredictor:
    """Holds the single converged VI weight set (reference
    declare_module.hpp:343-346) and scores it on ``device``."""

    def __init__(self, rank: int, n_features: int, task: str,
                 dtype=np.float32, device="cuda"):
        self.rank = rank
        self.n_features = n_features
        self.task = task
        self.dtype = np.dtype(dtype)
        self.device = torch.device(device)
        self.samples: List[VariationalFM] = []  # exactly one after fit

    def weights(self) -> VariationalFM:
        return self.samples[0]

    def predict(
        self,
        X: Optional[ArrayLike],
        X_rel: Sequence[RelationBlock] = (),
        n_workers: Optional[int] = None,
    ) -> np.ndarray:
        """The score of the posterior-mean weights, computed on the
        device through the row-space forward; for the classification task
        its probit squash Φ(score)."""
        if not self.samples:
            raise RuntimeError("Predictor has no samples.")
        vfm = self.samples[0]
        tdtype = torch_dtype(self.dtype)

        def up(a):
            return torch.as_tensor(np.asarray(a), dtype=tdtype,
                                   device=self.device)

        plan = compile_design(X, X_rel, dtype=self.dtype, for_training=False,
                              device=self.device)
        score = predict_score(plan, up(vfm.w0), up(vfm.w), up(vfm.V))
        score = score.double().cpu().numpy()
        if self.task == TASK_CLASSIFICATION:
            return std_cdf(score)
        return score
