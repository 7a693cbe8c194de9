"""Posterior-predictive averaging over kept Gibbs samples.

PyTorch counterpart of ``myfm_tpu/predictor.py`` ``Predictor``: samples
are stacked on the device in memory-bounded chunks and scored with
ops/forward_categorical when every table is one-hot, else with the
row-space forward (ops/forward.py) over a compiled design.
``n_workers`` is accepted for API parity and ignored.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from scipy import sparse as sps

from .containers import FM
from .design import compile_design
from .design_categorical import torch_dtype
from .ops.forward import predict_score
from .ops.forward_categorical import (
    compile_categorical_inference,
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
                 dtype=np.float32, device="cpu"):
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
        if not self.samples:
            raise RuntimeError("Predictor has no samples.")
        fast = compile_categorical_inference(
            X, X_rel, self.dtype, self.device
        )
        if fast is None:
            return self._predict_rows(X, X_rel)
        mode = "probit_sum" if self.task == TASK_CLASSIFICATION else "sum"
        total = np.zeros(fast.n_rows, dtype=np.float64)
        for part, w0s, ws, vs in self._sample_chunks():
            out = scores_samples_reduce(
                fast, w0s, ws, vs, mode=mode,
                row_chunk=serving_row_chunk(len(part), self.rank),
            )
            total += out.double().cpu().numpy()
        return total / len(self.samples)

    def _predict_rows(self, X, X_rel) -> np.ndarray:
        """Row-space scorer: the design compiled for inference, each kept
        sample scored with predict_score and summed per sample chunk."""
        if self.task == TASK_CLASSIFICATION:
            raise NotImplementedError(
                "classification on the row-space scorer: later slice"
            )
        plan = compile_design(X, X_rel, dtype=self.dtype, for_training=False,
                              device=self.device)
        total = np.zeros(plan.n_rows, dtype=np.float64)
        for part, w0s, ws, vs in self._sample_chunks():
            acc = torch.zeros(plan.n_rows, dtype=ws.dtype, device=ws.device)
            for k in range(len(part)):
                acc += predict_score(plan, w0s[k], ws[k], vs[k])
            total += acc.double().cpu().numpy()
        return total / len(self.samples)
