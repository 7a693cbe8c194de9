"""Posterior-predictive averaging over kept Gibbs samples, and scoring
with the converged variational weights.

PyTorch counterpart of ``myfm_tpu/predictor.py`` ``Predictor`` and
``VariationalPredictor``.  Gibbs samples are stacked on the device in
memory-bounded chunks and scored with ops/forward_categorical when every
table is one-hot or entity+attribute, else with the row-space forward
(ops/forward.py) over a compiled design; both scorers serve the
regression mean, the probit classifier's Φ and the ordered probit's
class probabilities.  A Predictor keeps the plans of the last design it
served (by the identity of ``(X, *X_rel)``) and the stacked sample
chunks of its current ``samples``, each under a ``_LiveKey`` (as the TPU
package does), so repeated serving calls skip the compile and the
upload.  The variational weight set is scored on the device with the
row-space forward.  ``n_workers`` is accepted for API parity and
ignored.  ``mesh`` (a ``torch.distributed`` process group, or a
``parallel.collectives.Axis``) splits the rows over the group's ranks:
each scores its own rows and one all-gather returns the whole
prediction on every rank (``scores_samples_reduce_sharded``); as in the
TPU package it needs the entity-space scorer.
"""

from __future__ import annotations

import weakref
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
    scores_samples_reduce_sharded,
    serving_row_chunk,
)
from .relational import RelationBlock

ArrayLike = Union[np.ndarray, sps.spmatrix]

TASK_CLASSIFICATION = "classification"

_CHUNK_ELEMENTS = 1 << 26


class _LiveKey:
    """Identity cache key that cannot alias recycled ids (the TPU
    package's).

    ``id()`` tuples alone are unsound keys: Python reuses addresses after
    garbage collection, so a freed design followed by a new one at the
    same address would be served the stale plan.  The key holds a
    weakref per object (a collected object makes it miss) and a cheap
    structural fingerprint (type, shape, nnz) as a second factor for
    objects that cannot be weakly referenced."""

    def __init__(self, objs):
        self._ids = tuple(id(o) for o in objs)
        self._prints = tuple(self._fingerprint(o) for o in objs)
        refs = []
        for o in objs:
            try:
                refs.append(weakref.ref(o))
            except TypeError:
                refs.append(None)
        self._refs = tuple(refs)

    @staticmethod
    def _fingerprint(o):
        shape = getattr(o, "shape", None)
        nnz = getattr(o, "nnz", None)
        return (type(o).__name__, shape, nnz)

    def matches(self, objs) -> bool:
        if len(objs) != len(self._ids):
            return False
        if tuple(id(o) for o in objs) != self._ids:
            return False
        if tuple(self._fingerprint(o) for o in objs) != self._prints:
            return False
        # a dead weakref means the keyed object was collected and this
        # id now belongs to another object
        return all(r is None or r() is not None for r in self._refs)


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
        self._plan_cache = None
        self._sample_stack_cache = None

    def __getstate__(self):
        # the caches hold device tensors and weakrefs: not pickled
        state = self.__dict__.copy()
        state["_plan_cache"] = state["_sample_stack_cache"] = None
        return state

    def __setstate__(self, state):
        state.setdefault("_plan_cache", None)
        state.setdefault("_sample_stack_cache", None)
        self.__dict__.update(state)

    def _plans(self, X, X_rel):
        """(entity-space plan or None, row-space plan or None) of the
        design, cached per design identity: X's arrays (the estimators
        pass ``csr_matrix(X)``, which shares them) and the blocks; a
        design without main columns is its blocks alone."""
        main = ()
        if X is not None and X.shape[1]:
            X = sps.csr_matrix(X)
            main = (X.indptr, X.indices, X.data)
        objs = main + tuple(X_rel)
        cached = self._plan_cache
        if cached is not None and cached[0].matches(objs):
            return cached[1]
        fast = compile_categorical_inference(
            X, X_rel, self.dtype, self.device
        )
        plan = None
        if fast is None:
            plan = compile_design(X, X_rel, dtype=self.dtype,
                                  for_training=False, device=self.device)
        self._plan_cache = (_LiveKey(objs), (fast, plan))
        return fast, plan

    def _sample_chunks(self):
        """Stacked (part, w0s, ws, Vs) device tensors per memory-bounded
        sample chunk, cached for the current ``samples`` (a new list or
        other sample objects rebuild them)."""
        cached = self._sample_stack_cache
        if cached is not None and cached[0].matches(tuple(self.samples)):
            return cached[1]
        per_sample = max(1, self.n_features * max(self.rank, 1))
        chunk = max(1, min(len(self.samples), _CHUNK_ELEMENTS // per_sample))
        tdtype = torch_dtype(self.dtype)

        def up(a):
            return torch.as_tensor(np.asarray(a), dtype=tdtype,
                                   device=self.device)

        staged = []
        for s0 in range(0, len(self.samples), chunk):
            part = self.samples[s0 : s0 + chunk]
            staged.append((
                part,
                up([s.w0 for s in part]),
                up(np.stack([s.w for s in part])),
                up(np.stack([s.V for s in part])),
            ))
        self._sample_stack_cache = (_LiveKey(tuple(self.samples)), staged)
        return staged

    def predict(
        self,
        X: Optional[ArrayLike],
        X_rel: Sequence[RelationBlock] = (),
        n_workers: Optional[int] = None,
        mesh=None,
    ) -> np.ndarray:
        """Posterior-predictive mean (probit-squashed per sample for
        classification, then averaged); ``mesh`` splits the rows over a
        process group's ranks."""
        mode = "probit_sum" if self.task == TASK_CLASSIFICATION else "sum"
        return self._reduce(X, X_rel, mode, None, mesh)

    def predict_parallel_oprobit(
        self,
        X: Optional[ArrayLike],
        X_rel: Sequence[RelationBlock] = (),
        n_workers: Optional[int] = None,
        cutpoint_index: int = 0,
        mesh=None,
    ) -> np.ndarray:
        """Per-class probabilities [N, K] averaged over the kept samples,
        each sample's on its cutpoint group ``cutpoint_index``;
        ``mesh`` as in ``predict``."""
        return self._reduce(X, X_rel, "oprobit_sum", cutpoint_index, mesh)

    def _reduce(self, X, X_rel, mode: str, cutpoint_index,
                mesh=None) -> np.ndarray:
        """The posterior sum of ``mode`` over every kept sample, on the
        entity-space scorer when the design compiles to its plan and on
        the row-space one otherwise, divided by the sample count."""
        if not self.samples:
            raise RuntimeError("Predictor has no samples.")
        fast, plan = self._plans(X, X_rel)
        axis = None
        if mesh is not None:
            from .parallel.collectives import Axis

            if fast is None:
                raise ValueError(
                    "mesh-sharded prediction requires the entity-space "
                    "fast path; this design fell back to the row-space "
                    "scorer (one process only).")
            axis = mesh if isinstance(mesh, Axis) else Axis(mesh)
        total = None
        for part, w0s, ws, vs in self._sample_chunks():
            cps = None
            if mode == "oprobit_sum":
                cps = torch.as_tensor(
                    np.stack([s.cutpoints[cutpoint_index] for s in part]),
                    dtype=ws.dtype, device=self.device,
                )
            if axis is not None:
                out = scores_samples_reduce_sharded(
                    fast, w0s, ws, vs, axis, mode=mode, cutpoints=cps,
                    row_chunk=serving_row_chunk(len(part), self.rank),
                )
            elif fast is not None:
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
