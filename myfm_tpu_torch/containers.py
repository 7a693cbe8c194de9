"""Posterior-sample, hyperparameter and history containers.

Python-native (numpy-backed) equivalents of the reference's bound C++
objects ``FM``, ``FMHyperParameters``, ``LearningHistory``
(/root/reference/cpp_source/declare_module.hpp:126-392).  All are plain
picklable objects; device arrays never leak into them, so serialized
models are portable across hosts/accelerators.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
from scipy import sparse as sps
from scipy.special import ndtr

from .relational import RelationBlock

ArrayLike = Union[np.ndarray, sps.spmatrix]

# factor-chunk bound for the numpy forward (elements of q per chunk)
_NP_CHUNK_ELEMENTS = 1 << 26


def fm_predict_score_numpy(
    w0: float,
    w: np.ndarray,
    V: np.ndarray,
    X: Optional[ArrayLike],
    blocks: Sequence[RelationBlock] = (),
) -> np.ndarray:
    """Numpy oracle of the FM forward pass (reference FM.hpp:54-136)."""
    if X is None:
        n_rows = blocks[0].mapper_size
        X = sps.csr_matrix((n_rows, 0), dtype=np.float64)
    X = sps.csr_matrix(X).astype(np.float64)
    n_rows = X.shape[0]
    w = np.asarray(w, dtype=np.float64)
    V = np.asarray(V, dtype=np.float64)

    score = np.full(n_rows, float(w0))
    offset = X.shape[1]
    score += X @ w[:offset]
    for b in blocks:
        bw = sps.csr_matrix(b.data).astype(np.float64) @ w[
            offset : offset + b.feature_size
        ]
        score += bw[b.original_to_block]
        offset += b.feature_size

    rank = V.shape[1]
    if rank == 0:
        return score
    chunk = max(1, min(rank, _NP_CHUNK_ELEMENTS // max(n_rows, 1)))
    X2 = X.power(2)
    blocks_sq = [sps.csr_matrix(b.data).power(2) for b in blocks]
    for r0 in range(0, rank, chunk):
        Vc = V[:, r0 : r0 + chunk]
        q = X @ Vc[: X.shape[1]]
        qs = X2 @ (Vc[: X.shape[1]] ** 2)
        offset = X.shape[1]
        for b, b2 in zip(blocks, blocks_sq):
            vb = Vc[offset : offset + b.feature_size]
            q += (b.data @ vb)[b.original_to_block]
            qs += (b2 @ vb**2)[b.original_to_block]
            offset += b.feature_size
        score += 0.5 * (q**2 - qs).sum(axis=1)
    return score


class FM:
    """One posterior sample of the model weights (reference ``_myfm.FM``)."""

    def __init__(
        self,
        w0: float,
        w: np.ndarray,
        V: np.ndarray,
        cutpoints: Optional[List[np.ndarray]] = None,
    ):
        self.w0 = float(w0)
        self.w = np.asarray(w)
        self.V = np.asarray(V)
        self.cutpoints: List[np.ndarray] = (
            [np.asarray(c) for c in cutpoints] if cutpoints else []
        )

    @property
    def n_factors(self) -> int:
        return int(self.V.shape[1])

    def predict_score(
        self, X: Optional[ArrayLike], X_rel: Sequence[RelationBlock] = ()
    ) -> np.ndarray:
        return fm_predict_score_numpy(self.w0, self.w, self.V, X, X_rel)

    def oprobit_predict_proba(
        self,
        X: Optional[ArrayLike],
        X_rel: Sequence[RelationBlock] = (),
        cutpoint_index: int = 0,
    ) -> np.ndarray:
        """P(class k) = Φ(γ_k − s) − Φ(γ_{k−1} − s) (FM.hpp:137-162)."""
        if not self.cutpoints:
            raise RuntimeError("No cutpoint available for this FM.")
        score = self.predict_score(X, X_rel)
        gamma = np.asarray(self.cutpoints[cutpoint_index], dtype=np.float64)
        cdf = ndtr(gamma[None, :] - score[:, None])  # [N, K-1]
        probs = np.empty((score.shape[0], gamma.shape[0] + 1))
        probs[:, 0] = cdf[:, 0]
        probs[:, 1:-1] = np.diff(cdf, axis=1)
        probs[:, -1] = 1.0 - cdf[:, -1]
        return probs

    def __getstate__(self):
        return {
            "w0": self.w0, "w": self.w, "V": self.V,
            "cutpoints": self.cutpoints,
        }

    def __setstate__(self, state):
        self.w0 = state["w0"]
        self.w = state["w"]
        self.V = state["V"]
        self.cutpoints = state["cutpoints"]


@dataclasses.dataclass
class FMHyperParameters:
    """Hyperprior state (reference HyperParams.hpp:8-37)."""

    alpha: float
    mu_w: np.ndarray  # [G]
    lambda_w: np.ndarray  # [G]
    mu_V: np.ndarray  # [G, R]
    lambda_V: np.ndarray  # [G, R]


@dataclasses.dataclass
class LearningHistory:
    """Per-iteration trace (reference LearningHistory.hpp:6-11)."""

    hypers: List[FMHyperParameters] = dataclasses.field(default_factory=list)
    # final cumulative MH accept count per cutpoint-group sampler
    # (reference FMTrainer.hpp:83-85 — one entry per sampler)
    n_mh_accept: List[int] = dataclasses.field(default_factory=list)
    # cumulative accept counts recorded every iteration, one list entry
    # per sweep holding the per-group counts (richer than the
    # reference's single final count; np.diff gives per-sweep accepts)
    n_mh_accept_trace: List[List[int]] = dataclasses.field(
        default_factory=list
    )
    train_log_losses: List[float] = dataclasses.field(default_factory=list)
    # which sweep engine the run resolved to ("fastpath" entity-space,
    # "joint" merged-row, "colored" chromatic fallback) — the
    # user-visible witness of the auto-dispatch decision, used by the
    # accuracy protocol and the engine-resolution tests
    engine: str = ""
    # the fast path's resolved Gram mode ("split", "bf16", or False for
    # IEEE; trainer._resolve_gram_fast_matmul); None on the other engines
    gram_fast_matmul: Optional[object] = None


@dataclasses.dataclass
class VariationalFM:
    """Converged variational posterior (means + variances) of all weights.

    Mirrors the reference ``VariationalFM`` (variational.hpp:63-110);
    the mean fields double as an ``FM``-compatible view for prediction.
    """

    w0: float
    w: np.ndarray
    V: np.ndarray
    w0_var: float
    w_var: np.ndarray
    V_var: np.ndarray
    cutpoints: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def n_factors(self) -> int:
        return int(self.V.shape[1])

    def predict_score(
        self, X: Optional[ArrayLike], X_rel: Sequence[RelationBlock] = ()
    ) -> np.ndarray:
        return fm_predict_score_numpy(self.w0, self.w, self.V, X, X_rel)


@dataclasses.dataclass
class VariationalFMHyperParameters:
    """Reference variational.hpp:26-61: adds variances/rates to hypers."""

    alpha: float
    alpha_rate: float
    mu_w: np.ndarray
    mu_w_var: np.ndarray
    lambda_w: np.ndarray
    lambda_w_rate: np.ndarray
    mu_V: np.ndarray
    mu_V_var: np.ndarray
    lambda_V: np.ndarray
    lambda_V_rate: np.ndarray


@dataclasses.dataclass
class VariationalLearningHistory:
    """Reference variational.hpp:139-145: final hyper + ELBO trace."""

    hypers: Optional[VariationalFMHyperParameters] = None
    elbos: List[float] = dataclasses.field(default_factory=list)
    # resolved VI engine ("fastpath" entity-space CAVI, "colored"
    # staged/chromatic fallback); see LearningHistory.engine
    engine: str = ""
    # the fast path's resolved Gram mode; see
    # LearningHistory.gram_fast_matmul
    gram_fast_matmul: Optional[object] = None
