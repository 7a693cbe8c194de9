"""Variational-inference estimators (coordinate-ascent mean field).

PyTorch counterpart of ``myfm_tpu/variational.py``
(``MyFMVariationalBase``, ``VariationalFMRegressor``) with the same
"auto" resolution: the all-one-hot fast-path plan, else the
entity+attribute plan (``allow_side=True``), both tiled for the VI
Gram's 3R+2 columns.  A design that compiles to neither needs the
row-space / colored VI, which is a later slice of the port and raises
``NotImplementedError``; so does ``VariationalFMClassifier``.  There is
no design cache: every fit compiles its plan.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
from scipy import sparse as sps

from .base import (
    REAL,
    ArrayLike,
    ConfigBuilder,
    MyFMBase,
    RegressorMixin,
    check_data_consistency,
)
from .relational import RelationBlock


def runtime_error_to_optional(fn):
    """Property access returns None before fit (variational.py:28-37)."""

    def wrapped(self):
        try:
            return fn(self)
        except RuntimeError:
            return None

    return property(wrapped)


class MyFMVariationalBase(MyFMBase):
    def _fetch_weights(self):
        if self.predictor_ is None:
            raise RuntimeError("Not fit yet.")
        return self.predictor_.samples[0]

    @runtime_error_to_optional
    def w0_mean(self) -> Optional[float]:
        return self._fetch_weights().w0

    @runtime_error_to_optional
    def w0_var(self) -> Optional[float]:
        return self._fetch_weights().w0_var

    @runtime_error_to_optional
    def w_mean(self) -> Optional[np.ndarray]:
        return self._fetch_weights().w

    @runtime_error_to_optional
    def w_var(self) -> Optional[np.ndarray]:
        return self._fetch_weights().w_var

    @runtime_error_to_optional
    def V_mean(self) -> Optional[np.ndarray]:
        return self._fetch_weights().V

    @runtime_error_to_optional
    def V_var(self) -> Optional[np.ndarray]:
        return self._fetch_weights().V_var

    def _predict_core(
        self,
        X: Optional[ArrayLike],
        X_rel: List[RelationBlock] = [],
    ) -> np.ndarray:
        predictor = self._fetch_predictor()
        shape = check_data_consistency(X, X_rel)
        X = (sps.csr_matrix((shape, 0), dtype=REAL) if X is None
             else sps.csr_matrix(X))
        return predictor.predict(X, X_rel)

    def _train_core(
        self,
        rank: int,
        init_stdev: float,
        X: sps.csr_matrix,
        X_rel: List[RelationBlock],
        y: np.ndarray,
        random_seed: int,
        config: ConfigBuilder,
        callback,
    ):
        from .design_categorical import try_compile_categorical
        from .ops.variational import VariationalConfig
        from .vi_trainer import CategoricalVITrainer

        cfg = VariationalConfig(
            task=config.task_type,
            alpha_0=config.alpha_0,
            beta_0=config.beta_0,
            gamma_0=config.gamma_0,
            mu_0=config.mu_0,
            reg_0=config.reg_0,
            fit_w0=config.fit_w0,
            fit_linear=config.fit_linear,
        )
        cat_plan = None
        if self.sweep_strategy in ("auto", "categorical"):
            grouping = np.asarray(config.group_index, dtype=np.int32)
            # every VI Gram carries 3R+2 z-columns [1 | e | φ | σ | τ] —
            # tile for that width (the TPU package tiles entity+attribute
            # plans for its 4R+2 columns)
            for allow_side in (False, True):
                cat_plan = try_compile_categorical(
                    X, X_rel, grouping=grouping, n_groups=None,
                    dtype=self.dtype, device=self.device,
                    rank=max(3 * rank, 1), allow_side=allow_side,
                )
                if cat_plan is not None:
                    break
        if cat_plan is not None:
            trainer = CategoricalVITrainer(
                cat_plan, y, cfg, rank, init_stdev, random_seed, self.dtype,
            )
            return trainer.run(config.n_iter, callback)
        if self.sweep_strategy == "categorical":
            raise ValueError(
                "sweep_strategy='categorical' requires every table "
                "(main and blocks) to be one-hot per row."
            )
        raise NotImplementedError(
            "row-space (colored) variational inference: later slice"
        )


class VariationalFMRegressor(RegressorMixin, MyFMVariationalBase):
    r"""Variational-inference FM regressor (deterministic CAVI)."""

    def fit(
        self,
        X: Optional[ArrayLike],
        y: np.ndarray,
        X_rel: List[RelationBlock] = [],
        X_test: Optional[ArrayLike] = None,
        y_test: Optional[np.ndarray] = None,
        X_rel_test: List[RelationBlock] = [],
        n_iter: int = 100,
        n_kept_samples: Optional[int] = None,
        grouping: Optional[List[int]] = None,
        group_shapes: Optional[List[int]] = None,
        callback: Optional[Callable] = None,
        config_builder: Optional[ConfigBuilder] = None,
    ) -> "VariationalFMRegressor":
        """Run CAVI (same parameters as
        ``myfm_tpu.VariationalFMRegressor.fit``)."""
        self._fit(
            X, y, X_rel=X_rel, X_test=X_test, y_test=y_test,
            X_rel_test=X_rel_test, n_iter=n_iter,
            n_kept_samples=n_kept_samples, grouping=grouping,
            group_shapes=group_shapes, callback=callback,
            config_builder=config_builder,
        )
        return self

    def predict(
        self,
        X: Optional[ArrayLike],
        X_rel: List[RelationBlock] = [],
    ) -> np.ndarray:
        """Score with the converged posterior means."""
        return self._predict_core(X, X_rel)


class VariationalFMClassifier:
    """The variational probit classifier: a later slice of the port."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "VariationalFMClassifier (probit VI): later slice"
        )
