"""Variational-inference estimators (coordinate-ascent mean field).

PyTorch counterpart of ``myfm_tpu/variational.py``
(``MyFMVariationalBase``, ``VariationalFMRegressor``,
``VariationalFMClassifier``) with the same "auto" resolution: the
all-one-hot fast-path plan, else the entity+attribute plan
(``allow_side=True``; ``compile_vi_fast_plan``), else the row-space
colored sweep (``sweep_strategy`` "colored" or "serial" go there
directly).  Both fast-path plans are tiled for this port's VI Gram
(3R+2 columns) and accepted where the TPU package accepts them (it
gates one-hot plans at width 3R and entity+attribute plans at 4R).
Plans come through the content-addressed cache (design_cache.py, keys
``"cat_vi"``, ``"cat_vi_ea"`` and ``"row_vi"``).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
from scipy import sparse as sps

from .base import (
    REAL,
    ArrayLike,
    ClassifierMixin,
    ConfigBuilder,
    MyFMBase,
    RegressorMixin,
    check_data_consistency,
)
from .relational import RelationBlock


def compile_vi_fast_plan(X, X_rel, grouping, dtype, device, rank: int,
                         fingerprint: Optional[str] = None):
    """The VI fast-path plan of (X, X_rel), or None: the all-one-hot
    plan, else the entity+attribute plan.  Both are tiled for the port's
    VI Gram z = [1 | e | φ | σ | τ] (D = 3R+2) and gated where the TPU
    package gates them: at width 3R for one-hot plans and at 4R for
    entity+attribute plans, whose Gram there carries 4R+2 columns.  With
    the design's ``fingerprint`` each plan comes through the plan cache
    (keys "cat_vi" and "cat_vi_ea")."""
    from .design_cache import get_or_build
    from .design_categorical import try_compile_categorical

    for kind, allow_side, gate in (("cat_vi", False, 3 * rank),
                                   ("cat_vi_ea", True, 4 * rank)):
        def build(allow_side=allow_side, gate=gate):
            return try_compile_categorical(
                X, X_rel, grouping=grouping, n_groups=None, dtype=dtype,
                device=device, rank=max(3 * rank, 1),
                allow_side=allow_side, gate_rank=max(gate, 1),
            )

        plan = (build() if fingerprint is None else get_or_build(
            kind, fingerprint, (np.dtype(dtype).str, rank, str(device)),
            build))
        if plan is not None:
            return plan
    return None


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
        from .design import compile_design
        from .ops.variational import VariationalConfig
        from .vi_trainer import CategoricalVITrainer, VariationalTrainer

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
        from .design_cache import design_fingerprint, get_or_build

        fp = design_fingerprint(X, X_rel, config.group_index)
        grouping = np.asarray(config.group_index, dtype=np.int32)
        if self._sharded:
            # multi-device CAVI (n_devices=N / mesh=): the fast path
            # only, as in the TPU package
            from .parallel.sharding_categorical import (
                ShardedCategoricalVITrainer,
            )

            if self.sweep_strategy not in ("auto", "categorical"):
                raise NotImplementedError(
                    "Multi-device variational training runs on the "
                    "categorical fast path; use sweep_strategy='auto' "
                    "or 'categorical'."
                )
            trainer = ShardedCategoricalVITrainer(
                X, X_rel, y, cfg, rank, init_stdev, random_seed,
                mesh=self._build_mesh(), grouping=grouping,
                dtype=self.dtype, device=self._fit_device(), fingerprint=fp,
            )
            return trainer.run(config.n_iter, callback)
        cat_plan = None
        if self.sweep_strategy in ("auto", "categorical"):
            cat_plan = compile_vi_fast_plan(X, X_rel, grouping, self.dtype,
                                            self.device, rank, fp)
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
        row_strategy = "serial" if self.sweep_strategy == "serial" else "auto"
        plan = get_or_build(
            "row_vi", fp,
            (self.dtype.str, row_strategy, self.max_unrolled_colors,
             str(self.device)),
            lambda: compile_design(
                X, X_rel, grouping=grouping, dtype=self.dtype,
                strategy=row_strategy,
                max_unrolled_colors=self.max_unrolled_colors,
                device=self.device,
            ),
        )
        trainer = VariationalTrainer(
            plan, y, cfg, rank, init_stdev, random_seed, self.dtype
        )
        return trainer.run(config.n_iter, callback)


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


class VariationalFMClassifier(ClassifierMixin, MyFMVariationalBase):
    r"""Variational-inference FM binary classifier (probit link)."""

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
    ) -> "VariationalFMClassifier":
        """Run CAVI on y ∈ {0, 1} (same parameters as
        ``myfm_tpu.VariationalFMClassifier.fit``)."""
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
        """The class (P(y = 1) > 0.5) under the converged means."""
        return self.predict_proba(X, X_rel) > 0.5

    def predict_proba(
        self,
        X: Optional[ArrayLike],
        X_rel: List[RelationBlock] = [],
    ) -> np.ndarray:
        """P(y = 1) = Φ(score) of the converged posterior means."""
        return self._predict_core(X, X_rel)
