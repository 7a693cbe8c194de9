"""Gibbs-sampler regressor on the categorical fast path and the joint
engine.

PyTorch counterpart of ``myfm_tpu/gibbs.py`` (``MyFMGibbsRegressor``,
``_gibbs_config``, ``_encode_ordered_targets`` and ``_train_core``).
The "auto" / "categorical" / "joint" engine resolution is the TPU
package's, unchanged; wherever it lands on the colored engine, this
port raises ``NotImplementedError``, since that engine is a later
slice.  There is no design cache: every fit compiles its plan.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

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
from .containers import FM, FMHyperParameters, LearningHistory
from .ops.gibbs import GibbsConfig
from .relational import RelationBlock


def _encode_ordered_targets(cutpoint_groups, y: np.ndarray):
    """Class-offset target encoding for multiple cutpoint groups: group
    g's classes map to [Σ_{j<g} K_j, Σ_{j<g} K_j + K_g).  A single group
    is validated the same way and passes through unchanged; no groups
    (regression) pass y through."""
    if len(cutpoint_groups) == 0:
        return y
    y = np.asarray(y)
    n = y.shape[0]
    assigned = np.full(n, -1, dtype=np.int64)
    y_enc = np.array(y, copy=True)
    offset = 0
    for g, (n_class, indices) in enumerate(cutpoint_groups):
        idx = np.asarray(indices, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise ValueError(
                f"cutpoint group {g} contains row indices outside "
                f"[0, {n})."
            )
        if np.any(assigned[idx] != -1):
            raise ValueError(
                f"cutpoint group {g} overlaps an earlier group; the "
                "groups must partition the rows."
            )
        assigned[idx] = g
        cls = y[idx]
        if cls.size and (cls.min() < 0 or cls.max() >= n_class):
            raise ValueError(
                f"cutpoint group {g} has targets outside "
                f"[0, {n_class})."
            )
        y_enc[idx] = cls + offset
        offset += n_class
    if np.any(assigned == -1):
        raise ValueError(
            "cutpoint groups must cover every row; "
            f"{int(np.sum(assigned == -1))} rows are unassigned."
        )
    return y_enc


def _gibbs_config(config: ConfigBuilder,
                  sweep_strategy: str) -> GibbsConfig:
    """Map the builder onto the static sweep config."""
    n_classes = tuple(int(k) for k, _ in config.cutpoint_groups)
    return GibbsConfig(
        task=config.task_type,
        alpha_0=config.alpha_0,
        beta_0=config.beta_0,
        gamma_0=config.gamma_0,
        mu_0=config.mu_0,
        reg_0=config.reg_0,
        fit_w0=config.fit_w0,
        fit_linear=config.fit_linear,
        nu_oprobit=config.nu_oprobit,
        cutpoint_scale=config.cutpoint_scale,
        n_class=n_classes[0] if n_classes else 0,
        n_classes=n_classes,
        joint_rows=sweep_strategy == "joint",
    )


def _joint_candidate(est, rank, config) -> bool:
    from .design import joint_auto_candidate

    return joint_auto_candidate(
        rank, bool(config.fit_linear), est.dtype, config.group_index
    )


class MyFMGibbsBase(MyFMBase):
    @property
    def w0_samples(self) -> Optional[np.ndarray]:
        r"""Samples for the global bias ``w0``; ``None`` before fit."""
        if self.predictor_ is None:
            return None
        return np.asarray([fm.w0 for fm in self.predictor_.samples])

    @property
    def w_samples(self) -> Optional[np.ndarray]:
        r"""Samples for linear coefficients ``w`` ([sample, feature])."""
        if self.predictor_ is None:
            return None
        return np.asarray([fm.w for fm in self.predictor_.samples])

    @property
    def V_samples(self) -> Optional[np.ndarray]:
        r"""Samples for ``V`` ([sample, feature, factor])."""
        if self.predictor_ is None:
            return None
        return np.asarray([fm.V for fm in self.predictor_.samples])

    def _predict_core(
        self,
        X: Optional[ArrayLike],
        X_rel: List[RelationBlock] = [],
        n_workers: Optional[int] = None,
    ) -> np.ndarray:
        predictor = self._fetch_predictor()
        shape = check_data_consistency(X, X_rel)
        if X is None:
            X = sps.csr_matrix((shape, 0), dtype=REAL)
        else:
            X = sps.csr_matrix(X)
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
        y = _encode_ordered_targets(config.cutpoint_groups, y)
        cat_plan = None
        # "auto" at small scale with a long chain prefers the JOINT
        # engine over the categorical fast path (the TPU package's
        # measured crossover, kept so both packages resolve alike)
        prefer_joint_small = (
            self.sweep_strategy == "auto"
            and config.n_iter >= 200
            and X.shape[0] <= 500_000
            and _joint_candidate(self, rank, config)
        )
        if self.sweep_strategy in (
            "auto", "categorical"
        ) and not prefer_joint_small:
            from .design_categorical import try_compile_categorical

            cat_plan = try_compile_categorical(
                X,
                X_rel,
                grouping=np.asarray(config.group_index, dtype=np.int32),
                n_groups=None,
                dtype=self.dtype,
                device=self.device,
                rank=rank,
                # side features are drawn as (R+1)-joint [w|V] rows, so
                # the entity+attribute extension needs the linear terms
                allow_side=bool(config.fit_linear),
            )
        use_joint = self.sweep_strategy == "joint"
        if cat_plan is None:
            if self.sweep_strategy == "categorical":
                raise ValueError(
                    "sweep_strategy='categorical' requires every table "
                    "(main and blocks) to be one-hot per row, or a "
                    "block of [one-hot | per-entity side-feature] "
                    "column groups within the entity+attribute gates."
                )
            from .design import (
                compile_design,
                joint_auto_candidate,
                joint_auto_eligible,
            )

            # "auto" prefers the merged joint sweep when the
            # rank/dtype/grouping and dense-machinery gates allow it
            want_joint = use_joint or (
                self.sweep_strategy == "auto"
                and joint_auto_candidate(
                    rank, bool(config.fit_linear), self.dtype,
                    config.group_index,
                )
            )
            plan = compile_design(
                X,
                X_rel,
                grouping=np.asarray(config.group_index, dtype=np.int32),
                dtype=self.dtype,
                strategy=(
                    "auto" if self.sweep_strategy in ("joint", "colored")
                    else self.sweep_strategy
                ),
                max_unrolled_colors=self.max_unrolled_colors,
                joint_dense=want_joint,
                joint_rank=rank,
                device=self.device,
            )
            use_joint = use_joint or (
                want_joint and joint_auto_eligible(plan, rank, self.dtype)
            )
        cfg = _gibbs_config(
            config, "joint" if use_joint else self.sweep_strategy
        )
        from .trainer import CategoricalGibbsTrainer, GibbsTrainer

        if cat_plan is not None:
            trainer = CategoricalGibbsTrainer(
                cat_plan, y, cfg, rank, init_stdev, random_seed,
                self.dtype,
            )
        else:
            trainer = GibbsTrainer(
                plan, y, cfg, rank, init_stdev, random_seed, self.dtype
            )
        return trainer.run(config.n_iter, config.n_kept_samples, callback)

    def get_hyper_trace(self):
        """Tidy per-iteration hyperparameter trace (a pandas DataFrame;
        pandas is imported here only)."""
        import pandas as pd

        if (self.n_groups_ is None) or (self.history_ is None):
            raise RuntimeError("Sampler not run yet.")
        columns = (
            ["alpha"]
            + ["mu_w[{}]".format(g) for g in range(self.n_groups_)]
            + ["lambda_w[{}]".format(g) for g in range(self.n_groups_)]
            + [
                "mu_V[{},{}]".format(g, r)
                for g in range(self.n_groups_)
                for r in range(self.rank)
            ]
            + [
                "lambda_V[{},{}]".format(g, r)
                for g in range(self.n_groups_)
                for r in range(self.rank)
            ]
        )
        res = []
        for hyper in self.history_.hypers:
            row = np.zeros(len(columns), dtype=np.float64)
            row[0] = hyper.alpha
            cursor = 1
            for hp in [hyper.mu_w, hyper.lambda_w, hyper.mu_V,
                       hyper.lambda_V]:
                row[cursor : cursor + hp.size] = np.asarray(hp).ravel()
                cursor += hp.size
            res.append(row)
        df = pd.DataFrame(np.vstack(res))
        df.columns = columns
        return df


class MyFMGibbsRegressor(RegressorMixin, MyFMGibbsBase):
    r"""Bayesian FM regressor via Gibbs sampling."""

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
        callback: Optional[
            Callable[
                [int, FM, FMHyperParameters, LearningHistory],
                Tuple[bool, Optional[str]],
            ]
        ] = None,
        config_builder: Optional[ConfigBuilder] = None,
    ) -> "MyFMGibbsRegressor":
        r"""Run Gibbs sampling (same parameters as
        ``myfm_tpu.MyFMGibbsRegressor.fit``)."""
        self._fit(
            X, y, X_rel=X_rel, X_test=X_test, X_rel_test=X_rel_test,
            y_test=y_test, n_iter=n_iter, n_kept_samples=n_kept_samples,
            grouping=grouping, callback=callback, group_shapes=group_shapes,
            config_builder=config_builder,
        )
        return self

    def predict(
        self,
        X: Optional[ArrayLike],
        X_rel: List[RelationBlock] = [],
        n_workers: Optional[int] = None,
    ) -> np.ndarray:
        """Posterior-predictive mean over the kept samples."""
        return self._predict_core(X, X_rel, n_workers=n_workers)


# Reference alias
MyFMRegressor = MyFMGibbsRegressor
