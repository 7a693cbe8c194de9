"""Gibbs-sampler estimators on the categorical fast path, the joint
engine and the colored engine: regressor, probit classifier, ordered
probit.

PyTorch counterpart of ``myfm_tpu/gibbs.py`` (``MyFMGibbsRegressor``,
``MyFMGibbsClassifier``, ``MyFMOrderedProbit``, ``_gibbs_config``,
``_encode_ordered_targets`` and ``_train_core``).  The engine does not
depend on the task.  The "auto" / "categorical" / "joint" / "colored" /
"serial" engine resolution is the TPU package's, unchanged.  Plans come
through the content-addressed cache (design_cache.py, keys
``"cat_gibbs"`` and ``"row_gibbs"``), so a refit of the same design on
the same device skips the compile.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
from scipy import sparse as sps

from .base import (
    REAL,
    TASK_ORDERED,
    ArrayLike,
    ClassifierMixin,
    ConfigBuilder,
    MyFMBase,
    RegressorMixin,
    check_data_consistency,
)
from .containers import FM, FMHyperParameters, LearningHistory
from .ops.gibbs import GibbsConfig
from .relational import RelationBlock
from .tracing import span


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
        from .design_cache import design_fingerprint, get_or_build

        # repeated fits on one design (sweeps, protocols, reruns) reuse
        # the compiled plan through the content-addressed cache
        with span("myfm.plan.fingerprint"):
            fp = design_fingerprint(X, X_rel, config.group_index)
        if self._sharded:
            return self._train_core_sharded(
                rank, init_stdev, X, X_rel, y, random_seed, config,
                callback, fp,
            )
        grouping = np.asarray(config.group_index, dtype=np.int32)
        device = str(self.device)
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

            # side features are drawn as (R+1)-joint [w|V] rows, so the
            # entity+attribute extension needs the linear terms
            allow_side = bool(config.fit_linear)
            cat_plan = get_or_build(
                "cat_gibbs", fp, (self.dtype.str, rank, allow_side, device),
                lambda: try_compile_categorical(
                    X, X_rel, grouping=grouping, n_groups=None,
                    dtype=self.dtype, device=self.device, rank=rank,
                    allow_side=allow_side,
                ),
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
            row_strategy = (
                "auto" if self.sweep_strategy in ("joint", "colored")
                else self.sweep_strategy
            )
            plan = get_or_build(
                "row_gibbs", fp,
                (self.dtype.str, row_strategy, self.max_unrolled_colors,
                 want_joint, rank, device),
                lambda: compile_design(
                    X, X_rel, grouping=grouping, dtype=self.dtype,
                    strategy=row_strategy,
                    max_unrolled_colors=self.max_unrolled_colors,
                    joint_dense=want_joint, joint_rank=rank,
                    device=self.device,
                ),
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

    def _train_core_sharded(self, rank, init_stdev, X, X_rel, y,
                            random_seed, config, callback, fp):
        """Multi-device training (``n_devices=N`` / ``mesh=``): this
        rank's part of the fit, on the engine one process resolves (the
        same "auto" rules: the small-scale joint preference, the fast
        path, the joint upgrade), through the sharded trainers of
        parallel/."""
        from .design import joint_auto_candidate
        from .parallel.sharding import ShardedGibbsTrainer
        from .parallel.sharding_categorical import (
            ShardedCategoricalGibbsTrainer,
        )

        axis = self._build_mesh()
        device = self._fit_device()
        cfg = _gibbs_config(config, self.sweep_strategy)
        grouping = np.asarray(config.group_index, dtype=np.int32)
        trainer = None
        prefer_joint_small = (
            self.sweep_strategy == "auto"
            and config.n_iter >= 200
            and X.shape[0] <= 500_000
            and _joint_candidate(self, rank, config)
        )
        if self.sweep_strategy in (
            "auto", "categorical"
        ) and not prefer_joint_small:
            try:
                trainer = ShardedCategoricalGibbsTrainer(
                    X, X_rel, y, cfg, rank, init_stdev, random_seed,
                    mesh=axis, grouping=grouping, dtype=self.dtype,
                    device=device, fingerprint=fp,
                )
            except ValueError:
                if self.sweep_strategy == "categorical":
                    raise ValueError(
                        "sweep_strategy='categorical' requires every "
                        "table (main and blocks) to be one-hot per row, "
                        "or a block of [one-hot | per-entity "
                        "side-feature] column groups within the "
                        "entity+attribute gates.") from None
        if trainer is None:
            trainer = ShardedGibbsTrainer(
                X, X_rel, y, cfg, rank, init_stdev, random_seed,
                mesh=axis, grouping=grouping, dtype=self.dtype,
                strategy=(
                    "auto" if self.sweep_strategy in (
                        "joint", "categorical", "colored"
                    ) else self.sweep_strategy
                ),
                max_unrolled_colors=self.max_unrolled_colors,
                joint_auto=(
                    self.sweep_strategy == "auto"
                    and joint_auto_candidate(
                        rank, bool(config.fit_linear), self.dtype,
                        config.group_index,
                    )
                ),
                device=device, fingerprint=fp,
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


class MyFMGibbsClassifier(ClassifierMixin, MyFMGibbsBase):
    r"""Bayesian FM binary classifier (probit data augmentation)."""

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
    ) -> "MyFMGibbsClassifier":
        r"""Run Gibbs sampling on y ∈ {0, 1} (same parameters as
        ``myfm_tpu.MyFMGibbsClassifier.fit``)."""
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
        """Class prediction at threshold 0.5."""
        return self.predict_proba(X, X_rel, n_workers=n_workers) > 0.5

    def predict_proba(
        self,
        X: Optional[ArrayLike],
        X_rel: List[RelationBlock] = [],
        n_workers: Optional[int] = None,
    ) -> np.ndarray:
        """P(y=1 | x): the posterior mean of the per-sample Φ(score)."""
        return self._predict_core(X, X_rel, n_workers=n_workers)


class MyFMOrderedProbit(MyFMGibbsBase):
    """Bayesian FM for ordinal regression (cumulative probit link)."""

    @property
    def _task_type(self) -> str:
        return TASK_ORDERED

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
        callback_default_freq: int = 5,
        cutpoint_groups: Optional[
            List[Tuple[int, List[int]]]
        ] = None,
    ) -> "MyFMOrderedProbit":
        """Fit the ordinal-probit FM on integer classes y ∈ [0, K).

        ``cutpoint_groups`` optionally partitions the rows into
        independent cutpoint samplers, each entry ``(n_class,
        row_indices)``; by default one group covers every row with
        K = max(y) + 1 classes."""
        config_builder = ConfigBuilder()
        y = np.asarray(y)
        if cutpoint_groups is None:
            n_class = int(y.max()) + 1
            cutpoint_groups = [(n_class, list(range(y.shape[0])))]
        config_builder.set_cutpoint_groups(cutpoint_groups)
        self.n_cutpoint_groups = len(cutpoint_groups)
        self._fit(
            X, y, X_rel=X_rel, X_test=X_test, y_test=y_test,
            X_rel_test=X_rel_test, n_iter=n_iter,
            n_kept_samples=n_kept_samples, grouping=grouping,
            callback=callback, group_shapes=group_shapes,
            config_builder=config_builder,
            callback_default_freq=callback_default_freq,
        )
        return self

    def _process_y(self, y: np.ndarray) -> np.ndarray:
        y = np.asarray(y)
        if y.min() < 0:
            raise ValueError("ordered-probit targets must be >= 0")
        return y.astype(np.float64)

    def _prepare_prediction_for_test(self, fm, X, X_rel):
        return fm.oprobit_predict_proba(
            sps.csr_matrix(X, dtype=REAL), X_rel, 0
        )

    def _measure_score(self, prediction, y) -> Dict[str, float]:
        result: Dict[str, float] = OrderedDict()
        result["accuracy"] = float(
            (np.argmax(prediction, axis=1) == y).mean()
        )
        result["log_loss"] = float(
            -np.log(
                prediction[
                    np.arange(prediction.shape[0]), y.astype(np.int64)
                ]
                + 1e-15
            ).mean()
        )
        return result

    def _status_report(self, fm, hyper) -> str:
        log_str = "w0 = {:.2f}, ".format(float(fm.w0))
        if len(fm.cutpoints) == 1:
            log_str += "cutpoint = {} ".format(
                ["{:.3f}".format(c) for c in list(fm.cutpoints[0])]
            )
        return log_str

    def predict_proba(
        self,
        X: Optional[ArrayLike],
        X_rel: List[RelationBlock] = [],
        n_workers: Optional[int] = None,
        cutpoint_index: int = 0,
    ) -> np.ndarray:
        """Per-class probabilities averaged over the kept samples [N, K],
        on cutpoint group ``cutpoint_index``'s scale."""
        predictor = self._fetch_predictor()
        shape = check_data_consistency(X, X_rel)
        if X is None:
            X = sps.csr_matrix((shape, 0), dtype=REAL)
        else:
            X = sps.csr_matrix(X)
        return predictor.predict_parallel_oprobit(
            X, X_rel, n_workers or 1, cutpoint_index
        )

    def predict(
        self,
        X: Optional[ArrayLike],
        X_rel: List[RelationBlock] = [],
        cutpoint_index: int = 0,
    ) -> np.ndarray:
        """The argmax class (on cutpoint group ``cutpoint_index``'s
        scale)."""
        return self.predict_proba(
            X, X_rel=X_rel, cutpoint_index=cutpoint_index
        ).argmax(axis=1)

    @property
    def cutpoint_samples(self) -> Optional[np.ndarray]:
        """Samples of the first cutpoint group's cutpoints; ``None``
        before fit."""
        return self.get_cutpoint_samples(0)

    def get_cutpoint_samples(
        self, cutpoint_index: int = 0
    ) -> Optional[np.ndarray]:
        """Samples of cutpoint group ``cutpoint_index``'s cutpoints
        ([sample, n_class − 1]); ``None`` before fit."""
        if self.predictor_ is None:
            return None
        return np.asarray(
            [fm.cutpoints[cutpoint_index] for fm in self.predictor_.samples]
        )


# Reference aliases
MyFMRegressor = MyFMGibbsRegressor
MyFMClassifier = MyFMGibbsClassifier
