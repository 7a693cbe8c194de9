"""Estimator base classes: the sklearn-style template-method API.

PyTorch counterpart of ``myfm_tpu/base.py``: the same constructor
surface, ``_fit`` validation/grouping/callback plumbing and the
Regressor and Classifier mixins.  Two differences: the estimator runs on an
explicit ``torch.device``, and multi-device training runs one process per
device over ``torch.distributed`` (``mesh`` is a process group, the
port's counterpart of a ``jax.sharding.Mesh``; parallel/).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections import OrderedDict
from typing import (
    Callable,
    Dict,
    List,
    Optional,
    Tuple,
    Union,
)

import numpy as np
import torch
from scipy import sparse as sps
from scipy.special import ndtr

try:
    from tqdm import tqdm
except Exception:  # pragma: no cover

    class tqdm:  # type: ignore
        def __init__(self, total=None, **kwargs):
            self.total = total

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def update(self, n=1):
            pass

        def set_description(self, s):
            pass


from .containers import FM, FMHyperParameters, LearningHistory
from .relational import RelationBlock
from .tracing import span

REAL = np.float64

ArrayLike = Union[np.ndarray, sps.spmatrix]

TASK_REGRESSION = "regression"
TASK_CLASSIFICATION = "classification"
TASK_ORDERED = "ordered"


def std_cdf(x: np.ndarray) -> np.ndarray:
    return ndtr(np.asarray(x, dtype=np.float64))


def check_data_consistency(
    X: Optional[ArrayLike], X_rel: List[RelationBlock]
) -> int:
    """Consistent row counts across X and X_rel; X may be None."""
    if X_rel:
        shape_rel_all = {rel.mapper_size for rel in X_rel}
        if len(shape_rel_all) > 1:
            raise ValueError("Inconsistent case size for X_rel.")
        shape = list(shape_rel_all)[0]
        if X is not None and X.shape[0] != shape:
            raise ValueError("X and X_rel have different shape.")
        return int(shape)
    if X is None:
        raise ValueError("At least X or X_rel must be provided.")
    return int(X.shape[0])


class ConfigBuilder:
    """Fluent learning-config builder (same surface as
    ``myfm_tpu.ConfigBuilder``)."""

    def __init__(self) -> None:
        self.alpha_0 = 1.0
        self.beta_0 = 1.0
        self.gamma_0 = 1.0
        self.mu_0 = 0.0
        self.reg_0 = 1.0
        self.fit_w0 = True
        self.fit_linear = True
        self.n_iter = 100
        self.n_kept_samples = 10
        self.task_type = TASK_REGRESSION
        self.nu_oprobit = 5
        self.cutpoint_scale = 10.0
        self.group_index: Optional[List[int]] = None
        self.cutpoint_groups: List[Tuple[int, List[int]]] = []

    def _setter(name):  # noqa: N805
        def set_(self, value):
            setattr(self, name, value)
            return self

        return set_

    set_alpha_0 = _setter("alpha_0")
    set_beta_0 = _setter("beta_0")
    set_gamma_0 = _setter("gamma_0")
    set_mu_0 = _setter("mu_0")
    set_reg_0 = _setter("reg_0")
    set_fit_w0 = _setter("fit_w0")
    set_fit_linear = _setter("fit_linear")
    set_n_iter = _setter("n_iter")
    set_n_kept_samples = _setter("n_kept_samples")
    set_task_type = _setter("task_type")
    set_nu_oprobit = _setter("nu_oprobit")
    set_cutpoint_scale = _setter("cutpoint_scale")
    set_cutpoint_groups = _setter("cutpoint_groups")
    del _setter

    def set_group_index(self, group_index) -> "ConfigBuilder":
        self.group_index = list(group_index)
        return self

    def set_identical_groups(self, dim: int) -> "ConfigBuilder":
        self.group_index = [0] * dim
        return self


class MyFMBase(ABC):
    r"""Bayesian Factorization Machine base."""

    def __init__(
        self,
        rank: int,
        init_stdev: float = 0.1,
        random_seed: int = 42,
        alpha_0: float = 1.0,
        beta_0: float = 1.0,
        gamma_0: float = 1.0,
        mu_0: float = 0.0,
        reg_0: float = 1.0,
        fit_w0: bool = True,
        fit_linear: bool = True,
        dtype=np.float32,
        sweep_strategy: str = "auto",
        max_unrolled_colors: int = 16,
        n_devices: Optional[int] = None,
        mesh=None,
        device: Union[str, torch.device] = "cuda",
    ):
        """Set up the sampler configuration.

        The parameters up to ``mesh`` mean what they mean in
        ``myfm_tpu.MyFMBase`` (priors: α, λ ~ Gamma(α₀/2, β₀/2);
        μ ~ N(μ₀, 1/γ₀); w0 ~ N(0, 1/reg₀); ``sweep_strategy`` picks
        the engine with the same "auto" rules).

        device:
            Where the chain's tensors live and the sweep runs.  On a
            CUDA device the Gram statistics go through the hand-written
            kernel (ops/gram.py); on the CPU through its plain PyTorch
            version.
        n_devices / mesh:
            Multi-device training: each rank of a ``torch.distributed``
            group runs the same fit on the whole design and keeps its
            own contiguous rows; statistics are summed with collectives
            where the TPU package ``psum``s, so the sharded chain is the
            one-process chain up to the order of those sums (parallel/).
            ``mesh`` is the process group (or a
            ``parallel.collectives.Axis``); ``n_devices=N`` uses the
            default group, which must be initialised with N ranks.  On a
            sharded fit a ``device`` of plain "cuda" means
            ``cuda:$LOCAL_RANK``.
        """
        if sweep_strategy not in ("auto", "serial", "colored",
                                  "categorical", "joint"):
            raise ValueError(
                "sweep_strategy must be one of 'auto', 'serial', "
                "'colored', 'categorical', 'joint'; got "
                f"{sweep_strategy!r}."
            )
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed
        self.alpha_0 = alpha_0
        self.beta_0 = beta_0
        self.gamma_0 = gamma_0
        self.mu_0 = mu_0
        self.reg_0 = reg_0
        self.fit_w0 = fit_w0
        self.fit_linear = fit_linear
        self.dtype = np.dtype(dtype)
        self.sweep_strategy = sweep_strategy
        self.max_unrolled_colors = max_unrolled_colors
        self.n_devices = n_devices
        self.mesh = mesh
        self.device = torch.device(device)

        self.predictor_ = None
        self.history_ = None
        self.n_groups_: Optional[int] = None

    def __str__(self) -> str:
        return (
            "{class_name}(init_stdev={init_stdev}, alpha_0={alpha_0}, "
            "beta_0={beta_0}, gamma_0={gamma_0}, mu_0={mu_0}, "
            "reg_0={reg_0})"
        ).format(
            class_name=self.__class__.__name__,
            init_stdev=self.init_stdev,
            alpha_0=self.alpha_0,
            beta_0=self.beta_0,
            gamma_0=self.gamma_0,
            mu_0=self.mu_0,
            reg_0=self.reg_0,
        )

    # -- abstract hooks ------------------------------------------------

    @property
    @abstractmethod
    def _task_type(self) -> str:
        raise NotImplementedError

    @abstractmethod
    def _train_core(
        self,
        rank,
        init_stdev,
        X,
        X_rel,
        y,
        random_seed,
        config: ConfigBuilder,
        callback,
    ):
        raise NotImplementedError

    @abstractmethod
    def _status_report(self, fm: FM, hyper: FMHyperParameters) -> str:
        raise NotImplementedError

    @abstractmethod
    def _prepare_prediction_for_test(self, fm, X, X_rel) -> np.ndarray:
        raise NotImplementedError

    @abstractmethod
    def _measure_score(self, prediction, y) -> Dict[str, float]:
        raise NotImplementedError

    def _process_y(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y).astype(np.float64)

    @property
    def _sharded(self) -> bool:
        return self.mesh is not None or (self.n_devices or 1) > 1

    def _build_mesh(self):
        """The data axis of a sharded fit (parallel/collectives.Axis):
        over ``mesh`` when given, else over the default process group,
        which must be initialised with ``n_devices`` ranks (the TPU
        package raises the same ValueError when fewer devices are
        visible)."""
        import torch.distributed as dist

        from .parallel.collectives import Axis

        if self.mesh is not None:
            return self.mesh if isinstance(self.mesh, Axis) else Axis(
                self.mesh)
        world = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 0)
        if world != self.n_devices:
            raise ValueError(
                f"n_devices={self.n_devices} requested but the default "
                f"torch.distributed group has {world} ranks (initialise "
                "it with one process per device, e.g. under torchrun).")
        return Axis(None)

    def _fit_device(self) -> torch.device:
        """The device of this rank's chain: plain "cuda" on a sharded fit
        is ``cuda:$LOCAL_RANK``."""
        import os

        if (self._sharded and self.device.type == "cuda"
                and self.device.index is None):
            return torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                           0)))
        return self.device

    # -- the fit template ----------------------------------------------

    @staticmethod
    def _coerce_design(X, X_rel, y, what: str):
        """Validate (X, X_rel, y) row counts and return X as csr
        (an empty [n, 0] matrix when the design is blocks-only)."""
        n_rows = check_data_consistency(X, X_rel)
        X = (
            sps.csr_matrix((n_rows, 0), dtype=REAL)
            if X is None
            else sps.csr_matrix(X)
        )
        if y.shape[0] != n_rows:
            raise ValueError(
                f"{what} design has {n_rows} rows but its target has "
                f"{y.shape[0]} entries."
            )
        return X

    def _resolve_iteration_counts(self, n_iter, n_kept_samples):
        """Typed n_iter/n_kept validation; the default keeps all but the
        first 5 draws, floored at 5."""
        if n_iter <= 0:
            raise ValueError(f"n_iter must be positive; got {n_iter}.")
        if n_kept_samples is None:
            return n_iter, min(max(n_iter - 5, 5), n_iter)
        if n_kept_samples <= 0:
            raise ValueError(
                f"n_kept_samples must be positive; got {n_kept_samples}."
            )
        if n_kept_samples > n_iter:
            raise ValueError(
                f"n_kept_samples ({n_kept_samples}) cannot exceed "
                f"n_iter ({n_iter})."
            )
        return n_iter, n_kept_samples

    def _resolve_grouping(self, builder, n_features, grouping,
                          group_shapes):
        """Feature→hyper-group map: explicit per-feature ids, contiguous
        run lengths (group_shapes), or one shared group."""
        if grouping is None and group_shapes is not None:
            grouping = np.repeat(
                np.arange(len(group_shapes)), group_shapes
            ).tolist()
        if grouping is None:
            self.n_groups_ = 1
            builder.set_identical_groups(n_features)
            return
        if len(grouping) != n_features:
            raise ValueError(
                f"grouping has {len(grouping)} entries but the "
                f"design has {n_features} features."
            )
        self.n_groups_ = len(set(grouping))
        builder.set_group_index(grouping)

    def _fit(
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
        callback_default_freq: int = 10,
    ) -> None:
        builder = config_builder or ConfigBuilder()

        y = np.asarray(y)
        X = self._coerce_design(X, X_rel, y, "training")
        n_features = X.shape[1] + sum(b.feature_size for b in X_rel)

        n_iter, n_kept_samples = self._resolve_iteration_counts(
            n_iter, n_kept_samples
        )
        self._resolve_grouping(builder, n_features, grouping,
                               group_shapes)

        # estimator ctor priors flow into the config verbatim
        for prior in ("alpha_0", "beta_0", "gamma_0", "mu_0", "reg_0",
                      "fit_w0", "fit_linear"):
            getattr(builder, f"set_{prior}")(getattr(self, prior))
        builder.set_n_iter(n_iter).set_n_kept_samples(n_kept_samples)
        builder.set_task_type(self._task_type)

        # optional held-out set scored by the default callback
        have_test_design = X_test is not None or bool(X_rel_test)
        if have_test_design != (y_test is not None):
            raise RuntimeError(
                "Must specify both (X_test or X_rel_test) and y_test."
            )
        if have_test_design:
            y_test = np.asarray(y_test)
            X_test = self._coerce_design(
                X_test, X_rel_test, y_test, "test"
            )

        def default_callback(i, fm, hyper, history):
            if i % callback_default_freq:
                return False, None
            report = self._status_report(fm, hyper)
            if have_test_design:
                scores = self._measure_score(
                    self._prepare_prediction_for_test(
                        fm, X_test, X_rel_test
                    ),
                    y_test,
                )
                report += "".join(
                    f" {name}_this: {value:.2f}"
                    for name, value in scores.items()
                )
            return False, report

        user_callback = callback or default_callback

        # disable=None: tqdm renders on a TTY and stays silent when
        # stdout/stderr is captured
        with tqdm(total=n_iter, disable=None) as progress:

            def on_iteration(i, fm, hyper, history) -> bool:
                should_stop, message = user_callback(
                    i, fm, hyper, history
                )
                if message is not None:
                    progress.set_description(message)
                progress.update(1)
                return should_stop

            # the default callback reads host values only every
            # callback_default_freq sweeps, so the trainer may keep the
            # hyper trace on the device until the chain ends
            # (trainer.callback_allows_async); a user callback gets
            # host values every sweep unless it opts in through a
            # truthy ``allow_async_trace`` attribute
            on_iteration.allow_async_trace = callback is None or bool(
                getattr(callback, "allow_async_trace", False)
            )

            with span("myfm.fit"):
                self.predictor_, self.history_ = self._train_core(
                    self.rank,
                    self.init_stdev,
                    X,
                    X_rel,
                    self._process_y(y),
                    self.random_seed,
                    builder,
                    on_iteration,
                )

    def _fetch_predictor(self):
        if self.predictor_ is None:
            raise RuntimeError("Predictor called before fit.")
        return self.predictor_


class RegressorMixin:
    @property
    def _task_type(self) -> str:
        return TASK_REGRESSION

    def _prepare_prediction_for_test(self, fm, X, X_rel):
        return fm.predict_score(X, X_rel)

    def _status_report(self, fm, hyper) -> str:
        return "alpha = {:.2f} w0 = {:.2f} ".format(
            float(hyper.alpha), float(fm.w0)
        )

    def _measure_score(self, prediction, y) -> Dict[str, float]:
        result = OrderedDict()
        result["rmse"] = float(((y - prediction) ** 2).mean() ** 0.5)
        result["mae"] = float(np.abs(y - prediction).mean())
        return result


class ClassifierMixin:
    """Binary probit classification: y ∈ {0, 1} is fitted as ±1, and
    the held-out scores are the log-loss, the accuracy and the AUC of
    Φ(score)."""

    @property
    def _task_type(self) -> str:
        return TASK_CLASSIFICATION

    def _prepare_prediction_for_test(self, fm, X, X_rel):
        return std_cdf(fm.predict_score(X, X_rel))

    def _process_y(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y).astype(np.float64) * 2 - 1

    def _measure_score(self, prediction, y) -> Dict[str, float]:
        result = OrderedDict()
        lp = np.log(prediction + 1e-15)
        l1mp = np.log(1 - prediction + 1e-15)
        gt = np.asarray(y) > 0
        result["ll"] = float(
            (-lp.dot(gt) - l1mp.dot(~gt)) / max(1, prediction.shape[0])
        )
        result["accuracy"] = float(np.mean((prediction >= 0.5) == gt))
        result["auc"] = roc_auc(gt, prediction)
        return result

    def _status_report(self, fm, hyper) -> str:
        return "w0 = {:.2f} ".format(float(fm.w0))


def roc_auc(positive: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve: the chance that a random positive
    scores above a random negative (ties count half), from the ranks."""
    positive = np.asarray(positive, dtype=bool)
    n_pos = int(positive.sum())
    n_neg = positive.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    from scipy.stats import rankdata

    ranks = rankdata(score)
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))
