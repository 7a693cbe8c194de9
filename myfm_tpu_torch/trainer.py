"""Training loops driving the categorical and the joint Gibbs sweeps.

PyTorch counterpart of ``myfm_tpu/trainer.py`` (``run_mcmc_loop``,
``GibbsTrainer``, ``CategoricalGibbsTrainer``, ``LazyFMView``,
``callback_allows_async``, and ``_resolve_joint_tail`` in place of
``_resolve_joint_pallas_tail``):
runs ``n_iter`` sweeps, keeps the last ``n_kept_samples`` weight samples
on the host, records the hyperparameter trace every iteration, and
invokes the callback with early-stop support.

Kept samples are copied to the host as they are kept.  When the callback
allows it, the hyper trace stays on the device until the chain ends and
is copied then, so the loop does not wait on the device every sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .containers import FM, FMHyperParameters, LearningHistory
from .design_categorical import torch_dtype
from .ops.categorical import (
    categorical_sweep,
    draw_sweep_variates,
    init_categorical_state,
    make_y_tiles,
)
from .ops.forward import predict_score
from .ops.gibbs import (
    TASK_REGRESSION,
    GibbsConfig,
    GibbsState,
    draw_gibbs_variates,
    gibbs_sweep,
    init_state,
    require_joint,
)
from .predictor import Predictor


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class LazyFMView(FM):
    """FM view over device state; copies arrays to the host only on
    access."""

    def __init__(self, state: GibbsState):
        self._state = state
        self._w0 = None
        self._w = None
        self._V = None

    @property
    def w0(self):  # type: ignore[override]
        if self._w0 is None:
            self._w0 = float(self._state.w0)
        return self._w0

    @property
    def w(self):  # type: ignore[override]
        if self._w is None:
            self._w = _host(self._state.w)
        return self._w

    @property
    def V(self):  # type: ignore[override]
        if self._V is None:
            self._V = _host(self._state.V)
        return self._V

    @property
    def cutpoints(self):  # type: ignore[override]
        return []

    def materialize(self) -> FM:
        return FM(self.w0, self.w, self.V, self.cutpoints)


def _hyper_of(state: GibbsState) -> FMHyperParameters:
    """The state's hyperparameters, still as device tensors."""
    return FMHyperParameters(
        alpha=state.alpha,
        mu_w=state.mu_w,
        lambda_w=state.lambda_w,
        mu_V=state.mu_V,
        lambda_V=state.lambda_V,
    )


def _to_host(hyper: FMHyperParameters) -> FMHyperParameters:
    return FMHyperParameters(
        alpha=float(hyper.alpha),
        mu_w=_host(hyper.mu_w),
        lambda_w=_host(hyper.lambda_w),
        mu_V=_host(hyper.mu_V),
        lambda_V=_host(hyper.lambda_V),
    )


def callback_allows_async(callback) -> bool:
    """True when the trace may be harvested after the chain: no
    callback, or one tagged ``allow_async_trace`` (the progress-bar
    wrapper in base._fit).  User callbacks get host values every
    sweep."""
    return callback is None or bool(
        getattr(callback, "allow_async_trace", False)
    )


def run_mcmc_loop(
    trainer,
    n_iter: int,
    n_kept_samples: int,
    callback=None,
    core_of=lambda s: s,
) -> Tuple[Predictor, LearningHistory]:
    """Shared MCMC driver: runs the chain, keeps the last
    ``n_kept_samples`` weight samples, records the hyper trace and
    invokes the callback with early stop.

    ``trainer`` provides ``_initialize()``, ``_sweep_call(state)`` and
    the ``rank / n_features / cfg / dtype / device / engine_name``
    attributes; ``core_of`` maps its state to the GibbsState."""
    state = trainer._initialize()
    predictor = Predictor(
        trainer.rank, trainer.n_features, trainer.cfg.task,
        trainer.dtype, trainer.device,
    )
    history = LearningHistory(engine=trainer.engine_name)
    deferred = callback_allows_async(callback)
    for it in range(n_iter):
        state = trainer._sweep_call(state)
        core = core_of(state)
        view = LazyFMView(core)
        if it + n_kept_samples >= n_iter:
            predictor.samples.append(view.materialize())
        hyper = _hyper_of(core)
        if not deferred:
            hyper = _to_host(hyper)
        history.hypers.append(hyper)
        if callback is not None and callback(it, view, hyper, history):
            break
    if deferred:
        history.hypers = [_to_host(h) for h in history.hypers]
    return predictor, history


def _resolve_gram_fast_matmul(cfg: GibbsConfig) -> GibbsConfig:
    """Resolve gram_fast_matmul=None (auto) to IEEE arithmetic (False),
    in float32 and float64 alike.  The TPU package's reduced-precision
    Gram modes ("split", "bf16") are not ported yet."""
    if cfg.gram_fast_matmul is None:
        return dataclasses.replace(cfg, gram_fast_matmul=False)
    if cfg.gram_fast_matmul is not False:
        raise NotImplementedError(
            f"gram_fast_matmul={cfg.gram_fast_matmul!r} (split / bf16 "
            "Gram modes): later slice"
        )
    return cfg


# The TPU package's gate on its tail kernel (trainer.py
# _resolve_joint_pallas_tail): beyond D = 34 (rank 32) the plain loop.
JOINT_TAIL_MAX_D = 34


def _resolve_joint_tail(cfg: GibbsConfig, plan, rank: int) -> GibbsConfig:
    """Resolve ``joint_tail_kernel``:

    - None (auto): the CUDA kernel when the plan lives on a CUDA device
      and D = rank + 2 <= JOINT_TAIL_MAX_D; otherwise the plain loop;
    - True: the kernel; raises for a plan on the CPU;
    - False: the plain loop.

    Nothing self-checks and silently falls back: the card tests and
    chip_smoke.py hold the kernel against its plain version."""
    if cfg.joint_tail_kernel is None:
        use = (plan.device.type == "cuda"
               and rank + 2 <= JOINT_TAIL_MAX_D)
        return dataclasses.replace(cfg, joint_tail_kernel=use)
    if cfg.joint_tail_kernel is True and plan.device.type != "cuda":
        raise ValueError(
            "joint_tail_kernel=True launches a CUDA kernel but the plan is "
            f"on {plan.device}; use joint_tail_kernel=False (the plain "
            "loop) there."
        )
    return cfg


class GibbsTrainer:
    """Gibbs trainer on a compiled row-space design (design.DesignPlan).
    This port runs the merged joint engine; a config that resolves to
    the colored engine raises.  Runs on the plan's device; one
    ``torch.Generator`` seeded with ``random_seed`` drives the chain."""

    def __init__(
        self,
        plan,  # DesignPlan
        y: np.ndarray,
        cfg: GibbsConfig,
        rank: int,
        init_stdev: float,
        random_seed: int,
        dtype=np.float32,
    ):
        require_joint(cfg)
        self.plan = plan
        self.cfg = _resolve_joint_tail(cfg, plan, rank)
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed
        self.dtype = np.dtype(dtype)
        self.device = plan.device
        self._tdtype = torch_dtype(self.dtype)
        self.y = torch.as_tensor(
            np.asarray(y).astype(self.dtype), device=self.device
        )
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(random_seed)

    @property
    def n_features(self) -> int:
        return self.plan.n_features

    @property
    def engine_name(self) -> str:
        return "joint" if self.cfg.joint_rows else "colored"

    def _sweep_call(self, state: GibbsState) -> GibbsState:
        variates = draw_gibbs_variates(
            self.plan, self.cfg, self.rank, self.generator, self._tdtype,
            self.device,
        )
        return gibbs_sweep(self.plan, state, self.y, variates, self.cfg)

    def _initialize(self) -> GibbsState:
        state = init_state(
            self.plan, self.rank, self.init_stdev, self.generator,
            self.cfg, self._tdtype, self.device,
        )
        # e = score − y (the TPU package's init_e)
        e = predict_score(self.plan, state.w0, state.w, state.V) - self.y
        return dataclasses.replace(state, e=e)

    def run(
        self,
        n_iter: int,
        n_kept_samples: int,
        callback: Optional[
            Callable[[int, FM, FMHyperParameters, LearningHistory], bool]
        ] = None,
    ) -> Tuple[Predictor, LearningHistory]:
        return run_mcmc_loop(self, n_iter, n_kept_samples, callback)


class CategoricalGibbsTrainer:
    """Gibbs trainer on the entity-space fast path (all tables one-hot;
    see ops/categorical.py).  Runs on the plan's device; one
    ``torch.Generator`` seeded with ``random_seed`` drives the chain."""

    def __init__(
        self,
        plan,  # CategoricalPlan
        y: np.ndarray,
        cfg: GibbsConfig,
        rank: int,
        init_stdev: float,
        random_seed: int,
        dtype=np.float32,
    ):
        if cfg.task != TASK_REGRESSION:
            raise NotImplementedError(
                f"task {cfg.task!r} on the fast path (probit tasks): "
                "later slice"
            )
        self.plan = plan
        self.cfg = _resolve_gram_fast_matmul(cfg)
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed
        self.dtype = np.dtype(dtype)
        self.device = plan.group_index.device
        self._tdtype = torch_dtype(self.dtype)
        self.y = torch.as_tensor(
            np.asarray(y).astype(self.dtype), device=self.device
        )
        # per-table tile-order copies of y
        self.y_tiles = make_y_tiles(plan, self.y)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(random_seed)

    @property
    def n_features(self) -> int:
        return self.plan.n_features

    @property
    def engine_name(self) -> str:
        return "fastpath"

    def _sweep_call(self, state):
        variates = draw_sweep_variates(
            self.plan, self.cfg, self.rank, self.generator, self._tdtype,
            self.device,
        )
        return categorical_sweep(
            self.plan, state, self.y, self.y_tiles, variates, self.cfg
        )

    def _initialize(self):
        core = init_state(
            self.plan, self.rank, self.init_stdev, self.generator,
            self.cfg, self._tdtype, self.device,
        )
        return init_categorical_state(self.plan, core, self.y, self.cfg)

    def run(
        self,
        n_iter: int,
        n_kept_samples: int,
        callback: Optional[
            Callable[[int, FM, FMHyperParameters, LearningHistory], bool]
        ] = None,
    ) -> Tuple[Predictor, LearningHistory]:
        return run_mcmc_loop(
            self, n_iter, n_kept_samples, callback,
            core_of=lambda s: s.core,
        )
