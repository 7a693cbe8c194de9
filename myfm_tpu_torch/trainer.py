"""Training loops driving the categorical, joint and colored Gibbs sweeps.

PyTorch counterpart of ``myfm_tpu/trainer.py`` (``run_mcmc_loop``,
``GibbsTrainer``, ``CategoricalGibbsTrainer``, ``LazyFMView``,
``callback_allows_async``, and ``_resolve_joint_tail`` in place of
``_resolve_joint_pallas_tail``):
runs ``n_iter`` sweeps, keeps the last ``n_kept_samples`` weight samples
(with their cutpoints, for the ordered task) on the host, records the
hyperparameter trace (and the MH accept counts) every iteration, and
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
from .ops.gram import gram_fast_selfcheck, gram_mode
from .ops.gibbs import (
    TASK_ORDERED,
    GibbsConfig,
    GibbsState,
    check_task,
    draw_gibbs_variates,
    gibbs_sweep,
    init_state,
)
from .ops.oprobit import initialize_oprobit_core
from .ops.special import uniform_open
from .predictor import Predictor


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _split_cutpoints(cat: np.ndarray, groups) -> list:
    """The concatenated cutpoint vector split into one vector per
    cutpoint group, as the FM container holds them."""
    groups = groups or (cat.shape[0] + 1,)
    out, off = [], 0
    for K in groups:
        out.append(cat[off : off + K - 1])
        off += K - 1
    return out


class LazyFMView(FM):
    """FM view over device state; copies arrays to the host only on
    access.  ``cut_groups`` (the class count per cutpoint group) splits
    the concatenated cutpoints."""

    def __init__(self, state: GibbsState, cut_groups=()):
        self._state = state
        self._cut_groups = cut_groups
        self._w0 = None
        self._w = None
        self._V = None
        self._cutpoints = None

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
        if self._cutpoints is None:
            cat = self._state.cutpoints
            self._cutpoints = (
                [] if cat is None
                else _split_cutpoints(_host(cat), self._cut_groups)
            )
        return self._cutpoints

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
    history = LearningHistory(
        engine=trainer.engine_name,
        gram_fast_matmul=trainer.cfg.gram_fast_matmul)
    deferred = callback_allows_async(callback)
    ordered = trainer.cfg.task == TASK_ORDERED
    cut_groups = trainer.cfg.cutpoint_group_classes
    for it in range(n_iter):
        state = trainer._sweep_call(state)
        core = core_of(state)
        view = LazyFMView(core, cut_groups)
        if it + n_kept_samples >= n_iter:
            predictor.samples.append(view.materialize())
        hyper = _hyper_of(core)
        if not deferred:
            hyper = _to_host(hyper)
        history.hypers.append(hyper)
        if ordered:
            # cumulative accept count per cutpoint group, every sweep
            acc = core.n_mh_accept.clone()
            history.n_mh_accept_trace.append(
                acc if deferred else _host(acc).tolist())
        if callback is not None and callback(it, view, hyper, history):
            break
    if deferred:
        history.hypers = [_to_host(h) for h in history.hypers]
        history.n_mh_accept_trace = [
            _host(a).tolist() for a in history.n_mh_accept_trace]
    if ordered:
        history.n_mh_accept = [
            int(c) for c in _host(core_of(state).n_mh_accept)
        ]
    return predictor, history


def _resolve_gram_fast_matmul(cfg, dtype, device, rank=None):
    """Resolve the fast path's Gram mode ``cfg.gram_fast_matmul`` (the
    TPU package's ``_resolve_gram_fast_matmul``, with a CUDA device in
    place of its TPU backend).  None (auto), float32 on a CUDA device,
    after the per-mode self-checks on that card
    (ops/gram.gram_fast_selfcheck):

    - Gibbs at rank >= 64 (``rank`` given): "bf16", the single-pass
      product (~4e-3 relative, orders below a Gibbs draw's noise);
    - otherwise "split", the 3-pass bf16 split (~1.5e-5 relative), also
      for the deterministic VI paths (``rank`` None);
    - a mode whose self-check fails is not taken (False: IEEE).

    Everything else (the CPU, float64) resolves to False.  An explicit
    value is kept, True as "split"; a mode other than False with float64
    on CUDA raises ValueError: there is no fp64 tensor-core path, and
    IEEE in its place would hide that."""
    mode = cfg.gram_fast_matmul
    cuda = torch.device(device).type == "cuda"
    f32 = np.dtype(dtype) == np.float32
    if mode is None:
        use = False
        if f32 and cuda:
            if rank is not None and rank >= 64 and gram_fast_selfcheck(
                    "bf16", device):
                use = "bf16"
            elif gram_fast_selfcheck("split", device):
                use = "split"
        return dataclasses.replace(cfg, gram_fast_matmul=use)
    if mode is not False:
        mode = gram_mode(mode)
        if cuda and not f32 and mode != "highest":
            raise ValueError(
                f"gram_fast_matmul={cfg.gram_fast_matmul!r} needs float32 "
                f"on a CUDA device, got {np.dtype(dtype).name}")
    return dataclasses.replace(cfg, gram_fast_matmul=mode)


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


def _target(y, cfg: GibbsConfig, dtype, device) -> torch.Tensor:
    """The chain's target on the device: the encoded integer classes for
    the ordered task, else y in the chain's dtype (±1 for
    classification).  Validates the task."""
    check_task(cfg)
    if cfg.task == TASK_ORDERED:
        return torch.as_tensor(np.asarray(y, dtype=np.int64), device=device)
    return torch.as_tensor(np.asarray(y).astype(dtype), device=device)


def _init_uniforms(trainer) -> torch.Tensor:
    """The ordered task's initial latent uniforms, from the chain's
    generator after the weights' own draws."""
    return uniform_open((trainer.y.shape[0],), trainer.generator,
                        trainer._tdtype, trainer.device)


class GibbsTrainer:
    """Gibbs trainer on a compiled row-space design (design.DesignPlan):
    the joint engine (``cfg.joint_rows``: merged (w, V) rows, or factor
    rows alone without the linear terms) or the colored engine.  Runs on
    the plan's device; one ``torch.Generator`` seeded with
    ``random_seed`` drives the chain."""

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
        self.plan = plan
        # as in the TPU package, only the joint engine resolves its tail
        # (which sweep_V_joint, without linear terms, never launches)
        self.cfg = (_resolve_joint_tail(cfg, plan, rank) if cfg.joint_rows
                    else cfg)
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed
        self.dtype = np.dtype(dtype)
        self.device = plan.device
        self._tdtype = torch_dtype(self.dtype)
        self.y = _target(y, cfg, self.dtype, self.device)
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
        score = predict_score(self.plan, state.w0, state.w, state.V)
        if self.cfg.task == TASK_ORDERED:
            # Newton MAP cutpoints, then the latent draw
            state, _ = initialize_oprobit_core(
                score, state, self.y, self.cfg, _init_uniforms(self))
            return state
        # e = score − y for regression and ±1 classification
        return dataclasses.replace(state, e=score - self.y)

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
    """Gibbs trainer on the entity-space fast path (one-hot and
    entity+attribute tables; see ops/categorical.py).  Runs on the
    plan's device; one ``torch.Generator`` seeded with ``random_seed``
    drives the chain.  A plan with entity+attribute tables resolves
    ``joint_tail_kernel`` as the joint engine does: its color scans run
    through kernel 4 where that engine's tail would."""

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
        self.plan = plan
        self.cfg = _resolve_gram_fast_matmul(cfg, dtype, plan.device, rank)
        if plan.has_side:
            self.cfg = _resolve_joint_tail(self.cfg, plan, rank)
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed
        self.dtype = np.dtype(dtype)
        self.device = plan.device
        self._tdtype = torch_dtype(self.dtype)
        self.y = _target(y, cfg, self.dtype, self.device)
        # per-table tile-order copies of y (the regression target; the
        # probit tasks gather their latent τ every sweep instead)
        self.y_tiles = make_y_tiles(plan, self.y.to(self._tdtype))
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
        u = (_init_uniforms(self) if self.cfg.task == TASK_ORDERED
             else None)
        return init_categorical_state(self.plan, core, self.y, self.cfg, u)

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
