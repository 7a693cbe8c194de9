"""Variational training loops.

PyTorch counterpart of ``myfm_tpu/vi_trainer.py``: ``CategoricalVITrainer``
(the entity-space fast path), ``VariationalTrainer`` (the row-space
colored sweep), ``run_cavi_loop`` (the reference's ``_cavi_loop``),
``_fetch_vfm``, ``_fetch_hyper`` and the lazy views.  The loop runs
``n_iter`` deterministic CAVI sweeps, records the ELBO of every sweep,
and invokes the callback with early-stop support.
When the callback allows it (``trainer.callback_allows_async``) the ELBO
trace stays on the device until the chain ends and is copied then, so
the loop does not wait on the device every sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .containers import (
    VariationalFM,
    VariationalFMHyperParameters,
    VariationalLearningHistory,
    fm_predict_score_numpy,
)
from .design_categorical import torch_dtype
from .ops.categorical import make_y_tiles
from .ops.categorical_vi import (
    categorical_vi_sweep,
    init_categorical_vi_state,
)
from .ops.variational import (
    VariationalConfig,
    VIState,
    vi_init_state,
    vi_sweep,
    vi_update_e_and_var,
)
from .predictor import VariationalPredictor
from .trainer import _host, _resolve_gram_fast_matmul, callback_allows_async

_HYPER_FIELDS = (
    "alpha", "alpha_rate", "mu_w", "mu_w_var", "lambda_w", "lambda_w_rate",
    "mu_V", "mu_V_var", "lambda_V", "lambda_V_rate",
)
_SCALARS = ("w0", "w0_var", "alpha", "alpha_rate")


def _fetch_vfm(state: VIState) -> VariationalFM:
    return VariationalFM(
        w0=float(state.w0), w=_host(state.w), V=_host(state.V),
        w0_var=float(state.w0_var), w_var=_host(state.w_var),
        V_var=_host(state.V_var),
    )


def _fetch_hyper(state: VIState) -> VariationalFMHyperParameters:
    return VariationalFMHyperParameters(**{
        f: float(getattr(state, f)) if f in _SCALARS
        else _host(getattr(state, f))
        for f in _HYPER_FIELDS
    })


class _LazyView:
    """Host values of a VIState's fields, copied on first access."""

    _FIELDS: Tuple[str, ...] = ()

    def __init__(self, state: VIState):
        object.__setattr__(self, "_state", state)
        object.__setattr__(self, "_vals", {})

    def __getattr__(self, name):
        if name not in self._FIELDS:
            raise AttributeError(name)
        if name not in self._vals:
            v = getattr(self._state, name)
            self._vals[name] = float(v) if name in _SCALARS else _host(v)
        return self._vals[name]


class LazyVFMView(_LazyView):
    """VariationalFM view over the device state of one sweep."""

    _FIELDS = ("w0", "w0_var", "w", "w_var", "V", "V_var")

    @property
    def n_factors(self) -> int:
        return int(self._state.V.shape[1])

    def predict_score(self, X, X_rel=()):
        return fm_predict_score_numpy(self.w0, self.w, self.V, X, X_rel)


class LazyVHyperView(_LazyView):
    """VariationalFMHyperParameters view over the device state."""

    _FIELDS = _HYPER_FIELDS


class CategoricalVITrainer:
    """CAVI trainer on the entity-space fast path (ops/categorical_vi.py).
    Runs on the plan's device; one ``torch.Generator`` seeded with
    ``random_seed`` draws the initial weights."""

    def __init__(
        self,
        plan,  # CategoricalPlan, tiled for the VI Gram's D = 3R+2
        y: np.ndarray,
        cfg: VariationalConfig,
        rank: int,
        init_stdev: float,
        random_seed: int,
        dtype=np.float32,
    ):
        self.plan = plan
        self.cfg = _resolve_gram_fast_matmul(cfg, dtype,
                                             plan.group_index.device)
        self.rank = rank
        self.init_stdev = init_stdev
        self.random_seed = random_seed
        self.dtype = np.dtype(dtype)
        self.device = plan.group_index.device
        self._tdtype = torch_dtype(self.dtype)
        self.y = torch.as_tensor(
            np.asarray(y).astype(self.dtype), device=self.device
        )
        self.y_tiles = make_y_tiles(plan, self.y)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(random_seed)

    def _initialize(self):
        core = vi_init_state(
            self.plan, self.rank, self.init_stdev, self.generator, self.cfg,
            self._tdtype, self.device,
        )
        return init_categorical_vi_state(self.plan, core, self.y, self.cfg)

    def _sweep(self, state):
        return categorical_vi_sweep(
            self.plan, state, self.y, self.y_tiles, self.cfg
        )

    def run(
        self,
        n_iter: int,
        callback: Optional[Callable] = None,
    ) -> Tuple[VariationalPredictor, VariationalLearningHistory]:
        return run_cavi_loop(self, n_iter, callback)


class VariationalTrainer:
    """CAVI trainer on the row-space colored sweep (ops/variational.py
    ``vi_sweep``) over a ``DesignPlan``, for designs the fast path does
    not take.  Runs on the plan's device; one ``torch.Generator`` seeded
    with ``random_seed`` draws the initial weights.  The TPU package's
    staged dispatch mode (one program per factor on large designs) is
    the same sequence of updates that this eager sweep runs anyway."""

    def __init__(
        self,
        plan,  # DesignPlan
        y: np.ndarray,
        cfg: VariationalConfig,
        rank: int,
        init_stdev: float,
        random_seed: int,
        dtype=np.float32,
    ):
        self.plan = plan
        self.cfg = cfg
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

    def _initialize(self) -> VIState:
        """Reference initialize_e (variational.hpp:234-241): the full
        mean/variance forward, then e = score − y for every task."""
        state = vi_init_state(
            self.plan, self.rank, self.init_stdev, self.generator, self.cfg,
            self._tdtype, self.device,
        )
        score, e_var_sum = vi_update_e_and_var(
            self.plan, state.w0, state.w0_var, state.w, state.w_var,
            state.V, state.V_var,
        )
        return dataclasses.replace(state, e=score - self.y,
                                   e_var_sum=e_var_sum)

    def _sweep(self, state: VIState) -> VIState:
        return vi_sweep(self.plan, state, self.y, self.cfg)

    def run(
        self,
        n_iter: int,
        callback: Optional[Callable] = None,
    ) -> Tuple[VariationalPredictor, VariationalLearningHistory]:
        return run_cavi_loop(self, n_iter, callback, engine="colored",
                             core_of=lambda s: s)


def run_cavi_loop(
    trainer,
    n_iter: int,
    callback: Optional[Callable] = None,
    engine: str = "fastpath",
    core_of: Callable = lambda s: s.core,
) -> Tuple[VariationalPredictor, VariationalLearningHistory]:
    """The CAVI loop: deterministic sweeps, the ELBO trace and the
    early-stop callback.  ``trainer`` provides ``_initialize()``,
    ``_sweep(state)`` and the ``plan / cfg / rank / dtype / device``
    attributes; ``core_of`` maps its state to the ``VIState`` and
    ``engine`` names it in the history.  A user callback gets host values
    every sweep; otherwise the ELBOs stay device scalars until the chain
    ends."""
    state = trainer._initialize()
    history = VariationalLearningHistory(
        hypers=None, elbos=[], engine=engine,
        gram_fast_matmul=trainer.cfg.gram_fast_matmul)
    deferred = callback_allows_async(callback)
    for it in range(n_iter):
        state = trainer._sweep(state)
        core = core_of(state)
        if deferred:
            history.elbos.append(core.elbo)
            if callback is not None and callback(
                it, LazyVFMView(core), LazyVHyperView(core), history
            ):
                break
        else:
            history.elbos.append(float(core.elbo))
            if callback is not None and callback(
                it, _fetch_vfm(core), _fetch_hyper(core), history
            ):
                break
    if deferred and history.elbos:
        history.elbos = torch.stack(history.elbos).double().cpu().tolist()
    core = core_of(state)
    history.hypers = _fetch_hyper(core)
    predictor = VariationalPredictor(
        trainer.rank, trainer.plan.n_features, trainer.cfg.task,
        trainer.dtype, trainer.device,
    )
    predictor.samples.append(_fetch_vfm(core))
    return predictor, history
