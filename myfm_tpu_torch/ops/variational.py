"""Coordinate-ascent variational inference (CAVI): config, state, and the
hyperparameter updates.

PyTorch counterpart of the parts of ``myfm_tpu/ops/variational.py`` that
the entity-space VI fast path (ops/categorical_vi.py) uses:
``VariationalConfig``, ``VIState``, ``vi_update_lambda``,
``vi_update_mu``, ``_safe_log`` and ``vi_init_state``.  Every update is a
posterior-mean assignment with variance bookkeeping (reference
variational.hpp:248-318).  The row-space / colored VI sweep is not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .gibbs import TASK_REGRESSION, _segment_sum, std_normal


@dataclasses.dataclass(frozen=True)
class VariationalConfig:
    """Static CAVI configuration (fields as in
    ``myfm_tpu.ops.variational.VariationalConfig``; the multi-device knobs
    are not part of this port yet)."""

    task: str = TASK_REGRESSION
    alpha_0: float = 1.0
    beta_0: float = 1.0
    gamma_0: float = 1.0
    mu_0: float = 0.0
    reg_0: float = 1.0
    fit_w0: bool = True
    fit_linear: bool = True
    # Gram arithmetic mode.  None = auto, which resolves to IEEE fp32
    # (False) in this port (trainer._resolve_gram_fast_matmul); the
    # split / bf16 modes of the TPU package are not ported yet.
    gram_fast_matmul: Optional[object] = None


@dataclasses.dataclass
class VIState:
    w0: torch.Tensor
    w0_var: torch.Tensor
    w: torch.Tensor  # [F]
    w_var: torch.Tensor  # [F]
    V: torch.Tensor  # [F, R]
    V_var: torch.Tensor  # [F, R]
    e: torch.Tensor  # [N] mean residual
    e_var_sum: torch.Tensor  # scalar: Σ_j Var(score_j)
    alpha: torch.Tensor
    alpha_rate: torch.Tensor
    mu_w: torch.Tensor  # [G]
    mu_w_var: torch.Tensor  # [G]
    lambda_w: torch.Tensor  # [G]
    lambda_w_rate: torch.Tensor  # [G]
    mu_V: torch.Tensor  # [G, R]
    mu_V_var: torch.Tensor
    lambda_V: torch.Tensor
    lambda_V_rate: torch.Tensor
    elbo: torch.Tensor


def vi_update_lambda(weight, weight_var, mu, mu_var, group_index,
                     group_counts, cfg):
    """λ̂ = (α₀+n_g) / (β₀ + Σ_g[dev² + Var w] + n_g Var μ); rate = β/2."""
    n_groups = mu.shape[0]
    dev2 = (weight - mu[group_index]) ** 2 + weight_var
    ssq = _segment_sum(dev2, group_index, n_groups)
    counts = group_counts
    if weight.ndim == 2:
        counts = counts[:, None]
    mu_var_term = mu_var * counts
    shape = cfg.alpha_0 + counts
    beta = cfg.beta_0 + ssq + mu_var_term
    return shape / beta, beta / 2.0


def vi_update_mu(weight, lam, group_index, group_counts, cfg):
    """μ̂ = λ(γ₀μ₀ + Σ_g w) / λ(γ₀ + n_g); variance 1 / λ(γ₀ + n_g)."""
    n_groups = lam.shape[0]
    s = _segment_sum(weight, group_index, n_groups)
    counts = group_counts
    if weight.ndim == 2:
        counts = counts[:, None]
    quad = lam * (cfg.gamma_0 + counts)
    lin = lam * (cfg.gamma_0 * cfg.mu_0 + s)
    return lin / quad, 1.0 / quad


def _safe_log(x):
    return torch.where(x > 0, torch.log(torch.clamp(x, min=1e-300)),
                       torch.zeros_like(x))


def vi_init_state(plan, rank: int, init_stdev: float,
                  generator: torch.Generator, cfg: VariationalConfig,
                  dtype: torch.dtype, device) -> VIState:
    """Reference VariationalFM::initialize_weight (variational.hpp:70-89)
    and initialize_hyper (variational.hpp:219-232), with the weights
    drawn from ``generator``.  When a fit flag is off the corresponding
    weight and its variance start (and stay) exactly zero."""
    F = plan.n_features
    G = plan.n_groups

    def normal(shape):
        return std_normal(shape, generator, dtype, device)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    V = init_stdev * normal((F, rank))
    if cfg.fit_linear:
        w = init_stdev * normal((F,))
        w_var = full((F,), init_stdev**2)
    else:
        w = full((F,), 0.0)
        w_var = full((F,), 0.0)
    if cfg.fit_w0:
        w0 = init_stdev * normal(())
        w0_var = full((), 1.0)
    else:
        w0 = full((), 0.0)
        w0_var = full((), 0.0)
    return VIState(
        w0=w0,
        w0_var=w0_var,
        w=w,
        w_var=w_var,
        V=V,
        V_var=full((F, rank), init_stdev**2),
        e=full((plan.n_rows,), 0.0),
        e_var_sum=full((), 0.0),
        alpha=full((), 1.0),
        alpha_rate=full((), plan.n_real * 0.5),
        mu_w=full((G,), 0.0),
        mu_w_var=full((G,), 1.0),
        lambda_w=full((G,), 1e-5),
        lambda_w_rate=full((G,), 1.0),
        mu_V=full((G, rank), 0.0),
        mu_V_var=full((G, rank), 1.0),
        lambda_V=full((G, rank), 1e-5),
        lambda_V_rate=full((G, rank), 1.0),
        elbo=full((), 0.0),
    )
