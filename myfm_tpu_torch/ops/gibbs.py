"""Gibbs hyperparameter conditionals, chain state and the row-space sweep.

PyTorch counterpart of the parts of ``myfm_tpu/ops/gibbs.py`` that the
categorical fast path and the joint engine use: ``GibbsConfig``,
``GibbsState``, ``_draw_normal``, ``draw_alpha``, ``draw_w0``,
``draw_lambda``, ``draw_mu``, ``init_state``, ``refresh_e`` for the
regression, classification (probit) and ordered-probit tasks, and
``gibbs_sweep`` with its merged-joint branch.  The colored engine
(``sweep_w``, ``sweep_V``, ``sweep_V_joint``) is not ported yet: a sweep
that needs it raises ``NotImplementedError``.

Every draw is a deterministic transform of standard variates that the
caller passes in (a standard-gamma variate, a standard normal, the
probit tasks' latent uniforms); the variates themselves come from a
``torch.Generator`` (``std_gamma``, ``std_normal``,
``special.uniform_open``).  The split lets the tests hand both packages
the same variates, since the JAX and torch generators give different
numbers from one seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .oprobit import OprobitVariates, oprobit_groups_update
from .special import truncated_std_normal_onesided, uniform_open

TASK_REGRESSION = "regression"
TASK_CLASSIFICATION = "classification"
TASK_ORDERED = "ordered"
_COLORED = "colored engine: later slice"


@dataclasses.dataclass(frozen=True)
class GibbsConfig:
    """Static learning configuration (fields as in
    ``myfm_tpu.ops.gibbs.GibbsConfig``; the multi-device knobs are not
    part of this port yet).  ``joint_unroll``, the TPU package's
    ``lax.scan`` unroll factor, has no counterpart: the tail runs as one
    kernel or as a plain Python loop."""

    task: str = TASK_REGRESSION
    alpha_0: float = 1.0
    beta_0: float = 1.0
    gamma_0: float = 1.0
    mu_0: float = 0.0
    reg_0: float = 1.0
    fit_w0: bool = True
    fit_linear: bool = True
    nu_oprobit: int = 5
    cutpoint_scale: float = 10.0
    n_class: int = 0
    n_classes: Tuple[int, ...] = ()
    joint_rows: bool = False
    # run the joint sweep's stacked color tail, and the fast path's
    # entity+attribute color scans, through the CUDA kernel
    # (ops/joint_tail.py) instead of its plain loop — the counterpart of
    # joint_pallas_tail.  None = auto: the trainer resolves it to the
    # kernel when the plan is on CUDA and D = rank + 2 <= 34
    # (trainer._resolve_joint_tail); True requires CUDA tensors.
    joint_tail_kernel: Optional[bool] = None
    # Gram arithmetic mode.  None = auto, which resolves to IEEE fp32
    # (False) in this port (trainer._resolve_gram_fast_matmul); the
    # split / bf16 modes of the TPU package are not ported yet.
    gram_fast_matmul: Optional[object] = None

    @property
    def cutpoint_group_classes(self) -> Tuple[int, ...]:
        """Class count per cutpoint group ((n_class,) when ungrouped).
        Group g's classes occupy the encoded targets
        [Σ_{j<g} K_j, Σ_{j<g} K_j + K_g) (ops/oprobit.py)."""
        if self.n_classes:
            return self.n_classes
        return (self.n_class,) if self.n_class else ()


@dataclasses.dataclass
class GibbsState:
    w0: torch.Tensor  # scalar
    w: torch.Tensor  # [F]
    V: torch.Tensor  # [F, R]
    e: torch.Tensor  # [N] residual: score − y (regression), score − z
    alpha: torch.Tensor  # scalar noise precision (1 for the probit tasks)
    mu_w: torch.Tensor  # [G]
    lambda_w: torch.Tensor  # [G]
    mu_V: torch.Tensor  # [G, R]
    lambda_V: torch.Tensor  # [G, R]
    cutpoints: Optional[torch.Tensor] = None  # [Σ(K−1)] (ordered probit)
    oprobit_alpha: Optional[torch.Tensor] = None  # [Σ(K−1)] unconstrained
    n_mh_accept: Optional[torch.Tensor] = None  # [groups] int32


def std_normal(shape, generator: torch.Generator, dtype,
               device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device)


def std_gamma(shape_param: torch.Tensor,
              generator: torch.Generator) -> torch.Tensor:
    """Standard Gamma(shape_param, rate 1) variates, one per element."""
    return torch._standard_gamma(shape_param, generator=generator)


def _draw_normal(quad, lin, noise):
    """Sample N(lin/quad, 1/quad) given a standard normal ``noise``."""
    return lin / quad + noise * torch.rsqrt(quad)


def _segment_sum(x: torch.Tensor, index: torch.Tensor, n: int):
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, index, x)


def draw_alpha(e, cfg: GibbsConfig, g: torch.Tensor):
    """α | e ~ Gamma((α₀+n)/2, rate=(β₀+Σe²)/2) given the standard-gamma
    variate ``g`` of shape (α₀+n)/2."""
    rate = (cfg.beta_0 + (e * e).sum()) / 2.0
    return g / rate


def draw_w0(e, w0, alpha, cfg: GibbsConfig, n_rows: int,
            noise: torch.Tensor):
    """w0 | e ~ N(·) with prior precision reg₀, given a standard normal;
    returns (w0_new, e shifted by w0_new − w0)."""
    quad = alpha * n_rows + cfg.reg_0
    lin = alpha * (n_rows * w0 - e.sum())
    w0_new = _draw_normal(quad, lin, noise)
    return w0_new, e + (w0_new - w0)


def lambda_gamma_shape(weight_ndim: int, group_counts: torch.Tensor,
                       cfg: GibbsConfig) -> torch.Tensor:
    """Shape parameter of the groupwise λ conditional's standard gamma.

    For factor matrices it is [G, 1]: the TPU package draws one gamma
    variate per group and scales it by each factor's rate (its
    ``counts[:, None]`` shape argument), and the port keeps that."""
    counts = group_counts
    if weight_ndim == 2:
        counts = counts[:, None]
    return (cfg.alpha_0 + counts) / 2.0


def draw_lambda(weight, mu, group_index, group_counts,
                cfg: GibbsConfig, g: torch.Tensor):
    """Groupwise λ | w,μ ~ Gamma((α₀+n_g)/2, rate=(β₀+Σ_g dev²)/2),
    given the standard-gamma variates ``g`` of shape
    ``lambda_gamma_shape``.  Handles the linear weights ([F], μ [G]) and
    a factor matrix ([F, R], μ [G, R]) alike."""
    n_groups = mu.shape[0]
    dev2 = (weight - mu[group_index]) ** 2
    ssq = _segment_sum(dev2, group_index, n_groups)
    rate = (cfg.beta_0 + ssq) / 2.0
    return g / rate


def draw_mu(weight, lam, group_index, group_counts, cfg: GibbsConfig,
            noise: torch.Tensor):
    """Groupwise μ | w,λ ~ N(lin/quad, 1/quad) given standard normals
    ``noise`` of λ's shape."""
    n_groups = lam.shape[0]
    s = _segment_sum(weight, group_index, n_groups)
    counts = group_counts
    if weight.ndim == 2:
        counts = counts[:, None]
    quad = lam * (cfg.gamma_0 + counts)
    lin = lam * (cfg.gamma_0 * cfg.mu_0 + s)
    return _draw_normal(quad, lin, noise)


def init_state(plan, rank: int, init_stdev: float,
               generator: torch.Generator, cfg: GibbsConfig,
               dtype: torch.dtype, device) -> GibbsState:
    """Weight init N(0, init_stdev²) and hyper init.  When a fit flag is
    off the corresponding weight starts (and stays) exactly zero."""
    F = plan.n_features
    G = plan.n_groups

    def normal(shape):
        return std_normal(shape, generator, dtype, device)

    V = init_stdev * normal((F, rank))
    w = (
        init_stdev * normal((F,))
        if cfg.fit_linear
        else torch.zeros(F, dtype=dtype, device=device)
    )
    w0 = (
        init_stdev * normal(())
        if cfg.fit_w0
        else torch.zeros((), dtype=dtype, device=device)
    )
    return GibbsState(
        w0=w0,
        w=w,
        V=V,
        e=torch.zeros(plan.n_rows, dtype=dtype, device=device),
        alpha=torch.ones((), dtype=dtype, device=device),
        mu_w=torch.zeros(G, dtype=dtype, device=device),
        lambda_w=torch.full((G,), 1e-5, dtype=dtype, device=device),
        mu_V=torch.zeros((G, rank), dtype=dtype, device=device),
        lambda_V=torch.full((G, rank), 1e-5, dtype=dtype, device=device),
    )


def check_task(cfg: GibbsConfig):
    """Raise on a task the sweeps do not know, and on an ordered task
    without cutpoint groups."""
    if cfg.task not in (TASK_REGRESSION, TASK_CLASSIFICATION, TASK_ORDERED):
        raise ValueError(f"unknown task {cfg.task!r}")
    if cfg.task == TASK_ORDERED and not cfg.cutpoint_group_classes:
        raise ValueError("the ordered task needs cutpoint groups (n_class or "
                         "n_classes)")


def draw_latent_variates(cfg: GibbsConfig, n_rows: int,
                         generator: torch.Generator, dtype: torch.dtype,
                         device):
    """The probit tasks' per-sweep variates after the weights' own: the
    [N] latent uniforms in [tiny, 1), and for the ordered task each
    cutpoint group's MH variates.  Returns (u_latent, oprobit) — both
    None for regression."""
    check_task(cfg)
    if cfg.task == TASK_REGRESSION:
        return None, None
    u = uniform_open((n_rows,), generator, dtype, device)
    if cfg.task == TASK_CLASSIFICATION:
        return u, None
    groups = cfg.cutpoint_group_classes
    chi_shape = torch.full((), cfg.nu_oprobit / 2.0, dtype=dtype,
                           device=device)
    mh = tuple(
        OprobitVariates(
            normal=std_normal((K - 1,), generator, dtype, device),
            chi=std_gamma(chi_shape, generator),
            u_accept=torch.rand((), generator=generator, dtype=dtype,
                                device=device),
        )
        for K in groups
    )
    return u, mh


@dataclasses.dataclass
class GibbsVariates:
    """Every standard variate one row-space sweep consumes (the TPU
    package draws them from the splits of its key: gibbs.py:926-928)."""

    gamma_alpha: Optional[torch.Tensor]  # scalar, Gamma((α₀+n)/2, 1)
    normal_w0: torch.Tensor  # scalar
    gamma_lambda_w: torch.Tensor  # [G]
    normal_mu_w: torch.Tensor  # [G]
    gamma_lambda_V: torch.Tensor  # [G, 1] (one variate per group)
    normal_mu_V: torch.Tensor  # [G, R]
    noise: torch.Tensor  # [F, R+1], the joint draws' ξ
    u_latent: Optional[torch.Tensor] = None  # [N] probit tasks
    oprobit: Optional[Tuple[OprobitVariates, ...]] = None  # per group


def draw_gibbs_variates(plan, cfg: GibbsConfig, rank: int,
                        generator: torch.Generator, dtype: torch.dtype,
                        device) -> GibbsVariates:
    """Draw one sweep's standard variates from ``generator`` (α's gamma
    variate only for regression: the probit tasks fix α = 1)."""
    G = plan.n_groups
    counts = plan.group_counts

    def normal(shape):
        return std_normal(shape, generator, dtype, device)

    gamma_alpha = None
    if cfg.task == TASK_REGRESSION:
        shape_alpha = torch.full(
            (), (cfg.alpha_0 + plan.n_rows) / 2.0, dtype=dtype,
            device=device
        )
        gamma_alpha = std_gamma(shape_alpha, generator)
    v = GibbsVariates(
        gamma_alpha=gamma_alpha,
        normal_w0=normal(()),
        gamma_lambda_w=std_gamma(lambda_gamma_shape(1, counts, cfg),
                                 generator),
        normal_mu_w=normal((G,)),
        gamma_lambda_V=std_gamma(lambda_gamma_shape(2, counts, cfg),
                                 generator),
        normal_mu_V=normal((G, rank)),
        noise=normal((plan.n_features, rank + 1)),
    )
    v.u_latent, v.oprobit = draw_latent_variates(
        cfg, plan.n_rows, generator, dtype, device)
    return v


def require_joint(cfg: GibbsConfig):
    """The port's row-space sweep is the merged joint engine; the
    colored engine is a later slice."""
    if not (cfg.joint_rows and cfg.fit_linear):
        raise NotImplementedError(_COLORED)


def refresh_latent(score, y, state: GibbsState, cfg: GibbsConfig,
                   u_latent, oprobit, weight=None):
    """The residual from freshly computed scores, for every task.

    Regression: e = score − y.  Classification: the latent probit
    response z ~ TN(score, 1; sign(y)) is redrawn and e = score − z.
    Ordered: one MH cutpoint step per group, then z ~ TN(score, 1; the
    class interval).  Returns (e, cutpoints, oprobit_alpha,
    n_mh_accept), the last three as in ``state`` unless ordered."""
    if cfg.task == TASK_REGRESSION:
        return score - y, state.cutpoints, state.oprobit_alpha, \
            state.n_mh_accept
    if cfg.task == TASK_CLASSIFICATION:
        t = truncated_std_normal_onesided(u_latent, -score, y > 0)
        return -t, state.cutpoints, state.oprobit_alpha, state.n_mh_accept
    if cfg.task == TASK_ORDERED:
        alpha, gamma, acc, e = oprobit_groups_update(
            score, y, state.oprobit_alpha, state.n_mh_accept,
            cfg.cutpoint_group_classes, cfg.reg_0, float(cfg.nu_oprobit),
            oprobit, u_latent, weight=weight,
        )
        return e, gamma, alpha, acc
    raise ValueError(f"unknown task {cfg.task!r}")


def refresh_e(plan, state: GibbsState, w0, w, V, y, cfg: GibbsConfig,
              u_latent=None, oprobit=None):
    """Recompute the residual from scratch on the row-space plan
    (``refresh_latent`` of its scores)."""
    from .forward import predict_score

    require_joint(cfg)
    return refresh_latent(predict_score(plan, w0, w, V), y, state, cfg,
                          u_latent, oprobit)


def draw_hypers(plan, state: GibbsState, variates: GibbsVariates,
                cfg: GibbsConfig) -> GibbsState:
    """The sweep's first half, α → w0 → (λ_w, μ_w) → (λ_V, μ_V): the
    state with its hyperparameters (and w0, e) drawn, weights as given."""
    v = variates
    n = plan.n_rows
    gi, gc = plan.group_index, plan.group_counts
    if cfg.task == TASK_REGRESSION:
        alpha = draw_alpha(state.e, cfg, v.gamma_alpha)
    else:
        alpha = torch.ones_like(state.w0)
    e = state.e
    w0 = state.w0
    if cfg.fit_w0:
        w0, e = draw_w0(e, w0, alpha, cfg, n, v.normal_w0)
    lambda_w = draw_lambda(state.w, state.mu_w, gi, gc, cfg, v.gamma_lambda_w)
    mu_w = draw_mu(state.w, lambda_w, gi, gc, cfg, v.normal_mu_w)
    lambda_V = draw_lambda(state.V, state.mu_V, gi, gc, cfg,
                           v.gamma_lambda_V)
    mu_V = draw_mu(state.V, lambda_V, gi, gc, cfg, v.normal_mu_V)
    return dataclasses.replace(
        state, w0=w0, e=e, alpha=alpha, mu_w=mu_w, lambda_w=lambda_w,
        mu_V=mu_V, lambda_V=lambda_V,
    )


def gibbs_sweep(plan, state: GibbsState, y: torch.Tensor,
                variates: GibbsVariates, cfg: GibbsConfig) -> GibbsState:
    """One full Gibbs iteration (α → w0 → λ_w, μ_w → λ_V, μ_V → the
    merged joint (w, V) pass → residual refresh: for the probit tasks
    the latent targets' redraw, and for the ordered task the cutpoints'
    MH step first), applying the given standard ``variates``.  α is 1
    for the probit tasks.  The input state is not modified.

    Both float32 fixes of the TPU package are kept: q is rebuilt from V
    at every sweep, and e is re-forwarded at its end, so the drift of
    the incrementally maintained caches cannot feed back into the
    draws."""
    from .joint import sweep_joint_u

    require_joint(cfg)
    h = draw_hypers(plan, state, variates, cfg)
    w, V, _, _ = sweep_joint_u(
        plan, h.e, h.w, h.V, h.alpha, h.lambda_w, h.mu_w, h.lambda_V,
        h.mu_V, variates.noise, q=None,
        tail_kernel=bool(cfg.joint_tail_kernel),
    )
    e, cutpoints, oprobit_alpha, n_mh_accept = refresh_e(
        plan, state, h.w0, w, V, y, cfg, variates.u_latent,
        variates.oprobit,
    )
    return dataclasses.replace(
        h, w=w, V=V, e=e, cutpoints=cutpoints, oprobit_alpha=oprobit_alpha,
        n_mh_accept=n_mh_accept,
    )
