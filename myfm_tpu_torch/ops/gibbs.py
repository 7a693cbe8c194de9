"""Gibbs hyperparameter conditionals, chain state and the row-space sweeps.

PyTorch counterpart of ``myfm_tpu/ops/gibbs.py``: ``GibbsConfig``,
``GibbsState``, the hyperparameter draws (``draw_alpha``, ``draw_w0``,
``draw_lambda``, ``draw_mu``), ``init_state``, ``refresh_e`` for the
regression, classification (probit) and ordered-probit tasks, the
colored engine (``sweep_w``, ``sweep_V``), the joint-row factor sweep
(``sweep_V_joint``) and ``gibbs_sweep``, whose merged (w, V) branch runs
ops/joint.py.

The colored engine draws one coordinate set at a time from its exact
conditional, organized by color (row-disjoint feature sets, design.py):
the linear weights, then each factor column in turn, "serial" plans
giving every feature its own color (myFM's own order).  Block tables
are drawn from per-block-row aggregates; a block's stacked colors
evolve those aggregates in closed form, so only the end of a stack
touches the [n_rows] residual.  The TPU package scans a ``ColorStack``
with ``lax.scan``; here a Python loop walks its colors.  No TPU kernel
lies on these sweeps, and none is written for them: they are gathers,
elementwise arithmetic, segment sums (ops/segsum.py) and (joint rows)
small batched solves.

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

from ..design import BlockPlan, ColorPlan, ColorStack, DesignPlan
from ..parallel.collectives import local_rows, psum, psum_many
from .forward import factor_q, factor_q_single, predict_score, take
from .joint import _scatter_rows, _segsum, solve_spd_sample
from .oprobit import OprobitVariates, oprobit_groups_update
from .rowspace import (
    block_sum,
    one_color,
    seg_sum,
    set_feat,
    stack_colors,
    term_index,
)
from .segsum import add_at, segment_sum
from .special import truncated_std_normal_onesided, uniform_open

TASK_REGRESSION = "regression"
TASK_CLASSIFICATION = "classification"
TASK_ORDERED = "ordered"


@dataclasses.dataclass(frozen=True)
class GibbsConfig:
    """Static learning configuration (fields as in
    ``myfm_tpu.ops.gibbs.GibbsConfig``, with the data axis
    ``parallel/collectives.Axis`` in place of its ``axis_name``).
    ``joint_unroll``, the TPU package's ``lax.scan`` unroll factor, has
    no counterpart: the tail runs as one kernel or as a plain Python
    loop."""

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
    # fast-path Gram arithmetic mode (kernel 1; ops/gram.gram_mode).
    # None = auto (trainer._resolve_gram_fast_matmul): float32 on a CUDA
    # card resolves, after per-mode self-checks on the card
    # (ops/gram.gram_fast_selfcheck), to the single-pass "bf16" Gram at
    # rank >= 64 and to the 3-pass bf16 "split" (~1.5e-5 relative)
    # otherwise; the CPU and float64 keep IEEE.  False forces IEEE, True
    # or "split" the split mode, "bf16" the single pass (float32 only on
    # the card: a mode with float64 there raises).
    gram_fast_matmul: Optional[object] = None
    # multi-device execution: the data axis the statistics are summed
    # over (None = one process; the sweep is then exactly the
    # single-process one), and whether the fast path sums each table's
    # [B, D, D] Gram with a reduce-scatter by entity window and
    # all-gathers the drawn weights (when the axis size divides B; else
    # one all-reduce of the whole Gram)
    axis: Optional[object] = None
    gram_reduce_scatter: bool = True

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


def draw_alpha(e, cfg: GibbsConfig, g: torch.Tensor):
    """α | e ~ Gamma((α₀+n)/2, rate=(β₀+Σe²)/2) given the standard-gamma
    variate ``g`` of shape (α₀+n)/2."""
    rate = (cfg.beta_0 + psum((e * e).sum(), cfg.axis)) / 2.0
    return g / rate


def draw_w0(e, w0, alpha, cfg: GibbsConfig, n_rows: int,
            noise: torch.Tensor):
    """w0 | e ~ N(·) with prior precision reg₀, given a standard normal;
    returns (w0_new, e shifted by w0_new − w0)."""
    quad = alpha * n_rows + cfg.reg_0
    lin = alpha * (n_rows * w0 - psum(e.sum(), cfg.axis))
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
    ssq = segment_sum(dev2, group_index, n_groups)
    rate = (cfg.beta_0 + ssq) / 2.0
    return g / rate


def draw_mu(weight, lam, group_index, group_counts, cfg: GibbsConfig,
            noise: torch.Tensor):
    """Groupwise μ | w,λ ~ N(lin/quad, 1/quad) given standard normals
    ``noise`` of λ's shape."""
    n_groups = lam.shape[0]
    s = segment_sum(weight, group_index, n_groups)
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


def draw_latent_variates(cfg: GibbsConfig, plan,
                         generator: torch.Generator, dtype: torch.dtype,
                         device):
    """The probit tasks' per-sweep variates after the weights' own: the
    [N] latent uniforms in [tiny, 1), and for the ordered task each
    cutpoint group's MH variates.  Returns (u_latent, oprobit) — both
    None for regression.  The uniforms are drawn at the whole design's
    length, as one process draws them, and a sharded plan keeps its own
    rows (the TPU package slices one global draw the same way)."""
    check_task(cfg)
    if cfg.task == TASK_REGRESSION:
        return None, None
    u = local_rows(uniform_open((plan.n_real,), generator, dtype, device),
                   plan.row_lo, plan.n_rows)
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
    package draws them from the splits of its key: gibbs.py:926-928;
    its w noise is (F,) from k_w, its factor noise (F,) per factor from
    the splits of k_v, or (F, R) from k_v for joint rows, or (F, R+1)
    for merged rows)."""

    gamma_alpha: Optional[torch.Tensor]  # scalar, Gamma((α₀+n)/2, 1)
    normal_w0: torch.Tensor  # scalar
    gamma_lambda_w: torch.Tensor  # [G]
    normal_mu_w: torch.Tensor  # [G]
    gamma_lambda_V: torch.Tensor  # [G, 1] (one variate per group)
    normal_mu_V: torch.Tensor  # [G, R]
    noise: torch.Tensor  # [F, R+1]: column 0 drives w, 1..R the factors
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
            (), (cfg.alpha_0 + plan.n_real) / 2.0, dtype=dtype,
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
        cfg, plan, generator, dtype, device)
    return v


# ---------------------------------------------------------------------------
# The colored engine: linear-weight color steps
# ---------------------------------------------------------------------------


def _per_feature_prior(c: ColorPlan, group_index, lam_col, mu_col):
    g = take(group_index, c.feat)
    return lam_col[g], mu_col[g]


def _stack_indices(stack: ColorStack):
    """(rows, seg, seg clamped to the slots, feat) of a ColorStack as
    int64: gathers through a pad slot id clamp into range as JAX's do,
    scatters into Pf + 1 slots drop it."""
    seg = stack.seg.long()
    return (stack.rows.long(), seg, seg.clamp(max=stack.feat.shape[1] - 1),
            stack.feat.long())


def _w_color_main(c: ColorPlan, e, w, alpha, lam_col, mu_col, noise,
                  group_index, axis=None):
    """The exact conditional of a row-disjoint main-table feature set's
    linear weights: quad = α Σx² + λ, lin = α(Σx² w_old − Σ x e) + λμ."""
    lam, mu = _per_feature_prior(c, group_index, lam_col, mu_col)
    w_old = take(w, c.feat)
    xe = psum(seg_sum(c.vals * e[c.rows], c.seg, c.feat.shape[0]), axis)
    quad = alpha * c.sx2 + lam
    lin = alpha * (c.sx2 * w_old - xe) + lam * mu
    w_new = _draw_normal(quad, lin, take(noise, c.feat))
    e = add_at(e, c.rows, take(w_new - w_old, c.seg) * c.vals,
               distinct=True)
    return e, set_feat(w, c.feat, w_new)


def _w_color_block(b: BlockPlan, c: ColorPlan, e, w, alpha, lam_col,
                   mu_col, noise, group_index, axis=None):
    """One block color's step: the stack fold over that color alone."""
    return _w_block_stack(b, one_color(c), e, w, alpha, lam_col, mu_col,
                          noise, group_index, axis)


def _w_block_stack(b: BlockPlan, stack: ColorStack, e, w, alpha, lam_col,
                   mu_col, noise, group_index, axis=None):
    """The block colors of ``stack`` in order, in O(block_size) per
    color: the conditional reads the residual only through its
    per-block-row sum e1, which evolves as e1 += cardinality · dxb under
    a color's update e += dxb[mapper]; the [n_rows] residual is touched
    once, after the loop.  What does not change along the loop (the
    priors, the precision and the noise term per slot) is built once for
    all colors."""
    F, B = w.shape[0], b.block_size
    alpha = torch.as_tensor(alpha, dtype=e.dtype, device=e.device)
    rows, seg, seg_c, feat = _stack_indices(stack)
    Pf = feat.shape[1]
    x, sx2 = stack.vals, stack.sx2
    gf = take(group_index, feat)
    lam_mu = lam_col[gf] * mu_col[gf]
    quad = alpha * sx2 + lam_col[gf]
    nz = take(noise, feat) * torch.rsqrt(quad)
    card = b.cardinality
    e1 = block_sum(e, b, axis)
    acc = e.new_zeros(B)
    w_ext = torch.cat([w, w.new_zeros(1)])  # pad feature ids: scratch
    for ci in range(rows.shape[0]):
        m, ft, xc = rows[ci], feat[ci], x[ci]
        w_old = w_ext[ft]
        xe = segment_sum(xc * e1[m], seg[ci], Pf + 1, ascending=True)[:Pf]
        lin = torch.addcmul(lam_mu[ci], alpha, sx2[ci] * w_old - xe)
        w_new = lin / quad[ci] + nz[ci]
        w_ext[ft] = w_new
        dxb = segment_sum((w_new - w_old)[seg_c[ci]] * xc, m, B,
                          distinct=True)
        e1.addcmul_(card, dxb)
        acc.add_(dxb)
    return e + acc[b.mapper], w_ext[:F]


def sweep_w(plan: DesignPlan, e, w, alpha, lambda_w, mu_w, noise,
            axis=None):
    """Every linear weight's draw, color by color, given one standard
    normal per feature (``noise`` [F]); on a sharded plan the per-feature
    and block-row sums are summed over the data ``axis``.  Returns
    (w, e)."""
    g = plan.group_index
    for c in plan.main.colors + stack_colors(plan.main.color_stack):
        e, w = _w_color_main(c, e, w, alpha, lambda_w, mu_w, noise, g, axis)
    for b in plan.blocks:
        for c in b.colors:
            e, w = _w_color_block(b, c, e, w, alpha, lambda_w, mu_w, noise,
                                  g, axis)
        if b.color_stack is not None:
            e, w = _w_block_stack(b, b.color_stack, e, w, alpha, lambda_w,
                                  mu_w, noise, g, axis)
    return w, e


# ---------------------------------------------------------------------------
# The colored engine: factor (V) color steps, one factor at a time
# ---------------------------------------------------------------------------


def _V_color_main(c: ColorPlan, e, q, v, alpha, lam_col, mu_col, noise,
                  group_index, axis=None):
    """The exact conditional of a row-disjoint main-table feature set's
    factor coordinates: with h = x(q − x v_old),
    quad = α Σh² + λ, lin = α(Σh² v_old − Σ e h) + λμ."""
    n_seg = c.feat.shape[0]
    lam, mu = _per_feature_prior(c, group_index, lam_col, mu_col)
    v_old = take(v, c.feat)
    x = c.vals
    h = x * (q[c.rows] - x * take(v_old, c.seg))
    sq, lin = psum_many(axis, seg_sum(h * h, c.seg, n_seg),
                        seg_sum(-e[c.rows] * h, c.seg, n_seg))
    lin = lin + sq * v_old
    quad = alpha * sq + lam
    lin = alpha * lin + lam * mu
    v_new = _draw_normal(quad, lin, take(noise, c.feat))
    dseg = take(v_new - v_old, c.seg)
    e = add_at(e, c.rows, dseg * h, distinct=True)
    q = add_at(q, c.rows, dseg * x, distinct=True)
    return e, q, set_feat(v, c.feat, v_new)


def _V_color_block(b: BlockPlan, c: ColorPlan, e, q, v, alpha, lam_col,
                   mu_col, noise, group_index, axis=None):
    """One block color's step: the stack fold over that color alone (its
    caches updated through the mapper once)."""
    return _V_block_stack(b, one_color(c), e, q, v, alpha, lam_col, mu_col,
                          noise, group_index, axis)


# The block aggregates' evolution under a color's per-block-row
# constants (a, b2), old values on every right-hand side, as 4 x 5 terms
# (row of [a, b2, a², a·b2], row of [E1, Q1, Q2, EQ, card], coefficient):
#   E1 += a·Q1 − b2·card       Q1 += a·card
#   Q2 += 2a·Q1 + a²·card      EQ += a·(Q2 + E1) + (a² − b2)·Q1 − a·b2·card
_V_AGG_TERMS = (
    (0, 1, 1.0), (1, 4, -1.0), None, None, None,
    (0, 4, 1.0), None, None, None, None,
    (0, 1, 2.0), (2, 4, 1.0), None, None, None,
    (0, 2, 1.0), (0, 0, 1.0), (2, 1, 1.0), (1, 1, -1.0), (3, 4, -1.0),
)


def _V_block_stack(b: BlockPlan, stack: ColorStack, e, q, v, alpha,
                   lam_col, mu_col, noise, group_index, axis=None):
    """The block colors of ``stack`` in order, in O(block_size) per
    color.  For block feature i with value x at block row m, the
    conditional reads (e, q) only through four per-block-row aggregates
    E1 = Σe, Q1 = Σq, Q2 = Σq², EQ = Σeq over m's members:

        Σ h² = x²(Q2 − 2x v_old Q1 + x² v_old² card),
        Σ e h = x(EQ − x v_old E1).

    Each color's update is e += a[mapper]·q − b2[mapper],
    q += a[mapper] with per-block-row a = Δx, b2 = Δx² v_old, under
    which the aggregates evolve in closed form (``_V_AGG_TERMS``), so the
    loop touches no [n_rows] tensor.  After it, with A = Σₖ aₖ and
    S = Σₖ aₖ·(Σ_{j<k} aⱼ) (each color sees the q of the earlier ones),

        e ← e + A[mapper]·q + (S − Σb2)[mapper],   q ← q + A[mapper].

    What does not change along the loop (priors, noise and x per entry,
    the term tables) is built once, and each color works on stacked rows
    (the aggregates [5, B], the two slot sums [2, Pf]): about forty
    device operations per color."""
    F, B = v.shape[0], b.block_size
    dev = e.device
    alpha = torch.as_tensor(alpha, dtype=e.dtype, device=dev)
    rows, seg, seg_c, feat = _stack_indices(stack)
    Pf = feat.shape[1]
    x = stack.vals
    neg_x, x2 = -x, x * x
    gf = take(group_index, feat)
    lam = lam_col[gf]
    lam_mu = lam * mu_col[gf]
    nz = take(noise, feat)
    (l_i, r_i), coef = term_index(_V_AGG_TERMS, 3, dev)
    agg_coef = torch.tensor(coef, dtype=e.dtype, device=dev)[:, None]
    sq_i = torch.tensor([0, 0], device=dev)
    sq_j = torch.tensor([0, 1], device=dev)
    agg = torch.stack([block_sum(e, b, axis), block_sum(q, b, axis),
                       block_sum(q * q, b, axis), block_sum(e * q, b, axis),
                       b.cardinality])  # [5, B]
    acc = e.new_zeros(3, B)  # A, ΣB2, S
    v_ext = torch.cat([v, v.new_zeros(1)])  # pad feature ids: scratch
    for ci in range(rows.shape[0]):
        m, ft, xc = rows[ci], feat[ci], x[ci]
        v_old = v_ext[ft]
        xv = xc * v_old[seg_c[ci]]
        E1m, Q1m, Q2m, EQm, cm = agg[:, m]
        sq_e = x2[ci] * torch.addcmul(
            Q2m, xv, torch.addcmul(-2.0 * Q1m, xv, cm))
        lin_e = neg_x[ci] * torch.addcmul(EQm, xv, E1m, value=-1.0)
        sq, lin = segment_sum(torch.stack([sq_e, lin_e], dim=1), seg[ci],
                              Pf + 1, ascending=True)[:Pf].T
        quad = torch.addcmul(lam[ci], alpha, sq)
        lin = torch.addcmul(lam_mu[ci], alpha,
                            torch.addcmul(lin, sq, v_old))
        v_new = lin / quad + nz[ci] * torch.rsqrt(quad)
        v_ext[ft] = v_new
        dseg = (v_new - v_old)[seg_c[ci]]
        u = segment_sum(torch.stack([dseg * xc, dseg * xc * xv], dim=1),
                        m, B, distinct=True).T  # a, b2
        lhs = torch.cat([u, u[sq_i] * u[sq_j]])  # + a², a·b2
        agg[:4].add_((agg_coef * lhs[l_i] * agg[r_i]).view(4, 5, B).sum(1))
        acc[2].addcmul_(u[0], acc[0])
        acc[:2].add_(u)
    am = acc[0][b.mapper]
    e = e + am * q + (acc[2] - acc[1])[b.mapper]
    return e, q + am, v_ext[:F]


def sweep_V_factor(plan: DesignPlan, e, v, alpha, lam_col, mu_col, noise,
                   axis=None):
    """One factor column's draws over every color of every table, its
    factor sums q rebuilt from ``v`` first; returns (e, v)."""
    g = plan.group_index
    q = factor_q_single(plan, v)
    for c in plan.main.colors + stack_colors(plan.main.color_stack):
        e, q, v = _V_color_main(c, e, q, v, alpha, lam_col, mu_col, noise,
                                g, axis)
    for b in plan.blocks:
        for c in b.colors:
            e, q, v = _V_color_block(b, c, e, q, v, alpha, lam_col, mu_col,
                                     noise, g, axis)
        if b.color_stack is not None:
            e, q, v = _V_block_stack(b, b.color_stack, e, q, v, alpha,
                                     lam_col, mu_col, noise, g, axis)
    return e, v


def sweep_V(plan: DesignPlan, e, V, alpha, lambda_V, mu_V, noise,
            axis=None):
    """Every factor's draws, factor after factor, given standard normals
    ``noise`` [F, R] (column r for factor r); ``axis`` as in
    ``sweep_w``.  Returns (V, e)."""
    cols = []
    for r in range(V.shape[1]):
        e, v = sweep_V_factor(plan, e, V[:, r], alpha, lambda_V[:, r],
                              mu_V[:, r], noise[:, r], axis)
        cols.append(v)
    return (torch.stack(cols, dim=1) if cols else V), e


# ---------------------------------------------------------------------------
# Joint-row factor sweep (sweep_strategy="joint" with fit_linear=False)
# ---------------------------------------------------------------------------
#
# Given every other weight the score is linear in feature j's factor row
# V_j, so p(V_j | rest) is one R-dimensional Gaussian,
#     A = α Σₙ xₙ²φₙφₙᵀ + diag(λ),   lin = α(S v_old − Σₙ xₙeₙφₙ) + λ∘μ,
# with φₙ = qₙ − xₙ v_old: one pass over the colors draws whole rows (a
# blocked Gibbs update of the same posterior).


def _chol_mean_sample(S, rhs, lam, xi, alpha):
    """mean = A⁻¹rhs plus L⁻ᵀξ for A = αS + diag(λ)
    (``joint.solve_spd_sample``: the unrolled λ-floored solver up to
    R = 32, batched ``torch.linalg`` beyond)."""
    return solve_spd_sample(alpha * S + torch.diag_embed(lam), rhs, xi, lam)


def _V_joint_color_main(c: ColorPlan, e, q, V, alpha, lam_g, mu_g, noise,
                        group_index, axis=None):
    """Joint-row draw of a main-table color; q is the full [N, R]
    factor-sum cache, V the [F, R] table."""
    n_seg = c.feat.shape[0]
    gidx = take(group_index, c.feat)
    lam, mu = lam_g[gidx], mu_g[gidx]
    v_old = take(V, c.feat)  # [Pf, R]
    x = c.vals[:, None]
    vo = take(v_old, c.seg)
    phi = q[c.rows] - x * vo  # [Pe, R]
    xphi = x * phi
    S = _segsum(xphi[:, :, None] * phi[:, None, :] * x[:, :, None], c.seg,
                n_seg)
    # the rhs row by row, α·Σ xφ(xφ·v_old − e) + λμ: a rank-deficient S
    # keeps its null components at relative precision in float32
    resid = (xphi * vo).sum(dim=1) - e[c.rows]
    r = _segsum(xphi * resid[:, None], c.seg, n_seg)
    S, r = psum_many(axis, S, r)
    v_new = _chol_mean_sample(S, alpha * r + lam * mu, lam,
                              take(noise, c.feat), alpha)
    dseg = take(v_new - v_old, c.seg)
    e = add_at(e, c.rows, (dseg * xphi).sum(dim=1), distinct=True)
    q = add_at(q, c.rows, dseg * x, distinct=True)
    return e, q, _scatter_rows(V, c.feat, v_new)


def _block_joint_stats(b: BlockPlan, e, q, axis=None):
    """Per-block-row aggregates of the joint draw: E1 = Σe, Q1 = Σq,
    EQ = Σeq, QQ = Σqqᵀ over the mapper."""
    return (block_sum(e, b, axis), block_sum(q, b, axis),
            block_sum(e[:, None] * q, b, axis),
            block_sum(q[:, :, None] * q[:, None, :], b, axis))


def _V_joint_block_color(b: BlockPlan, c: ColorPlan, stats, V, alpha,
                         lam_g, mu_g, noise, group_index):
    """Joint-row draw of one block color from the block-row aggregates.
    Within a color each block row carries at most one drawn feature
    (value x); with v = V_j,
        S_j = x²(QQ_m − x(v Q1ᵀ + Q1 vᵀ) + x² card v vᵀ),
        t_j = x(EQ_m − x E1_m v).
    Returns V and the per-block-row update coefficients (A [B, R],
    b2 [B]) of e += q·A − b2, q += A, which the caller applies or folds
    into carried aggregates."""
    E1, Q1, EQ, QQ = stats
    n_seg = c.feat.shape[0]
    gidx = take(group_index, c.feat)
    lam, mu = lam_g[gidx], mu_g[gidx]
    v_old = take(V, c.feat)  # [Pf, R]
    x = c.vals
    m = c.rows.long()
    vo = take(v_old, c.seg)
    qm = Q1[m]
    x3 = x[:, None, None]
    S_e = x3 * x3 * (
        QQ[m]
        - x3 * (vo[:, :, None] * qm[:, None, :]
                + qm[:, :, None] * vo[:, None, :])
        + (x * x * b.cardinality[m])[:, None, None]
        * vo[:, :, None] * vo[:, None, :]
    )
    t_e = x[:, None] * (EQ[m] - (x * E1[m])[:, None] * vo)
    S = _segsum(S_e, c.seg, n_seg)
    t = _segsum(t_e, c.seg, n_seg)
    rhs = alpha * (torch.einsum("pfg,pg->pf", S, v_old) - t) + lam * mu
    v_new = _chol_mean_sample(S, rhs, lam, take(noise, c.feat), alpha)
    dseg = take(v_new - v_old, c.seg)
    A = segment_sum(x[:, None] * dseg, m, b.block_size, distinct=True)
    b2 = segment_sum(x * x * (vo * dseg).sum(dim=1), m, b.block_size,
                     distinct=True)
    return _scatter_rows(V, c.feat, v_new), A, b2


def _update_joint_stats(stats, A, b2, card):
    """The aggregates' exact recurrences under e += q·A − b2, q += A
    (per block row; old values on every right-hand side)."""
    E1, Q1, EQ, QQ = stats
    QA = (Q1 * A).sum(dim=1)
    E1n = E1 + QA - b2 * card
    EQn = (
        EQ
        + torch.einsum("bfg,bg->bf", QQ, A)
        + E1[:, None] * A
        + QA[:, None] * A
        - b2[:, None] * Q1
        - (b2 * card)[:, None] * A
    )
    QQn = (
        QQ
        + A[:, :, None] * Q1[:, None, :]
        + Q1[:, :, None] * A[:, None, :]
        + card[:, None, None] * A[:, :, None] * A[:, None, :]
    )
    return E1n, Q1 + card[:, None] * A, EQn, QQn


def _V_joint_block_stack(b: BlockPlan, stack: ColorStack, e, q, V, alpha,
                         lam_g, mu_g, noise, group_index, axis=None):
    """The joint block draw folded over a ColorStack with O(B·R²)
    aggregates per color (the vector analogue of ``_V_block_stack``);
    the [n_rows] caches are rebuilt once after the loop,
    e += q·Atot + (S − ΣB2)[mapper], where S accumulates the prefix
    cross-terms Σₖ Aₖ·A_{<k}."""
    card = b.cardinality
    stats = _block_joint_stats(b, e, q, axis)
    At = e.new_zeros(b.block_size, V.shape[1])
    St = e.new_zeros(b.block_size)
    B2t = e.new_zeros(b.block_size)
    for c in stack_colors(stack):
        V, A, b2 = _V_joint_block_color(b, c, stats, V, alpha, lam_g, mu_g,
                                        noise, group_index)
        stats = _update_joint_stats(stats, A, b2, card)
        St = St + (A * At).sum(dim=1)
        At = At + A
        B2t = B2t + b2
    am = At[b.mapper]
    e = e + (am * q).sum(dim=1) + (St - B2t)[b.mapper]
    return e, q + am, V


def sweep_V_joint(plan: DesignPlan, e, V, alpha, lambda_V, mu_V, noise,
                  axis=None):
    """One pass over the colors drawing whole factor rows, given standard
    normals ``noise`` [F, R]; ``axis`` as in ``sweep_w``.  Returns
    (V, e)."""
    if V.shape[1] == 0:
        return V, e
    g = plan.group_index
    q = factor_q(plan, V)  # [N, R]
    for c in plan.main.colors + stack_colors(plan.main.color_stack):
        e, q, V = _V_joint_color_main(c, e, q, V, alpha, lambda_V, mu_V,
                                      noise, g, axis)
    for b in plan.blocks:
        if b.colors:
            stats = _block_joint_stats(b, e, q, axis)
            for c in b.colors:
                V, A, b2 = _V_joint_block_color(b, c, stats, V, alpha,
                                                lambda_V, mu_V, noise, g)
                am = A[b.mapper]
                e = e + (am * q).sum(dim=1) - b2[b.mapper]
                q = q + am
                stats = _update_joint_stats(stats, A, b2, b.cardinality)
        if b.color_stack is not None:
            e, q, V = _V_joint_block_stack(b, b.color_stack, e, q, V, alpha,
                                           lambda_V, mu_V, noise, g, axis)
    return V, e




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
            oprobit, u_latent, weight=weight, axis=cfg.axis,
        )
        return e, gamma, alpha, acc
    raise ValueError(f"unknown task {cfg.task!r}")


def refresh_e(plan, state: GibbsState, w0, w, V, y, cfg: GibbsConfig,
              u_latent=None, oprobit=None):
    """Recompute the residual from scratch on the row-space plan
    (``refresh_latent`` of its scores)."""
    return refresh_latent(predict_score(plan, w0, w, V), y, state, cfg,
                          u_latent, oprobit)


def draw_hypers(plan, state: GibbsState, variates: GibbsVariates,
                cfg: GibbsConfig) -> GibbsState:
    """The sweep's first half, α → w0 → (λ_w, μ_w) → (λ_V, μ_V): the
    state with its hyperparameters (and w0, e) drawn, weights as given."""
    v = variates
    n = plan.n_real
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
    """One full Gibbs iteration, applying the given standard
    ``variates``: α → w0 → (λ_w, μ_w) → (λ_V, μ_V) → the weights → the
    residual refresh (for the probit tasks the latent targets' redraw,
    and for the ordered task the cutpoints' MH step first).  α is 1 for
    the probit tasks.  The input state is not modified.

    The weights' pass follows the config as the TPU package's does: the
    merged joint (w, V) pass (``joint_rows`` with ``fit_linear``);
    ``sweep_V_joint`` (``joint_rows`` without); else the colored engine,
    ``sweep_w`` (with ``fit_linear``) then ``sweep_V``.  ``noise``
    column 0 drives w and columns 1..R the factors.  The TPU package
    draws (λ_V, μ_V) after ``sweep_w``; they depend on V and μ_V alone,
    which ``sweep_w`` leaves as they are, so drawing them first gives
    the same chain.

    Both float32 fixes of the TPU package are kept: q is rebuilt from V
    at every sweep (per factor in ``sweep_V``), and e is re-forwarded at
    its end, so the drift of the incrementally maintained caches cannot
    feed back into the draws."""
    from .joint import sweep_joint_u

    h = draw_hypers(plan, state, variates, cfg)
    noise = variates.noise
    w, e = h.w, h.e
    merged = cfg.joint_rows and cfg.fit_linear
    if cfg.fit_linear and not merged:
        w, e = sweep_w(plan, e, w, h.alpha, h.lambda_w, h.mu_w, noise[:, 0],
                       cfg.axis)
    if merged:
        w, V, _, _ = sweep_joint_u(
            plan, e, w, h.V, h.alpha, h.lambda_w, h.mu_w, h.lambda_V,
            h.mu_V, noise, q=None,
            tail_kernel=bool(cfg.joint_tail_kernel), axis=cfg.axis,
        )
    elif cfg.joint_rows:
        V, e = sweep_V_joint(plan, e, h.V, h.alpha, h.lambda_V, h.mu_V,
                             noise[:, 1:], cfg.axis)
    else:
        V, e = sweep_V(plan, e, h.V, h.alpha, h.lambda_V, h.mu_V,
                       noise[:, 1:], cfg.axis)
    e, cutpoints, oprobit_alpha, n_mh_accept = refresh_e(
        plan, state, h.w0, w, V, y, cfg, variates.u_latent,
        variates.oprobit,
    )
    return dataclasses.replace(
        h, w=w, V=V, e=e, cutpoints=cutpoints, oprobit_alpha=oprobit_alpha,
        n_mh_accept=n_mh_accept,
    )
