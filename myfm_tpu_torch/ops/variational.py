"""Coordinate-ascent variational inference (CAVI): config, state, the
hyperparameter updates and the row-space (colored) sweep.

PyTorch counterpart of ``myfm_tpu/ops/variational.py``.  Every update is
a posterior-mean assignment with variance bookkeeping (reference
variational.hpp:248-318 for the hyperparameters, :450-713 for the
weights).  The entity-space fast path (ops/categorical_vi.py) uses the
config, the state, the hyperparameter updates, ``finish_task`` and
``_group_elbo_terms``; every other design runs ``vi_sweep`` here, over
the colors of a row-space ``DesignPlan`` (design.py), for the regression
and the probit classification task.

The row-space sweep keeps ground-truth per-row vectors

    q_j    = Σ_i x_{ji} V̄_i          (factor mean sum)
    x2s_j  = Σ_i x²_{ji} s_i          (factor variance sum)
    x3sv_j = Σ_i x³_{ji} s_i V̄_i

and the per-block-row segment aggregates of them; a block's stacked
colors evolve those aggregates in closed form (``_vi_V_block_stack``).
Update order: α → w0 → λ_w → μ_w → w → λ_V → μ_V → V (factor by
factor, color by color) → (e, Var, ELBO).  The TPU package scans a
``ColorStack`` with ``lax.scan``; here a Python loop walks its colors.
The sweep is elementwise arithmetic, gathers and ``index_add_`` only (no
matmul, so no TF32 setting reaches it).  Gathers through a pad feature
or slot id clamp into range as JAX's do (``forward.take``); pad entries
carry x = 0, so they add nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..design import BlockPlan, ColorPlan, ColorStack, DesignPlan
from .forward import linear_term, take
from .gibbs import (
    TASK_CLASSIFICATION,
    TASK_REGRESSION,
    _segment_sum,
    std_normal,
)
from .rowspace import (
    block_sum,
    one_color,
    seg_sum,
    set_feat,
    stack_colors,
    term_index,
)
from .special import (
    mean_var_truncated_normal_left,
    mean_var_truncated_normal_right,
)


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
    # fast-path Gram arithmetic mode (kernels 1 and 2; ops/gram.
    # gram_mode).  None = auto (trainer._resolve_gram_fast_matmul):
    # float32 on a CUDA card resolves to the 3-pass bf16 "split" (~1.5e-5
    # relative) after its self-check on the card; the CPU and float64
    # keep IEEE.  False forces IEEE, True or "split" the split mode,
    # "bf16" the single pass (float32 only on the card).
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
        # the row count of the α conditional (every row on one device)
        alpha_rate=full((), getattr(plan, "n_real", plan.n_rows) * 0.5),
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


# ---------------------------------------------------------------------------
# task finish and ELBO (shared with the entity-space fast path)
# ---------------------------------------------------------------------------


def finish_task(score: torch.Tensor, y: torch.Tensor,
                cfg: VariationalConfig):
    """(e, tau, row ELBO) from the refreshed mean score.  Regression:
    e = score − y.  Classification (probit): the latent z's mean under
    the truncated normal N(score, 1) restricted to the side y says,
    e = score − mean, tau = mean, and the rows' ELBO term
    Σ log Z + ½(mean − score)² (the TPU package's ``vi_finish_e``)."""
    if cfg.task == TASK_REGRESSION:
        return score - y, None, score.new_zeros(())
    if cfg.task == TASK_CLASSIFICATION:
        m_l, _, z_l = mean_var_truncated_normal_left(score)
        m_r, _, z_r = mean_var_truncated_normal_right(score)
        pos = y > 0
        mean = torch.where(pos, m_l, m_r)
        logz = torch.where(pos, z_l, z_r)
        return (score - mean, mean,
                (logz + 0.5 * (mean - score) ** 2).sum())
    raise NotImplementedError(
        "Ordered probit for variational FM is not implemented "
        "(parity with the reference, variational.hpp:857-859)."
    )


def _group_elbo_terms(plan, state: VIState, cfg: VariationalConfig, elbo):
    """The α, w0 and hyper-group ELBO contributions
    (variational.hpp:861-913); ``plan`` is any plan with
    ``group_index``, ``group_counts`` and ``n_groups``."""
    g = plan.group_index
    G = plan.n_groups
    counts = plan.group_counts

    elbo = elbo + state.alpha * state.alpha_rate * (
        1.0 - _safe_log(state.alpha_rate)
    )
    elbo = elbo - cfg.gamma_0 * (
        state.w0 * state.w0 + state.w0_var
    ) + 0.5 * _safe_log(state.w0_var)

    dev2_w = (state.w - state.mu_w[g]) ** 2
    rate_w = (
        cfg.beta_0
        + _segment_sum(dev2_w + state.w_var, g, G)
        + state.mu_w_var * counts
    )
    elbo = elbo + (0.5 * _safe_log(state.mu_w_var)).sum()
    elbo = elbo + (0.5 * _safe_log(state.w_var)).sum()
    elbo = elbo + (
        state.lambda_w * (-rate_w / 2.0 + state.lambda_w_rate)
    ).sum()
    elbo = elbo - (
        state.lambda_w * state.lambda_w_rate
        * _safe_log(state.lambda_w_rate)
    ).sum()
    elbo = elbo - (0.5 * (state.mu_w - cfg.mu_0) ** 2).sum()

    if state.V.shape[1] > 0:
        dev2_V = (state.V - state.mu_V[g, :]) ** 2
        rate_V = (
            cfg.beta_0
            + _segment_sum(dev2_V + state.V_var, g, G)
            + state.mu_V_var * counts[:, None]
        )
        elbo = elbo + (0.5 * _safe_log(state.mu_V_var)).sum()
        elbo = elbo + (0.5 * _safe_log(state.V_var)).sum()
        elbo = elbo + (
            state.lambda_V * (-rate_V / 2.0 + state.lambda_V_rate)
        ).sum()
        elbo = elbo - (
            state.lambda_V * state.lambda_V_rate
            * _safe_log(state.lambda_V_rate)
        ).sum()
    return elbo


# ---------------------------------------------------------------------------
# row-space helpers
# ---------------------------------------------------------------------------


def _row_cache(plan: DesignPlan, fn):
    """Σ over entries of fn(x, col) per original row, blocks gathered."""

    def table(coo_row, coo_col, coo_val, n_local):
        return coo_val.new_zeros(n_local).index_add_(
            0, coo_row, fn(coo_val, coo_col))

    m = plan.main
    out = table(m.coo_row, m.coo_col, m.coo_val, plan.n_rows)
    for b in plan.blocks:
        out = out + table(b.coo_row, b.coo_col, b.coo_val,
                          b.block_size)[b.mapper]
    return out


def _entry_weight_total(plan: DesignPlan, fn):
    """Σ over *expanded* entries of fn(x, col) (scalar)."""
    m = plan.main
    total = fn(m.coo_val, m.coo_col).sum()
    for b in plan.blocks:
        per_block_row = b.coo_val.new_zeros(b.block_size).index_add_(
            0, b.coo_row, fn(b.coo_val, b.coo_col))
        total = total + (per_block_row * b.cardinality).sum()
    return total


# ---------------------------------------------------------------------------
# α and w0 (variational.hpp:248-270)
# ---------------------------------------------------------------------------


def vi_update_alpha(state: VIState, cfg: VariationalConfig, n_rows: int,
                    dtype: torch.dtype):
    """(α, rate): fixed at 1 for the probit task, else
    α = (α₀ + n)/2 / rate, rate = (β₀ + Σe² + Σ Var score)/2."""
    if cfg.task == TASK_CLASSIFICATION:
        one = torch.ones((), dtype=dtype, device=state.e.device)
        return one, one.clone()
    e_all = (state.e * state.e).sum() + state.e_var_sum
    rate = (cfg.beta_0 + e_all) / 2.0
    return (cfg.alpha_0 + n_rows) / 2.0 / rate, rate


def vi_update_w0(state: VIState, cfg: VariationalConfig, n_rows: int):
    """(w0, Var w0, e) after w0's CAVI step."""
    quad = state.alpha * n_rows + cfg.reg_0
    lin = state.alpha * (n_rows * state.w0 - state.e.sum())
    w0_new = lin / quad
    return w0_new, 1.0 / quad, state.e + (w0_new - state.w0)


# ---------------------------------------------------------------------------
# linear-weight color steps (the Gibbs conditionals; mean assignment)
# ---------------------------------------------------------------------------


def _w_step(c: ColorPlan, xe, w, w_var, alpha, lam_col, mu_col, g):
    """(w, w_var, delta per slot) of one color given Σ x e per slot."""
    gf = take(g, c.feat)
    lam = lam_col[gf]
    mu = mu_col[gf]
    w_old = take(w, c.feat)
    quad = alpha * c.sx2 + lam
    lin = alpha * (c.sx2 * w_old - xe) + lam * mu
    w_new = lin / quad
    return (set_feat(w, c.feat, w_new), set_feat(w_var, c.feat, 1.0 / quad),
            w_new - w_old)


def _vi_w_color_main(c: ColorPlan, e, w, w_var, alpha, lam_col, mu_col, g):
    xe = seg_sum(c.vals * e[c.rows], c.seg, c.feat.shape[0])
    w, w_var, delta = _w_step(c, xe, w, w_var, alpha, lam_col, mu_col, g)
    e = e.index_add(0, c.rows, take(delta, c.seg) * c.vals)
    return e, w, w_var


def _vi_w_color_block(b: BlockPlan, c: ColorPlan, e, w, w_var, alpha,
                      lam_col, mu_col, g):
    """One block color's step: the stack fold over that color alone."""
    return _vi_w_block_stack(b, one_color(c), e, w, w_var, alpha, lam_col,
                             mu_col, g)


def _vi_w_block_stack(b: BlockPlan, stack: ColorStack, e, w, w_var, alpha,
                      lam_col, mu_col, g):
    """The block colors of ``stack`` in order, in O(block_size) per
    color: the conditional reads the residual only through its
    per-block-row sum e1, which evolves as e1 += cardinality · dxb; the
    [n_rows] residual is touched once after the loop."""
    card = b.cardinality
    e1 = block_sum(e, b)
    acc = e.new_zeros(b.block_size)
    for c in stack_colors(stack):
        xe = seg_sum(c.vals * e1[c.rows], c.seg, c.feat.shape[0])
        w, w_var, delta = _w_step(c, xe, w, w_var, alpha, lam_col, mu_col,
                                  g)
        dxb = e.new_zeros(b.block_size).index_add_(
            0, c.rows, take(delta, c.seg) * c.vals)
        e1 = e1 + card * dxb
        acc = acc + dxb
    return e + acc[b.mapper], w, w_var


def vi_sweep_w(plan: DesignPlan, e, w, w_var, alpha, lambda_w, mu_w):
    """Every linear weight's CAVI step, color by color."""
    g = plan.group_index
    for c in plan.main.colors + stack_colors(plan.main.color_stack):
        e, w, w_var = _vi_w_color_main(c, e, w, w_var, alpha, lambda_w,
                                       mu_w, g)
    for b in plan.blocks:
        for c in b.colors:
            e, w, w_var = _vi_w_color_block(b, c, e, w, w_var, alpha,
                                            lambda_w, mu_w, g)
        if b.color_stack is not None:
            e, w, w_var = _vi_w_block_stack(b, b.color_stack, e, w, w_var,
                                            alpha, lambda_w, mu_w, g)
    return e, w, w_var


# ---------------------------------------------------------------------------
# factor (V) color steps with variance corrections
# ---------------------------------------------------------------------------


def _V_solve(c: ColorPlan, S_h2, S_eh, S_qv, S_lcv, vo_f, v, s, alpha,
             lam_col, mu_col, g):
    """The CAVI step of one color's factor coordinates from its slot
    sums and old means ``vo_f``; returns (v, s, vn_f, sn_f)."""
    gf = take(g, c.feat)
    lam = lam_col[gf]
    mu = mu_col[gf]
    quad = alpha * (S_h2 + S_qv) + lam
    lin = alpha * (-S_eh + S_h2 * vo_f - S_lcv) + lam * mu
    vn_f = lin / quad
    sn_f = 1.0 / quad
    return (set_feat(v, c.feat, vn_f), set_feat(s, c.feat, sn_f), vn_f,
            sn_f)


def _vi_V_color_main(c: ColorPlan, carry, alpha, lam_col, mu_col, g):
    """CAVI conditional for V_{i,r} (variational.hpp:504-554):
    quad = α[Σ h̄² + Σ x² x2s₋ᵢ] + λ
    lin  = α[−Σ e h̄ + (Σ h̄²) v̄_old − Σ(h̄ x2s₋ᵢ − x x3sv₋ᵢ)] + λ μ
    """
    e, q, x2s, x3sv, v, s = carry
    n_seg = c.feat.shape[0]
    vo_f = take(v, c.feat)
    vo = take(vo_f, c.seg)
    so = take(take(s, c.feat), c.seg)
    x = c.vals
    x2 = x * x
    h = x * (q[c.rows] - x * vo)
    x2e = x2s[c.rows] - x2 * so  # exclude own variance
    x3e = x3sv[c.rows] - x2 * x * so * vo
    v, s, vn_f, sn_f = _V_solve(
        c, seg_sum(h * h, c.seg, n_seg),
        seg_sum(e[c.rows] * h, c.seg, n_seg),
        seg_sum(x2 * x2e, c.seg, n_seg),
        seg_sum(h * x2e - x * x3e, c.seg, n_seg),
        vo_f, v, s, alpha, lam_col, mu_col, g,
    )
    dseg = take(vn_f - vo_f, c.seg)
    sn = take(sn_f, c.seg)
    e = e.index_add(0, c.rows, dseg * h)
    q = q.index_add(0, c.rows, dseg * x)
    x2s = x2s.index_add(0, c.rows, x2 * (sn - so))
    x3sv = x3sv.index_add(0, c.rows,
                          x2 * x * (sn * take(vn_f, c.seg) - so * vo))
    return e, q, x2s, x3sv, v, s


def _block_aggregates(b: BlockPlan, e, q, x2s, x3sv):
    """The seven per-block-row aggregates a block color reads:
    (E1, Q1, Q2, EQ, X2S1, QX2S, X3SV1)."""
    return (block_sum(e, b), block_sum(q, b), block_sum(q * q, b),
            block_sum(e * q, b), block_sum(x2s, b),
            block_sum(q * x2s, b), block_sum(x3sv, b))


def _vi_V_color_block(b: BlockPlan, c: ColorPlan, carry, alpha, lam_col,
                      mu_col, g):
    """One block color's step: the stack fold over that color alone
    (its caches updated through the mapper once)."""
    return _vi_V_block_stack(b, one_color(c), carry, alpha, lam_col,
                             mu_col, g)


# The block color step's conditional, per slot, from sums over its
# entries: for block feature i with value x at block row m (card members,
# aggregates E1, Q1, Q2, EQ, X2S1, QX2S, X3SV1 over members j;
# variational.hpp:556-709),
#   Σ h̄²        = x²Q2 − 2x³v̄Q1 + x⁴v̄²card
#   Σ e h̄        = xEQ − x²v̄E1
#   Σ x² x2s₋ᵢ    = x²X2S1 − x⁴s̄card
#   Σ(h̄ x2s₋ᵢ − x x3sv₋ᵢ)
#                 = xQX2S − x³s̄Q1 − x²v̄X2S1 + 2x⁴s̄v̄card − xX3SV1,
# and quad = α[Σh̄² + Σx²x2s₋ᵢ] + λ, lin = α[(Σh̄²)v̄ − Σeh̄ − Σ(h̄x2s₋ᵢ −
# x x3sv₋ᵢ)] + λμ.  v̄ is one value per slot, so both brackets are sums
# over entries, of 5 and 10 terms (zero-padded to 2 x 10).  Each term is
# (aggregate row of [E1, Q1, Q2, EQ, X2S1, QX2S, X3SV1, card], power row
# of [x, x², x³, x⁴], row of [1, v̄, s̄, v̄², s̄v̄, v̄³], coefficient).
_S_TERMS = (
    (2, 1, 0, 1.0), (1, 2, 1, -2.0), (7, 3, 3, 1.0), (4, 1, 0, 1.0),
    (7, 3, 2, -1.0), None, None, None, None, None,
    (2, 1, 1, 1.0), (1, 2, 3, -2.0), (7, 3, 5, 1.0), (3, 0, 0, -1.0),
    (0, 1, 1, 1.0), (5, 0, 0, -1.0), (1, 2, 2, 1.0), (4, 1, 1, 1.0),
    (7, 3, 4, -2.0), (6, 0, 0, 1.0),
)
# The aggregates' evolution under a color's per-block-row constants
# (a, b2, c2, c3), old values on every right-hand side, as 7 x 5 terms:
# (row of [a, b2, c2, c3, a², a·b2, a·c2], aggregate row, coef).
#   E1   += a·Q1 − b2·card          Q1 += a·card
#   Q2   += 2a·Q1 + a²·card         EQ += a·(Q2+E1) + (a²−b2)·Q1 − a·b2·card
#   X2S1 += c2·card                 X3SV1 += c3·card
#   QX2S += a·X2S1 + c2·Q1 + a·c2·card
_AGG_TERMS = (
    (0, 1, 1.0), (1, 7, -1.0), None, None, None,
    (0, 7, 1.0), None, None, None, None,
    (0, 1, 2.0), (4, 7, 1.0), None, None, None,
    (0, 2, 1.0), (0, 0, 1.0), (4, 1, 1.0), (1, 1, -1.0), (5, 7, -1.0),
    (2, 7, 1.0), None, None, None, None,
    (0, 4, 1.0), (2, 1, 1.0), (6, 7, 1.0), None, None,
    (3, 7, 1.0), None, None, None, None,
)


def _vi_V_block_stack(b: BlockPlan, stack: ColorStack, carry, alpha,
                      lam_col, mu_col, g):
    """The block colors of ``stack`` in order, in O(block_size) per
    color: the CAVI conditional reads the row caches only through seven
    per-block-row aggregates, which evolve in closed form under each
    color's updates (``_AGG_TERMS``); the [n_rows] caches are rebuilt
    once after the loop from A = Σa, S = Σₖ aₖ·(Σ_{j<k} aⱼ), ΣB2, ΣC2
    and ΣC3.

    Every quantity that does not change along the loop (powers of x,
    term coefficients, priors per slot, clamped indices) is built for
    all colors at once, and each color's step works on stacked rows (the
    aggregates [8, B], (v̄, s) [2, F+1] with a scratch column for pad
    feature ids, the conditional's two sums [2, Pf]), so a color costs
    about fifty device operations."""
    e, q, x2s, x3sv, v, s = carry
    dev, dt = e.device, e.dtype
    B, F = b.block_size, v.shape[0]
    Pf = stack.feat.shape[1]
    rows = stack.rows.long()
    seg = stack.seg.long()
    seg_c = seg.clamp(max=Pf - 1)  # JAX's clamped gather of pad slots
    feat = stack.feat.long()
    x = stack.vals
    x2 = x * x
    xpow = torch.stack([x, x2, x2 * x, x2 * x2], dim=1)  # [C, 4, Pe]
    (agg_i, pow_i, dyn_i), coef = term_index(_S_TERMS, 4, dev)
    S_coef = torch.tensor(coef, dtype=dt, device=dev)[:, None]
    xterm = xpow[:, pow_i] * S_coef  # [C, 20, Pe]
    (l_i, r_i), coef = term_index(_AGG_TERMS, 3, dev)
    A_coef = torch.tensor(coef, dtype=dt, device=dev)[:, None]
    sq_i = torch.tensor([0, 0, 0], device=dev)
    sq_j = torch.tensor([0, 1, 2], device=dev)
    gf = g[feat.clamp(max=F - 1)]
    lam = lam_col[gf]  # [C, Pf]
    lam_mu = lam * mu_col[gf]
    ones = x.new_ones(x.shape[1])

    agg = torch.stack(
        list(_block_aggregates(b, e, q, x2s, x3sv)) + [b.cardinality]
    )  # [8, B]
    vs = torch.cat([torch.stack([v, s]), v.new_zeros(2, 1)], dim=1)
    acc = e.new_zeros(5, B)  # A, ΣB2, ΣC2, ΣC3, S
    for ci in range(rows.shape[0]):
        m, sg, sgc, ft = rows[ci], seg[ci], seg_c[ci], feat[ci]
        old_f = vs[:, ft]  # [2, Pf]: v̄, s of the color's features
        vo, so = old_f[:, sgc]  # per entry
        vo2 = vo * vo
        dyn = torch.stack([ones, vo, so, vo2, so * vo, vo2 * vo])
        terms = (xterm[ci] * dyn[dyn_i] * agg[agg_i[:, None], m]).view(
            2, 10, -1).sum(dim=1)
        quad_s, lin_s = x.new_zeros(2, Pf + 1).index_add_(
            1, sg, terms)[:, :Pf]
        quad = torch.addcmul(lam[ci], alpha, quad_s)
        lin = torch.addcmul(lam_mu[ci], alpha, lin_s)
        vn_f = lin / quad
        sn_f = 1.0 / quad
        vs[:, ft] = torch.stack([vn_f, sn_f])
        dseg, sn, vn = torch.stack([vn_f - old_f[0], sn_f, vn_f])[:, sgc]
        xc, x2c, x3c = xpow[ci, 0], xpow[ci, 1], xpow[ci, 2]
        u = x.new_zeros(4, B).index_add_(1, m, torch.stack([
            dseg * xc, dseg * x2c * vo, x2c * (sn - so),
            x3c * (sn * vn - dyn[4]),
        ]))  # per block row: a, b2, c2, c3
        lhs = torch.cat([u, u[sq_i] * u[sq_j]])  # + a², a·b2, a·c2
        agg[:7].add_((A_coef * lhs[l_i] * agg[r_i]).view(7, 5, B).sum(1))
        acc[4].add_(u[0] * acc[0])
        acc[:4].add_(u)
    am = acc[0][b.mapper]
    e = e + am * q + (acc[4] - acc[1])[b.mapper]
    return (e, q + am, x2s + acc[2][b.mapper], x3sv + acc[3][b.mapper],
            vs[0, :F], vs[1, :F])


def vi_V_factor(plan: DesignPlan, e, v_col, s_col, alpha, lam_r, mu_r):
    """One factor of the CAVI V sweep: (e, v_col, s_col) → updated."""
    g = plan.group_index
    q = _row_cache(plan, lambda x, col: x * take(v_col, col))
    x2s = _row_cache(plan, lambda x, col: x * x * take(s_col, col))
    x3sv = _row_cache(
        plan, lambda x, col: x * x * x * take(s_col, col) * take(v_col, col)
    )
    carry = (e, q, x2s, x3sv, v_col, s_col)
    for c in plan.main.colors + stack_colors(plan.main.color_stack):
        carry = _vi_V_color_main(c, carry, alpha, lam_r, mu_r, g)
    for b in plan.blocks:
        for c in b.colors:
            carry = _vi_V_color_block(b, c, carry, alpha, lam_r, mu_r, g)
        if b.color_stack is not None:
            carry = _vi_V_block_stack(b, b.color_stack, carry, alpha,
                                      lam_r, mu_r, g)
    return carry[0], carry[4], carry[5]


def vi_sweep_V(plan: DesignPlan, e, V, V_var, alpha, lambda_V, mu_V):
    """Every factor's CAVI steps, factor after factor."""
    rank = V.shape[1]
    if rank == 0:
        return e, V, V_var
    v_cols, s_cols = [], []
    for r in range(rank):
        e, v_new, s_new = vi_V_factor(
            plan, e, V[:, r], V_var[:, r], alpha, lambda_V[:, r],
            mu_V[:, r],
        )
        v_cols.append(v_new)
        s_cols.append(s_new)
    return e, torch.stack(v_cols, dim=1), torch.stack(s_cols, dim=1)


# ---------------------------------------------------------------------------
# e / Var(score) / ELBO refresh (variational.hpp:715-914)
# ---------------------------------------------------------------------------


def vi_e_var_linear(plan: DesignPlan, w0, w0_var, w, w_var):
    """Order-0/1 part of the residual/variance refresh."""
    e = w0 + linear_term(plan, w)
    e_var_sum = plan.n_rows * w0_var + _entry_weight_total(
        plan, lambda x, col: x * x * take(w_var, col)
    )
    return e, e_var_sum


def vi_e_var_factor(plan: DesignPlan, e, e_var_sum, v, s):
    """One factor's contribution to the residual/variance refresh
    (variational.hpp:715-833)."""

    def cache(fn):
        return _row_cache(plan, lambda x, col: fn(x, take(v, col),
                                                  take(s, col)))

    q = cache(lambda x, vc, sc: x * vc)
    q_s = cache(lambda x, vc, sc: x * x * vc * vc)
    x2s = cache(lambda x, vc, sc: x * x * sc)
    x3sv = cache(lambda x, vc, sc: x**3 * sc * vc)
    x4s2 = cache(lambda x, vc, sc: x**4 * sc * sc)
    x4sv2 = cache(lambda x, vc, sc: x**4 * sc * vc * vc)
    e = e + 0.5 * (q * q - q_s)
    # per-row Var of the pairwise term (variational.hpp:829-830)
    e_var_sum = e_var_sum + (
        q * q * x2s + 0.5 * x2s * x2s - 2.0 * x3sv * q
        - 0.5 * x4s2 + x4sv2
    ).sum()
    return e, e_var_sum


def vi_update_e_and_var(plan: DesignPlan, w0, w0_var, w, w_var, V, V_var):
    """(mean score per row, Σ_rows Var(score))."""
    e, e_var_sum = vi_e_var_linear(plan, w0, w0_var, w, w_var)
    for r in range(V.shape[1]):
        e, e_var_sum = vi_e_var_factor(plan, e, e_var_sum, V[:, r],
                                       V_var[:, r])
    return e, e_var_sum


def vi_update_e(plan: DesignPlan, state: VIState, y,
                cfg: VariationalConfig) -> VIState:
    e, e_var_sum = vi_update_e_and_var(
        plan, state.w0, state.w0_var, state.w, state.w_var, state.V,
        state.V_var,
    )
    return vi_finish_e(plan, state, e, e_var_sum, y, cfg)


def vi_finish_e(plan: DesignPlan, state: VIState, score, e_var_sum, y,
                cfg: VariationalConfig) -> VIState:
    """Task residual and ELBO given the refreshed (score, e_var_sum)."""
    e, _, elbo = finish_task(score, y, cfg)
    elbo = elbo - state.alpha * (
        cfg.beta_0 + (e * e).sum() + e_var_sum
    ) / 2.0
    elbo = _group_elbo_terms(plan, state, cfg, elbo)
    return dataclasses.replace(state, e=e, e_var_sum=e_var_sum, elbo=elbo)


def vi_sweep_stage_a(plan: DesignPlan, state: VIState,
                     cfg: VariationalConfig) -> VIState:
    """Hyperparameter and linear stages of the CAVI iteration
    (everything before the factor sweep)."""
    n = plan.n_rows
    alpha, alpha_rate = vi_update_alpha(state, cfg, n, state.e.dtype)
    state = dataclasses.replace(state, alpha=alpha, alpha_rate=alpha_rate)
    if cfg.fit_w0:
        w0, w0_var, e = vi_update_w0(state, cfg, n)
        state = dataclasses.replace(state, w0=w0, w0_var=w0_var, e=e)
    gi, gc = plan.group_index, plan.group_counts
    lambda_w, lambda_w_rate = vi_update_lambda(
        state.w, state.w_var, state.mu_w, state.mu_w_var, gi, gc, cfg)
    mu_w, mu_w_var = vi_update_mu(state.w, lambda_w, gi, gc, cfg)
    state = dataclasses.replace(
        state, lambda_w=lambda_w, lambda_w_rate=lambda_w_rate, mu_w=mu_w,
        mu_w_var=mu_w_var,
    )
    if cfg.fit_linear:
        e, w, w_var = vi_sweep_w(plan, state.e, state.w, state.w_var,
                                 state.alpha, state.lambda_w, state.mu_w)
        state = dataclasses.replace(state, e=e, w=w, w_var=w_var)
    lambda_V, lambda_V_rate = vi_update_lambda(
        state.V, state.V_var, state.mu_V, state.mu_V_var, gi, gc, cfg)
    mu_V, mu_V_var = vi_update_mu(state.V, lambda_V, gi, gc, cfg)
    return dataclasses.replace(
        state, lambda_V=lambda_V, lambda_V_rate=lambda_V_rate, mu_V=mu_V,
        mu_V_var=mu_V_var,
    )


def vi_sweep(plan: DesignPlan, state: VIState, y,
             cfg: VariationalConfig) -> VIState:
    """One full row-space CAVI iteration.  The input state is not
    modified."""
    state = vi_sweep_stage_a(plan, state, cfg)
    e, V, V_var = vi_sweep_V(plan, state.e, state.V, state.V_var,
                             state.alpha, state.lambda_V, state.mu_V)
    state = dataclasses.replace(state, e=e, V=V, V_var=V_var)
    return vi_update_e(plan, state, y, cfg)
