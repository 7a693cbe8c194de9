"""Entity-space Gibbs sweep for all-categorical designs (fast path).

PyTorch counterpart of ``myfm_tpu/ops/categorical.py``, for the
regression, classification (probit) and ordered-probit tasks.  Because
every table is one-hot per row, the residual and the factor sums are
functions of the small per-entity weight tables,

    score_n = w0 + Σ_t w_t[c_t(n)] + ½ Σ_r (Q_nr² − QS_nr),
    Q_n = Σ_t V_t[c_t(n)],  QS_n = Σ_t V_t[c_t(n)]²,  e_n = score_n − y_n,

so each table pass rebuilds (e, φ) in its own tile space from gathers
of the other tables' [w | V | qs] rows, computes every entity's Gram
G_u = Σ_{n∈u} z zᵀ, z = [1 | e | φ] (ops/gram.py), and draws the
table's weights from those statistics in entity space:

    card = G[0,0], E1 = G[0,1], Sφ_r = G[0,2+r],
    EQ_r = G[1,2+r], Sφ²_r = G[2+r,2+r], Σφ_rφ_s = G[2+r,2+s].

Update order: α → w0 → λ_w/μ_w → λ_V/μ_V → per table {w_t, V_t factor
scan}.  α and w0 need only the carried residual moments Σe and Σe²,
which the last table pass refreshes exactly from its Gram statistics.
The probit tasks fix α = 1 and regress on a latent target τ instead of
y: after the table passes they score every row, redraw τ (and, ordered,
the cutpoints by MH first) and take the moments from the new residual;
each table pass reads τ gathered into its tile order.

An entity+attribute table (``plan.side[t]``: a block's rows as entities,
with per-entity side features) enters the other tables' passes through
its effective rows [w̃ | Ṽ | qs̃] (``eff_tables``), and its own pass
(``_ea_table_pass``) draws the side features' joint [w_j | V_j] rows
color by color from its Gram, through kernel 4 on the card.

A sweep is two steps: ``draw_sweep_variates`` draws every standard
variate of the sweep from a ``torch.Generator``, and
``categorical_sweep`` applies them, so a test can inject the TPU
package's own variates.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..design_categorical import CategoricalPlan, CategoricalTable
from ..parallel.collectives import psum, psum_many
from .gibbs import (
    GibbsConfig,
    GibbsState,
    TASK_CLASSIFICATION,
    TASK_ORDERED,
    TASK_REGRESSION,
    _draw_normal,
    draw_lambda,
    draw_latent_variates,
    draw_mu,
    lambda_gamma_shape,
    refresh_latent,
    std_gamma,
    std_normal,
)
from .forward import matmul_fp32, take
from .gram import fused_tile_gram_cross, fused_tile_gram_cross_reference
from .joint import _scatter_rows
from .joint_tail import joint_tail_pass, joint_tail_pass_reference
from .oprobit import OprobitVariates, initialize_oprobit_core


@dataclasses.dataclass
class CategoricalState:
    """GibbsState plus the latent target tau (None for regression, where
    y is used directly) and the carried residual moments
    sum_e = Σe, sum_e2 = Σe²."""

    core: GibbsState
    tau: Optional[torch.Tensor]
    sum_e: torch.Tensor
    sum_e2: torch.Tensor


@dataclasses.dataclass
class SweepVariates:
    """Every standard variate one sweep consumes, in the order the TPU
    package splits its key (categorical.py:771-816); the probit tasks
    add the latent uniforms (and, ordered, each cutpoint group's MH
    variates) and draw no α variate."""

    gamma_alpha: Optional[torch.Tensor]  # scalar, Gamma((α₀+n)/2, 1)
    normal_w0: torch.Tensor  # scalar
    gamma_lambda_w: torch.Tensor  # [G]
    normal_mu_w: torch.Tensor  # [G]
    gamma_lambda_V: torch.Tensor  # [G, 1] (one variate per group)
    normal_mu_V: torch.Tensor  # [G, R]
    noise_w: torch.Tensor  # [F]
    noise_V: torch.Tensor  # [F, R]
    u_latent: Optional[torch.Tensor] = None  # [N] probit tasks
    oprobit: Optional[Tuple[OprobitVariates, ...]] = None  # per group


def draw_sweep_variates(plan: CategoricalPlan, cfg: GibbsConfig,
                        rank: int, generator: torch.Generator,
                        dtype: torch.dtype, device) -> SweepVariates:
    """Draw one sweep's standard variates from ``generator``."""
    G = plan.n_groups
    F = plan.n_features
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
    v = SweepVariates(
        gamma_alpha=gamma_alpha,
        normal_w0=normal(()),
        gamma_lambda_w=std_gamma(lambda_gamma_shape(1, counts, cfg),
                                 generator),
        normal_mu_w=normal((G,)),
        gamma_lambda_V=std_gamma(lambda_gamma_shape(2, counts, cfg),
                                 generator),
        normal_mu_V=normal((G, rank)),
        noise_w=normal((F,)),
        noise_V=normal((F, rank)),
    )
    v.u_latent, v.oprobit = draw_latent_variates(
        cfg, plan, generator, dtype, device)
    return v


def _pad_zero_row(arr: torch.Tensor) -> torch.Tensor:
    """Append one all-zero row so pad indices gather zeros in bounds."""
    return torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])


def _table_slice(W: torch.Tensor, t: CategoricalTable) -> torch.Tensor:
    return W[t.col_offset : t.col_offset + t.n_cols]


def _wv_source(w, V, t2: CategoricalTable) -> torch.Tensor:
    """Table t2's [w | V | qs] rows ([B+1, 2+R], zero pad row last);
    qs = Σ_r V² is precomputed once per entity so the Gram kernel adds
    one column instead of squaring every gathered row."""
    V_t = _table_slice(V, t2)
    return _pad_zero_row(
        torch.cat(
            [
                _table_slice(w, t2)[:, None],
                V_t,
                (V_t * V_t).sum(dim=1, keepdim=True),
            ],
            dim=1,
        )
    )


def _wv_rows(w, V, t2: CategoricalTable, idx: torch.Tensor):
    """Gather [w_t2 | V_t2 | qs_t2] rows by entity index (pad -> 0)."""
    return _wv_source(w, V, t2)[idx]


def _side_eff(si, w, V) -> torch.Tensor:
    """One entity+attribute table's effective rows [B, 2+R] (eff_tables)."""
    fc = si.feat_cols.long()
    w_s, V_s = w[fc], V[fc]
    xs = si.xs
    return torch.cat(
        [
            matmul_fp32(xs, w_s[:, None]),
            matmul_fp32(xs, V_s),
            matmul_fp32(xs * xs, V_s * V_s).sum(dim=1, keepdim=True),
        ],
        dim=1,
    )


def eff_tables(plan: CategoricalPlan, w, V):
    """Per-table effective entity rows.

    ``None`` for a one-hot table, whose [w_t | V_t] slices are the
    per-entity rows.  For an entity+attribute table (plan.side[t]) the
    dense per-entity reduction of the side weights,

        w̃_u = Xs[u,:]·w_s,  Ṽ_u = Xs[u,:]@V_s,
        qs_u = Σ_r Σ_i Xs²[u,i] V_s²[i,r]   (the true per-entity Σ x²V²),

    packed as [B, 2+R] = [w̃ | Ṽ | qs], the layout ``_wv_source`` gives
    one-hot tables."""
    return [None if si is None else _side_eff(si, w, V) for si in plan.side]


def _eff_source(w, V, t2: CategoricalTable, eff2) -> torch.Tensor:
    """Table t2's gather source of [w | V | qs] rows ([B+1, 2+R], zero
    pad row last): its own slices, or its effective rows ``eff2``."""
    if eff2 is None:
        return _wv_source(w, V, t2)
    return _pad_zero_row(eff2)


def _eff_rows(w, V, t2: CategoricalTable, eff2, idx: torch.Tensor):
    """Table t2's [w | V | qs] rows at entity ids ``idx``."""
    return _eff_source(w, V, t2, eff2)[idx]


def _score_parts(plan: CategoricalPlan, w, V, w0, ent_maps, ones,
                 eff=None):
    """(score, Q) at the rows addressed by ent_maps[t2] for each table;
    ``ones`` masks pad rows (only needed for the w0 term)."""
    rank = V.shape[1]
    n = ent_maps[0].shape[0]
    if eff is None:
        eff = eff_tables(plan, w, V)
    lin = V.new_zeros(n)
    Q = V.new_zeros(n, rank)
    qs_sum = V.new_zeros(n)
    for t2, eff2, idx in zip(plan.tables, eff, ent_maps):
        g = _eff_rows(w, V, t2, eff2, idx)  # [n, 2+R] = [w | V | qs]
        lin = lin + g[:, 0]
        Q = Q + g[:, 1 : 1 + rank]
        qs_sum = qs_sum + g[:, 1 + rank]
    score = ones * w0 + lin
    if rank:
        score = score + 0.5 * ((Q * Q).sum(dim=1) - qs_sum)
    return score, Q


def score_rows(plan: CategoricalPlan, w0, w, V,
               row_chunk: int = 1 << 20):
    """Forward pass in main row order, chunked over rows so peak memory
    stays O(row_chunk · R)."""
    t0 = plan.tables[0]
    eff = eff_tables(plan, w, V)
    out = []
    for r0 in range(0, plan.n_rows, row_chunk):
        ms = [t.ent_main[r0 : r0 + row_chunk] for t in plan.tables]
        ones = (ms[0] < t0.n_cols).to(V.dtype)
        s, _ = _score_parts(plan, w, V, w0, ms, ones, eff)
        out.append(s)
    return torch.cat(out)


def score_and_q(plan: CategoricalPlan, w0, w, V):
    """(score [N], Q [N, R]) in main row order (unchunked)."""
    t0 = plan.tables[0]
    ones = (t0.ent_main < t0.n_cols).to(V.dtype)
    ent_maps = [t.ent_main for t in plan.tables]
    return _score_parts(plan, w, V, w0, ent_maps, ones)


def table_gram_operands(
    plan: CategoricalPlan,
    ti: int,
    w: torch.Tensor,
    V: torch.Tensor,
    eff,
    own_rows: torch.Tensor,  # [B, 2+R] own per-entity [w | V | qs]
    tau_tile: torch.Tensor,  # [NT] target in this table's tile order
):
    """Yield, per chunk of ``chunk_tiles`` tiles of table ti, the Gram
    kernel's operands (aux2, gths, wvsl, cont_in, cont_out, last_slot)
    built from the current weights."""
    t = plan.tables[ti]
    D = V.shape[1] + 2
    K = t.n_tiles
    T = t.tile_rows
    # own-table rows per (tile, slot): tiny ([K, S, 2+R]); the kernel
    # rebuilds the own contribution from these, so own rows are never
    # gathered at [N] scale
    wvsl = _pad_zero_row(own_rows)[t.ent_slots]
    others = [
        (_eff_source(w, V, t2, eff[t2i]), plan.cross_ent[ti][t2i])
        for t2i, t2 in enumerate(plan.tables)
        if t2i != ti
    ]
    slot_f = t.slot_f.view(K, T)
    tau = tau_tile.view(K, T)
    for k0 in range(0, K, t.chunk_tiles):
        k1 = min(K, k0 + t.chunk_tiles)
        # the OTHER tables' gathered [w | V | qs] rows feed the kernel
        # as they are; it sums their lin / Q / qs contributions itself
        gths = [
            src[m[k0 * T : k1 * T]].view(k1 - k0, T, D)
            for src, m in others
        ]
        aux2 = torch.stack([slot_f[k0:k1], tau[k0:k1]], dim=1)
        yield (aux2, gths, wvsl[k0:k1], t.cont_in[k0:k1],
               t.cont_out[k0:k1], t.last_slot[k0:k1])


def _build_table_gram(
    plan: CategoricalPlan,
    ti: int,
    w: torch.Tensor,
    V: torch.Tensor,
    eff,
    own_rows: torch.Tensor,  # [B, 2+R] own per-entity [w | V | qs]
    tau_tile: torch.Tensor,  # [NT] target in this table's tile order
    plain: bool,
    fast_matmul=False,
):
    """Per-entity Gram G_u = Σ_{n∈u} z zᵀ, z = [1 | e⁰ | φ_other], for
    table ti, built chunk by chunk of tiles from the current weights, in
    the Gram mode ``fast_matmul`` (the resolved ``cfg.gram_fast_matmul``;
    ops/gram.gram_mode), for one-hot and entity+attribute tables alike.

    e⁰ EXCLUDES w0: consumers apply the exact rank-1 correction
    z₁ += w0·z₀ to the Gram statistics (_entity_draws).  ``plain``
    computes the Grams with the plain PyTorch version of the kernel on
    any device (the kernel-vs-plain comparisons on the card)."""
    t = plan.tables[ti]
    D = V.shape[1] + 2
    S = t.tile_entities
    max_fin = t.max_fin
    gram = fused_tile_gram_cross_reference if plain else fused_tile_gram_cross
    G = V.new_zeros(t.n_cols, D, D)
    carry = V.new_zeros(D, D)
    chunks = table_gram_operands(plan, ti, w, V, eff, own_rows, tau_tile)
    for c, (aux2, gths, wvsl, ci, co, ls) in enumerate(chunks):
        flat, carry = gram(aux2, gths, wvsl, ci, co, ls, S, carry,
                           fast_matmul=fast_matmul)
        # consume this chunk's finalized entities into G over their
        # contiguous id window; the full [K*S, D, D] partial array
        # never exists
        vals = flat[t.fin_idx[c]]  # [max_fin, D, D]
        win = int(t.fin_win[c])
        msk = (t.fin_mask[c] > 0)[:, None, None]
        G[win : win + max_fin] = torch.where(
            msk, vals, G[win : win + max_fin]
        )
    return G


def _table_pass(
    plan: CategoricalPlan,
    ti: int,
    w: torch.Tensor,  # [F]
    V: torch.Tensor,  # [F, R]
    w0,
    alpha,
    lambda_w,
    mu_w,
    lambda_V,
    mu_V,
    group_index,
    noise_w,  # [F]
    noise_V,  # [F, R]
    tau_tile,  # [NT] target in this table's tile order (pad 0)
    cfg: GibbsConfig,
    plain: bool = False,
    want_moments: bool = False,
    eff=None,
):
    """One table's w draw + factor scan; returns new (w, V, moments).

    ``moments`` (when requested — the sweep's last table) is the exact
    post-draw (Σe, Σe²), computed purely from Gram statistics."""
    t = plan.tables[ti]
    off, B = t.col_offset, t.n_cols

    w_t = _table_slice(w, t)
    V_t = _table_slice(V, t)
    g_t = group_index[off : off + B]
    if eff is None:
        eff = eff_tables(plan, w, V)

    own_rows = torch.cat(
        [w_t[:, None], V_t, (V_t * V_t).sum(dim=1, keepdim=True)], dim=1
    )
    G = _build_table_gram(plan, ti, w, V, eff, own_rows, tau_tile, plain,
                          cfg.gram_fast_matmul or False)
    nw_t, nV_t = noise_w[t.noise_feat], noise_V[t.noise_feat]
    axis = cfg.axis
    if (axis is not None and cfg.gram_reduce_scatter and axis.size > 1
            and B % axis.size == 0):
        # each rank receives the summed Gram of its own entity window
        # only, draws that window's weights (the noise is per feature, so
        # the draws do not depend on which rank makes them) and the
        # [Bw, 1+R] draws are all-gathered: ~D²/(1+R) fewer bytes than
        # an all-reduce of the [B, D, D] Gram
        Bw = B // axis.size
        win = slice(axis.index * Bw, (axis.index + 1) * Bw)
        w_win, V_win, parts = _entity_draws(
            axis.psum_scatter(G), w0, w_t[win], V_t[win], g_t[win], alpha,
            lambda_w, mu_w, lambda_V, mu_V, nw_t[win], nV_t[win], cfg,
            want_moments,
        )
        wv = axis.all_gather(torch.cat([w_win[:, None], V_win], dim=1))
        w_new, V_new = wv[:, 0], wv[:, 1:]
        if want_moments:
            parts = axis.psum_many(*parts)
    else:
        # the rank's partial Grams sum to the whole design's; the draws
        # below are then the same on every rank
        w_new, V_new, parts = _entity_draws(
            psum(G, axis), w0, w_t, V_t, g_t, alpha, lambda_w, mu_w,
            lambda_V, mu_V, nw_t, nV_t, cfg, want_moments,
        )
    w = w.clone()
    V = V.clone()
    w[off : off + B] = w_new
    V[off : off + B] = V_new
    return w, V, (parts if want_moments else None)


def _entity_draws(G, w0, w_t, V_t, g_t, alpha, lambda_w, mu_w,
                  lambda_V, mu_V, noise_w_t, noise_V_t, cfg,
                  want_moments):
    """Per-entity w draw + factor scan from the Gram statistics.

    The kernel builds G over z = [1 | e⁰ | φ] with e⁰ = e − w0; the
    true-residual statistics follow exactly from z₁ = z₁⁰ + w0·z₀:
        E1 = E1⁰ + w0·card,  Σeφ_r = Σe⁰φ_r + w0·Σφ_r,
        Σe² = Σe⁰² + 2·w0·E1⁰ + w0²·card.
    Returns (w_new, V_new, (Σe, Σe²) or None)."""
    rank = V_t.shape[1]
    card = G[:, 0, 0]
    Sphi = G[:, 0, 2:]  # [B, R]
    E1_0 = G[:, 0, 1]  # Σ e⁰ (w0-less residual)
    E1 = E1_0 + w0 * card
    EQphi0 = G[:, 1, 2:] + w0 * Sphi  # [B, R] pre-draw Σ e φ

    lam_w = lambda_w[g_t]
    mu_wg = mu_w[g_t]

    # --- linear weight draw -------------------------------------------
    if cfg.fit_linear:
        quad = alpha * card + lam_w
        lin = alpha * (card * w_t - E1) + lam_w * mu_wg
        w_new = _draw_normal(quad, lin, noise_w_t)
        dw = w_new - w_t
        # e_n += dw_u  ->  EQ_r += dw * Sphi_r
        EQphi = EQphi0 + dw[:, None] * Sphi
    else:
        w_new = w_t
        dw = torch.zeros_like(w_t)
        EQphi = EQphi0

    # --- factor scan in entity space, chunked ------------------------
    # Sequential per-coordinate draws over factors; the cross-factor
    # coupling EQ_s += δ_r G[r, s] is applied densely within a chunk of
    # C factors and to later chunks with one einsum per chunk.
    if rank:
        C = min(8, rank)
        lam_V = lambda_V[g_t]  # [B, R]
        mu_Vg = mu_V[g_t]  # [B, R]
        v_new_cols = []
        EQ_corr = torch.zeros_like(EQphi)
        for c0 in range(0, rank, C):
            c1 = min(c0 + C, rank)
            Gc = G[:, 2 + c0 : 2 + c1, 2:]  # [B, c, R]
            EQ_chunk = (EQphi + EQ_corr)[:, c0:c1].clone()
            deltas = []
            for j in range(c1 - c0):
                r = c0 + j
                diag_r = Gc[:, j, r]
                v_old = V_t[:, r]
                quad = alpha * diag_r + lam_V[:, r]
                lin = (
                    alpha * (diag_r * v_old - EQ_chunk[:, j])
                    + lam_V[:, r] * mu_Vg[:, r]
                )
                v_new = _draw_normal(quad, lin, noise_V_t[:, r])
                delta = v_new - v_old
                if j + 1 < c1 - c0:
                    EQ_chunk[:, j + 1 :] += (
                        delta[:, None] * Gc[:, j, r + 1 : c1]
                    )
                v_new_cols.append(v_new)
                deltas.append(delta)
            if c1 < rank:
                delta_c = torch.stack(deltas, dim=1)  # [B, c]
                EQ_corr[:, c1:] += torch.einsum(
                    "bc,bcr->br", delta_c, Gc[:, :, c1:]
                )
        V_new = torch.stack(v_new_cols, dim=1)  # [B, R]
    else:
        V_new = V_t

    parts = None
    if want_moments:
        dV = V_new - V_t  # [B, R]
        E2 = (
            G[:, 1, 1].sum()
            + 2.0 * w0 * E1_0.sum()
            + w0 * w0 * card.sum()
        )
        dphi = (dV * Sphi).sum(dim=1)  # [B] Σ_r δ_r Sφ_r
        sum_e = E1.sum() + (dw * card).sum() + dphi.sum()
        cross = (dw * E1).sum() + (dV * EQphi0).sum()
        quad_term = (
            (dw * dw * card).sum()
            + 2.0 * (dw * dphi).sum()
            + torch.einsum("br,brs,bs->", dV, G[:, 2:, 2:], dV)
        )
        sum_e2 = E2 + 2.0 * cross + quad_term
        parts = (sum_e, sum_e2)

    return w_new, V_new, parts


def ea_flat_gram(G: torch.Tensor, w0, own: torch.Tensor) -> torch.Tensor:
    """An entity+attribute table's kernel Gram [B, D, D] over
    z = [1 | e⁰ | φ_other] as the color scan's flat lanes-major Gram
    [D², B] over [1 | e | Q]: G' = M G Mᵀ with M = I + v e₀ᵀ and
    v = [0, w0, Ṽ_u] (the kernel's e⁰ lacks w0, and Q = φ + Ṽ), both
    rank-1 additions of the z₀ column.  ``own`` is the table's
    effective rows [w̃ | Ṽ | qs̃].  The result is symmetrized: the
    additions round Ĝ[i, j] and Ĝ[j, i] in different orders, and the
    tail kernel reads the upper triangle where the plain steps read both
    (as ``ops/joint.build_block_gram``)."""
    B = own.shape[0]
    v = torch.cat(
        [own.new_zeros((B, 1)),
         torch.as_tensor(w0, dtype=own.dtype, device=own.device).expand(B, 1),
         own[:, 1:-1]],
        dim=1,
    )  # [B, D]
    G = (
        G
        + v[:, :, None] * G[:, 0:1, :]
        + G[:, :, 0:1] * v[:, None, :]
        + (v[:, :, None] * v[:, None, :]) * G[:, 0:1, 0:1]
    )
    G = 0.5 * (G + G.transpose(1, 2))
    return G.reshape(B, -1).T.contiguous()


def ea_scan_operands(si, w, V, lambda_w, mu_w, lambda_V, mu_V,
                     group_index, noise_w, noise_V):
    """The side features' pre-gathered (u0, lam, mu, xi), [C, Pf, R+1]
    each, over the color stack ``si.stack_feat`` (pad id F gathers the
    last row, as JAX's clamped gathers do; its draws are dropped)."""
    feat = si.stack_feat
    gidx = take(group_index, feat)
    return (
        take(torch.cat([w[:, None], V], dim=1), feat),
        take(torch.cat([lambda_w[:, None], lambda_V], dim=1), gidx),
        take(torch.cat([mu_w[:, None], mu_V], dim=1), gidx),
        take(torch.cat([noise_w[:, None], noise_V], dim=1), feat),
    )


def ea_color_scan(Gf, xw, segb, u0, lam, mu, xi, alpha, D,
                  kernel: bool = False):
    """The side features' colors in order on the flat Gram Gf [D², B]:
    each color draws its features' (R+1)-rows, then Ĝ ← T Ĝ Tᵀ — the
    joint engine's tail (``joint_tail_pass``, the CUDA kernel, when
    ``kernel``; else its plain version) with a zero Atot/Ct carry, which
    the Gram's evolution does not read and whose results are dropped.
    Returns (Gf, u_new [C, Pf, R+1])."""
    tail = joint_tail_pass if kernel else joint_tail_pass_reference
    B = Gf.shape[1]
    Gf, _, _, u_all = tail(Gf, Gf.new_zeros((D - 2, B)), Gf.new_zeros((B,)),
                           xw, segb, u0, lam, mu, xi, alpha, D)
    return Gf, u_all


def _ea_table_pass(
    plan: CategoricalPlan,
    ti: int,
    w: torch.Tensor,  # [F]
    V: torch.Tensor,  # [F, R]
    w0,
    alpha,
    lambda_w,
    mu_w,
    lambda_V,
    mu_V,
    group_index,
    noise_w,  # [F]
    noise_V,  # [F, R]
    tau_tile,  # [NT] target in this table's tile order (pad 0)
    cfg: GibbsConfig,
    plain: bool = False,
    want_moments: bool = False,
    eff=None,
    scan_kernel: bool = False,
):
    """Entity+attribute table pass: every side feature's [w_j | V_j] row
    drawn from its (R+1)-dim joint conditional, one color of the side
    columns at a time, in entity space; returns (w, V, moments).

    Kernel 1 builds the per-entity Gram over z = [1 | e⁰ | φ_other] with
    the table's effective rows as its own rows (``plain``: its plain
    version); ``ea_flat_gram`` turns it into the per-block-row Gram over
    [1 | e | Q] that the joint engine's dense color machinery evolves,
    Ĝ ← T Ĝ Tᵀ per color, so later colors and the returned moments see
    the exact post-draw statistics.  ``scan_kernel`` runs the colors
    through kernel 4 (``ea_color_scan``).  ``moments`` (the sweep's last
    table) is (Σe, Σe²) of the scanned Gram: flat rows 1 and D+1."""
    si = plan.side[ti]
    rank = V.shape[1]
    D = rank + 2
    if eff is None:
        eff = eff_tables(plan, w, V)
    own = eff[ti]  # [B, 2+R] = [w̃ | Ṽ | qs̃]
    G = _build_table_gram(plan, ti, w, V, eff, own, tau_tile, plain,
                          cfg.gram_fast_matmul or False)
    # side features couple the table's entities, so a sharded chain
    # sums the whole Gram (no window) and every rank runs the same scan
    Gf = ea_flat_gram(psum(G, cfg.axis), w0, own)
    ops = ea_scan_operands(si, w, V, lambda_w, mu_w, lambda_V, mu_V,
                           group_index, noise_w, noise_V)
    alpha_t = torch.as_tensor(alpha, dtype=V.dtype, device=V.device)
    Gf, u_all = ea_color_scan(Gf, si.stack_xw, si.stack_segb, *ops,
                              alpha_t, D, kernel=scan_kernel)
    U = _scatter_rows(torch.cat([w[:, None], V], dim=1),
                      si.stack_feat.reshape(-1), u_all.reshape(-1, rank + 1))
    moments = None
    if want_moments:
        moments = (Gf[1].sum(), Gf[D + 1].sum())
    return U[:, 0], U[:, 1:], moments


def sweep_hypers(plan: CategoricalPlan, state: CategoricalState,
                 v: SweepVariates, cfg: GibbsConfig):
    """A sweep's draws before its table passes, in the TPU package's
    order: α (1 for the probit tasks) from the carried Σe², w0 from Σe,
    then λ_w, μ_w, λ_V, μ_V.  Returns (alpha, w0, lambda_w, mu_w,
    lambda_V, mu_V)."""
    core = state.core
    n = plan.n_real
    if cfg.task == TASK_REGRESSION:
        # α | e ~ Gamma((α₀+n)/2, rate=(β₀+Σe²)/2) from the carried moment
        alpha = v.gamma_alpha / ((cfg.beta_0 + state.sum_e2) / 2.0)
    else:
        alpha = torch.ones_like(core.w0)
    w0 = core.w0
    if cfg.fit_w0:
        quad = alpha * n + cfg.reg_0
        lin = alpha * (n * w0 - state.sum_e)
        w0 = _draw_normal(quad, lin, v.normal_w0)
    gi, gc = plan.group_index, plan.group_counts
    lambda_w = draw_lambda(core.w, core.mu_w, gi, gc, cfg, v.gamma_lambda_w)
    mu_w = draw_mu(core.w, lambda_w, gi, gc, cfg, v.normal_mu_w)
    lambda_V = draw_lambda(core.V, core.mu_V, gi, gc, cfg,
                           v.gamma_lambda_V)
    mu_V = draw_mu(core.V, lambda_V, gi, gc, cfg, v.normal_mu_V)
    return alpha, w0, lambda_w, mu_w, lambda_V, mu_V


def categorical_sweep(
    plan: CategoricalPlan,
    state: CategoricalState,
    y: torch.Tensor,
    y_tiles: Tuple[torch.Tensor, ...],
    variates: SweepVariates,
    cfg: GibbsConfig,
    plain: bool = False,
) -> CategoricalState:
    """One full Gibbs iteration on the categorical fast path, applying
    the given standard ``variates``.  ``y_tiles[t]`` is y gathered to
    table t's tile order (make_y_tiles, once per fit; the probit tasks
    gather their latent τ instead, every sweep).  ``y`` holds ±1 for
    classification and the encoded integer classes for the ordered
    task.  ``plain`` builds every Gram with kernel 1's plain version;
    ``cfg.joint_tail_kernel`` (resolved by the trainer) runs the
    entity+attribute color scans through kernel 4.  The input state is
    not modified."""
    core = state.core
    v = variates

    alpha, w0, lambda_w, mu_w, lambda_V, mu_V = sweep_hypers(
        plan, state, v, cfg)
    gi = plan.group_index
    tau_tiles = (y_tiles if cfg.task == TASK_REGRESSION
                 else make_y_tiles(plan, state.tau))

    w, V = core.w, core.V
    n_tables = len(plan.tables)
    moments = None
    regression = cfg.task == TASK_REGRESSION
    eff = eff_tables(plan, w, V)
    for ti in range(n_tables):
        last = ti == n_tables - 1
        args = (plan, ti, w, V, w0, alpha, lambda_w, mu_w, lambda_V, mu_V,
                gi, v.noise_w, v.noise_V, tau_tiles[ti], cfg, plain)
        if plan.side[ti] is None:
            w, V, moments = _table_pass(
                *args, want_moments=regression and last, eff=eff)
            continue
        w, V, moments = _ea_table_pass(
            *args, want_moments=regression and last, eff=eff,
            scan_kernel=bool(cfg.joint_tail_kernel),
        )
        if not last:
            # this table's effective rows for the passes still to come
            eff = list(eff)
            eff[ti] = _side_eff(plan.side[ti], w, V)

    new_core = GibbsState(
        w0=w0, w=w, V=V, e=core.e, alpha=alpha,
        mu_w=mu_w, lambda_w=lambda_w, mu_V=mu_V, lambda_V=lambda_V,
        cutpoints=core.cutpoints, oprobit_alpha=core.oprobit_alpha,
        n_mh_accept=core.n_mh_accept,
    )
    if regression:
        # the last table pass computed the exact post-sweep moments in
        # entity space; no residual refresh is needed
        sum_e, sum_e2 = moments
        return CategoricalState(
            core=new_core, tau=None, sum_e=sum_e, sum_e2=sum_e2
        )
    # the probit tasks redraw the latent target per row, which needs
    # the score
    score = score_rows(plan, w0, w, V)
    e, cutpoints, oprobit_alpha, n_mh_accept = refresh_latent(
        score, y, core, cfg, v.u_latent, v.oprobit,
    )
    new_core = dataclasses.replace(
        new_core, e=e, cutpoints=cutpoints, oprobit_alpha=oprobit_alpha,
        n_mh_accept=n_mh_accept,
    )
    sum_e, sum_e2 = psum_many(cfg.axis, e.sum(), (e * e).sum())
    return CategoricalState(
        core=new_core, tau=score - e, sum_e=sum_e, sum_e2=sum_e2
    )


def init_categorical_state(
    plan: CategoricalPlan, core: GibbsState, y: torch.Tensor,
    cfg: GibbsConfig, u_latent: Optional[torch.Tensor] = None,
) -> CategoricalState:
    """The residual, its moments and the latent τ from freshly
    initialised weights: e = score − y for regression and (±1-coded)
    classification, whose τ starts at y; for the ordered task the
    Newton MAP cutpoints and a latent draw from the uniforms
    ``u_latent``."""
    score = score_rows(plan, core.w0, core.w, core.V)
    tau = None
    if cfg.task == TASK_ORDERED:
        core, e = initialize_oprobit_core(score, core, y, cfg, u_latent)
        tau = score - e
    else:
        e = score - y
        core = dataclasses.replace(core, e=e)
        if cfg.task == TASK_CLASSIFICATION:
            tau = y.clone()
    sum_e, sum_e2 = psum_many(cfg.axis, e.sum(), (e * e).sum())
    return CategoricalState(
        core=core, tau=tau, sum_e=sum_e, sum_e2=sum_e2
    )


def make_y_tiles(plan: CategoricalPlan, y: torch.Tensor):
    """Per-table tile-order copies of y (once per fit) or of the latent
    τ (once per sweep): device gathers, pad rows 0."""
    y_pad = _pad_zero_row(y[:, None])[:, 0]
    return tuple(y_pad[t.src] for t in plan.tables)
