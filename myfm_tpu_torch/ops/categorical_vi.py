"""Entity-space CAVI for all-categorical designs (the VI fast path).

PyTorch counterpart of ``myfm_tpu/ops/categorical_vi.py`` for the
regression and the probit classification task.  Same architecture as the Gibbs fast path
(ops/categorical.py): for one-hot tables every per-row cache is a
function of the small per-entity tables, so each table pass rebuilds its
state in tile space from cross-table gathers and needs one Gram per
entity, over the variational second-moment columns:

    z = [1 | e | φ_1..R | σ_1..R | τ_1..R],   D = 3R + 2,

where (per row, excluding the own table; x = 1 everywhere)
    φ_r = Σ_other V̄_r        (factor mean sum)
    σ_r = Σ_other s_r        (factor variance sum)
    τ_r = Σ_other s_r V̄_r.

The CAVI conditionals read only the Gram rows [1 | e | φ], so kernel 1
(ops/gram.py ``fused_tile_gram_cross`` in its VI layout) emits the
[2 + R, D] rectangle.  Per entity (reference variational.hpp:450-554 at
x = 1):

    w:    quad = α·card + λ_w,     lin = α(card·w̄ − E1) + λ_w μ_w
    V_r:  quad = α(Σφ_r² + Σσ_r) + λ
          lin  = α(−Σeφ_r + (Σφ_r²)v̄ − (Σφ_rσ_r − Στ_r)) + λμ

Entity+attribute tables (block rows carrying side features) are updated
color by color in entity space (``_vi_ea_table_pass``): kernel 2
(``fused_tile_gram``) builds each block row's Gram over the same
z = [1 | e | φ | σ | τ] (D = 3R + 2) from the other tables, the own
contribution is folded in, and every color's exact sequential CAVI
updates are followed by the Ĝ ← T Ĝ Tᵀ evolution.  With side values x
the variance columns are σ = Σ x² s and τ = Σ x³ s v̄ (the reference's
x2s / x3sv caches).  Here the port departs from the TPU package, whose
entity+attribute Gram carries a = Σ x s and b = Σ x² s v̄ in their place
(D = 4R + 2): those are a power of x short in the covariance term, so
its color updates are not coordinate maximisers when x ∉ {0, 1} and the
ELBO falls (ML-100k timeSVD++ features; ROADMAP Queue C).  For x ∈ {0, 1}
the two agree exactly.

Update order: α → w0 → λ_w/μ_w → λ_V/μ_V → per table {w_t, V_t factor
scan} → (e, Var, ELBO) refresh.  Every update is the exact coordinate-wise
maximiser, so the ELBO is non-decreasing.  For the classification task α
stays 1 and the Gram's target column carries the latent probit means τ
of the previous refresh (``CategoricalVIState.tau``, gathered per tile)
in place of y.  Each pass takes ``plain`` to run the kernels' plain
PyTorch versions on any device (the comparisons on the card).  The
multi-device branches of the TPU package are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..design_categorical import CategoricalPlan, CategoricalTable
from ..parallel.collectives import psum, psum_many
from .categorical import _pad_zero_row, _table_slice, make_y_tiles
from .gibbs import TASK_REGRESSION
from .gram import (
    fused_tile_gram,
    fused_tile_gram_cross,
    fused_tile_gram_cross_reference,
    fused_tile_gram_reference,
)
from .variational import (
    VariationalConfig,
    VIState,
    _group_elbo_terms,
    finish_task,
    vi_update_lambda,
    vi_update_mu,
)


@dataclasses.dataclass
class CategoricalVIState:
    """VIState plus the latent mean target tau [N] (None for regression,
    where y is used directly)."""

    core: VIState
    tau: Optional[torch.Tensor]


def _ext_source(w, w_var, V, V_var, t2: CategoricalTable) -> torch.Tensor:
    """Table t2's [w | w_var | V | s | sV | qs] rows ([B+1, 3+3R], zero
    pad row last); qs = Σ_r V̄² is precomputed in the [B]-sized source so
    the consumers never square-and-reduce gathered rows."""
    V_t = _table_slice(V, t2)
    s_t = _table_slice(V_var, t2)
    return _pad_zero_row(torch.cat(
        [
            _table_slice(w, t2)[:, None], _table_slice(w_var, t2)[:, None],
            V_t, s_t, s_t * V_t, (V_t * V_t).sum(dim=1, keepdim=True),
        ],
        dim=1,
    ))


@dataclasses.dataclass
class _VIEff:
    """Per-entity VI reductions of one entity+attribute table's side
    features (reference second/fourth-moment caches,
    variational.hpp:556-833).  With xs the dense [B, Fs] side matrix and
    w̄ / w_var / V̄ / s the side features' posterior moments:

        ext  [B, 2+3R]: [Σxw̄ | Σx²wvar | Σxv̄ | σ = Σx²s | τ = Σx³sv̄]
        qs   [B]:       Σ_r Σ x²v̄²
        x4s2 [B]:       Σ_r Σ x⁴ s²    (refresh A4)
        x4sv2 [B]:      Σ_r Σ x⁴ s v̄² (refresh A7)
    """

    ext: torch.Tensor
    qs: torch.Tensor
    x4s2: torch.Tensor
    x4sv2: torch.Tensor


def vi_eff_tables(plan: CategoricalPlan, w, w_var, V, V_var):
    """Per-table VI effective arrays: None for one-hot tables, a
    ``_VIEff`` for entity+attribute tables."""
    out: List[Optional[_VIEff]] = []
    for si in plan.side:
        if si is None:
            out.append(None)
            continue
        fc = si.feat_cols.long()
        w_s, wv_s, V_s, s_s = w[fc], w_var[fc], V[fc], V_var[fc]
        xs = si.xs
        xs2 = xs * xs
        xs3 = xs2 * xs
        xs4 = xs2 * xs2
        ext = torch.cat(
            [
                (xs @ w_s)[:, None], (xs2 @ wv_s)[:, None], xs @ V_s,
                xs2 @ s_s, xs3 @ (s_s * V_s),
            ],
            dim=1,
        )
        out.append(_VIEff(
            ext=ext,
            qs=(xs2 @ (V_s * V_s)).sum(dim=1),
            x4s2=(xs4 @ (s_s * s_s)).sum(dim=1),
            x4sv2=(xs4 @ (s_s * V_s * V_s)).sum(dim=1),
        ))
    return out


def _vi_source(w, w_var, V, V_var, t2: CategoricalTable,
               eff2: Optional[_VIEff]) -> torch.Tensor:
    """Table t2's per-entity [w | w_var | V | σ | τ | qs] rows ([B+1,
    3+3R], zero pad row last): its own slices for a one-hot table, its
    side reductions for an entity+attribute table."""
    if eff2 is None:
        return _ext_source(w, w_var, V, V_var, t2)
    return _pad_zero_row(torch.cat([eff2.ext, eff2.qs[:, None]], dim=1))


def _consume_chunk(G, flat, t: CategoricalTable, c: int, rows_r: int):
    """Write chunk c's finalized entities' Gram rectangles into G over
    their contiguous id window (the full [K*S, ...] partial array never
    exists)."""
    vals = flat[t.fin_idx[c]][:, :rows_r, :]
    win = int(t.fin_win[c])
    sl = slice(win, win + t.max_fin)
    msk = (t.fin_mask[c] > 0)[:, None, None]
    G[sl] = torch.where(msk, vals, G[sl])


def vi_gram_operands(plan: CategoricalPlan, ti: int, w, w_var, V, V_var,
                     tau_tile, eff=None):
    """Yield, per chunk of ``chunk_tiles`` tiles of one-hot table ti,
    kernel 1's VI-layout operands (aux2, gths, wvsl, cont_in, cont_out,
    last_slot) built from the current moments."""
    t = plan.tables[ti]
    rank = V.shape[1]
    K, T = t.n_tiles, t.tile_rows
    if eff is None:
        eff = [None] * len(plan.tables)
    V_t = _table_slice(V, t)
    # own [w | V | qs] rows per (tile, slot) for in-kernel reconstruction
    wvsl = _pad_zero_row(torch.cat(
        [_table_slice(w, t)[:, None], V_t,
         (V_t * V_t).sum(dim=1, keepdim=True)], dim=1,
    ))[t.ent_slots]  # [K, S, 2+R]
    # the other tables' raw [ext | qs] rows feed the kernel as they are
    # (q_lo=2, n_extra=2R: the σ/τ columns ride the z block)
    sources = [
        (_vi_source(w, w_var, V, V_var, t2, eff[t2i]),
         plan.cross_ent[ti][t2i])
        for t2i, t2 in enumerate(plan.tables) if t2i != ti
    ]
    W_gth = 3 + 3 * rank
    slot_f = t.slot_f.view(K, T)
    tau = tau_tile.view(K, T)
    for k0 in range(0, K, t.chunk_tiles):
        k1 = min(K, k0 + t.chunk_tiles)
        gths = [src[m[k0 * T : k1 * T]].view(k1 - k0, T, W_gth)
                for src, m in sources]
        aux2 = torch.stack([slot_f[k0:k1], tau[k0:k1]], dim=1)
        yield (aux2, gths, wvsl[k0:k1], t.cont_in[k0:k1],
               t.cont_out[k0:k1], t.last_slot[k0:k1])


def vi_table_gram(plan: CategoricalPlan, ti: int, w, w_var, V, V_var,
                  tau_tile, eff=None, plain: bool = False,
                  fast_matmul=False):
    """Per-entity Gram rectangles [B, 2+R, 3R+2] of one-hot table ti over
    z = [1 | e⁰ | φ | σ | τ] (e⁰ without w0), built chunk by chunk of
    tiles through kernel 1's VI layout in Gram mode ``fast_matmul``."""
    t = plan.tables[ti]
    rank = V.shape[1]
    rows_r = 2 + rank
    gram = fused_tile_gram_cross_reference if plain else fused_tile_gram_cross
    G = V.new_zeros(t.n_cols, rows_r, 3 * rank + 2)
    carry = V.new_zeros(rows_r, 3 * rank + 2)
    chunks = vi_gram_operands(plan, ti, w, w_var, V, V_var, tau_tile, eff)
    for c, (aux2, gths, wvsl, ci, co, ls) in enumerate(chunks):
        flat, carry = gram(aux2, gths, wvsl, ci, co, ls, t.tile_entities,
                           carry, q_lo=2, n_extra=2 * rank,
                           out_rows=rows_r, fast_matmul=fast_matmul)
        _consume_chunk(G, flat, t, c, rows_r)
    return G


def _vi_entity_updates(G, w0, w_t, wv_t, V_t, s_t, g_t, alpha, lambda_w,
                       mu_w, lambda_V, mu_V, cfg: VariationalConfig):
    """Per-entity CAVI w update + factor scan from the Gram statistics.

    The kernel builds G over z = [1 | e⁰ | ...] with e⁰ = e − w0; the
    true-residual statistics follow exactly from z₁ = z₁⁰ + w0·z₀:
    E1 = E1⁰ + w0·card and Σeφ_r = Σe⁰φ_r + w0·Σφ_r.
    Returns (w_new, w_var_new, V_new, V_var_new)."""
    rank = V_t.shape[1]
    card = G[:, 0, 0]
    Sphi = G[:, 0, 2 : 2 + rank]  # [B, R]
    E1 = G[:, 0, 1] + w0 * card
    EQphi = G[:, 1, 2 : 2 + rank] + w0 * Sphi
    Ssig = G[:, 0, 2 + rank : 2 + 2 * rank]
    Stau = G[:, 0, 2 + 2 * rank : 2 + 3 * rank]

    lam_w = lambda_w[g_t]
    mu_wg = mu_w[g_t]
    if cfg.fit_linear:
        quad = alpha * card + lam_w
        lin = alpha * (card * w_t - E1) + lam_w * mu_wg
        w_new = lin / quad
        wv_new = 1.0 / quad
        dw = w_new - w_t
        EQphi = EQphi + dw[:, None] * Sphi
    else:
        w_new, wv_new = w_t, wv_t

    if not rank:
        return w_new, wv_new, V_t, s_t
    C = min(8, rank)
    lam_V = lambda_V[g_t]
    mu_Vg = mu_V[g_t]
    v_new_cols, s_new_cols = [], []
    EQ_corr = torch.zeros_like(EQphi)
    for c0 in range(0, rank, C):
        c1 = min(c0 + C, rank)
        Gc = G[:, 2 + c0 : 2 + c1, 2 : 2 + rank]  # [B, c, R]
        # the φσ cross block for this factor chunk (its diagonal is read)
        Gps = G[:, 2 + c0 : 2 + c1, 2 + rank : 2 + 2 * rank]
        EQ_chunk = (EQphi + EQ_corr)[:, c0:c1].clone()
        deltas = []
        for j in range(c1 - c0):
            r = c0 + j
            Sphi2_r = Gc[:, j, r]
            v_old = V_t[:, r]
            quad = alpha * (Sphi2_r + Ssig[:, r]) + lam_V[:, r]
            lin = (
                alpha * (
                    -EQ_chunk[:, j]
                    + Sphi2_r * v_old
                    - (Gps[:, j, r] - Stau[:, r])
                )
                + lam_V[:, r] * mu_Vg[:, r]
            )
            v_new = lin / quad
            delta = v_new - v_old
            if j + 1 < c1 - c0:
                EQ_chunk[:, j + 1 :] += delta[:, None] * Gc[:, j, r + 1 : c1]
            v_new_cols.append(v_new)
            s_new_cols.append(1.0 / quad)
            deltas.append(delta)
        if c1 < rank:
            EQ_corr[:, c1:] += torch.einsum(
                "bc,bcr->br", torch.stack(deltas, dim=1), Gc[:, :, c1:]
            )
    return (w_new, wv_new, torch.stack(v_new_cols, dim=1),
            torch.stack(s_new_cols, dim=1))


def _write_table(W, new, t: CategoricalTable):
    W = W.clone()
    W[t.col_offset : t.col_offset + t.n_cols] = new
    return W


def _vi_table_pass(plan: CategoricalPlan, ti: int, w, w_var, V, V_var,
                   w0, alpha, lambda_w, mu_w, lambda_V, mu_V, group_index,
                   tau_tile, cfg: VariationalConfig, eff=None,
                   plain: bool = False):
    """One one-hot table's CAVI w update + factor scan in entity space;
    returns the new (w, w_var, V, V_var)."""
    t = plan.tables[ti]
    G = vi_table_gram(plan, ti, w, w_var, V, V_var, tau_tile, eff, plain,
                      cfg.gram_fast_matmul or False)
    g_t = group_index[t.col_offset : t.col_offset + t.n_cols]
    old = (_table_slice(w, t), _table_slice(w_var, t), _table_slice(V, t),
           _table_slice(V_var, t))
    axis, B = cfg.axis, t.n_cols
    if (axis is not None and cfg.gram_reduce_scatter and axis.size > 1
            and B % axis.size == 0):
        # as the Gibbs pass: each rank updates its entity window from the
        # reduce-scattered Gram and the updates are all-gathered
        Bw = B // axis.size
        win = slice(axis.index * Bw, (axis.index + 1) * Bw)
        new = _vi_entity_updates(
            axis.psum_scatter(G), w0, *(a[win] for a in old), g_t[win],
            alpha, lambda_w, mu_w, lambda_V, mu_V, cfg)
        rank = V.shape[1]
        cat = axis.all_gather(torch.cat(
            [new[0][:, None], new[1][:, None], new[2], new[3]], dim=1))
        w_new, wv_new = cat[:, 0], cat[:, 1]
        V_new, s_new = cat[:, 2 : 2 + rank], cat[:, 2 + rank :]
    else:
        w_new, wv_new, V_new, s_new = _vi_entity_updates(
            psum(G, axis), w0, *old, g_t, alpha, lambda_w, mu_w, lambda_V,
            mu_V, cfg,
        )
    return (_write_table(w, w_new, t), _write_table(w_var, wv_new, t),
            _write_table(V, V_new, t), _write_table(V_var, s_new, t))


def _update_gram_lanes_u(G, s_vec, u_vec, D):
    """Ĝ ← T Ĝ Tᵀ in flat lanes-major [rows_r·D, B] layout for the VI
    entity+attribute transform T = I + e₁ sᵀ + u e₀ᵀ (the [rows_r, D]
    rectangle of the symmetric Ĝ; the variance columns' per-update shifts
    are constant per block row and ride z₀ = 1 through u).  Expansion (g = Ĝs, r₀ = Ĝe₀):
        Ĝ' = Ĝ + e₁pᵀ + pe₁ᵀ + urᵀ + ruᵀ,
        p = g + (sᵀr₀)u + ½(sᵀg)e₁,   r = r₀ + ½Ĝ₀₀u."""
    B = G.shape[1]
    rows_r = G.shape[0] // D
    Gr = G.view(rows_r, D, B)
    # g[j, b] = Σ_k Ĝ[k, j, b] s[k, b] over the rectangle's rows (s lives
    # on rows {0, q} ⊂ rect; Ĝ is symmetric, so this is Ĝ·s over all j)
    g = (Gr * s_vec[:rows_r, None, :]).sum(dim=0)  # [D, B]
    sgs = (s_vec * g).sum(dim=0)
    p = g + g[0:1] * u_vec
    p[1] += 0.5 * sgs
    col0 = G[0:D]  # Ĝ[0, :] = Ĝ[:, 0] by symmetry, [D, B]
    r = col0 + 0.5 * col0[0:1] * u_vec
    e1_i = (torch.arange(rows_r, device=G.device) == 1).to(G.dtype)
    e1_j = (torch.arange(D, device=G.device) == 1).to(G.dtype)
    corr = (
        e1_i[:, None, None] * p[None]
        + p[:rows_r, None] * e1_j[None, :, None]
        + u_vec[:rows_r, None] * r[None]
        + r[:rows_r, None] * u_vec[None]
    )
    return G + corr.view(rows_r * D, B)


def _vi_dense_color_step(G, xw, segb, u0, s0, lam, mu, alpha, rank,
                         fit_linear: bool):
    """One entity+attribute VI color: exact sequential CAVI updates of
    every feature's (w, V_1..V_R) coordinates, vectorized over the color's
    features (row-disjoint), followed by the Ĝ ← T Ĝ Tᵀ evolution so
    later colors see exact post-update statistics.

    ``G`` is the flat lanes-major [rows_r·D, B] Gram rectangle over
    z = [1 | e | q (R) | σ (R) | τ (R)], D = 3R+2, with σ = Σ x² s and
    τ = Σ x³ s v̄ over all features (own-feature borders subtracted
    below).  For coordinate v = V_jr the score is c_n + h_n v with
    h = x φ_r (φ_r = q_r − x v̄_jr), so the CAVI update is
        quad = α Σ x²(φ̄² + σ⁻ʲ) + λ,
        lin  = α Σ(−h̄e + v̄(h̄² + Var h) − Cov(h, score)) + λμ,
    with Cov(h, score) = x_j[q̄_r(σ_r − x_j² s_jr) − (τ_r − x_j³ s_jr v̄_jr)]
    (reference variational.hpp:450-713 with its x2s / x3sv caches).
    Sequential exactness inside a feature: the w update shifts Σxeφ_r by
    Δw·Σx²φ_r, factor r shifts Σxeφ_r' by Δv_r·Σx²φ_rφ_r'.

    Every term but that Σxeφ recurrence reads only pre-color values (the
    q columns hold them until the evolution), so they are computed for
    all R factors at once as [R, Pf] and [R, R, Pf] tensors; only the
    recurrence runs as a loop of R steps.
    Returns (u_new [Pf, 1+R], var_new [Pf, 1+R], G)."""
    dtype = G.dtype
    Pf = u0.shape[0]
    R = rank
    D = 3 * R + 2
    B = xw.shape[0]

    oh = torch.nn.functional.one_hot(segb.long(), Pf + 1)[:, :Pf].to(dtype)
    x2 = xw * xw
    x3 = x2 * xw
    wq = torch.cat(
        [x2[:, None] * oh, x3[:, None] * oh, (x2 * x2)[:, None] * oh,
         xw[:, None] * oh],
        dim=1,
    )  # [B, 4Pf]
    rows_r = G.shape[0] // D  # [1 | e | q] rectangle rows (= 2+R)
    TT = (G @ wq).view(rows_r, D, 4 * Pf)
    G2 = TT[..., :Pf]  # Σx²Ĝ [rows_r, D, Pf]
    S30 = TT[0, :, Pf : 2 * Pf]  # Σx³Ĝ[0, :] [D, Pf]
    x4c = TT[0, 0, 2 * Pf : 3 * Pf]  # Σx⁴ [Pf]
    W1 = TT[..., 3 * Pf :]  # ΣxĜ [rows_r, D, Pf]

    card2 = G2[0, 0]
    s3c = S30[0]
    sxe = W1[1, 0]  # Σxe
    sx2e = G2[0, 1]  # Σx²e

    w_old = u0[:, 0]
    vT = u0[:, 1:].T  # [R, Pf] v̄ (old)
    sT = s0[:, 1:].T  # [R, Pf] s (old)
    lam_w, mu_w = lam[:, 0], mu[:, 0]
    lam_V, mu_V = lam[:, 1:].T, mu[:, 1:].T

    q = slice(2, 2 + R)
    sg = slice(2 + R, 2 + 2 * R)  # σ columns
    tau = slice(2 + 2 * R, 2 + 3 * R)  # τ columns
    # Σx²φ_r and Σxeφ_r with the v̄ borders (φ_r = q_r − x v̄_jr)
    Sphi = G2[0, q] - vT * s3c
    Exephi = W1[1, q] - vT * sx2e
    if fit_linear:
        quad_w = alpha * card2 + lam_w
        lin_w = alpha * (card2 * w_old - sxe) + lam_w * mu_w
        w_new = lin_w / quad_w
        wv_new = 1.0 / quad_w
        dw = w_new - w_old
        Exephi = Exephi + dw * Sphi
    else:
        w_new, wv_new = w_old, s0[:, 0]
        dw = torch.zeros_like(w_old)

    if R:
        Gqq = G2[q, q]  # [R, R, Pf]
        S30q = S30[q]  # [R, Pf]
        Sphi2 = (
            torch.diagonal(Gqq, dim1=0, dim2=1).T
            - 2.0 * vT * S30q
            + vT * vT * x4c
        )
        sig = G2[0, sg] - sT * x4c  # Σx²σ⁻ʲ
        quad = alpha * (Sphi2 + sig) + lam_V
        covx = (
            torch.diagonal(W1[q, sg], dim1=0, dim2=1).T
            - sT * S30q
            - W1[0, tau]
            + sT * vT * x4c
        )
        vS, vsig, lmu = vT * Sphi2, vT * sig, lam_V * mu_V
        # Σx²φ_rφ_r' with both borders at the old v̄
        cross = (
            Gqq
            - vT[:, None] * S30q[None, :]
            - vT[None, :] * S30q[:, None]
            + vT[:, None] * vT[None, :] * x4c
        )
        S_new = 1.0 / quad
        v_new_l, dv_l = [], []
        for r in range(R):
            lin = alpha * (-Exephi[r] + vS[r] + vsig[r] - covx[r]) + lmu[r]
            v_new = lin / quad[r]
            dv = v_new - vT[r]
            if r + 1 < R:
                Exephi[r + 1 :] = Exephi[r + 1 :] + dv * cross[r, r + 1 :]
            v_new_l.append(v_new)
            dv_l.append(dv)
        dV = torch.stack(dv_l)  # [R, Pf]
        V_new = torch.stack(v_new_l)
        dS = S_new - sT
        dSV = S_new * V_new - sT * vT
        c0 = (vT * dV).sum(dim=0)  # v̄_old·Δv per feature
    else:
        dV = V_new = S_new = dS = dSV = G.new_zeros(0, Pf)
        c0 = G.new_zeros(Pf)

    # B-space update coefficients (one feature per row within a color)
    dwB = oh @ dw
    c0B = oh @ c0
    a0 = xw * dwB - x2 * c0B
    A_q = (oh @ dV.T).T * xw[None]
    dS_B = (oh @ dS.T).T
    dSV_B = (oh @ dSV.T).T
    zeros1 = G.new_zeros(1, B)
    s_vec = torch.cat(
        [a0[None], zeros1, A_q, G.new_zeros(2 * R, B)], dim=0
    )
    u_vec = torch.cat(
        [
            zeros1, zeros1, A_q,
            dS_B * x2[None],  # Δσ = x² Δs
            dSV_B * x3[None],  # Δτ = x³ Δ(s v̄)
        ],
        dim=0,
    )
    G = _update_gram_lanes_u(G, s_vec, u_vec, D)
    u_new = torch.cat([w_new[:, None], V_new.T], dim=1)
    var_new = torch.cat([wv_new[:, None], S_new.T], dim=1)
    return u_new, var_new, G


def vi_ea_gram_operands(plan: CategoricalPlan, ti: int, w, w_var, V,
                        V_var, w0, tau_tile, eff):
    """Yield, per chunk of ``chunk_tiles`` tiles of entity+attribute
    table ti, kernel 2's operands (meta, q_other, slot, wvsl, cont_in,
    cont_out, last_slot): the OTHER tables' contributions summed into
    meta = [ones | w0 + lin − τ | qs] and q_other = [φ_o | σ_o | τ_o],
    and the own [w̃ | Ṽ] rows per slot."""
    t = plan.tables[ti]
    rank = V.shape[1]
    K, T = t.n_tiles, t.tile_rows
    own = eff[ti]
    # own mean rows [w̃ | Ṽ] for in-kernel score reconstruction, and the
    # own QS − Q̃² correction folded into the qs operand
    wvsl = _pad_zero_row(torch.cat(
        [own.ext[:, 0:1], own.ext[:, 2 : 2 + rank]], dim=1
    ))[t.ent_slots]  # [K, S, 1+R]
    ds_pad = _pad_zero_row(
        own.qs - (own.ext[:, 2 : 2 + rank] ** 2).sum(dim=1)
    )
    sources = [
        (_vi_source(w, w_var, V, V_var, t2, eff[t2i]),
         plan.cross_ent[ti][t2i])
        for t2i, t2 in enumerate(plan.tables) if t2i != ti
    ]
    slot = t.slot.view(K, T)
    for k0 in range(0, K, t.chunk_tiles):
        k1 = min(K, k0 + t.chunk_tiles)
        r0, r1 = k0 * T, k1 * T
        acc = None  # Σ over the other tables of [w | w_var | V | σ | τ | qs]
        for src, m in sources:
            rows = src[m[r0:r1]]
            acc = rows if acc is None else acc + rows
        ones_c = (t.src[r0:r1] < plan.n_rows).to(V.dtype)
        qs_o = acc[:, 2 + 3 * rank] + ds_pad[t.ent_of_tile_row[r0:r1]]
        lin_tau = ones_c * w0 + acc[:, 0] - tau_tile[r0:r1]
        meta = torch.stack([ones_c, lin_tau, qs_o], dim=1).view(k1 - k0, T, 3)
        q_ext = acc[:, 2 : 2 + 3 * rank].contiguous().view(
            k1 - k0, T, 3 * rank)
        yield (meta, q_ext, slot[k0:k1], wvsl[k0:k1], t.cont_in[k0:k1],
               t.cont_out[k0:k1], t.last_slot[k0:k1])


def vi_ea_table_gram(plan: CategoricalPlan, ti: int, w, w_var, V, V_var,
                     w0, tau_tile, eff, plain: bool = False,
                     fast_matmul=False):
    """Per-block-row Gram rectangles [B, 2+R, 3R+2] of entity+attribute
    table ti over z = [1 | e | φ_o | σ_o | τ_o] from the OTHER tables'
    contributions (e includes w0 here), built chunk by chunk of tiles
    through kernel 2 in Gram mode ``fast_matmul``."""
    t = plan.tables[ti]
    rank = V.shape[1]
    rows_r = 2 + rank
    gram = fused_tile_gram_reference if plain else fused_tile_gram
    G = V.new_zeros(t.n_cols, rows_r, 3 * rank + 2)
    carry = V.new_zeros(rows_r, 3 * rank + 2)
    chunks = vi_ea_gram_operands(plan, ti, w, w_var, V, V_var, w0,
                                 tau_tile, eff)
    for c, ops in enumerate(chunks):
        flat, carry = gram(*ops, t.tile_entities, carry, out_rows=rows_r,
                           fast_matmul=fast_matmul)
        _consume_chunk(G, flat, t, c, rows_r)
    return G


def _vi_ea_table_pass(plan: CategoricalPlan, ti: int, w, w_var, V, V_var,
                      w0, alpha, lambda_w, mu_w, lambda_V, mu_V,
                      group_index, tau_tile, cfg: VariationalConfig, eff,
                      plain: bool = False):
    """Entity+attribute table pass: the side features' coordinates are
    updated color by color in entity space, with variance bookkeeping.
    Returns the new (w, w_var, V, V_var)."""
    si = plan.side[ti]
    rank = V.shape[1]
    D = 3 * rank + 2
    rows_r = 2 + rank
    B = plan.tables[ti].n_cols
    own = eff[ti]
    G = psum(vi_ea_table_gram(plan, ti, w, w_var, V, V_var, w0, tau_tile,
                              eff, plain, cfg.gram_fast_matmul or False),
             cfg.axis)

    # own-contribution conversion: z_total = z + U·z₀ with per-entity
    # U = [0, 0, Ṽ, σ̃, τ̃]  ⇒  G ← G + U g₀ᵀ + g₀ Uᵀ + G₀₀ UUᵀ
    U_conv = torch.cat([V.new_zeros(B, 2), own.ext[:, 2:]], dim=1)
    U_r = U_conv[:, :rows_r]  # = [0, 0, Ṽ] (the σ/τ rows are outside)
    col0 = G[:, :, 0:1]
    G = (
        G
        + U_r[:, :, None] * G[:, 0:1, :]
        + col0 * U_conv[:, None, :]
        + (U_r[:, :, None] * U_conv[:, None, :]) * G[:, 0:1, 0:1]
    )
    Gf = G.reshape(B, rows_r * D).T.contiguous()  # lanes-major

    # per-color pre-gathered moments and priors
    feat = si.stack_feat.long()  # [C, Pf], pad = F
    F = plan.n_features

    def gather(table):
        return _pad_zero_row(table)[feat]

    gidx = _pad_zero_row(group_index[:, None])[feat][..., 0]
    u0 = gather(torch.cat([w[:, None], V], dim=1))
    s0 = gather(torch.cat([w_var[:, None], V_var], dim=1))
    lam_s = torch.cat([lambda_w[:, None], lambda_V], dim=1)[gidx]
    mu_s = torch.cat([mu_w[:, None], mu_V], dim=1)[gidx]
    u_all, var_all = [], []
    for ci in range(feat.shape[0]):
        u_new, var_new, Gf = _vi_dense_color_step(
            Gf, si.stack_xw[ci], si.stack_segb[ci], u0[ci], s0[ci],
            lam_s[ci], mu_s[ci], alpha, rank, bool(cfg.fit_linear),
        )
        u_all.append(u_new)
        var_all.append(var_new)
    flat_feat = feat.reshape(-1)
    keep = flat_feat < F  # pad slots are dropped
    idx = flat_feat[keep]
    u_flat = torch.cat(u_all)[keep]
    var_flat = torch.cat(var_all)[keep]
    w, w_var, V, V_var = w.clone(), w_var.clone(), V.clone(), V_var.clone()
    w[idx] = u_flat[:, 0]
    w_var[idx] = var_flat[:, 0]
    V[idx] = u_flat[:, 1:]
    V_var[idx] = var_flat[:, 1:]
    return w, w_var, V, V_var


def vi_refresh_rows(plan: CategoricalPlan, w0, w0_var, w, w_var, V, V_var,
                    row_chunk: int = 1 << 20, eff=None):
    """(score [N], Σ_rows Var(score)) in one chunked streaming pass
    (reference update_e_and_var, variational.hpp:715-833); on a sharded
    plan the rank's rows' scores and the sum over this rank's rows.  Per factor
    the pairwise term f = ½(q² − Σx²V²) has
    Var(f) = q̄²·A2 − 2q̄·A5 + ½A2² − ½A4 + A7 with A2 = Σx²s,
    A5 = Σx³sv̄, A4 = Σx⁴s², A7 = Σx⁴sv̄²; entity+attribute tables supply
    the power-weighted sums through ``eff``."""
    rank = V.shape[1]
    t0 = plan.tables[0]
    if eff is None:
        eff = [None] * len(plan.tables)
    sources = []
    for t2, eff2 in zip(plan.tables, eff):
        if eff2 is None:
            sources.append(_ext_source(w, w_var, V, V_var, t2))
        else:
            sources.append(_pad_zero_row(torch.cat(
                [eff2.ext, eff2.qs[:, None], eff2.x4s2[:, None],
                 eff2.x4sv2[:, None]], dim=1)))
    scores = []
    evs = V.new_zeros(())
    for r0 in range(0, plan.n_rows, row_chunk):
        ms = [t.ent_main[r0 : r0 + row_chunk] for t in plan.tables]
        n = ms[0].shape[0]
        ones = (ms[0] < t0.n_cols).to(V.dtype)
        lin = V.new_zeros(n)
        wvar_s = V.new_zeros(n)
        Q = V.new_zeros(n, rank)
        QS = V.new_zeros(n)
        X2S = V.new_zeros(n, rank)
        X3SV = V.new_zeros(n, rank)
        X4S2 = V.new_zeros(n)
        X4SV2 = V.new_zeros(n)
        for src, eff2, idx in zip(sources, eff, ms):
            rows = src[idx]
            gth = rows[:, : 2 + 3 * rank]
            Vg = gth[:, 2 : 2 + rank]
            sg = gth[:, 2 + rank : 2 + 2 * rank]
            svg = gth[:, 2 + 2 * rank : 2 + 3 * rank]
            QS = QS + rows[:, 2 + 3 * rank]
            if eff2 is None:
                X4S2 = X4S2 + (sg * sg).sum(dim=1)
                X4SV2 = X4SV2 + (svg * Vg).sum(dim=1)
            else:
                X4S2 = X4S2 + rows[:, 3 + 3 * rank]
                X4SV2 = X4SV2 + rows[:, 4 + 3 * rank]
            lin = lin + gth[:, 0]
            wvar_s = wvar_s + gth[:, 1]
            Q = Q + Vg
            X2S = X2S + sg
            X3SV = X3SV + svg
        score = ones * w0 + lin
        var_row = ones * w0_var + wvar_s
        if rank:
            score = score + 0.5 * ((Q * Q).sum(dim=1) - QS)
            var_row = (
                var_row
                + (Q * Q * X2S - 2.0 * X3SV * Q).sum(dim=1)
                + 0.5 * (X2S * X2S).sum(dim=1)
                - 0.5 * X4S2
                + X4SV2
            )
        scores.append(score)
        evs = evs + (var_row * ones).sum()
    return torch.cat(scores), evs


def categorical_vi_sweep(
    plan: CategoricalPlan,
    state: CategoricalVIState,
    y: torch.Tensor,
    y_tiles: Tuple[torch.Tensor, ...],
    cfg: VariationalConfig,
    plain: bool = False,
) -> CategoricalVIState:
    """One full CAVI iteration on the entity-space fast path.  ``y_tiles``
    is y in each table's tile order (ops/categorical.make_y_tiles); the
    classification task gathers the state's τ the same way.  The input
    state is not modified."""
    core = state.core
    dtype = core.V.dtype
    n = plan.n_real

    sum_e, sum_e2 = psum_many(cfg.axis, core.e.sum(),
                              (core.e * core.e).sum())
    if cfg.task == TASK_REGRESSION:
        alpha_rate = (cfg.beta_0 + (sum_e2 + core.e_var_sum)) / 2.0
        alpha = torch.tensor((cfg.alpha_0 + n) / 2.0, dtype=dtype,
                             device=core.V.device) / alpha_rate
        tau_tiles = y_tiles
    else:
        alpha = torch.ones((), dtype=dtype, device=core.V.device)
        alpha_rate = alpha.clone()
        tau_tiles = make_y_tiles(plan, state.tau)

    # w0 (e is refreshed at sweep end; only the stats are needed here)
    w0, w0_var = core.w0, core.w0_var
    if cfg.fit_w0:
        quad = alpha * n + cfg.reg_0
        lin = alpha * (n * w0 - sum_e)
        w0 = lin / quad
        w0_var = 1.0 / quad

    gi, gc = plan.group_index, plan.group_counts
    lambda_w, lambda_w_rate = vi_update_lambda(
        core.w, core.w_var, core.mu_w, core.mu_w_var, gi, gc, cfg)
    mu_w, mu_w_var = vi_update_mu(core.w, lambda_w, gi, gc, cfg)
    lambda_V, lambda_V_rate = vi_update_lambda(
        core.V, core.V_var, core.mu_V, core.mu_V_var, gi, gc, cfg)
    mu_V, mu_V_var = vi_update_mu(core.V, lambda_V, gi, gc, cfg)

    w, w_var, V, V_var = core.w, core.w_var, core.V, core.V_var
    eff = vi_eff_tables(plan, w, w_var, V, V_var) if plan.has_side else None
    for ti in range(len(plan.tables)):
        if plan.side[ti] is not None:
            w, w_var, V, V_var = _vi_ea_table_pass(
                plan, ti, w, w_var, V, V_var, w0, alpha, lambda_w, mu_w,
                lambda_V, mu_V, gi, tau_tiles[ti], cfg, eff, plain,
            )
            # this table's side moments changed: later tables' gathers
            # and the refresh must see the updated reductions
            eff = vi_eff_tables(plan, w, w_var, V, V_var)
        else:
            w, w_var, V, V_var = _vi_table_pass(
                plan, ti, w, w_var, V, V_var, w0, alpha, lambda_w, mu_w,
                lambda_V, mu_V, gi, tau_tiles[ti], cfg, eff, plain,
            )

    # refresh (e, e_var_sum) + ELBO
    score, e_var_sum = vi_refresh_rows(plan, w0, w0_var, w, w_var, V,
                                       V_var, eff=eff)
    e, tau, row_elbo = finish_task(score, y, cfg)
    e_var_sum, row_elbo, e2 = psum_many(cfg.axis, e_var_sum, row_elbo,
                                        (e * e).sum())
    new_core = VIState(
        w0=w0, w0_var=w0_var, w=w, w_var=w_var, V=V, V_var=V_var,
        e=e, e_var_sum=e_var_sum, alpha=alpha, alpha_rate=alpha_rate,
        mu_w=mu_w, mu_w_var=mu_w_var,
        lambda_w=lambda_w, lambda_w_rate=lambda_w_rate,
        mu_V=mu_V, mu_V_var=mu_V_var,
        lambda_V=lambda_V, lambda_V_rate=lambda_V_rate,
        elbo=core.elbo.new_zeros(()),
    )
    elbo = row_elbo - alpha * (cfg.beta_0 + e2 + e_var_sum) / 2.0
    elbo = _group_elbo_terms(plan, new_core, cfg, elbo)
    return CategoricalVIState(
        core=dataclasses.replace(new_core, elbo=elbo), tau=tau
    )


def init_categorical_vi_state(plan: CategoricalPlan, core: VIState,
                              y: torch.Tensor,
                              cfg: VariationalConfig) -> CategoricalVIState:
    """Reference initialize (variational.hpp:234-241): the full
    mean/variance forward, e = score − y for every task; the
    classification task's first target τ is y itself (±1)."""
    eff = (
        vi_eff_tables(plan, core.w, core.w_var, core.V, core.V_var)
        if plan.has_side else None
    )
    score, e_var_sum = vi_refresh_rows(
        plan, core.w0, core.w0_var, core.w, core.w_var, core.V,
        core.V_var, eff=eff,
    )
    core = dataclasses.replace(core, e=score - y,
                               e_var_sum=psum(e_var_sum, cfg.axis))
    tau = None if cfg.task == TASK_REGRESSION else y.to(score.dtype)
    return CategoricalVIState(core=core, tau=tau)
