"""Merged (R+1)-dimensional joint-row Gibbs sweep (the "joint" engine).

PyTorch counterpart of ``myfm_tpu/ops/joint.py``.  Given every other
weight, the FM score is linear in feature j's extended row
u_j = [w_j | V_j], so with φ_n = q_n − x v_old and ψ_n = x·[1 | φ_n]

    p(u_j | rest) = N(A⁻¹ rhs, A⁻¹),   A = α S + diag([λ_w, λ_V]),
    rhs = α (S u_old − Σ_n e_n ψ_n) + λ∘μ,   S = Σ_n ψψᵀ,

and one pass over the colors draws w and V together.

Block tables keep their statistics in one symmetric Gram per block row,
Ĝ_m = Σ_{n: m(n)=m} z zᵀ with z = [1, e_n, q_n] (D = R + 2).  A color's
residual/factor update e += a0 + q·A, q += A is the linear map
z ← T z, so Ĝ evolves exactly as Ĝ ← T Ĝ Tᵀ; the draw statistics come
from Ĝ with the v_old border terms (module doc of the TPU package).
The dense path carries Ĝ flat and lanes-major, [D², B], as the TPU
package does; its sequential tail of colors is ``ops/joint_tail.py``
(the hand-written CUDA kernel on the card).

float32 note (as in the TPU package): the main-table step assembles its
rhs row-wise, α·Σψ(ψᵀu_old − e), so a rank-deficient S keeps its null
components at relative precision; the block paths assemble S and t from
Ĝ, whose separately rounded aggregates make an α(S·u − t) cancellation
inherent to the Gram design.  Every Cholesky pivot is floored at λ.

Every function returns new tensors and leaves its inputs as they are.
Gathers by feature id clamp the pad id (``n_features``) into range, as
JAX's gathers do; scatters of drawn rows drop it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as nnf

from ..design import BlockPlan, ColorPlan, DenseColor, DesignPlan
from ..parallel.collectives import psum, psum_many
from .forward import factor_q, take
from .segsum import add_at, segment_sum, segment_sum_chunked


def _segsum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """segment_sum over a color's ascending ``seg`` with JAX's
    semantics: segment ids ≥ n are dropped."""
    return segment_sum(x, seg.clamp(max=n), n + 1, ascending=True)[:n]


def _scatter_rows(U: torch.Tensor, feat: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """U with rows ``feat`` set to ``rows``; ids ≥ F (pad) are dropped.
    The pad ids land on a dummy row, so there is no host sync."""
    F = U.shape[0]
    ext = torch.cat([U, U.new_zeros((1,) + tuple(U.shape[1:]))])
    ext[feat.clamp(max=F).long()] = rows
    return ext[:F]


# ---------------------------------------------------------------------------
# Batched Cholesky sampler
# ---------------------------------------------------------------------------


def chol_solve_sample(A, rhs, xi, pivot_floor=None):
    """sample = A⁻¹rhs + L⁻ᵀξ for batched SPD A [B, D, D], unrolled
    over columns with every step a [B]-batched op.

    Each pivot is floored at 8·eps·|A_jj| + tiny and, when given, at
    ``pivot_floor`` [B, D]: for A = αS + diag(λ) with S PSD every exact
    pivot is ≥ λ_j, so flooring at λ only corrects roundoff."""
    D = A.shape[-1]
    dtype = A.dtype
    finfo = torch.finfo(dtype)
    eps8 = 8.0 * finfo.eps
    ar = torch.arange(D, device=A.device)
    cols = []  # cols[j]: column j of L as [B, D] (rows < j zeroed)
    for j in range(D):
        col = A[:, :, j]
        for k in range(j):
            col = col - cols[k] * cols[k][:, j : j + 1]
        floor_j = eps8 * A[:, j, j].abs() + finfo.tiny
        if pivot_floor is not None:
            floor_j = torch.maximum(floor_j, pivot_floor[:, j])
        pivot = torch.maximum(col[:, j], floor_j)
        inv_d = torch.rsqrt(pivot)
        colj = col.clone()
        colj[:, j] = pivot
        colj = colj * inv_d[:, None]
        cols.append(colj * (ar >= j).to(dtype))
    # forward: L z = rhs
    z = []
    for j in range(D):
        acc = rhs[:, j]
        for k in range(j):
            acc = acc - cols[k][:, j] * z[k]
        z.append(acc / cols[j][:, j])
    zx = torch.stack(z, dim=1) + xi
    # backward: Lᵀ s = z + ξ
    s = [None] * D
    for j in reversed(range(D)):
        acc = zx[:, j]
        for k in range(j + 1, D):
            acc = acc - cols[j][:, k] * s[k]
        s[j] = acc / cols[j][:, j]
    return torch.stack(s, dim=1)


def solve_spd_sample(A, rhs, xi, lam):
    """A⁻¹rhs + L⁻ᵀξ for batched A = αS + diag(λ), S PSD.  D ≤ 32 takes
    the unrolled solver with pivots floored at λ; larger D takes
    ``torch.linalg.cholesky`` with a diagonal ridge of
    (2D+64)·eps·max(diag A, λ), an upper bound on the computed pivots'
    roundoff (as the TPU package does with XLA's linalg)."""
    D = A.shape[-1]
    if D <= 32:
        return chol_solve_sample(A, rhs, xi, pivot_floor=lam)
    diag_max = A.diagonal(dim1=-2, dim2=-1).max(dim=-1, keepdim=True).values
    ridge = (2.0 * D + 64.0) * torch.finfo(A.dtype).eps * torch.maximum(
        diag_max, lam
    )
    L = torch.linalg.cholesky(A + torch.diag_embed(ridge))
    z = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    s = torch.linalg.solve_triangular(
        L.transpose(-1, -2), z + xi[..., None], upper=True
    )
    return s[..., 0]


def _draw_u(S, t, u_old, lam, mu, alpha, xi):
    """Draw u_new ~ p(u | rest) from (S, t) statistics."""
    A = alpha * S + torch.diag_embed(lam)
    rhs = alpha * (torch.einsum("pfg,pg->pf", S, u_old) - t) + lam * mu
    return solve_spd_sample(A, rhs, xi, lam)


# ---------------------------------------------------------------------------
# Main-table color step (direct per-row state)
# ---------------------------------------------------------------------------


def _joint_u_color_main(c: ColorPlan, e, q, U, alpha, lam_gu, mu_gu,
                        noise, group_index, axis=None):
    """(R+1)-joint draw for a row-disjoint main-table feature set.
    Returns (e, q, U)."""
    n_seg = c.feat.shape[0]
    gidx = take(group_index, c.feat)
    lam = take(lam_gu, gidx)
    mu = take(mu_gu, gidx)
    u_old = take(U, c.feat)  # [Pf, R+1]
    v_old = u_old[:, 1:]
    x = c.vals[:, None]
    phi = take(q, c.rows) - x * take(v_old, c.seg)  # [Pe, R]
    psi = x * torch.cat([torch.ones_like(x), phi], dim=1)  # [Pe, R+1]
    S = _segsum(psi[:, :, None] * psi[:, None, :], c.seg, n_seg)
    # rhs row-wise: α·Σψ(ψᵀu_old − e) + λμ (module doc, float32 note)
    resid = (psi * take(u_old, c.seg)).sum(dim=1) - take(e, c.rows)
    r = _segsum(psi * resid[:, None], c.seg, n_seg)
    S, r = psum_many(axis, S, r)
    A = alpha * S + torch.diag_embed(lam)
    rhs = alpha * r + lam * mu
    u_new = solve_spd_sample(A, rhs, take(noise, c.feat), lam)
    dseg = take(u_new - u_old, c.seg)
    rows = c.rows.long()
    e = add_at(e, rows, (dseg * psi).sum(dim=1), distinct=True)
    q = add_at(q, rows, dseg[:, 1:] * x, distinct=True)
    return e, q, _scatter_rows(U, c.feat, u_new)


# ---------------------------------------------------------------------------
# Block pass: Ĝ statistics (ragged form)
# ---------------------------------------------------------------------------


_INDEX_MAPS: Dict[Tuple[int, str], Tuple[torch.Tensor, ...]] = {}


def _index_maps(D: int, device) -> Tuple[torch.Tensor, ...]:
    """(II, JJ, col0, m_i1, m_j1) for the flat D² layout: flat entry k is
    Ĝ[k // D, k % D]; col0 holds the flat ids of Ĝ[:, 0]."""
    key = (D, str(device))
    maps = _INDEX_MAPS.get(key)
    if maps is None:
        k = torch.arange(D * D, device=device)
        II, JJ = k // D, k % D
        maps = (II, JJ, torch.arange(D, device=device) * D,
                (II == 1)[:, None], (JJ == 1)[:, None])
        _INDEX_MAPS[key] = maps
    return maps


def build_block_gram(b: BlockPlan, e, q, axis=None, row_chunk=1 << 20,
                     flat=False):
    """Ĝ [B, D, D] (or flat [B, D²]) = per-block-row sums of z zᵀ,
    z = [1, e, q], chunked over rows (on CUDA over the mapper's stable
    order, ``BlockPlan.mapper_order``) so the temporary stays bounded.
    The sums go through ops/segsum.py, in one order on every run; the
    result is symmetrized all the same, as the TPU package's is, so that
    every reader (the tail kernel reads the upper triangle, the plain
    steps read both) sees one matrix whatever order the two triangles
    were summed in.  On the CPU the sums are sequential and the
    symmetrization leaves every bit as it is.  On a sharded plan the
    rank's sums are summed over the data ``axis``."""
    B = b.block_size
    D = q.shape[1] + 2
    II, JJ = _index_maps(D, e.device)[:2]

    def summands(rows):
        sl_e = e[rows]
        z = torch.cat([torch.ones_like(sl_e)[:, None], sl_e[:, None],
                       q[rows]], dim=1)
        return z[:, II] * z[:, JJ]

    G = segment_sum_chunked(summands, b.mapper, B, e.new_zeros((B, D * D)),
                            row_chunk, order=b.mapper_order)
    G = psum(G, axis).reshape(B, D, D)
    G = 0.5 * (G + G.transpose(1, 2))
    return G.reshape(B, D * D) if flat else G


def _joint_u_block_color(b: BlockPlan, c: ColorPlan, G, U, alpha,
                         lam_gu, mu_gu, noise, group_index):
    """One block color drawn from Ĝ [B, D, D]; returns U and the
    per-block-row update coefficients (a0 [B], A [B, R])."""
    n_seg = c.feat.shape[0]
    B, D, _ = G.shape
    R = D - 2
    gidx = take(group_index, c.feat)
    lam = take(lam_gu, gidx)
    mu = take(mu_gu, gidx)
    u_old = take(U, c.feat)
    v_old = u_old[:, 1:]

    x = c.vals
    m = c.rows.long()
    Gm = G[m]  # [Pe, D, D]
    x2 = (x * x)[:, None, None]
    packed = torch.cat(
        [
            x2 * Gm,
            (x[:, None] * Gm[:, 1, :])[:, None, :],
            ((x * x * x)[:, None] * Gm[:, 0, :])[:, None, :],
            ((x * x * x * x)[:, None] * Gm[:, 0, :])[:, None, :],
        ],
        dim=1,
    )  # [Pe, D+3, D]
    T = _segsum(packed, c.seg, n_seg)
    G2 = T[:, :D, :]  # Σ x² Ĝ
    row1 = T[:, D, :]  # Σ x Ĝ[1,:]
    row0_3 = T[:, D + 1, :]  # Σ x³ Ĝ[0,:]
    s4c = T[:, D + 2, 0]  # Σ x⁴ card

    s3c = row0_3[:, 0]
    s3q = row0_3[:, 2:]
    top = torch.cat(
        [G2[:, 0:1, 0:1], G2[:, 0:1, 2:] - (s3c[:, None] * v_old)[:, None, :]],
        dim=2,
    )  # [Pf, 1, R+1]
    bot_left = top[:, :, 1:].transpose(1, 2)  # [Pf, R, 1]
    bot_right = (
        G2[:, 2:, 2:]
        - v_old[:, :, None] * s3q[:, None, :]
        - s3q[:, :, None] * v_old[:, None, :]
        + s4c[:, None, None] * v_old[:, :, None] * v_old[:, None, :]
    )
    S = torch.cat([top, torch.cat([bot_left, bot_right], dim=2)], dim=1)
    t = torch.cat(
        [row1[:, 0:1], row1[:, 2:] - G2[:, 0, 1][:, None] * v_old], dim=1
    )
    u_new = _draw_u(S, t, u_old, lam, mu, alpha, take(noise, c.feat))
    dseg = take(u_new - u_old, c.seg)
    # e_n += x·Δw − x²(v_old·Δv) + q_n·(x·Δv)   (per block row)
    a0 = segment_sum(
        x * dseg[:, 0]
        - x * x * (take(v_old, c.seg) * dseg[:, 1:]).sum(dim=1),
        m, B, distinct=True,
    )
    A = segment_sum(x[:, None] * dseg[:, 1:], m, B, distinct=True)
    return _scatter_rows(U, c.feat, u_new), a0, A


def _update_gram(G, a0, A):
    """Ĝ ← T Ĝ Tᵀ for z ← Tz, e += a0 + q·A, q += A ([B, D, D] form)."""
    B, D, _ = G.shape
    s_vec = torch.cat([a0[:, None], G.new_zeros((B, 1)), A], dim=1)
    g = torch.einsum("bij,bj->bi", G, s_vec)
    sgs = (s_vec * g).sum(dim=1)
    e1 = G.new_zeros((D,))
    e1[1] = 1.0
    sh = s_vec.clone()
    sh[:, 0] = 0.0
    p = g + 0.5 * sgs[:, None] * e1 + g[:, 0:1] * sh
    r = G[:, :, 0] + 0.5 * G[:, 0:1, 0] * sh
    G = G.clone()
    G[:, 1, :] += p
    G[:, :, 1] += p
    G[:, 2:, :] += A[:, :, None] * r[:, None, :]
    G[:, :, 2:] += r[:, :, None] * A[:, None, :]
    return G


def _joint_u_block_pass(b: BlockPlan, e, q, U, alpha, lam_gu, mu_gu,
                        noise, group_index, axis=None):
    """All colors of one block in ragged form: Ĝ built once, evolved per
    color; the [N]-sized state is touched once at the end,
        e += (Ct + q⁰·Atot)[mapper],   q += Atot[mapper],
    where Ct accumulates a0 plus the prefix cross-terms A_k·Σ_{j<k}A_j."""
    B = b.block_size
    R = q.shape[1]
    G = build_block_gram(b, e, q, axis)
    Atot = e.new_zeros((B, R))
    Ct = e.new_zeros((B,))
    colors = list(b.colors)
    if b.color_stack is not None:
        cs = b.color_stack
        colors += [
            ColorPlan(rows=cs.rows[k], vals=cs.vals[k], seg=cs.seg[k],
                      feat=cs.feat[k], sx2=cs.sx2[k])
            for k in range(cs.feat.shape[0])
        ]
    for c in colors:
        U, a0, A = _joint_u_block_color(
            b, c, G, U, alpha, lam_gu, mu_gu, noise, group_index
        )
        Ct = Ct + a0 + (A * Atot).sum(dim=1)
        Atot = Atot + A
        G = _update_gram(G, a0, A)
    am = take(Atot, b.mapper)
    e = e + (am * q).sum(dim=1) + take(Ct, b.mapper)
    return e, q + am, U


# ---------------------------------------------------------------------------
# Dense (lanes-major) block pass
# ---------------------------------------------------------------------------


def _dense_color_step(G, xw, segb, u_old, lam, mu, xi, alpha, D):
    """One dense color on the flat lanes-major Gram G [D², B].
    ``u_old``/``lam``/``mu``/``xi`` are the color's pre-gathered
    [Pf, R+1] rows.  Returns (u_new [Pf, R+1], a0 [B], A_B [R, B]), the
    per-block-row coefficients of e += a0 + q·A, q += A."""
    dtype = G.dtype
    Pf = u_old.shape[0]
    vT = u_old[:, 1:].T  # [R, Pf]

    oh = nnf.one_hot(segb.long(), Pf + 1)[:, :Pf].to(dtype)  # [B, Pf]
    x2 = xw * xw
    wq = torch.cat(
        [
            x2[:, None] * oh,
            (x2 * xw)[:, None] * oh,
            (x2 * x2)[:, None] * oh,
            xw[:, None] * oh,
        ],
        dim=1,
    )  # [B, 4Pf]
    TT = (G @ wq).reshape(D, D, 4 * Pf)
    G2 = TT[..., :Pf]  # Σx²Ĝ [D, D, Pf]
    s3 = TT[0, :, Pf : 2 * Pf]  # Σx³Ĝ[0,:] [D, Pf]
    x4c = TT[0, 0, 2 * Pf : 3 * Pf]  # Σx⁴card [Pf]
    w1 = TT[1, :, 3 * Pf :]  # ΣxĜ[1,:] [D, Pf]
    s3c = s3[0]
    s3q = s3[2:]  # [R, Pf]

    S00 = G2[0:1, 0:1, :]
    S0q = (G2[0, 2:, :] - s3c[None] * vT)[None]  # [1, R, Pf]
    Sqq = (
        G2[2:, 2:, :]
        - vT[:, None] * s3q[None]
        - s3q[:, None] * vT[None]
        + x4c * vT[:, None] * vT[None]
    )
    S = torch.cat(
        [
            torch.cat([S00, S0q], dim=1),
            torch.cat([S0q.transpose(0, 1), Sqq], dim=1),
        ],
        dim=0,
    ).permute(2, 0, 1)  # [Pf, R+1, R+1]
    t = torch.cat([w1[0:1], w1[2:] - G2[0, 1][None] * vT], dim=0).T

    u_new = _draw_u(S, t, u_old, lam, mu, alpha, xi)
    delta = u_new - u_old
    dw = delta[:, 0]
    dv = delta[:, 1:]
    c0 = (u_old[:, 1:] * dv).sum(dim=1)  # v_old·Δv per feature
    a0 = xw * (oh @ dw) - x2 * (oh @ c0)
    A_B = (oh @ dv).T * xw[None]
    return u_new, a0, A_B


def _update_gram_lanes(G, a0, A_B, D):
    """Ĝ ← T Ĝ Tᵀ in the flat [D², B] layout: one correction
    corr[k] = e1_i p_j + p_i e1_j + ŝ_i r_j + r_i ŝ_j, i = k//D, j = k%D."""
    B = G.shape[1]
    II, JJ, col0_idx, m_i1, m_j1 = _index_maps(D, G.device)
    s = torch.cat([a0[None], G.new_zeros((1, B)), A_B], dim=0)  # [D, B]
    sh = torch.cat([G.new_zeros((2, B)), A_B], dim=0)  # ŝ = [0, 0, A]
    g = torch.einsum("djb,jb->db", G.reshape(D, D, B), s)  # Ĝ·s [D, B]
    sgs = (s * g).sum(dim=0)
    p = g + g[0:1] * sh
    p[1] += 0.5 * sgs
    col0 = G[col0_idx]  # Ĝ[:, 0] as [D, B]
    r = col0 + 0.5 * col0[0:1] * sh
    corr = m_i1 * p[JJ] + p[II] * m_j1 + sh[II] * r[JJ] + r[II] * sh[JJ]
    return G + corr


def _carry_update(G, Atot, Ct, a0, A_B, D):
    """Evolve a block's carried state by one color's (a0, A_B):
    Ct += a0 + A_B·Atot, Atot += A_B, Ĝ ← T Ĝ Tᵀ."""
    Ct = Ct + a0 + (A_B * Atot).sum(dim=0)
    return _update_gram_lanes(G, a0, A_B, D), Atot + A_B, Ct


def _dense_color_apply(G, Atot, Ct, xw, segb, u0, lam, mu, xi, alpha, D):
    """One dense color: draw its features' rows, then carry the state.
    Returns (G, Atot, Ct, u_new)."""
    u_new, a0, A_B = _dense_color_step(G, xw, segb, u0, lam, mu, xi,
                                       alpha, D)
    return (*_carry_update(G, Atot, Ct, a0, A_B, D), u_new)


def _chol_solve_sample_lanes(Svv, rhs, xi, eps8, tiny, floor=None):
    """chol_solve_sample on lists of [B]-lane vectors: ``Svv[i][j]``,
    ``rhs[i]`` and ``xi[i]`` are [B] tensors; returns the solution as a
    list.  Same recurrences and pivot floor (``floor``: the per-coordinate
    exact lower bound, the prior λ)."""
    Dp = len(rhs)
    cols = []  # cols[j][i - j] for i >= j: column j of L
    for j in range(Dp):
        col = [Svv[i][j] for i in range(Dp)]
        for k in range(j):
            ck = cols[k]
            col = [
                col[i] - ck[i - k] * ck[j - k] if i >= j else col[i]
                for i in range(Dp)
            ]
        floor_j = eps8 * Svv[j][j].abs() + tiny
        if floor is not None:
            floor_j = torch.maximum(floor_j, floor[j])
        pivot = torch.maximum(col[j], floor_j)
        inv_d = torch.rsqrt(pivot)
        cols.append([pivot * inv_d] + [col[i] * inv_d
                                       for i in range(j + 1, Dp)])
    z = []
    for j in range(Dp):
        acc = rhs[j]
        for k in range(j):
            acc = acc - cols[k][j - k] * z[k]
        z.append(acc / cols[j][0])
    zx = [z[j] + xi[j] for j in range(Dp)]
    s = [None] * Dp
    for j in reversed(range(Dp)):
        acc = zx[j]
        for k in range(j + 1, Dp):
            acc = acc - cols[j][k - j] * s[k]
        s[j] = acc / cols[j][0]
    return s


def _identity_color_apply(dc: DenseColor, G, Atot, Ct, U, alpha, lam_gu,
                          mu_gu, noise, group_index, D):
    """Draw a color's single-entry features straight off the Gram: each
    touches one block row b, so its (S, t) are that row's Ĝ entries
    scaled by powers of x.  Exact: same-color features are row-disjoint,
    so drawing this subset before the color's remainder gives the same
    draws as one combined step.  Returns (G, Atot, Ct, U)."""
    R = D - 2
    Dp = R + 1
    dtype = G.dtype
    finfo = torch.finfo(dtype)
    x = dc.id_xw
    f = dc.id_feat
    has = f < U.shape[0]  # F_total marks rows without a feature
    u_old = take(U, f)  # [B, R+1]
    gidx = take(group_index, f)
    lam = take(lam_gu, gidx)
    mu = take(mu_gu, gidx)
    xi = take(noise, f)

    x2 = x * x
    x3 = x2 * x
    x4 = x2 * x2

    def row(i, j):
        return G[i * D + j]

    v = [u_old[:, 1 + r] for r in range(R)]
    g00 = row(0, 0)
    s3c = x3 * g00
    S = [[None] * Dp for _ in range(Dp)]
    S[0][0] = x2 * g00
    for r in range(R):
        S[0][1 + r] = x2 * row(0, 2 + r) - s3c * v[r]
        S[1 + r][0] = S[0][1 + r]
    for r in range(R):
        for r2 in range(r, R):
            val = (
                x2 * row(2 + r, 2 + r2)
                - v[r] * x3 * row(0, 2 + r2)
                - x3 * row(0, 2 + r) * v[r2]
                + x4 * g00 * v[r] * v[r2]
            )
            S[1 + r][1 + r2] = val
            S[1 + r2][1 + r] = val
    t = [x * row(1, 0)] + [
        x * row(1, 2 + r) - x2 * row(0, 1) * v[r] for r in range(R)
    ]

    u0v = [u_old[:, i] for i in range(Dp)]
    lamv = [lam[:, i] for i in range(Dp)]
    A = [
        [alpha * S[i][j] + (lamv[i] if i == j else 0.0) for j in range(Dp)]
        for i in range(Dp)
    ]
    rhs = []
    for i in range(Dp):
        acc = S[i][0] * u0v[0]
        for j in range(1, Dp):
            acc = acc + S[i][j] * u0v[j]
        rhs.append(alpha * (acc - t[i]) + lamv[i] * mu[:, i])
    s = _chol_solve_sample_lanes(
        A, rhs, [xi[:, i] for i in range(Dp)], 8.0 * finfo.eps,
        finfo.tiny, floor=lamv,
    )
    u_new = torch.stack(s, dim=1)  # [B, R+1]

    delta = torch.where(has[:, None], u_new - u_old, 0.0)
    dv = delta[:, 1:]
    a0 = x * delta[:, 0] - x2 * (u_old[:, 1:] * dv).sum(dim=1)
    A_B = (x[:, None] * dv).T  # [R, B]
    G, Atot, Ct = _carry_update(G, Atot, Ct, a0, A_B, D)
    U = _scatter_rows(U, f, torch.where(has[:, None], u_new, u_old))
    return G, Atot, Ct, U


def dense_tail_operands(b: BlockPlan, U, lam_gu, mu_gu, noise, group_index):
    """The tail stack's pre-gathered (u0, lam, mu, xi), [C, Pf, R+1] each."""
    feat = b.dense_stack.feat
    gidx = take(group_index, feat)
    return (take(U, feat), take(lam_gu, gidx), take(mu_gu, gidx),
            take(noise, feat))


def _joint_u_block_pass_dense(b: BlockPlan, e, q, U, alpha, lam_gu,
                              mu_gu, noise, group_index,
                              tail_kernel=False, axis=None):
    """All colors of one block via the dense lanes-major machinery: the
    unrolled head colors one by one, then the stacked tail in one call
    of ``joint_tail_pass`` (the CUDA kernel, ``tail_kernel=True``) or of
    its plain version (``False``)."""
    from .joint_tail import joint_tail_pass, joint_tail_pass_reference

    B = b.block_size
    R = q.shape[1]
    D = R + 2
    # [D², B]
    G = build_block_gram(b, e, q, axis, flat=True).T.contiguous()
    Atot = e.new_zeros((R, B))
    Ct = e.new_zeros((B,))

    for dc in b.dense_colors:
        if dc.id_feat is not None:
            G, Atot, Ct, U = _identity_color_apply(
                dc, G, Atot, Ct, U, alpha, lam_gu, mu_gu, noise,
                group_index, D,
            )
        gidx = take(group_index, dc.feat)
        G, Atot, Ct, u_new = _dense_color_apply(
            G, Atot, Ct, dc.xw, dc.segb, take(U, dc.feat),
            take(lam_gu, gidx), take(mu_gu, gidx), take(noise, dc.feat),
            alpha, D,
        )
        U = _scatter_rows(U, dc.feat, u_new)

    if b.dense_stack is not None:
        ds = b.dense_stack
        tail = joint_tail_pass if tail_kernel else joint_tail_pass_reference
        _, Atot, Ct, u_all = tail(
            G, Atot, Ct, ds.xw, ds.segb,
            *dense_tail_operands(b, U, lam_gu, mu_gu, noise, group_index),
            alpha, D,
        )
        U = _scatter_rows(U, ds.feat.reshape(-1), u_all.reshape(-1, R + 1))

    am = take(Atot.T, b.mapper)  # [N, R]
    e = e + (am * q).sum(dim=1) + take(Ct, b.mapper)
    return e, q + am, U


def sweep_joint_u(plan: DesignPlan, e, w, V, alpha, lambda_w, mu_w,
                  lambda_V, mu_V, noise, q=None, tail_kernel=False,
                  axis=None):
    """One merged (w, V) joint pass over all colors of all tables, given
    the standard normals ``noise`` [F, R+1] (JAX draws them from the
    sweep's key).  Returns (w, V, e, q); ``q=None`` rebuilds the
    factor-sum cache from V.  On a sharded plan the per-feature sums and
    the Ĝ statistics are summed over the data ``axis``."""
    g = plan.group_index
    U = torch.cat([w[:, None], V], dim=1)  # [F, R+1]
    lam_gu = torch.cat([lambda_w[:, None], lambda_V], dim=1)
    mu_gu = torch.cat([mu_w[:, None], mu_V], dim=1)
    if q is None:
        q = factor_q(plan, V)  # [N, R]

    colors = list(plan.main.colors)
    cs = plan.main.color_stack
    if cs is not None:
        colors += [
            ColorPlan(rows=cs.rows[k], vals=cs.vals[k], seg=cs.seg[k],
                      feat=cs.feat[k], sx2=cs.sx2[k])
            for k in range(cs.feat.shape[0])
        ]
    for c in colors:
        e, q, U = _joint_u_color_main(c, e, q, U, alpha, lam_gu, mu_gu,
                                      noise, g, axis)

    for b in plan.blocks:
        if b.dense_colors or b.dense_stack is not None:
            e, q, U = _joint_u_block_pass_dense(
                b, e, q, U, alpha, lam_gu, mu_gu, noise, g,
                tail_kernel=tail_kernel, axis=axis,
            )
        else:
            e, q, U = _joint_u_block_pass(
                b, e, q, U, alpha, lam_gu, mu_gu, noise, g, axis
            )
    return U[:, 0], U[:, 1:], e, q
