"""Plain reference of one Gibbs sweep of a Bayesian factorization machine
on one-hot tables (myFM / libFM semantics), its forward pass, and the
design of the configurations that name it (``design``: the program's
one-hot design and this module's, ``sweep_flops``).

Plain torch in float64, independent of the program under test: it
imports nothing of the measured package and works from the design, the
priors of the configuration file, the state a sweep starts from and the
standard variates the sweep consumes.

The model: score_n = w0 + Σ_t w[c_t(n)] + ½ Σ_r ((Σ_t V[c_t(n), r])²
− Σ_t V[c_t(n), r]²) over the tables t, each row naming one entity of
each table; residual e_n = score_n − y_n.  One sweep, in libFM's order:
α, then w0, then λ_w, μ_w, λ_V, μ_V per group, then table by table every
entity's w and then its factors r = 0 .. R-1, each drawn from its
Gaussian conditional given everything drawn before it.  The entities of
one table share no row, so a table's entities are drawn together; their
statistics are the entity Grams over z = [1 | e⁰ | φ], with e⁰ = e − w0
(the rank-1 correction for w0 is exact) and φ_r = Σ_{t' ≠ t} V[c_t'(n), r].

The lower-precision controls: ``gram_dtype`` rounds the Gram's operands
z before the products (accumulated in float64); ``stat_dtype`` computes
the statistics of the hyperparameter draws (the residual from values
rounded to that dtype, its moments and the groups' sums, each a torch
reduction whose result has that dtype).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

F64 = torch.float64
TILE_ROWS = 32
CHUNK_TILES = 8192
ROW_CHUNK = 1 << 20


def _gather_sum(tables, w, V, rows, skip: Optional[int] = None):
    """(Σ_t w, Σ_t V, Σ_t |V|²) of ``rows`` over the tables but ``skip``,
    in the dtype of w and V."""
    lin = torch.zeros(rows.shape[0], dtype=w.dtype, device=w.device)
    Q = torch.zeros(rows.shape[0], V.shape[1], dtype=V.dtype,
                    device=w.device)
    qs = torch.zeros_like(lin)
    for t, (offset, ids) in enumerate(tables):
        if t == skip:
            continue
        f = offset + ids[rows]
        Vf = V[f]
        lin = lin + w[f]
        Q = Q + Vf
        qs = qs + (Vf * Vf).sum(dim=1)
    return lin, Q, qs


def _forward(tables, w0, w, V, n_rows: int, dtype=F64) -> torch.Tensor:
    """score [n_rows], returned in float64; ``dtype`` rounds w0, w and V
    and computes in that dtype (the forward's control)."""
    w, V = w.to(dtype), V.to(dtype)
    w0 = torch.as_tensor(w0, device=w.device).to(dtype)
    out = []
    for r0 in range(0, n_rows, ROW_CHUNK):
        rows = torch.arange(r0, min(n_rows, r0 + ROW_CHUNK), device=w.device)
        lin, Q, qs = _gather_sum(tables, w, V, rows)
        out.append((w0 + lin + 0.5 * ((Q * Q).sum(dim=1) - qs)).to(F64))
    return torch.cat(out)


def forward(design: dict, w0, w, V, dtype=F64) -> torch.Tensor:
    """score [N] of the design's rows (``design`` as ``sweep`` takes it),
    returned in float64; ``dtype`` rounds w0, w and V and computes in
    that dtype (the forward's control)."""
    return _forward(design["tables"], w0, w, V, design["y"].shape[0], dtype)


def entity_gram(ids: torch.Tensor, n_entities: int, z_rows, D: int,
                gram_dtype=None) -> torch.Tensor:
    """G [B, D, D] = Σ_{n: ids[n] = u} z_n z_nᵀ, with ``z_rows(rows)`` the
    [len(rows), D] rows of z: each entity's rows in tiles of TILE_ROWS,
    one batched product per chunk of tiles, summed into the entities."""
    device = ids.device
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    counts = torch.bincount(ids, minlength=n_entities)
    tiles = (counts + TILE_ROWS - 1) // TILE_ROWS
    tile_entity = torch.repeat_interleave(
        torch.arange(n_entities, device=device), tiles)
    first_row = torch.cumsum(counts, 0) - counts
    first_tile = torch.cumsum(tiles, 0) - tiles
    pos = torch.arange(n, device=device) - first_row[sorted_ids]
    row_at = torch.full((tile_entity.shape[0], TILE_ROWS), -1,
                        dtype=torch.long, device=device)
    row_at[first_tile[sorted_ids] + pos // TILE_ROWS, pos % TILE_ROWS] = order
    G = torch.zeros(n_entities, D, D, dtype=F64, device=device)
    for k0 in range(0, tile_entity.shape[0], CHUNK_TILES):
        rows = row_at[k0 : k0 + CHUNK_TILES]
        valid = (rows >= 0).to(F64)[..., None]
        z = z_rows(rows.clamp(min=0).reshape(-1)).view(*rows.shape, D)
        z = z * valid
        if gram_dtype is not None:
            z = z.to(gram_dtype).to(F64)
        G.index_add_(0, tile_entity[k0 : k0 + CHUNK_TILES],
                     torch.bmm(z.transpose(1, 2), z))
    return G


def _normal(quad, lin, noise):
    return lin / quad + noise / torch.sqrt(quad), 1.0 / torch.sqrt(quad)


def _segment_sum(x, group_index, n_groups):
    """Per-group sums of the rows of x, each one reduction in x's dtype
    (torch accumulates a bfloat16 sum in float32 and rounds the result)."""
    return torch.stack([x[group_index == g].sum(dim=0)
                        for g in range(n_groups)])


def draw_hypers(e, state: dict, variates: dict, prior: dict, gi,
                stat_dtype=F64) -> Tuple[Dict[str, torch.Tensor],
                                         Dict[str, torch.Tensor]]:
    """The sweep's first draws, α from Σe², w0 from Σe (``e`` the residual
    in ``stat_dtype``), then λ and μ of w and of V per group of
    ``gi`` [F]; ``state`` and ``variates`` in float64.  Returns (draws,
    sds) of those."""
    s, z = state, variates
    n = e.shape[0]
    G = int(gi.max()) + 1
    n_g = torch.bincount(gi, minlength=G).to(F64)
    a0, b0, g0 = prior["alpha_0"], prior["beta_0"], prior["gamma_0"]
    w0, w, V = s["w0"], s["w"], s["V"]
    R = V.shape[1]
    draws, sds = {}, {}

    def low(x):
        return x.to(stat_dtype)

    k_alpha = (a0 + n) / 2.0
    alpha = z["gamma_alpha"] / ((b0 + (e * e).sum().to(F64)) / 2.0)
    draws["alpha"], sds["alpha"] = alpha, alpha / k_alpha ** 0.5
    draws["w0"], sds["w0"] = _normal(alpha * n + prior["reg_0"],
                                     alpha * (n * w0 - e.sum().to(F64)),
                                     z["normal_w0"])

    k_g = (a0 + n_g) / 2.0
    for name, x, mu_old, gshape in (("w", w, s["mu_w"], (G,)),
                                    ("V", V, s["mu_V"], (G, R))):
        dev2 = (low(x) - low(mu_old)[gi]) ** 2
        kk = k_g if x.ndim == 1 else k_g[:, None]
        lam = z[f"gamma_lambda_{name}"] / (
            (b0 + _segment_sum(dev2, gi, G).to(F64)) / 2.0)
        lam = lam.expand(gshape)
        cnt = n_g if x.ndim == 1 else n_g[:, None]
        mu, mu_sd = _normal(lam * (g0 + cnt),
                            lam * (g0 * prior["mu_0"]
                                   + _segment_sum(low(x), gi, G).to(F64)),
                            z[f"normal_mu_{name}"])
        draws[f"lambda_{name}"], sds[f"lambda_{name}"] = lam, lam / kk.sqrt()
        draws[f"mu_{name}"], sds[f"mu_{name}"] = mu, mu_sd
    return draws, sds


def draw_one_hot(Gt, feat: slice, gi, draws: dict, noise_w, noise_V,
                 w, V, w_sd, V_sd) -> None:
    """One one-hot table's draws from its entity Grams Gt [B, D, D] over
    z = [1 | e⁰ | φ] (e⁰ the residual without w0, φ the other features'
    factor sums): every entity's w, then its factors r = 0 .. R-1, each
    from its Gaussian conditional given everything drawn before it; the
    table's features are ``feat``, α, w0, λ and μ come from ``draws``.
    Writes the draws and their conditionals' sds into w, V, w_sd, V_sd."""
    R = V.shape[1]
    alpha, w0 = draws["alpha"], draws["w0"]
    g_t = gi[feat]
    card, Sphi = Gt[:, 0, 0], Gt[:, 0, 2:]
    E1 = Gt[:, 0, 1] + w0 * card
    EQ = Gt[:, 1, 2:] + w0 * Sphi
    w_old, V_old = w[feat], V[feat]
    lam_w, mu_w = draws["lambda_w"][g_t], draws["mu_w"][g_t]
    w_new, w_sd[feat] = _normal(
        alpha * card + lam_w,
        alpha * (card * w_old - E1) + lam_w * mu_w, noise_w[feat])
    EQ = EQ + (w_new - w_old)[:, None] * Sphi
    lam_V, mu_V = draws["lambda_V"][g_t], draws["mu_V"][g_t]
    delta = torch.zeros_like(V_old)
    V_new = V_old.clone()
    for r in range(R):
        G_r = Gt[:, 2 + r, 2:]
        diag = G_r[:, r]
        eq = EQ[:, r] + (delta[:, :r] * G_r[:, :r]).sum(dim=1)
        V_new[:, r], V_sd[feat, r] = _normal(
            alpha * diag + lam_V[:, r],
            alpha * (diag * V_old[:, r] - eq) + lam_V[:, r] * mu_V[:, r],
            noise_V[feat, r])
        delta[:, r] = V_new[:, r] - V_old[:, r]
    w[feat], V[feat] = w_new, V_new


def sweep(design: dict, prior: dict, state: dict, variates: dict,
          gram_dtype=None, stat_dtype=F64) -> Tuple[Dict[str, torch.Tensor],
                                                    Dict[str, torch.Tensor]]:
    """One sweep from ``state`` (w0, w, V, mu_w, lambda_w, mu_V, lambda_V)
    with the standard ``variates`` (gamma_alpha, normal_w0,
    gamma_lambda_w, normal_mu_w, gamma_lambda_V, normal_mu_V, noise_w,
    noise_V).  ``design``: ``tables`` [(feature offset, entity ids [N])]
    in feature order, ``sizes`` (entities per table), ``y`` [N],
    ``group_index`` [F].  Returns (draws, sds): every drawn value and the
    standard deviation of the conditional it was drawn from, by name."""
    s = {k: v.to(F64) for k, v in state.items()}
    z = {k: v.to(F64) for k, v in variates.items()}
    tables, y = design["tables"], design["y"].to(F64)
    gi = design["group_index"]
    n = y.shape[0]
    w0, w, V = s["w0"], s["w"].clone(), s["V"].clone()
    R = V.shape[1]
    e = (_forward(tables, w0, w, V, n, stat_dtype) - y).to(stat_dtype)
    draws, sds = draw_hypers(e, s, z, prior, gi, stat_dtype)

    w_sd, V_sd = torch.zeros_like(w), torch.zeros_like(V)
    for t, ((offset, ids), B) in enumerate(zip(tables, design["sizes"])):
        e0 = _forward(tables, 0.0, w, V, n) - y  # e without w0

        def z_rows(rows, t=t):
            _, Q, _ = _gather_sum(tables, w, V, rows, skip=t)
            ones = torch.ones(rows.shape[0], 1, dtype=F64, device=w.device)
            return torch.cat([ones, e0[rows, None], Q], dim=1)

        Gt = entity_gram(ids, B, z_rows, R + 2, gram_dtype)
        draw_one_hot(Gt, slice(offset, offset + B), gi, draws,
                     z["noise_w"], z["noise_V"], w, V, w_sd, V_sd)
        del Gt
    draws["w"], draws["V"] = w, V
    sds["w"], sds["V"] = w_sd, V_sd
    return draws, sds


HYPERS = ("alpha", "w0", "lambda_w", "mu_w", "lambda_V", "mu_V")
WEIGHTS = ("w", "V")


def widest_gap_sd(program: Dict[str, torch.Tensor],
                  draws: Dict[str, torch.Tensor],
                  sds: Dict[str, torch.Tensor],
                  names: Sequence[str]) -> Tuple[float, str]:
    """The widest |program − reference| over the drawn values ``names``,
    in units of each conditional's standard deviation, and the name it
    is in."""
    worst, where = 0.0, ""
    for name in names:
        ref = draws[name]
        got = program[name].to(device=ref.device, dtype=F64).reshape(
            ref.shape)
        gap = float(((got - ref).abs() / sds[name]).max())
        if math.isnan(gap):
            return math.inf, name
        if gap > worst:
            worst, where = gap, name
    return worst, where


def rmse(score: torch.Tensor, y: torch.Tensor) -> float:
    return float(((score - y.to(F64)) ** 2).mean().sqrt())


def tables_of(ids: Sequence[torch.Tensor], sizes: Sequence[int]
              ) -> List[Tuple[int, torch.Tensor]]:
    """[(feature offset, ids)] for one-hot tables laid out in order."""
    out, offset = [], 0
    for t_ids, B in zip(ids, sizes):
        out.append((offset, t_ids))
        offset += B
    return out


def one_hot_design(split, config: dict):
    """(X, blocks, grouping) of the configuration's one-hot tables, listed
    in feature order (the ``main`` ones first, as the columns of X, then
    each ``block`` table as a RelationBlock of an identity matrix, given
    as its (mapper, matrix) pair); one group per table."""
    import numpy as np
    import scipy.sparse as sps

    n = len(split)
    shape = config["dataset"]
    main = [t for t in config["tables"] if t["layout"] == "main"]
    widths = [shape[t["entities"]] for t in main]
    cols = np.stack([getattr(split, t["column"]) + off for t, off in
                     zip(main, np.cumsum([0] + widths[:-1]))], axis=1)
    X = sps.csr_matrix(
        (np.ones(cols.size), cols.reshape(-1),
         np.arange(0, cols.size + 1, len(main))),
        shape=(n, sum(widths)))
    blocks = [(getattr(split, t["column"]),
               sps.identity(shape[t["entities"]], format="csr"))
              for t in config["tables"] if t["layout"] == "block"]
    grouping = [g for g, t in enumerate(config["tables"])
                for _ in range(shape[t["entities"]])]
    return X, blocks, grouping


def design(config: dict, train, test) -> dict:
    """The design of both splits (``fmbench/data.Ratings``): ``program``,
    the program's (X, blocks, grouping) of each (``one_hot_design``);
    ``reference``, this module's (what ``sweep`` and ``forward`` take,
    host tensors); ``shape``, its sizes (rows, test rows, entities per
    table, tables)."""
    sizes = [config["dataset"][t["entities"]] for t in config["tables"]]

    def reference(split):
        return dict(
            tables=tables_of([torch.as_tensor(getattr(split, t["column"]))
                              for t in config["tables"]], sizes),
            sizes=sizes, y=torch.as_tensor(split.y),
            group_index=torch.repeat_interleave(
                torch.arange(len(sizes)), torch.as_tensor(sizes)))

    return dict(
        program=dict(train=one_hot_design(train, config),
                     test=one_hot_design(test, config)),
        reference=dict(train=reference(train), test=reference(test)),
        shape=dict(rows=len(train), test_rows=len(test), entities=sizes,
                   tables=len(sizes)))


def sweep_flops(config: dict, design: dict, scored_rows: int) -> float:
    """Model FLOPs of one fast-path sweep (``fmbench/roofline.py``'s
    one-hot count) with ``scored_rows`` held-out rows scored."""
    from fmbench import roofline

    shape = design["shape"]
    return roofline.sweep_flops(shape["rows"], sum(shape["entities"]),
                                shape["tables"], config["rank"], scored_rows)
