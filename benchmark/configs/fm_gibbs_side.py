"""Plain reference of one Gibbs sweep of a Bayesian factorization machine
on the timeSVD++-flipped design, with its forward pass and its design.

The design is myFM's ``examples/ml-10m-regression.py -f
timesvdpp_flipped`` under the stricter protocol (Rendle, Zhang and
Koren 2019, arXiv:1905.01395, the Bayesian timeSVD++ flipped model),
built as ``examples/ml_features.py:build_feature_blocks`` builds it:

* X, the date one-hot;
* the user block, [one-hot user | 1/√c over the movies the user rated
  in the training split], a row per user of the split;
* the movie block, [one-hot movie | 1/√c over the users who rated it];
* five groups: date, user, the users' implicit movies, movie, the
  movies' implicit users.

The one-hot columns come from vocabularies of the training split with
an unknown column 0 (``CategoryValueToSparseEncoder``'s
``handle_unknown="create"``); the implicit sets come from the training
split, and the held-out blocks reuse them (c counts a key's training
ratings; a pair rated twice holds 2/√c, as ``csr_matrix`` sums it).

Plain torch in float64, independent of the program under test: it
imports nothing of the measured package.  The model is fm_gibbs.py's
with real-valued features: score_n = w0 + Σ_f x_nf w_f
+ ½ Σ_r ((Σ_f x_nf V_fr)² − Σ_f x_nf² V_fr²).  One sweep, in the order
of the port's fast-path sweep (ops/categorical.py ``categorical_sweep``;
its plan lists a block's one-hot table with the other one-hot tables
and the block's side columns after them): α, w0, λ and μ per group
(``fm_gibbs.draw_hypers``); the one-hot tables date, user, movie, each
entity's w and then its factors (``fm_gibbs.draw_one_hot`` from the
entity Grams over [1 | e⁰ | φ]); then the user block's side columns and
the movie block's.

A block's side columns are drawn colour by colour.  The colours are the
greedy ones: one pass over the columns in order, a column's colour the
largest of its block rows' counters (0 for a column with no rows),
after which those counters become colour + 1; so the columns of one
colour share no block row.  Each side feature j draws u_j = [w_j | V_j]
from its exact joint conditional: with Q_n the row's factor sums, ŷ_n
is linear in u_j with gradient h_n = x_nj [1 | Q_n − x_nj V_j], so the
precision is A = α Σ h hᵀ + diag(λ) and the mean A⁻¹(α(Σ h hᵀ u_j −
Σ h e) + λ μ), λ and μ being its group's [λ_w | λ_V] and [μ_w | μ_V];
the draw is the mean plus L⁻ᵀ ξ, A = L Lᵀ, ξ = [noise_w_j | noise_V_j].
A block row b's rows share x_bj, so the sums come from the block rows'
Grams Ĝ_b = Σ_{n∈b} z zᵀ over z = [1 | e | Q], taken once a block and
carried through the colours: a draw moves each touched row's
e by x Δw + x ΔV·(Q − x V_old) and its Q by x ΔV, so the touched
block rows' Grams become T Ĝ Tᵀ.  Each colour works on its features
and their non-zeros together, so a pass costs one Gram over the rows
and then the colours and the non-zeros (a D³ product each), not rows ×
features.

The lower-precision controls are fm_gibbs.py's: ``gram_dtype`` rounds
the operands z of every Gram (entity and block row) before the
products, ``stat_dtype`` the hyperparameters' statistics, ``dtype`` the
forward.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch


def _sibling(name: str):
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"fm_gibbs_side_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


fm_gibbs = _sibling("fm_gibbs")
F64 = fm_gibbs.F64
ROW_CHUNK = fm_gibbs.ROW_CHUNK
HYPERS, WEIGHTS = fm_gibbs.HYPERS, fm_gibbs.WEIGHTS
widest_gap_sd, rmse = fm_gibbs.widest_gap_sd, fm_gibbs.rmse


# --------------------------------------------------------------------------
# The design
# --------------------------------------------------------------------------


def _columns(vocab: np.ndarray, values: np.ndarray) -> np.ndarray:
    """The one-hot column of each value: i + 1 for the i-th of the sorted
    training ``vocab``, 0 (unknown) for a value outside it."""
    pos = np.minimum(np.searchsorted(vocab, values), len(vocab) - 1)
    return np.where(vocab[pos] == values, pos + 1, 0).astype(np.int64)


def _one_hot(cols: np.ndarray, width: int):
    import scipy.sparse as sps

    n = cols.shape[0]
    return sps.csr_matrix((np.ones(n), cols, np.arange(n + 1)),
                          shape=(n, width))


def _implicit(keys, implicit_key, implicit_col, n_cols: int):
    """The N-hot rows of ``keys`` (sorted unique): row k holds 1/√c at
    the columns met with keys[k] in the implicit source, c their count
    (``examples/ml_features.py:_implicit_matrix``)."""
    import scipy.sparse as sps

    order = np.argsort(implicit_key, kind="stable")
    sorted_keys = implicit_key[order]
    row_of = np.searchsorted(keys, sorted_keys)
    valid = (row_of < len(keys)) & (
        keys[np.clip(row_of, 0, len(keys) - 1)] == sorted_keys)
    rows = row_of[valid]
    cols = implicit_col[order][valid]
    counts = np.bincount(rows, minlength=len(keys))
    data = 1.0 / np.sqrt(np.maximum(counts, 1))[rows]
    return sps.csr_matrix((data, (rows, cols)), shape=(len(keys), n_cols))


def greedy_colors(csc) -> np.ndarray:
    """Each column's colour by the greedy rule (module docstring)."""
    counters = np.zeros(csc.shape[0], dtype=np.int64)
    color = np.zeros(csc.shape[1], dtype=np.int64)
    for f in range(csc.shape[1]):
        rows = csc.indices[csc.indptr[f]:csc.indptr[f + 1]]
        if rows.size:
            color[f] = counters[rows].max()
            counters[rows] = color[f] + 1
    return color


def _color_stack(side, first_feature: int) -> list:
    """Per colour, in order: (its features' global ids [P], then for each
    of its non-zeros the block row, the feature's place in the colour
    and the value x)."""
    csc = side.tocsc()
    csc.sort_indices()
    color = greedy_colors(csc)
    n_colors = int(color.max()) + 1 if color.size else 0
    order = np.argsort(color, kind="stable")
    bounds = np.searchsorted(color[order], np.arange(n_colors + 1))
    slot = np.empty_like(color)
    slot[order] = np.arange(color.size) - bounds[color[order]]
    nz_col = np.repeat(np.arange(csc.shape[1]), np.diff(csc.indptr))
    nz = np.argsort(color[nz_col], kind="stable")
    nz_bounds = np.searchsorted(color[nz_col][nz], np.arange(n_colors + 1))
    rows, places, x = csc.indices[nz], slot[nz_col][nz], csc.data[nz]
    out = []
    for c in range(n_colors):
        lo, hi = nz_bounds[c], nz_bounds[c + 1]
        out.append((torch.as_tensor(first_feature
                                    + order[bounds[c]:bounds[c + 1]]),
                    torch.as_tensor(rows[lo:hi].astype(np.int64)),
                    torch.as_tensor(places[lo:hi]),
                    torch.as_tensor(x[lo:hi])))
    return out


def design(config: dict, train, test) -> dict:
    """The design of both splits (``fmbench/data.Ratings``): ``program``,
    the program's (X, blocks, grouping) of each, the blocks as (mapper,
    matrix) pairs; ``reference``, this module's (what ``sweep`` and
    ``forward`` take, host tensors); ``shape``, its sizes."""
    import scipy.sparse as sps

    vocab = {k: np.unique(getattr(train, k)) for k in ("day", "user", "item")}
    width = {k: len(v) + 1 for k, v in vocab.items()}
    # the implicit sets' columns, from the training split alone
    implicit_col = {k: _columns(vocab[k], getattr(train, k))
                    for k in ("user", "item")}
    # feature offsets: date | user, its implicit movies | movie, its
    # implicit users
    sizes = [width["day"], width["user"], width["item"], width["item"],
             width["user"]]
    offset = np.cumsum([0] + sizes[:-1])
    grouping = [g for g, n in enumerate(sizes) for _ in range(n)]
    blocks_of = (("user", "item", 1), ("item", "user", 3))

    def split_design(split, colors: bool):
        X = _one_hot(_columns(vocab["day"], split.day), width["day"])
        blocks, one_hot, side = [], [], []
        one_hot.append((0, torch.as_tensor(_columns(vocab["day"],
                                                    split.day)),
                        width["day"]))
        for key, other, g in blocks_of:
            keys, mapper = np.unique(getattr(split, key), return_inverse=True)
            implicit = _implicit(keys, getattr(train, key),
                                 implicit_col[other], width[other])
            blocks.append((mapper, sps.hstack(
                [_one_hot(_columns(vocab[key], keys), width[key]), implicit],
                format="csr")))
            one_hot.append((int(offset[g]), torch.as_tensor(
                _columns(vocab[key], getattr(split, key))), width[key]))
            coo = implicit.tocoo()
            part = dict(
                ids=torch.as_tensor(mapper.astype(np.int64)), B=len(keys),
                rows=torch.as_tensor(coo.row.astype(np.int64)),
                feat=torch.as_tensor(offset[g + 1] + coo.col.astype(np.int64)),
                x=torch.as_tensor(coo.data))
            if colors:
                part["colors"] = _color_stack(implicit, int(offset[g + 1]))
            side.append(part)
        # the port's table order: the one-hot tables in feature order
        one_hot.sort(key=lambda t: t[0])
        reference = dict(y=torch.as_tensor(split.y), one_hot=one_hot,
                         side=side,
                         group_index=torch.as_tensor(np.asarray(grouping)))
        return (X, blocks, grouping), reference

    program_train, ref_train = split_design(train, True)
    program_test, ref_test = split_design(test, False)
    return dict(
        program=dict(train=program_train, test=program_test),
        reference=dict(train=ref_train, test=ref_test),
        shape=dict(
            rows=len(train), test_rows=len(test),
            entities=[t[2] for t in ref_train["one_hot"]],
            block_rows=[s["B"] for s in ref_train["side"]],
            side_features=[sizes[2], sizes[4]],
            side_nonzeros=[int(s["x"].shape[0]) for s in ref_train["side"]],
            test_side_nonzeros=[int(s["x"].shape[0])
                                for s in ref_test["side"]],
            colors=[len(s["colors"]) for s in ref_train["side"]]))


def sweep_flops(config: dict, design: dict, scored_rows: int) -> float:
    """Model FLOPs of one sweep of this design: every table's Grams over
    the training rows (the three one-hot tables' entities and the two
    blocks' rows, rows × D² × 2, D = rank + 2), the one-hot entities'
    draws as factorisations (D³ / 3 each), each side feature's joint
    draw ((R + 1)³ / 3) and per side non-zero its sums and its Gram's
    carry (2 (R + 1)² + 4 D²), and the forward over ``scored_rows``
    held-out rows (each of the five parts' R + 1 gathered values summed,
    then ½(|Q|² − Σ|V|²), with the held-out blocks' side rows: 2 (R + 1)
    a non-zero)."""
    shape = design["shape"]
    R = config["rank"]
    D = R + 2
    n_tables = len(shape["entities"]) + len(shape["block_rows"])
    forward = (scored_rows * (n_tables + 2) * (R + 1)
               + sum(shape["test_side_nonzeros"]) * 2 * (R + 1)
               if scored_rows else 0)
    return (n_tables * shape["rows"] * D * D * 2
            + sum(shape["entities"]) * D ** 3 / 3
            + sum(shape["side_features"]) * (R + 1) ** 3 / 3
            + sum(shape["side_nonzeros"]) * (2 * (R + 1) ** 2 + 4 * D * D)
            + forward)


# --------------------------------------------------------------------------
# The forward
# --------------------------------------------------------------------------


def _parts(design: dict, w, V) -> list:
    """[(ids [N], per-entity rows [B, 2+R] = [w | V | qs])] of every table:
    a one-hot table's own weights, a block's side rows' sums (w̃ = x·w,
    Ṽ = x·V, qs = Σ x² |V|²), in w's dtype."""
    out = []
    for offset, ids, B in design["one_hot"]:
        Vt = V[offset:offset + B]
        out.append((ids, torch.cat([w[offset:offset + B, None], Vt,
                                    (Vt * Vt).sum(dim=1, keepdim=True)],
                                   dim=1)))
    for s in design["side"]:
        x = s["x"].to(w.dtype)
        Vf = V[s["feat"]]
        rows = torch.cat([(x * w[s["feat"]])[:, None], x[:, None] * Vf,
                          (x * x * (Vf * Vf).sum(dim=1))[:, None]], dim=1)
        out.append((s["ids"], torch.zeros(s["B"], rows.shape[1],
                                          dtype=w.dtype, device=w.device)
                    .index_add_(0, s["rows"], rows)))
    return out


def _sums(parts, rows, skip=None):
    """(Σ w, Σ V, Σ qs) of ``rows`` over the parts but ``skip``."""
    total = None
    for k, (ids, table) in enumerate(parts):
        if k != skip:
            g = table[ids[rows]]
            total = g if total is None else total + g
    R = total.shape[1] - 2
    return total[:, 0], total[:, 1:1 + R], total[:, 1 + R]


def _score(parts, w0, n_rows: int) -> torch.Tensor:
    """score [n_rows] in float64, computed in the parts' dtype."""
    out = []
    for r0 in range(0, n_rows, ROW_CHUNK):
        rows = torch.arange(r0, min(n_rows, r0 + ROW_CHUNK),
                            device=parts[0][0].device)
        lin, Q, qs = _sums(parts, rows)
        out.append((w0 + lin + 0.5 * ((Q * Q).sum(dim=1) - qs)).to(F64))
    return torch.cat(out)


def forward(design: dict, w0, w, V, dtype=F64) -> torch.Tensor:
    """score [N] of the design's rows in float64; ``dtype`` rounds w0, w
    and V and computes in that dtype (the forward's control)."""
    w, V = w.to(dtype), V.to(dtype)
    w0 = torch.as_tensor(w0, device=w.device).to(dtype)
    return _score(_parts(design, w, V), w0, design["y"].shape[0])


# --------------------------------------------------------------------------
# The sweep
# --------------------------------------------------------------------------


def _side_pass(part, parts, e, gi, draws, z, w, V, w_sd, V_sd, gram_dtype):
    """One block's side features, colour by colour (module docstring),
    from the residual ``e`` [N] and the parts' rows; writes the draws
    and their conditionals' sds into w, V, w_sd, V_sd."""
    R = V.shape[1]
    D = R + 2
    alpha = draws["alpha"]
    q_idx = torch.cat([torch.zeros(1, dtype=torch.long),
                       torch.arange(2, D)]).to(w.device)

    def z_rows(rows):
        _, Q, _ = _sums(parts, rows)
        ones = torch.ones(rows.shape[0], 1, dtype=F64, device=w.device)
        return torch.cat([ones, e[rows, None], Q], dim=1)

    G = fm_gibbs.entity_gram(part["ids"], part["B"], z_rows, D, gram_dtype)
    lam_all = torch.cat([draws["lambda_w"][:, None], draws["lambda_V"]],
                        dim=1)
    mu_all = torch.cat([draws["mu_w"][:, None], draws["mu_V"]], dim=1)
    noise = torch.cat([z["noise_w"][:, None], z["noise_V"]], dim=1)
    eye = torch.eye(D, dtype=F64, device=w.device)
    for feat, rows, place, x in part["colors"]:
        P = feat.shape[0]
        u_old = torch.cat([w[feat, None], V[feat]], dim=1)  # [P, R+1]
        Gb = G[rows]  # [nb, D, D]
        xv = x[:, None] * u_old[place, 1:]  # x V_j of each touched row
        # K = M Ĝ with M z = [1 | Q − x V_j]; then S_b = K Mᵀ
        K = Gb[:, q_idx, :].clone()
        K[:, 1:, :] -= xv[:, :, None] * Gb[:, 0:1, :]
        S_b = K[:, :, q_idx].clone()
        S_b[:, :, 1:] -= K[:, :, 0:1] * xv[:, None, :]
        S = torch.zeros(P, R + 1, R + 1, dtype=F64, device=w.device)
        S.index_add_(0, place, (x * x)[:, None, None] * S_b)
        t = torch.zeros(P, R + 1, dtype=F64, device=w.device)
        t.index_add_(0, place, x[:, None] * K[:, :, 1])
        g = gi[feat]
        lam, mu = lam_all[g], mu_all[g]
        A = alpha * S + torch.diag_embed(lam)
        rhs = alpha * (torch.einsum("pij,pj->pi", S, u_old) - t) + lam * mu
        L = torch.linalg.cholesky(A)
        mean = torch.cholesky_solve(rhs[:, :, None], L)[:, :, 0]
        u_new = mean + torch.linalg.solve_triangular(
            L.transpose(1, 2), noise[feat, :, None], upper=True)[:, :, 0]
        sd = torch.cholesky_inverse(L).diagonal(dim1=1, dim2=2).sqrt()
        w[feat], V[feat] = u_new[:, 0], u_new[:, 1:]
        w_sd[feat], V_sd[feat] = sd[:, 0], sd[:, 1:]
        # carry the touched block rows' Grams: z' = T z
        d = (u_new - u_old)[place]  # [nb, R+1]
        xdv = x[:, None] * d[:, 1:]
        T = eye.expand(rows.shape[0], D, D).clone()
        T[:, 1, 0] += x * (d[:, 0] - (xv * d[:, 1:]).sum(dim=1))
        T[:, 1, 2:] += xdv
        T[:, 2:, 0] += xdv
        G[rows] = T @ Gb @ T.transpose(1, 2)


def sweep(design: dict, prior: dict, state: dict, variates: dict,
          gram_dtype=None, stat_dtype=F64) -> Tuple[Dict[str, torch.Tensor],
                                                    Dict[str, torch.Tensor]]:
    """One sweep from ``state`` (w0, w, V, mu_w, lambda_w, mu_V, lambda_V)
    with the standard ``variates`` (gamma_alpha, normal_w0,
    gamma_lambda_w, normal_mu_w, gamma_lambda_V, normal_mu_V, noise_w,
    noise_V) on ``design`` (``design()``'s reference design of the
    training split).  Returns (draws, sds): every drawn value and the
    standard deviation of the conditional it was drawn from (a joint
    draw's: each coordinate's marginal), by name."""
    s = {k: v.to(F64) for k, v in state.items()}
    z = {k: v.to(F64) for k, v in variates.items()}
    y, gi = design["y"].to(F64), design["group_index"]
    n = y.shape[0]
    w0, w, V = s["w0"], s["w"].clone(), s["V"].clone()
    R = V.shape[1]
    parts = _parts(design, w.to(stat_dtype), V.to(stat_dtype))
    e = (_score(parts, w0.to(stat_dtype), n) - y).to(stat_dtype)
    draws, sds = fm_gibbs.draw_hypers(e, s, z, prior, gi, stat_dtype)
    w_sd, V_sd = torch.zeros_like(w), torch.zeros_like(V)
    for t, (offset, ids, B) in enumerate(design["one_hot"]):
        parts = _parts(design, w, V)
        e0 = _score(parts, 0.0, n) - y  # e without w0

        def z_rows(rows, t=t, parts=parts, e0=e0):
            _, Q, _ = _sums(parts, rows, skip=t)
            ones = torch.ones(rows.shape[0], 1, dtype=F64, device=w.device)
            return torch.cat([ones, e0[rows, None], Q], dim=1)

        Gt = fm_gibbs.entity_gram(ids, B, z_rows, R + 2, gram_dtype)
        fm_gibbs.draw_one_hot(Gt, slice(offset, offset + B), gi, draws,
                              z["noise_w"], z["noise_V"], w, V, w_sd, V_sd)
        del Gt
    for part in design["side"]:
        parts = _parts(design, w, V)
        e = _score(parts, draws["w0"], n) - y
        _side_pass(part, parts, e, gi, draws, z, w, V, w_sd, V_sd,
                   gram_dtype)
    draws["w"], draws["V"] = w, V
    sds["w"], sds["V"] = w_sd, V_sd
    return draws, sds
