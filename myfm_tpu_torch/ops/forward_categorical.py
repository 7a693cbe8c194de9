"""Entity-space posterior-predictive scoring (the serving fast path).

PyTorch counterpart of ``myfm_tpu/ops/forward_categorical.py``.  The
sample axis is batched into columns: each table's per-entity weight rows
for all S kept samples are stacked into one gather source, so scoring S
samples costs one row gather per table per row chunk.

Layout (per table, S samples, rank R):

    src_v  [B+1, S*R]   factor rows, sample-major (pad row zero)
    src_wq [B+1, 2*S]   [w_s | qs_s] where qs_s = Σ_r V_sr²
                        (for an entity+attribute table: the effective
                        rows w̃, Ṽ and the true Σ_i x² V², so the same
                        identity holds)

and per row chunk

    score[n, s] = w0_s + lin[n, s] + ½ (Σ_r Q² − qs)[n, s].

The posterior sum (probit-squashed per sample for classification, or the
per-class probabilities of each sample's cutpoints for the ordered task)
reduces on the device; only the [N] (or [N, K]) result reaches the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import sparse as sps

from .forward import matmul_fp32


@dataclasses.dataclass(frozen=True)
class InferenceTable:
    """One table of an inference design: the per-row entity map plus,
    for an entity+attribute table, the dense per-entity side matrix (no
    tile packing — that exists for the sweep's Gram builds)."""

    ent: torch.Tensor  # [N] int32 — entity id per row
    col_offset: int
    n_cols: int
    xs: Optional[torch.Tensor] = None  # [B, Fs] dense side matrix
    feat_cols: Optional[torch.Tensor] = None  # [Fs] global feature ids


@dataclasses.dataclass(frozen=True)
class InferencePlan:
    tables: Tuple[InferenceTable, ...]
    n_rows: int
    n_features: int


def _onehot_runs(bc: sps.csc_matrix):
    """(maximal one-hot column runs [(lo, hi)], the other columns) of a
    block: a run is a maximal stretch of columns whose values are all
    1.0 with exactly one hit per block row; a column that starts no run
    is a side column."""
    F = bc.shape[1]
    runs: List[Tuple[int, int]] = []
    side_cols: List[int] = []
    lo = 0
    while lo < F:
        hi = lo
        while hi < F:
            d = bc.data[bc.indptr[hi] : bc.indptr[hi + 1]]
            if d.size and not (d == 1.0).all():
                break
            hi += 1
        if hi > lo and (np.diff(bc[:, lo:hi].tocsr().indptr) == 1).all():
            runs.append((lo, hi))
            lo = hi
        else:
            side_cols.append(lo)
            lo += 1
    return runs, side_cols


def compile_categorical_inference(
    X: Optional[sps.spmatrix],
    blocks: Sequence,
    dtype,
    device,
) -> Optional[InferencePlan]:
    """Inference plan for a categorical / entity+attribute design, or
    None when any table fails the gates (the caller falls back to the
    row-space scorer).  Needs no grouping: a block that is not one-hot
    has its maximal one-hot column runs peeled into tables of their own,
    and whatever is left is a dense side matrix over the block rows,
    within ``SIDE_DENSE_ELEMS``."""
    from ..design_categorical import SIDE_DENSE_ELEMS, categorical_mapping

    dtype = np.dtype(dtype)
    if X is None:
        if not blocks:
            return None
        n_rows = blocks[0].mapper_size
        X = sps.csr_matrix((n_rows, 0), dtype=dtype)
    X = sps.csr_matrix(X)
    n_rows = X.shape[0]
    n_features = X.shape[1] + sum(b.feature_size for b in blocks)

    def ids(a):
        return torch.as_tensor(np.asarray(a).astype(np.int32), device=device)

    tables: List[InferenceTable] = []

    def add_onehot(ent, B, off):
        tables.append(InferenceTable(ent=ids(ent), col_offset=off, n_cols=B))

    if X.shape[1] > 0:
        ent = categorical_mapping(X)
        if ent is None:
            return None
        add_onehot(ent, X.shape[1], 0)
    offset = X.shape[1]
    for b in blocks:
        bx = sps.csr_matrix(b.data)
        mapper = np.asarray(b.original_to_block, dtype=np.int64)
        ent = categorical_mapping(bx, mapper)
        if ent is not None:
            add_onehot(ent, b.feature_size, offset)
            offset += b.feature_size
            continue
        bc = bx.tocsc()
        runs, side_cols = _onehot_runs(bc)
        for lo, hi in runs:
            add_onehot(categorical_mapping(bc[:, lo:hi].tocsr(), mapper),
                       hi - lo, offset + lo)
        if side_cols:
            B = b.block_size
            if B * len(side_cols) > SIDE_DENSE_ELEMS:
                return None
            cols = np.asarray(side_cols, dtype=np.int64)
            tables.append(InferenceTable(
                ent=ids(mapper),
                col_offset=offset + int(cols[0]),
                n_cols=B,
                xs=torch.as_tensor(bc[:, cols].toarray().astype(dtype),
                                   device=device),
                feat_cols=ids(offset + cols),
            ))
        offset += b.feature_size
    if not tables:
        return None
    return InferencePlan(
        tables=tuple(tables), n_rows=n_rows, n_features=n_features
    )


def _pad_zero_row(arr: torch.Tensor) -> torch.Tensor:
    return torch.cat([arr, arr.new_zeros((1,) + tuple(arr.shape[1:]))])


def stack_sources(plan: InferencePlan, ws: torch.Tensor,
                  Vs: torch.Tensor):
    """Per-table stacked gather sources for S samples: a list of
    (src_v [B+1, S*R], src_wq [B+1, 2*S]) whose pad row (entity id
    == B) is all zero."""
    S, F, R = Vs.shape
    out = []
    for t in plan.tables:
        B = t.n_cols
        if t.xs is None:
            off = t.col_offset
            V_t = Vs[:, off : off + B, :]  # [S, B, R]
            w_t = ws[:, off : off + B]  # [S, B]
            qs_t = (V_t * V_t).sum(dim=2)  # [S, B]
        else:
            fc = t.feat_cols.long()
            w_s, V_s = ws[:, fc], Vs[:, fc, :]  # [S, Fs], [S, Fs, R]
            w_t = matmul_fp32(t.xs, w_s.T).T  # [S, B]
            V_t = matmul_fp32(t.xs, V_s)  # [S, B, R]
            # the true per-entity Σ_i x² V² (not Ṽ²): with it the q-cache
            # identity holds for multi-hot rows as it is
            qs_t = matmul_fp32(t.xs * t.xs, (V_s * V_s).sum(dim=2).T).T
        src_v = V_t.permute(1, 0, 2).reshape(B, S * R)
        src_wq = torch.cat([w_t.T, qs_t.T], dim=1)  # [B, 2S]
        out.append((_pad_zero_row(src_v), _pad_zero_row(src_wq)))
    return out


def _chunk_scores(plan, sources, w0s, idxs, n_samples, rank):
    """Scores [n, S] for one chunk of rows (idxs: per-table entity ids,
    pad id == n_cols -> zero rows)."""
    S = n_samples
    n = idxs[0].shape[0]
    src0 = sources[0][0]
    accQ = src0.new_zeros(n, S * rank)
    lin = src0.new_zeros(n, S)
    qs = src0.new_zeros(n, S)
    for (src_v, src_wq), idx in zip(sources, idxs):
        gwq = src_wq[idx]  # [n, 2S]
        accQ = accQ + src_v[idx]
        lin = lin + gwq[:, :S]
        qs = qs + gwq[:, S:]
    ones = (idxs[0] < plan.tables[0].n_cols).to(src0.dtype)
    q2 = (accQ * accQ).reshape(n, S, rank).sum(dim=2)
    return ones[:, None] * w0s[None, :] + lin + 0.5 * (q2 - qs)


_ROW_CHUNK = 1 << 19


def serving_row_chunk(
    n_samples: int, rank: int, budget_elems: int = 1 << 25
) -> int:
    """Row-chunk size bounding the scoring pass's working set: the
    accQ accumulator and the per-table gathers are [row_chunk, S*R]."""
    per_row = max(n_samples * max(rank, 1), 1)
    rc = max(budget_elems // per_row, 512)
    return min(_ROW_CHUNK, 1 << (rc.bit_length() - 1))


def oprobit_class_probs(score: torch.Tensor,
                        cutpoints: torch.Tensor) -> torch.Tensor:
    """P(class k | score, γ) = Φ(γ_k − s) − Φ(γ_{k−1} − s) with γ_{−1} =
    −∞ and γ_{K−1} = +∞: scores [..., S] and cutpoints [S, K−1] give
    [..., S, K]."""
    cdf = torch.special.ndtr(cutpoints - score[..., None])
    zero = torch.zeros_like(cdf[..., :1])
    return (torch.cat([cdf, zero + 1.0], dim=-1)
            - torch.cat([zero, cdf], dim=-1))


def scores_samples_reduce(
    plan: InferencePlan,
    w0s: torch.Tensor,  # [S]
    ws: torch.Tensor,  # [S, F]
    Vs: torch.Tensor,  # [S, F, R]
    mode: str = "sum",  # "sum" | "probit_sum" | "oprobit_sum"
    cutpoints: Optional[torch.Tensor] = None,  # [S, K-1] for oprobit
    row_chunk: int = _ROW_CHUNK,
):
    """Device-reduced posterior-predictive sums over S samples.

    mode "sum":         Σ_s score_s                  -> [N]
    mode "probit_sum":  Σ_s Φ(score_s)               -> [N]
    mode "oprobit_sum": Σ_s P(class | score_s, γ_s)  -> [N, K]
    (callers divide by the total sample count; summing keeps chunked
    sample batches exact)."""
    if mode not in ("sum", "probit_sum", "oprobit_sum"):
        raise ValueError(f"serving mode {mode!r}")
    if (mode == "oprobit_sum") != (cutpoints is not None):
        raise ValueError("cutpoints go with mode 'oprobit_sum' only")
    S, F, R = Vs.shape
    sources = stack_sources(plan, ws, Vs)
    out = []
    for r0 in range(0, plan.n_rows, row_chunk):
        idxs = [t.ent[r0 : r0 + row_chunk] for t in plan.tables]
        sc = _chunk_scores(plan, sources, w0s, idxs, S, R)
        if mode == "probit_sum":
            sc = torch.special.ndtr(sc)
        elif mode == "oprobit_sum":
            sc = oprobit_class_probs(sc, cutpoints)
        out.append(sc.sum(dim=1))
    return torch.cat(out)


def scores_samples_reduce_sharded(
    plan: InferencePlan,
    w0s: torch.Tensor,
    ws: torch.Tensor,
    Vs: torch.Tensor,
    axis,
    mode: str = "sum",
    cutpoints: Optional[torch.Tensor] = None,
    row_chunk: int = _ROW_CHUNK,
):
    """``scores_samples_reduce`` with the rows split over the data axis
    ``axis`` (parallel/collectives.Axis): each rank scores its own
    contiguous rows against the replicated samples, and one all-gather
    returns the whole [N] / [N, K] sums on every rank.  Scoring is
    row-independent, so every row's value is the one a single process
    computes for it."""
    lo, hi = axis.rows(plan.n_rows)
    local = dataclasses.replace(
        plan, n_rows=hi - lo,
        tables=tuple(dataclasses.replace(t, ent=t.ent[lo:hi])
                     for t in plan.tables))
    out = scores_samples_reduce(local, w0s, ws, Vs, mode=mode,
                                cutpoints=cutpoints, row_chunk=row_chunk)
    return axis.gather_rows(out, plan.n_rows)
