"""The FM forward pass over a compiled row-space design.

PyTorch counterpart of ``myfm_tpu/ops/forward.py``:

    ŷ(x) = w0 + Σᵢ wᵢxᵢ + ½ Σᵣ[(Σᵢ Vᵢᵣxᵢ)² − Σᵢ Vᵢᵣ²xᵢ²]

over the plan's COO tables.  Block tables are scored on their unique
block rows and gathered to the original rows through the mapper.
Segment sums are ``index_add_``.  Gathers clamp the pad feature id
(``n_features``) into range as JAX's gathers do; pad entries carry
value 0, so they add nothing.
"""

from __future__ import annotations

import torch

from ..design import DesignPlan

# Upper bound on elements of the per-chunk q matrix (as in the TPU
# package): bounds the pairwise term's peak memory on large designs.
_CHUNK_ELEMENTS = 1 << 27


def _factor_chunk(rank: int, n_rows: int) -> int:
    return max(1, min(rank, _CHUNK_ELEMENTS // max(n_rows, 1)))


def take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` with indices past the end clamped to the last row —
    JAX's gather semantics, which the plans' pad ids rely on."""
    return a[idx.clamp(max=a.shape[0] - 1).long()]


def _table_matvec(coo_row, coo_col, coo_val, n_rows_local, vcols):
    contrib = coo_val[:, None] * take(vcols, coo_col)
    out = vcols.new_zeros((n_rows_local, vcols.shape[1]))
    return out.index_add_(0, coo_row, contrib)


def _table_matvec1(coo_row, coo_col, coo_val, n_rows_local, v):
    contrib = coo_val * take(v, coo_col)
    return v.new_zeros((n_rows_local,)).index_add_(0, coo_row, contrib)


def linear_term(plan: DesignPlan, w: torch.Tensor) -> torch.Tensor:
    """Σᵢ wᵢxᵢ per original row."""
    m = plan.main
    out = _table_matvec1(m.coo_row, m.coo_col, m.coo_val, plan.n_rows, w)
    for b in plan.blocks:
        lb = _table_matvec1(b.coo_row, b.coo_col, b.coo_val, b.block_size, w)
        out = out + take(lb, b.mapper)
    return out


def factor_q(plan: DesignPlan, vcols: torch.Tensor) -> torch.Tensor:
    """q[n, r] = Σᵢ x_{ni} V_{ir} for a chunk of factor columns [F, C]."""
    m = plan.main
    q = _table_matvec(m.coo_row, m.coo_col, m.coo_val, plan.n_rows, vcols)
    for b in plan.blocks:
        qb = _table_matvec(b.coo_row, b.coo_col, b.coo_val, b.block_size,
                           vcols)
        q = q + take(qb, b.mapper)
    return q


def _factor_q_sq(plan: DesignPlan, vcols: torch.Tensor) -> torch.Tensor:
    """q_S[n, r] = Σᵢ x²_{ni} V²_{ir}."""

    def sq_matvec(coo_row, coo_col, coo_val, n_rows_local):
        contrib = (coo_val * coo_val)[:, None] * take(vcols, coo_col) ** 2
        out = vcols.new_zeros((n_rows_local, vcols.shape[1]))
        return out.index_add_(0, coo_row, contrib)

    m = plan.main
    qs = sq_matvec(m.coo_row, m.coo_col, m.coo_val, plan.n_rows)
    for b in plan.blocks:
        qsb = sq_matvec(b.coo_row, b.coo_col, b.coo_val, b.block_size)
        qs = qs + take(qsb, b.mapper)
    return qs


def pairwise_term(plan: DesignPlan, V: torch.Tensor) -> torch.Tensor:
    """½ Σᵣ (q² − q_S) per row, chunked over factors."""
    rank = V.shape[1]
    out = V.new_zeros((plan.n_rows,))
    chunk = _factor_chunk(rank, plan.n_rows)
    for r0 in range(0, rank, chunk):
        vc = V[:, r0 : r0 + chunk]
        q = factor_q(plan, vc)
        qs = _factor_q_sq(plan, vc)
        out = out + 0.5 * (q * q - qs).sum(dim=-1)
    return out


def predict_score(plan: DesignPlan, w0, w: torch.Tensor,
                  V: torch.Tensor) -> torch.Tensor:
    """Full FM score per row."""
    score = w0 + linear_term(plan, w)
    if V.shape[1] > 0:
        score = score + pairwise_term(plan, V)
    return score
