"""The FM forward pass over a compiled row-space design.

PyTorch counterpart of ``myfm_tpu/ops/forward.py``:

    ŷ(x) = w0 + Σᵢ wᵢxᵢ + ½ Σᵣ[(Σᵢ Vᵢᵣxᵢ)² − Σᵢ Vᵢᵣ²xᵢ²]

over the plan's COO tables.  Block tables are scored on their unique
block rows and gathered to the original rows through the mapper.
Segment sums go through ops/segsum.py (one order of addition on
every run).  Gathers clamp the pad feature id
(``n_features``) into range as JAX's gathers do; pad entries carry
value 0, so they add nothing.
"""

from __future__ import annotations

import torch

from ..design import DesignPlan
from .segsum import segment_sum

# Upper bound on elements of the per-chunk q matrix (as in the TPU
# package): bounds the pairwise term's peak memory on large designs.
_CHUNK_ELEMENTS = 1 << 27


def _factor_chunk(rank: int, n_rows: int) -> int:
    return max(1, min(rank, _CHUNK_ELEMENTS // max(n_rows, 1)))


def take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` with indices past the end clamped to the last row —
    JAX's gather semantics, which the plans' pad ids rely on."""
    return a[idx.clamp(max=a.shape[0] - 1).long()]


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` at full float32 precision whatever the process's TF32
    settings (JAX's ``Precision.HIGHEST``): float32 operands multiply in
    float64 and round once; float64 as it is."""
    if a.dtype == torch.float32:
        return (a.double() @ b.double()).float()
    return a @ b


def _table_matvec(t, n_rows_local, vcols):
    """Σ over a table's entries (``TablePlan`` or ``BlockPlan``) of
    x·vcols[col] per table row."""
    scale = t.coo_val if vcols.dim() == 1 else t.coo_val[:, None]
    return segment_sum(scale * take(vcols, t.coo_col), t.coo_row,
                       n_rows_local, order=t.coo_order)


def linear_term(plan: DesignPlan, w: torch.Tensor) -> torch.Tensor:
    """Σᵢ wᵢxᵢ per original row."""
    out = _table_matvec(plan.main, plan.n_rows, w)
    for b in plan.blocks:
        out = out + take(_table_matvec(b, b.block_size, w), b.mapper)
    return out


def factor_q(plan: DesignPlan, vcols: torch.Tensor) -> torch.Tensor:
    """q[n, r] = Σᵢ x_{ni} V_{ir} for a chunk of factor columns [F, C]."""
    q = _table_matvec(plan.main, plan.n_rows, vcols)
    for b in plan.blocks:
        q = q + take(_table_matvec(b, b.block_size, vcols), b.mapper)
    return q


def factor_q_single(plan: DesignPlan, v: torch.Tensor) -> torch.Tensor:
    """q[n] for one factor column [F]: the same matvec as the linear
    term's."""
    return linear_term(plan, v)


def _factor_q_sq(plan: DesignPlan, vcols: torch.Tensor) -> torch.Tensor:
    """q_S[n, r] = Σᵢ x²_{ni} V²_{ir}."""

    def sq_matvec(t, n_rows_local):
        x2 = (t.coo_val * t.coo_val)[:, None]
        contrib = x2 * take(vcols, t.coo_col) ** 2
        return segment_sum(contrib, t.coo_row, n_rows_local,
                           order=t.coo_order)

    qs = sq_matvec(plan.main, plan.n_rows)
    for b in plan.blocks:
        qs = qs + take(sq_matvec(b, b.block_size), b.mapper)
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
