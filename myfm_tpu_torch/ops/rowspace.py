"""Helpers of the row-space color sweeps (the colored Gibbs engine in
ops/gibbs.py and row-space CAVI in ops/variational.py).

A color's pad entries carry x = 0 and a slot id equal to the color's
real feature count (at most its slot count Pf); pad slots carry the
feature id ``n_features``.  JAX's gathers clamp such ids into range and
its scatters (``mode="drop"``, ``segment_sum``) drop them; these helpers
keep both rules.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..design import BlockPlan, ColorPlan, ColorStack


def seg_sum(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Segment sum into ``n`` slots; a pad slot id equal to ``n`` is
    dropped, as JAX's ``segment_sum`` drops it."""
    return vals.new_zeros(n + 1).index_add_(0, seg, vals)[:n]


def set_feat(a: torch.Tensor, feat: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """``a.at[feat].set(vals, mode="drop")``: pad ids (= len(a)) write a
    scratch row that is cut off."""
    out = torch.cat([a, a.new_zeros(1)])
    out[feat] = vals
    return out[:-1]


def stack_colors(stack: Optional[ColorStack]):
    """The colors of a ColorStack, one ColorPlan each (views)."""
    if stack is None:
        return ()
    return tuple(
        ColorPlan(stack.rows[i], stack.vals[i], stack.seg[i],
                  stack.feat[i], stack.sx2[i])
        for i in range(stack.rows.shape[0])
    )


def one_color(c: ColorPlan) -> ColorStack:
    """A ColorStack holding the single color ``c``."""
    return ColorStack(c.rows[None], c.vals[None], c.seg[None],
                      c.feat[None], c.sx2[None])


def block_sum(x: torch.Tensor, b: BlockPlan) -> torch.Tensor:
    """Σ of a per-row tensor over each block row's members."""
    out = x.new_zeros((b.block_size,) + tuple(x.shape[1:]))
    return out.index_add_(0, b.mapper, x)


def term_index(terms, width, device):
    """(index tensors per term field, coefficients) of a term table, pad
    terms as index 0 with coefficient 0."""
    full = [t if t is not None else (0,) * (width - 1) + (0.0,)
            for t in terms]
    idx = [torch.tensor([t[k] for t in full], device=device)
           for k in range(width - 1)]
    return idx, [t[-1] for t in full]
