"""Multi-device Gibbs on the row-space engines (colored and joint).

PyTorch counterpart of ``myfm_tpu/parallel/sharding.py``.  Every rank
compiles the whole design (the same plan one process compiles) and
keeps its own contiguous rows of it (``shard_design``):

* the main table's entries and colors keep the rank's rows, relabelled
  from 0; the sweep sums their per-feature sums over the data axis
  (``GibbsConfig.axis``, passed down as the ops' ``axis``);
* RelationBlock tables (unique entities) stay whole on every rank; the
  mapper keeps the rank's rows, and every block-row sum over it is
  summed over the axis (``rowspace.block_sum`` and
  ``joint.build_block_gram``, whose all-reduced Ĝ then feeds the joint
  tail, kernel 4 on the card, alike on every rank);
* w, V, the hyperparameters and the generator are replicated, so every
  rank draws the same weights from the same summed statistics.

The TPU package pads every shard to one static shape for ``shard_map``;
a rank here holds exactly its rows, so the plan needs no pad rows and
no row mask.  A shard is data only, a function of the design, the
rank's index and the axis size: the plan cache keys it by those.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..design import (
    ColorPlan,
    ColorStack,
    DesignPlan,
    TablePlan,
    compile_design,
    joint_auto_eligible,
    with_segment_orders,
)
from ..ops.gibbs import GibbsConfig
from ..trainer import GibbsTrainer
from .collectives import Axis


def _partition_entries(rows: torch.Tensor, lo: int, hi: int):
    """(keep mask, relabelled rows) of entries whose row is in [lo, hi)."""
    keep = (rows >= lo) & (rows < hi)
    return keep, rows[keep] - lo


def _shard_color(c: ColorPlan, lo: int, hi: int) -> ColorPlan:
    keep, rows = _partition_entries(c.rows, lo, hi)
    return dataclasses.replace(c, rows=rows.to(c.rows.dtype),
                               vals=c.vals[keep], seg=c.seg[keep])


def _shard_stack(cs: ColorStack, lo: int, hi: int) -> ColorStack:
    """Each color's entries in [lo, hi), padded to the longest with
    zero-valued entries at row 0 and the drop slot Pf."""
    parts = [_shard_color(ColorPlan(cs.rows[k], cs.vals[k], cs.seg[k],
                                    cs.feat[k], cs.sx2[k]), lo, hi)
             for k in range(cs.rows.shape[0])]
    Pe = max(1, max(p.rows.shape[0] for p in parts))
    Pf = cs.feat.shape[1]

    def pad(x, fill):
        out = x.new_full((Pe,), fill)
        out[: x.shape[0]] = x
        return out

    return ColorStack(
        rows=torch.stack([pad(p.rows, 0) for p in parts]),
        vals=torch.stack([pad(p.vals, 0) for p in parts]),
        seg=torch.stack([pad(p.seg, Pf) for p in parts]),
        feat=cs.feat, sx2=cs.sx2)


def shard_design(plan: DesignPlan, axis: Axis) -> DesignPlan:
    """This rank's part of a compiled design (module docstring)."""
    n = plan.n_rows
    lo, hi = axis.rows(n)
    m = plan.main
    keep, coo_row = _partition_entries(m.coo_row, lo, hi)
    main = TablePlan(
        coo_row=coo_row.to(m.coo_row.dtype), coo_col=m.coo_col[keep],
        coo_val=m.coo_val[keep],
        colors=tuple(_shard_color(c, lo, hi) for c in m.colors),
        color_stack=(None if m.color_stack is None
                     else _shard_stack(m.color_stack, lo, hi)),
        col_offset=m.col_offset, n_cols=m.n_cols,
    )
    blocks = tuple(
        dataclasses.replace(b, mapper=b.mapper[lo:hi])
        for b in plan.blocks)
    return with_segment_orders(dataclasses.replace(
        plan, main=main, blocks=blocks, n_rows=hi - lo, row_lo=lo,
        n_total=n))


class ShardedGibbsTrainer(GibbsTrainer):
    """Data-parallel Gibbs on the colored or joint engine: one rank of a
    ``torch.distributed`` group.  Every rank passes the whole design; the
    chain equals the one-process chain of ``GibbsTrainer`` on the same
    design and seed up to the order of the summed statistics."""

    def __init__(
        self,
        X,
        X_rel: Sequence,
        y: np.ndarray,
        cfg: GibbsConfig,
        rank: int,
        init_stdev: float,
        random_seed: int,
        mesh: Optional[Axis] = None,
        grouping: Optional[np.ndarray] = None,
        dtype=np.float32,
        strategy: str = "auto",
        max_unrolled_colors: int = 16,
        joint_auto: bool = False,
        device="cuda",
        fingerprint: Optional[str] = None,
    ):
        axis = mesh if isinstance(mesh, Axis) else Axis(mesh)
        want_joint = cfg.joint_rows or joint_auto

        def build():
            return shard_design(compile_design(
                X, X_rel, grouping=grouping, dtype=dtype, strategy=strategy,
                max_unrolled_colors=max_unrolled_colors,
                joint_dense=want_joint, joint_rank=rank, device=device,
            ), axis)

        plan = build() if fingerprint is None else _cached(
            "row_gibbs", fingerprint,
            (np.dtype(dtype).str, strategy, max_unrolled_colors, want_joint,
             rank, str(device)), axis, build)
        if joint_auto and not cfg.joint_rows and joint_auto_eligible(
                plan, rank, dtype):
            # the estimator's "auto" upgrade, on the same gates, so a
            # sharded fit resolves the engine one process resolves
            cfg = dataclasses.replace(cfg, joint_rows=True)
        cfg = dataclasses.replace(cfg, axis=axis)
        super().__init__(plan, y, cfg, rank, init_stdev, random_seed, dtype)


def _cached(kind, fingerprint, key, axis: Axis, build):
    """A shard's plan through the plan cache, keyed also by this rank's
    index and the axis size."""
    from ..design_cache import get_or_build

    return get_or_build(
        kind, fingerprint,
        tuple(key) + ("shard", axis.index, axis.size), build)
