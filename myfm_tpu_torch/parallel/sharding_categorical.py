"""Multi-device training on the categorical fast path (Gibbs and CAVI).

PyTorch counterpart of ``myfm_tpu/parallel/sharding_categorical.py``.
Rows split contiguously over the ranks of a ``torch.distributed``
group; each rank tiles its own rows (``compile_sharded_categorical``)
with the (T, S) one process takes for the whole table, so a table is
accepted or refused exactly where one process accepts or refuses it.
Weights, hyperparameters and the generator are replicated.  Per table,
each rank runs kernel 1 over its rows' tiles and gets partial
per-entity Grams; one reduce-scatter (or, where the entity count does
not split evenly over the ranks, or for an entity+attribute table, one
all-reduce) turns them into the whole design's statistics, after which
every rank makes the same entity-space draws (ops/categorical.py and
ops/categorical_vi.py read the axis from the config).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..design_categorical import CategoricalPlan, try_compile_categorical
from ..trainer import CategoricalGibbsTrainer
from ..vi_trainer import CategoricalVITrainer
from .collectives import Axis


def compile_sharded_categorical(
    X,
    blocks: Sequence,
    grouping: Optional[np.ndarray],
    axis: Axis,
    dtype,
    device,
    rank: int,
    allow_side: bool = False,
    gate_rank: Optional[int] = None,
    fingerprint: Optional[str] = None,
    kind: str = "cat_gibbs",
) -> Optional[CategoricalPlan]:
    """This rank's fast-path plan of the design, or None where one
    process would not compile it.  ``rank`` is the width the tiling is
    chosen for (``try_compile_categorical``); with a ``fingerprint`` the
    plan comes through the plan cache under ``kind``, keyed also by the
    rank's index and the axis size."""
    from ..base import check_data_consistency
    from ..design_cache import get_or_build

    rows = axis.rows(check_data_consistency(X, list(blocks)))

    def build():
        return try_compile_categorical(
            X, blocks, grouping=grouping, n_groups=None, dtype=dtype,
            device=device, rank=rank, allow_side=allow_side,
            gate_rank=gate_rank, rows=rows)

    if fingerprint is None:
        return build()
    return get_or_build(
        kind, fingerprint,
        (np.dtype(dtype).str, rank, allow_side, gate_rank, str(device),
         "shard", axis.index, axis.size), build)


class ShardedCategoricalGibbsTrainer(CategoricalGibbsTrainer):
    """Data-parallel fast-path Gibbs: one rank of a process group.  The
    chain equals ``CategoricalGibbsTrainer``'s on the same design and
    seed up to the order of the summed Gram partials."""

    def __init__(
        self,
        X,
        X_rel: Sequence,
        y: np.ndarray,
        cfg,  # GibbsConfig
        rank: int,
        init_stdev: float,
        random_seed: int,
        mesh=None,
        grouping: Optional[np.ndarray] = None,
        dtype=np.float32,
        device="cuda",
        fingerprint: Optional[str] = None,
    ):
        axis = mesh if isinstance(mesh, Axis) else Axis(mesh)
        plan = compile_sharded_categorical(
            X, X_rel, grouping, axis, dtype, device, rank,
            allow_side=bool(cfg.fit_linear), fingerprint=fingerprint)
        if plan is None:
            raise ValueError(
                "Design is not all-categorical; use ShardedGibbsTrainer.")
        cfg = dataclasses.replace(cfg, axis=axis)
        super().__init__(plan, y, cfg, rank, init_stdev, random_seed, dtype)


class ShardedCategoricalVITrainer(CategoricalVITrainer):
    """Data-parallel CAVI on the fast path (one-hot, else
    entity+attribute plans, tiled and gated as one process tiles and
    gates them).  CAVI is deterministic, so the sharded run equals the
    one-process run up to the order of the summed Gram partials."""

    def __init__(
        self,
        X,
        X_rel: Sequence,
        y: np.ndarray,
        cfg,  # VariationalConfig
        rank: int,
        init_stdev: float,
        random_seed: int,
        mesh=None,
        grouping: Optional[np.ndarray] = None,
        dtype=np.float32,
        device="cuda",
        fingerprint: Optional[str] = None,
    ):
        axis = mesh if isinstance(mesh, Axis) else Axis(mesh)
        plan = None
        for kind, allow_side, gate in (("cat_vi", False, 3 * rank),
                                       ("cat_vi_ea", True, 4 * rank)):
            plan = compile_sharded_categorical(
                X, X_rel, grouping, axis, dtype, device, max(3 * rank, 1),
                allow_side=allow_side, gate_rank=max(gate, 1),
                fingerprint=fingerprint, kind=kind)
            if plan is not None:
                break
        if plan is None:
            raise ValueError(
                "Multi-device variational training requires an "
                "all-categorical or entity+attribute design.")
        cfg = dataclasses.replace(cfg, axis=axis)
        super().__init__(plan, y, cfg, rank, init_stdev, random_seed, dtype)
