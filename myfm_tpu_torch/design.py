"""Row-space design compilation for the joint Gibbs engine.

PyTorch counterpart of ``myfm_tpu/design.py``: the main table and every
RelationBlock are lowered to flat COO arrays (for the forward pass) and
their features are partitioned into colors, sets of columns that share
no row, whose Gibbs conditionals are independent and are drawn together.
With ``joint_dense=True`` each block also gets the dense block-row color
operands of the joint sweep (``DenseColor`` / ``DenseStack``).

Everything is built with numpy on the host and uploaded once to the
plan's ``device``; every array equals the TPU package's (same padding,
same pad values, same dtypes).  The coloring is the numpy greedy pass,
which assigns exactly what the TPU package's native planner assigns.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import sparse as sps

from .relational import RelationBlock


def _pad_to(n: int, multiple: int = 8) -> int:
    if n == 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


# minimum number of single-entry features in an unrolled dense color
# before they are split into the identity fast step (DenseColor.id_*)
IDENTITY_SPLIT_MIN = 32

# sweep_strategy="auto" upgrades to the merged joint-row sweep up to
# this rank (same value as the TPU package)
JOINT_AUTO_MAX_RANK = 128

# above this rank the joint compile drops the identity split and caps
# the unrolled dense head at 4 colors
JOINT_UNROLL_MAX_RANK = 16


# ---------------------------------------------------------------------------
# Plan dataclasses (plain dataclasses of tensors on one device)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ColorPlan:
    """One row-disjoint feature set of a table.  Entries are sorted by
    ``seg`` and padded with ``val == 0``; ``feat`` is padded with the
    total feature count (an index past the end)."""

    rows: torch.Tensor  # [Pe] int32, local row space
    vals: torch.Tensor  # [Pe] float
    seg: torch.Tensor  # [Pe] int32, slot in `feat`; pad = n_feat
    feat: torch.Tensor  # [Pf] int32, global feature ids; pad = F_total
    sx2: torch.Tensor  # [Pf] float, Σx² over expanded rows


@dataclasses.dataclass(frozen=True)
class ColorStack:
    """Same-shaped colors stacked along a leading color axis."""

    rows: torch.Tensor  # [C, Pe]
    vals: torch.Tensor  # [C, Pe]
    seg: torch.Tensor  # [C, Pe]
    feat: torch.Tensor  # [C, Pf]
    sx2: torch.Tensor  # [C, Pf]


@dataclasses.dataclass(frozen=True)
class TablePlan:
    """Compiled main table: COO for forwards plus colors for the sweep."""

    coo_row: torch.Tensor  # [Pe_all] int32
    coo_col: torch.Tensor  # [Pe_all] int32, global ids (pad F_total)
    coo_val: torch.Tensor  # [Pe_all] float (pad 0)
    colors: Tuple[ColorPlan, ...]
    color_stack: Optional[ColorStack]
    col_offset: int
    n_cols: int


@dataclasses.dataclass(frozen=True)
class DenseColor:
    """One color in dense block-row form (joint sweep): every block row
    belongs to at most one drawn feature of the color.  ``id_xw`` /
    ``id_feat`` (optional) carve out the single-entry features, drawn
    straight off their row's Gram entries (ops/joint.py
    ``_identity_color_apply``)."""

    xw: torch.Tensor  # [B] float, x at each block row (0 = absent)
    segb: torch.Tensor  # [B] int32, slot in `feat` (pad = Pf)
    feat: torch.Tensor  # [Pf] int32, global ids (pad = F_total)
    id_xw: Optional[torch.Tensor] = None  # [B] float
    id_feat: Optional[torch.Tensor] = None  # [B] int32 (F_total = none)


@dataclasses.dataclass(frozen=True)
class DenseStack:
    """Stacked DenseColors with a common Pf (the sequential tail)."""

    xw: torch.Tensor  # [C, B]
    segb: torch.Tensor  # [C, B]
    feat: torch.Tensor  # [C, Pf]


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Compiled RelationBlock: block-row COO, mapper and cardinality,
    plus the joint sweep's dense color operands when compiled with
    ``joint_dense=True`` inside the budget."""

    coo_row: torch.Tensor  # [Pe_all] int32, block rows
    coo_col: torch.Tensor  # [Pe_all] int32, global ids
    coo_val: torch.Tensor  # [Pe_all] float
    colors: Tuple[ColorPlan, ...]
    color_stack: Optional[ColorStack]
    mapper: torch.Tensor  # [N] int32, original row -> block row
    cardinality: torch.Tensor  # [B] float
    col_offset: int
    n_cols: int
    block_size: int
    dense_colors: Tuple[DenseColor, ...] = ()
    dense_stack: Optional[DenseStack] = None


@dataclasses.dataclass(frozen=True)
class DesignPlan:
    """The full compiled design.  ``row_mask`` is always None here (the
    TPU package sets it only on multi-device plans)."""

    main: TablePlan
    blocks: Tuple[BlockPlan, ...]
    group_index: torch.Tensor  # [F] int32
    group_counts: torch.Tensor  # [G] float
    row_mask: Optional[torch.Tensor]
    n_rows: int
    n_features: int
    n_groups: int

    @property
    def device(self) -> torch.device:
        return self.group_index.device


# ---------------------------------------------------------------------------
# Engine-resolution gates
# ---------------------------------------------------------------------------


def _joint_auto_core(rank: int, dtype, group_counts) -> bool:
    """The (rank, dtype, grouping) thresholds shared by both halves of
    the "auto" → joint decision."""
    if rank > JOINT_AUTO_MAX_RANK:
        return False
    if np.dtype(dtype) == np.float64:
        return True
    counts = np.asarray(group_counts)
    return counts.size > 0 and float(counts.min()) >= max(
        16, 4 * (rank + 2)
    )


def joint_auto_candidate(
    rank: int, fit_linear: bool, dtype, group_index
) -> bool:
    """Pre-compile part of the "auto" → joint upgrade decision: True when
    the linear terms are fit, the rank is within JOINT_AUTO_MAX_RANK,
    and (under float32) every hyper-group is large enough to identify
    its λ draws tightly.  Computable from (rank, dtype, grouping)
    alone."""
    return fit_linear and _joint_auto_core(
        rank, dtype,
        np.bincount(np.asarray(group_index, dtype=np.int64)),
    )


def joint_auto_eligible(
    plan: DesignPlan, rank: int, dtype=np.float32
) -> bool:
    """Post-compile part of the "auto" → joint decision: the shared
    thresholds on the plan's own group counts, plus "every block got
    dense color operands" (compiled with ``joint_dense=True`` inside the
    budget).  ``fit_linear`` is checked by ``joint_auto_candidate``."""
    return all(
        b.dense_colors or b.dense_stack is not None
        for b in plan.blocks
        if b.n_cols > 0
    ) and _joint_auto_core(
        rank, dtype, plan.group_counts.detach().cpu().numpy()
    )


# ---------------------------------------------------------------------------
# Greedy chromatic planner
# ---------------------------------------------------------------------------


def greedy_color(csc: sps.csc_matrix) -> List[np.ndarray]:
    """Partition columns into row-disjoint sets (a valid coloring).

    Greedy single pass in column order with per-row counters ``c``:
    a column's color is ``max(c[rows])``, after which ``c[rows]`` is
    raised to ``color + 1``.  The same pass as the TPU package's native
    planner and numpy fallback, so it assigns the same colors."""
    n_rows, n_cols = csc.shape
    indptr, indices = csc.indptr, csc.indices
    c = np.zeros(n_rows, dtype=np.int32)
    assign = np.zeros(n_cols, dtype=np.int32)
    for f in range(n_cols):
        rows = indices[indptr[f] : indptr[f + 1]]
        if rows.size == 0:
            continue
        col = int(c[rows].max())
        assign[f] = col
        c[rows] = np.maximum(c[rows], col + 1)
    n_colors = int(assign.max()) + 1 if n_cols else 0
    order = np.argsort(assign, kind="stable")
    bounds = np.searchsorted(assign[order], np.arange(n_colors + 1))
    return [order[bounds[i] : bounds[i + 1]] for i in range(n_colors)]


def _serial_colors(n_cols: int) -> List[np.ndarray]:
    return [np.array([f]) for f in range(n_cols)]


# ---------------------------------------------------------------------------
# Table compilation
# ---------------------------------------------------------------------------


def _take_segments(
    indptr: np.ndarray, feats: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Flat nnz indices of the given columns (in column order) plus the
    per-column counts, without a Python loop."""
    counts = (indptr[feats + 1] - indptr[feats]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), counts
    starts = indptr[feats].astype(np.int64)
    offs = np.zeros(len(feats), dtype=np.int64)
    np.cumsum(counts[:-1], out=offs[1:])
    idx = (
        np.arange(total, dtype=np.int64)
        + np.repeat(starts - offs, counts)
    )
    return idx, counts


def _build_color_arrays(
    csc: sps.csc_matrix,
    feats_local: np.ndarray,
    col_offset: int,
    n_features_total: int,
    sx2_all: np.ndarray,
    dtype: np.dtype,
    pe: Optional[int] = None,
    pf: Optional[int] = None,
) -> Tuple[np.ndarray, ...]:
    """(rows, vals, seg, feat, sx2) host arrays of one color."""
    indptr, indices, data = csc.indptr, csc.indices, csc.data
    idx, counts = _take_segments(indptr, feats_local)
    nnz = int(counts.sum())
    n_feat = len(feats_local)
    Pe = pe if pe is not None else _pad_to(nnz)
    Pf = pf if pf is not None else _pad_to(n_feat)

    rows = np.zeros(Pe, dtype=np.int32)
    vals = np.zeros(Pe, dtype=dtype)
    seg = np.full(Pe, n_feat, dtype=np.int32)
    rows[:nnz] = indices[idx]
    vals[:nnz] = data[idx]
    seg[:nnz] = np.repeat(np.arange(n_feat, dtype=np.int32), counts)

    feat = np.full(Pf, n_features_total, dtype=np.int32)
    feat[:n_feat] = feats_local + col_offset
    sx2 = np.zeros(Pf, dtype=dtype)
    sx2[:n_feat] = sx2_all[feats_local]
    return rows, vals, seg, feat, sx2


def _build_dense_colors(
    csc: sps.csc_matrix,
    groups: List[np.ndarray],
    col_offset: int,
    n_features_total: int,
    dtype: np.dtype,
    max_unrolled_colors: int,
    budget_elements: int,
    identity_split: bool,
    up,
) -> Tuple[Optional[Tuple[DenseColor, ...]], Optional[DenseStack]]:
    """Dense per-block-row color operands: the first
    ``max_unrolled_colors`` colors one by one (each with its own Pf and,
    with ``identity_split``, its single-entry features carved out), the
    rest stacked with a common Pf.  (None, None) when C×B exceeds the
    budget."""
    B = csc.shape[0]
    if len(groups) * B > budget_elements:
        return None, None
    indptr, indices, data = csc.indptr, csc.indices, csc.data

    def one(feats_local, pf=None):
        idx, counts = _take_segments(indptr, feats_local)
        n_feat = len(feats_local)
        Pf = pf if pf is not None else _pad_to(n_feat)
        xw = np.zeros(B, dtype=dtype)
        segb = np.full(B, Pf, dtype=np.int32)
        rows = indices[idx]
        xw[rows] = data[idx]
        segb[rows] = np.repeat(np.arange(n_feat, dtype=np.int32), counts)
        feat = np.full(Pf, n_features_total, dtype=np.int32)
        feat[:n_feat] = feats_local + col_offset
        return xw, segb, feat

    dense_colors = []
    for g in groups[:max_unrolled_colors]:
        counts_g = indptr[g + 1] - indptr[g]
        singles_mask = counts_g == 1
        id_xw = id_feat = None
        if identity_split and int(singles_mask.sum()) >= IDENTITY_SPLIT_MIN:
            singles = g[singles_mask]
            g = g[~singles_mask]
            pos = indptr[singles]
            srows = indices[pos]
            id_xw = np.zeros(B, dtype=dtype)
            id_feat = np.full(B, n_features_total, dtype=np.int32)
            id_xw[srows] = data[pos]
            id_feat[srows] = (singles + col_offset).astype(np.int32)
        x, s, f = one(g)
        dense_colors.append(DenseColor(
            xw=up(x), segb=up(s), feat=up(f),
            id_xw=None if id_xw is None else up(id_xw),
            id_feat=None if id_feat is None else up(id_feat),
        ))
    dense_stack = None
    stacked = groups[max_unrolled_colors:]
    if stacked:
        pf = _pad_to(max(len(g) for g in stacked))
        built = [one(g, pf=pf) for g in stacked]
        dense_stack = DenseStack(
            xw=up(np.stack([b[0] for b in built])),
            segb=up(np.stack([b[1] for b in built])),
            feat=up(np.stack([b[2] for b in built])),
        )
    return tuple(dense_colors), dense_stack


def _compile_table(
    X: sps.csr_matrix,
    col_offset: int,
    n_features_total: int,
    dtype: np.dtype,
    strategy: str,
    expanded_weight: Optional[np.ndarray],
    max_unrolled_colors: int,
    for_training: bool,
    up,
    joint_dense: bool = False,
    dense_budget: int = 64 << 20,
    joint_rank: Optional[int] = None,
):
    """Shared compilation of main and block tables.
    ``expanded_weight``: per-local-row multiplicity of the static Σx²
    (None for the main table, ``cardinality`` for blocks)."""
    n_cols = X.shape[1]
    coo = X.tocoo()
    nnz = coo.nnz
    Pe = _pad_to(nnz)
    coo_row = np.zeros(Pe, dtype=np.int32)
    coo_col = np.full(Pe, n_features_total, dtype=np.int32)
    coo_val = np.zeros(Pe, dtype=dtype)
    coo_row[:nnz] = coo.row
    coo_col[:nnz] = coo.col + col_offset
    coo_val[:nnz] = coo.data

    colors: Tuple[ColorPlan, ...] = ()
    color_stack = None
    dense_colors = dense_stack = None
    if for_training and n_cols > 0:
        csc = X.tocsc()
        csc.sort_indices()
        if expanded_weight is None:
            sx2_all = np.asarray(csc.power(2).sum(axis=0), dtype=dtype).ravel()
        else:
            w = np.asarray(expanded_weight, dtype=np.float64)
            sx2_all = np.asarray(csc.power(2).T.dot(w), dtype=dtype).ravel()
        groups = (
            _serial_colors(n_cols) if strategy == "serial"
            else greedy_color(csc)
        )
        if joint_dense:
            wide = joint_rank is not None and joint_rank > JOINT_UNROLL_MAX_RANK
            dense_colors, dense_stack = _build_dense_colors(
                csc, groups, col_offset, n_features_total, dtype,
                min(max_unrolled_colors, 4) if wide else max_unrolled_colors,
                dense_budget, identity_split=not wide, up=up,
            )
        colors = tuple(
            ColorPlan(*map(up, _build_color_arrays(
                csc, g, col_offset, n_features_total, sx2_all, dtype
            )))
            for g in groups[:max_unrolled_colors]
        )
        stacked = groups[max_unrolled_colors:]
        if stacked:
            indptr = csc.indptr
            pe = _pad_to(max(
                int((indptr[g + 1] - indptr[g]).sum()) for g in stacked
            ))
            pf = _pad_to(max(len(g) for g in stacked))
            planned = [
                _build_color_arrays(csc, g, col_offset, n_features_total,
                                    sx2_all, dtype, pe=pe, pf=pf)
                for g in stacked
            ]
            color_stack = ColorStack(*(
                up(np.stack([c[k] for c in planned])) for k in range(5)
            ))
    return (up(coo_row), up(coo_col), up(coo_val), colors, color_stack,
            dense_colors, dense_stack)


def compile_design(
    X: Optional[sps.spmatrix],
    blocks: Sequence[RelationBlock] = (),
    grouping: Optional[np.ndarray] = None,
    n_groups: Optional[int] = None,
    dtype=np.float32,
    strategy: str = "auto",
    max_unrolled_colors: int = 16,
    for_training: bool = True,
    joint_dense: bool = False,
    dense_budget: int = 64 << 20,
    joint_rank: Optional[int] = None,
    device="cuda",
) -> DesignPlan:
    """Compile (X, blocks) into a plan on ``device`` (arguments as in
    ``myfm_tpu.design.compile_design``).  ``strategy="serial"`` makes
    every feature its own color; ``joint_dense`` adds the dense block
    color operands of the joint sweep when each block's
    n_colors × block_size fits ``dense_budget``; ``joint_rank`` above
    JOINT_UNROLL_MAX_RANK trims the unrolled head."""
    dtype = np.dtype(dtype)
    device = torch.device(device)

    def up(a):
        return torch.as_tensor(a, device=device)

    if X is None:
        if not blocks:
            raise ValueError("At least X or blocks must be provided.")
        X = sps.csr_matrix((blocks[0].mapper_size, 0), dtype=dtype)
    X = sps.csr_matrix(X).astype(dtype)
    n_rows = X.shape[0]
    for b in blocks:
        if b.mapper_size != n_rows:
            raise ValueError(
                "RelationBlock mapper size "
                f"{b.mapper_size} != number of rows {n_rows}."
            )
    n_features = X.shape[1] + sum(b.feature_size for b in blocks)

    if grouping is None:
        grouping = np.zeros(n_features, dtype=np.int32)
        n_groups = 1
    else:
        grouping = np.asarray(grouping, dtype=np.int32)
        if grouping.shape[0] != n_features:
            raise ValueError(
                f"grouping has length {grouping.shape[0]}, expected "
                f"{n_features}."
            )
        if n_groups is None:
            n_groups = int(grouping.max()) + 1 if grouping.size else 1
        uniq = np.unique(grouping)
        if uniq.size and (
            uniq[0] < 0 or uniq[-1] >= n_groups or uniq.size != n_groups
        ):
            raise ValueError(
                "group indices must cover 0..n_groups-1 contiguously "
                "(reference contract, FMLearningConfig.hpp:33-40)."
            )
    group_counts = np.bincount(grouping, minlength=n_groups).astype(dtype)

    coo_row, coo_col, coo_val, colors, cstack, _, _ = _compile_table(
        X, 0, n_features, dtype, strategy, None, max_unrolled_colors,
        for_training, up,
    )
    main = TablePlan(coo_row=coo_row, coo_col=coo_col, coo_val=coo_val,
                     colors=colors, color_stack=cstack, col_offset=0,
                     n_cols=X.shape[1])

    compiled_blocks: List[BlockPlan] = []
    offset = X.shape[1]
    for b in blocks:
        card = np.bincount(
            b.original_to_block, minlength=b.block_size
        ).astype(dtype)
        bx = sps.csr_matrix(b.data).astype(dtype)
        (coo_row, coo_col, coo_val, colors, cstack, dcolors,
         dstack) = _compile_table(
            bx, offset, n_features, dtype, strategy, card,
            max_unrolled_colors, for_training, up,
            joint_dense=joint_dense, dense_budget=dense_budget,
            joint_rank=joint_rank,
        )
        compiled_blocks.append(BlockPlan(
            coo_row=coo_row, coo_col=coo_col, coo_val=coo_val,
            colors=colors, color_stack=cstack,
            mapper=up(np.asarray(b.original_to_block, dtype=np.int32)),
            cardinality=up(card), col_offset=offset,
            n_cols=b.feature_size, block_size=b.block_size,
            dense_colors=dcolors if dcolors is not None else (),
            dense_stack=dstack,
        ))
        offset += b.feature_size

    return DesignPlan(
        main=main,
        blocks=tuple(compiled_blocks),
        group_index=up(grouping),
        group_counts=up(group_counts),
        row_mask=None,
        n_rows=n_rows,
        n_features=n_features,
        n_groups=int(n_groups),
    )
