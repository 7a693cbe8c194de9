"""Design compilation for the categorical fast path.

PyTorch counterpart of ``myfm_tpu/design_categorical.py``.  A table
(the main table or a RelationBlock seen through its mapper) is
*categorical* when every row has exactly one active feature with value
1.0.  For such tables the Gibbs sweep runs in entity space
(ops/categorical.py): rows are sorted by entity and packed into tiles of
``T`` rows holding at most ``S`` entities, and the per-entity Gram
statistics come from one kernel launch per chunk of tiles (ops/gram.py).

Every layout array is bit-equal to the TPU package's at the same (T, S).
On a CUDA device the O(rows) layouts (each tile row's source row and
slot) are derived on the card from the uploaded entity ids and the
counts-only packing metadata (``_plan_tiles``, ``_derive_src_slot_device``),
as the TPU package derives them on its TPU; elsewhere, or with
``derive_src_on_device=False``, the native planner packs them on the
host (``_native.pack_tiles_native``; ``_pack_tiles`` is its plain numpy
version).  Both give the same bits.
What differs is how (T, S) is chosen: the TPU package ranks tilings by a
VMEM-gated cost model of its Pallas kernel, while this port uses a rule
of its own fitted to the CUDA kernel (``choose_tiling``).  Whether a
table is accepted at all is the TPU package's decision: its ranking's
winner must pad the rows by at most ``max_inflation``
(``reference_tiling``, a host-only copy of that arithmetic), so "auto"
resolves to the same engine in both packages.

With ``allow_side`` a block of [one-hot | per-entity side feature] column
groups compiles too: its one-hot groups become ordinary tables, and its
side columns an *entity+attribute* table over the block rows, whose
``SideInfo`` holds the dense side matrix and the per-color operands of
the side features (``compile_side_info``).  The Gibbs and the VI fast
paths (ops/categorical.py, ops/categorical_vi.py) run such plans.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import sparse as sps

from .tracing import span

# The CUDA Gram kernel stages one tile's z rows [T, D] in shared memory;
# this bound keeps that stage within the 48 KiB a block gets without an
# opt-in, so several blocks stay resident per SM.
GRAM_ZTILE_BYTES = 48 << 10
TILE_ROWS_CANDIDATES = (512, 256, 128)
TILE_ENTITIES_CANDIDATES = (1, 2, 4, 8, 16, 32, 64)

# rows per Gram chunk of the sweep — bounds the [chunk, R]-sized
# temporaries, and with per-chunk Gram consumption removes any
# K*S*D*D-sized array (same constants as the TPU package, so the fin_*
# windows agree bit for bit)
CHUNK_ROWS = 1 << 20
CHUNK_FLAT_BYTES = 1 << 30

# Entity+attribute gates (the TPU package's): a non-one-hot column group
# of a block compiles as a dense per-entity side matrix only when the
# dense [B, Fs] footprint and the stacked per-color operands [C, B] stay
# bounded, and the greedy coloring of the side columns (conflict =
# co-occurrence in a block row) stays shallow.
SIDE_DENSE_ELEMS = 1 << 25
SIDE_MAX_COLORS = 2048


def _packed_rows(counts: np.ndarray, T: int, S: int) -> int:
    """Exact padded row count of the greedy packing (``_pack_tiles``),
    from the native planner."""
    from ._native import packed_rows_native

    return packed_rows_native(counts, T, S)


def _packed_rows_reference(counts: np.ndarray, T: int, S: int) -> int:
    """The plain version of ``_packed_rows``, computed from the
    cardinality sequence without materializing the layout: one step per
    entity, an entity longer than the room left in its tile closing that
    tile and ``(rest - 1) // T`` full ones."""
    counts = np.asarray(counts)
    total = 0
    row_fill = 0
    ent_fill = 0
    for c in counts[counts > 0].tolist():
        if row_fill >= T or ent_fill >= S:
            total += T
            row_fill = 0
            ent_fill = 0
        room = T - row_fill
        if c <= room:
            row_fill += c
            ent_fill += 1
            continue
        rest = c - room
        full = (rest - 1) // T
        total += T * (1 + full)
        row_fill = rest - T * full
        ent_fill = 1
    if row_fill:
        total += T
    return total


# The TPU package's acceptance rule, copied as host arithmetic (its
# tiling ranking in myfm_tpu/design_categorical.py, its Gram kernel's
# VMEM model in myfm_tpu/ops/pallas_gram.py).  Only the decision is
# taken from it: an accepted table is packed at this port's own (T, S).
REF_TILE_ROWS = 1024  # the TPU package's DEFAULT_TILE_ROWS
REF_TILE_ENTITIES = 8  # its DEFAULT_TILE_ENTITIES
REF_GRAM_VMEM_BUDGET = 14 << 20  # its GRAM_VMEM_BUDGET
_REF_CLOCK_HZ = 0.94e9
_REF_HBM_BPS = 8.19e11
_REF_VPU_S_SLOPE_NS = 0.45
_REF_TILE_OVERHEAD_NS = 450.0


def _ref_tile_bytes(r: int, c: int, itemsize: int = 4) -> int:
    """One [r, c] buffer padded to (8, 128) tiles."""
    return (-(-r // 8) * 8) * (-(-c // 128) * 128) * itemsize


def _ref_vmem_bytes(T: int, S: int, rank: int) -> int:
    """The TPU package's modeled VMEM bytes of one Gram grid step
    (``fused_gram_vmem_bytes(T, S, rank)`` at its defaults: float32,
    two cross tables, one tile per step)."""
    D = rank + 2
    Dp = -(-D // 8) * 8
    w_cols = 1 + rank
    tile = _ref_tile_bytes
    dd = tile(D, D)
    in_meta = tile(T, 1) + tile(T, 3) + tile(T, rank)
    in_cross = tile(2, T) + 2 * tile(T, w_cols + 1)
    double_buffered = (
        max(in_meta, in_cross) + tile(S, w_cols) + dd
        + tile(S * Dp, D) + dd
    )
    scratch = tile(T, S * Dp) + tile(T, Dp) + dd
    return 2 * double_buffered + scratch


def _ref_ns_per_row(T: int, S: int, rank: int) -> float:
    """The TPU package's modeled Gram time per row (``_gram_ns_per_row``
    with two cross tables)."""
    D = rank + 2
    Dp = -(-D // 8) * 8
    n_mm = 1 if rank >= 64 else 3
    cycles = n_mm * -(-T // 128) * -(-D // 128) * max(S * Dp, 128)
    mxu = cycles / _REF_CLOCK_HZ / T * 1e9
    dma = 3 * -(-(rank + 1) // 128) * (4 * 128) / _REF_HBM_BPS * 1e9
    return (mxu + dma + _REF_VPU_S_SLOPE_NS * S
            + _REF_TILE_OVERHEAD_NS / T)


def reference_tiling(counts: np.ndarray, rank: int):
    """(T, S, inflation) that the TPU package tiles a table with off
    the TPU: the cheapest of its ranking (``rank_tilings(counts,
    REF_TILE_ROWS, REF_TILE_ENTITIES, rank)[0]``), whose inflation its
    compile gates on.  ``rank`` is the width that package passes: R on
    the Gibbs path, 3R for one-hot VI plans, 4R for entity+attribute VI
    plans.

    The candidates are visited in order of a lower bound of their cost
    (each tile holds at most T rows and S entities) and the walk stops
    once that bound exceeds the best exact cost, so most candidates are
    never packed; the winner is the ranking's, ties included."""
    counts = np.asarray(counts)
    n = max(int(counts.sum()), 1)
    n_ent = int((counts > 0).sum())
    cands = {(Tc, Sc) for Tc in (128, 256, 512, 1024, 2048, 4096)
             for Sc in TILE_ENTITIES_CANDIDATES}
    cands.add((REF_TILE_ROWS, REF_TILE_ENTITIES))  # the caller's fallback
    bounded = []
    for Tc, Sc in sorted(cands):
        if _ref_vmem_bytes(Tc, Sc, rank) > REF_GRAM_VMEM_BUDGET:
            continue
        ns = _ref_ns_per_row(Tc, Sc, rank)
        tiles = max(-(-n // Tc), -(-n_ent // Sc))
        bounded.append(((tiles * Tc) / n * ns, Tc, Sc, ns))
    if not bounded:  # very large D: the smallest config
        return 128, 1, _packed_rows(counts, 128, 1) / n
    bounded.sort()
    best = None
    for lower, Tc, Sc, ns in bounded:
        if best is not None and lower > best[0]:
            break
        infl = _packed_rows(counts, Tc, Sc) / n
        cand = (infl * ns, Tc, Sc, infl)
        if best is None or cand < best:
            best = cand
    return best[1], best[2], best[3]


def _fitting_tile_rows(rank: int, itemsize: int) -> Tuple[int, ...]:
    """The tile heights whose z stage T·(rank+2)·itemsize fits
    GRAM_ZTILE_BYTES, largest first (the smallest candidate when none
    does)."""
    fit = tuple(T for T in TILE_ROWS_CANDIDATES
                if T * (rank + 2) * itemsize <= GRAM_ZTILE_BYTES)
    return fit or TILE_ROWS_CANDIDATES[-1:]


def _tiling_cost(counts: np.ndarray, T: int, S: int, D: int,
                 n_cross: int, n: int):
    """(modeled bytes, inflation) of one (T, S) on the CUDA kernel."""
    packed = _packed_rows(counts, T, S)
    tiles = packed // T
    return tiles * (T * (n_cross * D + 2) + S * D * D), packed / n


def choose_tiling(counts: np.ndarray, rank: int, itemsize: int,
                  n_cross: int = 2):
    """(T, S, inflation) for one table on the CUDA Gram kernel.

    T is the largest of TILE_ROWS_CANDIDATES whose z stage
    T·(rank+2)·itemsize fits GRAM_ZTILE_BYTES (the smallest candidate
    otherwise).  S minimizes the kernel's modeled bytes per table pass
    (by arithmetic intensity the kernel is bound by memory bandwidth;
    PERF.md has how close it gets): each packed tile
    reads T rows of (slot, τ) plus ``n_cross`` gathered [w | V | qs]
    rows and writes S partial Grams of D² entries,

        bytes(S) = tiles(T, S) · (T·(n_cross·D + 2) + S·D²) · itemsize.

    A small S wastes rows on padding when entities are short (many
    tiles); a large S writes Grams for slots that a dense table never
    fills."""
    D = rank + 2
    T = _fitting_tile_rows(rank, itemsize)[0]
    n = max(int(counts.sum()), 1)
    best = None
    for S in TILE_ENTITIES_CANDIDATES:
        cost, infl = _tiling_cost(counts, T, S, D, n_cross, n)
        if best is None or cost < best[0]:
            best = (cost, S, infl)
    _, S, inflation = best
    return T, S, inflation


def least_inflating_tiling(counts: np.ndarray, rank: int, itemsize: int,
                           n_cross: int = 2):
    """(T, S, inflation) with the least padding among every fitting T
    and every S (ties to the fewer modeled bytes): the port's tiling of
    a table that the TPU package accepts but ``choose_tiling`` pads by
    more than the gate allows."""
    D = rank + 2
    n = max(int(counts.sum()), 1)
    best = None
    for T in _fitting_tile_rows(rank, itemsize):
        for S in TILE_ENTITIES_CANDIDATES:
            cost, infl = _tiling_cost(counts, T, S, D, n_cross, n)
            if best is None or (infl, cost) < best[0]:
                best = ((infl, cost), T, S)
    (infl, _), T, S = best
    return T, S, infl


def categorical_mapping(
    X: sps.csr_matrix,
    mapper: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """If (X, mapper) encodes a one-hot feature per original row,
    return ``ent[n]`` = the active *local column* per original row,
    else None."""
    X = sps.csr_matrix(X)
    nnz_per_row = np.diff(X.indptr)
    if not (nnz_per_row == 1).all():
        return None
    if not (X.data == 1.0).all():
        return None
    col_of_row = X.indices.astype(np.int64)  # [n_local_rows]
    if mapper is None:
        return col_of_row
    return col_of_row[np.asarray(mapper, dtype=np.int64)]


@dataclasses.dataclass(frozen=True)
class CategoricalTable:
    """Static layout of one categorical table's sorted-tile space
    (fields as in the TPU package; ``NT = n_tiles * T`` tile rows, pad
    tile rows have ``src == N`` and ``slot_f == S``)."""

    src: torch.Tensor  # [NT] int32 — main-order row index (pad = N)
    slot: torch.Tensor  # [NT] int32 — local entity slot within tile
    slot_f: torch.Tensor  # [NT] float — slot, pad rows = S
    ent_of_tile_row: torch.Tensor  # [NT] int32 — entity id (pad = B)
    cont_in: torch.Tensor  # [K] int32 — tile starts with a continued entity
    cont_out: torch.Tensor  # [K] int32 — tile's last entity continues on
    last_slot: torch.Tensor  # [K] int32 — slot of the tile's last entity
    ent_slots: torch.Tensor  # [K, S] int32 — entity id per slot (pad=B)
    final_part: torch.Tensor  # [B] int32 — flat (tile*S+slot) holding
    #     each entity's complete Gram
    fin_win: np.ndarray  # [n_chunks] int32 — window start entity id (host:
    #     the sweep slices G with it, so it must not cost a device sync)
    fin_idx: torch.Tensor  # [n_chunks, max_fin] int32 — chunk-local slot
    fin_mask: torch.Tensor  # [n_chunks, max_fin] int32 — 1 = write row
    cardinality: torch.Tensor  # [B] float — rows per entity
    ent_main: torch.Tensor  # [N] int32 — entity id per main-order row
    noise_feat: torch.Tensor  # [B] int64 — global feature ids of entities
    col_offset: int
    n_cols: int  # B
    n_tiles: int
    tile_rows: int  # T
    tile_entities: int  # S
    chunk_tiles: int = 0
    max_fin: int = 0


@dataclasses.dataclass(frozen=True)
class SideInfo:
    """Per-entity side features of one entity+attribute table.

    The owning ``CategoricalTable`` tiles the block rows themselves
    (``ent[n] = mapper[n]``, ``B = block_size``); ``xs`` holds the
    non-one-hot feature values of each block row.  Colors partition the
    side columns into row-disjoint sets, so each color's operands are
    dense B-vectors: ``xw`` (the x value at each block row, 0 where the
    color has no feature) and ``segb`` (the feature's slot in the color,
    Pf where none)."""

    xs: torch.Tensor  # [B, Fs] float — dense side matrix
    feat_cols: torch.Tensor  # [Fs] int32 — global feature ids
    stack_xw: torch.Tensor  # [C, B] float
    stack_segb: torch.Tensor  # [C, B] int32 (pad = Pf)
    stack_feat: torch.Tensor  # [C, Pf] int32 global ids (pad = F)
    n_cols: int  # Fs


def compile_side_info(
    Xs: sps.csr_matrix,
    col_ids: np.ndarray,
    n_features: int,
    dtype,
    device,
) -> Optional[SideInfo]:
    """Dense side matrix and stacked per-color operands on ``device``, or
    None when the footprint or coloring gates fail (the TPU package's
    gates and layout, bit for bit)."""
    from .design import greedy_color

    Xs = sps.csr_matrix(Xs)
    B, Fs = Xs.shape
    if B * Fs > SIDE_DENSE_ELEMS:
        return None
    csc = Xs.tocsc()
    colors = greedy_color(csc)
    C = len(colors)
    if C > SIDE_MAX_COLORS or C * B > SIDE_DENSE_ELEMS:
        return None
    col_ids = np.asarray(col_ids, dtype=np.int64)
    Pf = max(max(len(c) for c in colors), 1)
    xw = np.zeros((C, B), dtype=dtype)
    segb = np.full((C, B), Pf, dtype=np.int32)
    feat = np.full((C, Pf), n_features, dtype=np.int64)
    for ci, cols in enumerate(colors):
        for sj, j in enumerate(cols):
            lo, hi = csc.indptr[j], csc.indptr[j + 1]
            rows = csc.indices[lo:hi]
            xw[ci, rows] = csc.data[lo:hi]
            segb[ci, rows] = sj
            feat[ci, sj] = col_ids[j]

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return SideInfo(
        xs=up(Xs.toarray().astype(dtype)),
        feat_cols=up(col_ids.astype(np.int32)),
        stack_xw=up(xw),
        stack_segb=up(segb),
        stack_feat=up(feat.astype(np.int32)),
        n_cols=Fs,
    )


def _finalize_windows(final_part: np.ndarray, counts: np.ndarray,
                      K: int, S: int, chunk_tiles: int):
    """Per-chunk contiguous entity windows for Gram consumption.

    Entity u's complete Gram lands at flat slot final_part[u]; the
    chunk that produces it is final_part[u] // (chunk_tiles * S).
    Entities are packed in ascending id order, so each chunk finalizes
    a contiguous id range (interleaved empty entities are masked out —
    their G rows stay zero, which is their correct Gram)."""
    B = final_part.shape[0]
    n_chunks = -(-K // chunk_tiles)
    per_chunk = chunk_tiles * S
    has_rows = counts > 0
    chunk_of = final_part // per_chunk
    wins = np.zeros(n_chunks, dtype=np.int64)
    spans = []
    for c in range(n_chunks):
        ids = np.nonzero(has_rows & (chunk_of == c))[0]
        if ids.size:
            lo, hi = int(ids[0]), int(ids[-1]) + 1
        else:
            lo, hi = 0, 0
        wins[c] = lo
        spans.append(hi - lo)
    max_fin = min(max(max(spans), 1), B)
    # clamp windows into [0, B - max_fin]
    wins = np.clip(wins, 0, B - max_fin)
    fin_idx = np.zeros((n_chunks, max_fin), dtype=np.int32)
    fin_mask = np.zeros((n_chunks, max_fin), dtype=np.int32)
    for c in range(n_chunks):
        ids = np.nonzero(has_rows & (chunk_of == c))[0]
        loc = ids - wins[c]
        fin_idx[c, loc] = (final_part[ids] - c * per_chunk).astype(
            np.int32
        )
        fin_mask[c, loc] = 1
    return wins.astype(np.int32), fin_idx, fin_mask, max_fin


@dataclasses.dataclass(frozen=True)
class CategoricalPlan:
    """All-categorical design: one CategoricalTable per table, main
    table first (when non-empty), then the blocks.

    ``cross_ent[t][t2]`` maps table t's tile rows to table t2's entity
    ids (pad rows -> B_{t2}), so each table pass rebuilds the residual
    and factor sums in its own tile space from the small per-entity
    weight tables."""

    tables: Tuple[CategoricalTable, ...]
    cross_ent: Tuple[Tuple[torch.Tensor, ...], ...]
    group_index: torch.Tensor  # [F] int64
    group_counts: torch.Tensor  # [G] float
    n_rows: int
    n_features: int
    n_groups: int
    # side[t] is the SideInfo of table t when t is an entity+attribute
    # table (its entities are block rows with per-entity side features),
    # else None; all None for an all-one-hot design
    side: Tuple[Optional[SideInfo], ...] = ()
    # a sharded plan (parallel/sharding_categorical.py) tiles rows
    # [row_lo, row_lo + n_rows) of an ``n_total``-row design
    row_lo: int = 0
    n_total: Optional[int] = None

    def __post_init__(self):
        if len(self.side) != len(self.tables):
            object.__setattr__(self, "side", (None,) * len(self.tables))

    @property
    def has_side(self) -> bool:
        return any(si is not None for si in self.side)

    @property
    def device(self) -> torch.device:
        return self.group_index.device

    @property
    def n_real(self) -> int:
        """Rows in the α/w0 conditionals: the whole design's."""
        return self.n_rows if self.n_total is None else self.n_total


def _pack_tiles(
    ent_sorted: np.ndarray, order: np.ndarray, n_entities: int,
    T: int, S: int,
):
    """Pack entity-sorted rows into (T-row, ≤S-entity) tiles.

    Returns (src, slot, ent_of_tile_row, cont_in, cont_out, last_slot,
    ent_slots, final_part).  Pads use src = N (out of range),
    ent = n_entities.

    Greedy: walk entities in order, filling the current tile; start a
    new tile when it is full (T rows) or already holds S entities.
    Entities longer than the remaining space split across consecutive
    tiles; a split entity always resumes at slot 0 of the next tile, so
    the Gram kernel can carry its running sum forward and deposit the
    complete Gram at the entity's LAST (tile, slot) — recorded in
    ``final_part``.  Within a tile, rows are in slot order and pad rows
    come last."""
    n = ent_sorted.shape[0]
    counts = np.bincount(ent_sorted, minlength=n_entities)

    src_chunks: List[np.ndarray] = []
    slot_chunks: List[np.ndarray] = []
    ent_chunks: List[np.ndarray] = []
    tile_first: List[int] = []  # first entity per tile
    tile_last: List[int] = []  # last entity per tile
    tile_last_slot: List[int] = []
    tile_slot_ents: List[List[int]] = []  # per tile: entity per slot
    cur_slot_ents: List[int] = []
    final_tile = np.full(n_entities, -1, dtype=np.int64)
    final_slot = np.zeros(n_entities, dtype=np.int64)

    row_fill = 0
    ent_fill = 0
    cur_first = -1
    cur_last = -1

    def close_tile():
        nonlocal row_fill, ent_fill, cur_first, cur_last, cur_slot_ents
        pad_rows = T - row_fill
        if pad_rows:
            src_chunks.append(np.full(pad_rows, -1, dtype=np.int64))
            # pad rows carry slot 0 — their gathered values are zero
            slot_chunks.append(np.zeros(pad_rows, dtype=np.int64))
            ent_chunks.append(
                np.full(pad_rows, n_entities, dtype=np.int64)
            )
        tile_first.append(cur_first)
        tile_last.append(cur_last)
        tile_last_slot.append(max(ent_fill - 1, 0))
        tile_slot_ents.append(
            cur_slot_ents + [n_entities] * (S - len(cur_slot_ents))
        )
        row_fill = 0
        ent_fill = 0
        cur_first = -1
        cur_last = -1
        cur_slot_ents = []

    pos = 0
    for u in range(n_entities):
        c = int(counts[u])
        if c == 0:
            continue
        taken = 0
        while taken < c:
            if row_fill >= T or ent_fill >= S:
                close_tile()
            take = min(c - taken, T - row_fill)
            src_chunks.append(order[pos : pos + take])
            slot_chunks.append(np.full(take, ent_fill, dtype=np.int64))
            ent_chunks.append(np.full(take, u, dtype=np.int64))
            if cur_first < 0:
                cur_first = u
            cur_last = u
            cur_slot_ents.append(u)
            final_tile[u] = len(tile_first)  # current tile index
            final_slot[u] = ent_fill
            pos += take
            taken += take
            row_fill += take
            ent_fill += 1
    if row_fill:
        close_tile()
    # one trailing all-pad tile: an all-zero partial slot at flat index
    # (n_tiles-1)*S for row-less entities' final_part
    close_tile()

    n_tiles = len(tile_first)
    tf = np.asarray(tile_first, dtype=np.int64)
    tl = np.asarray(tile_last, dtype=np.int64)
    cont_in = np.zeros(n_tiles, dtype=np.int32)
    cont_out = np.zeros(n_tiles, dtype=np.int32)
    if n_tiles > 1:
        same = (tf[1:] == tl[:-1]) & (tf[1:] >= 0)
        cont_in[1:] = same.astype(np.int32)
        cont_out[:-1] = same.astype(np.int32)
    last_slot = np.asarray(tile_last_slot, dtype=np.int32)
    ent_slots = np.asarray(tile_slot_ents, dtype=np.int32).reshape(
        n_tiles, S
    )

    final_part = np.where(
        final_tile >= 0,
        final_tile * S + final_slot,
        (n_tiles - 1) * S,  # first slot of the trailing all-pad tile
    ).astype(np.int32)

    src = np.concatenate(src_chunks) if src_chunks else np.empty(0, np.int64)
    slot = (
        np.concatenate(slot_chunks) if slot_chunks else np.empty(0, np.int64)
    )
    ent = np.concatenate(ent_chunks) if ent_chunks else np.empty(0, np.int64)
    src = np.where(src < 0, n, src)  # pad -> N
    return (
        src.astype(np.int32),
        slot.astype(np.int32),
        ent.astype(np.int32),
        cont_in,
        cont_out,
        last_slot,
        ent_slots,
        final_part,
    )


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy float32/float64 dtype."""
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def _plan_tiles(counts: np.ndarray, T: int, S: int):
    """Counts-only tile packing: the greedy walk of ``_pack_tiles`` over
    the cardinalities alone, materializing no O(rows) array.  The
    src / slot layouts are derived on the device from ``ent_main`` and
    the per-segment layout returned here (``_derive_src_slot_device``).

    Returns (seg_starts, seg_shift, seg_slot, meta): segment i covers
    the entity-sorted positions [seg_starts[i], seg_starts[i+1]) and
    goes to tile rows pos + seg_shift[i] with slot seg_slot[i]; a last
    sentinel segment covers the positions past the last real row (masked
    rows, which sort last).  meta = (n_tiles, cont_in, cont_out,
    last_slot, ent_slots, final_part), bit-equal to ``_pack_tiles``'s
    (the TPU package's ``_plan_tiles``, line for line)."""
    n_entities = counts.shape[0]
    seg_starts: List[int] = []
    seg_dest: List[int] = []
    seg_slot: List[int] = []
    tile_first: List[int] = []
    tile_last: List[int] = []
    tile_last_slot: List[int] = []
    tile_slot_ents: List[List[int]] = []
    cur_slot_ents: List[int] = []
    final_tile = np.full(n_entities, -1, dtype=np.int64)
    final_slot = np.zeros(n_entities, dtype=np.int64)

    row_fill = 0
    ent_fill = 0
    cur_first = -1
    cur_last = -1

    def close_tile():
        nonlocal row_fill, ent_fill, cur_first, cur_last, cur_slot_ents
        tile_first.append(cur_first)
        tile_last.append(cur_last)
        tile_last_slot.append(max(ent_fill - 1, 0))
        tile_slot_ents.append(
            cur_slot_ents + [n_entities] * (S - len(cur_slot_ents))
        )
        row_fill = 0
        ent_fill = 0
        cur_first = -1
        cur_last = -1
        cur_slot_ents = []

    pos = 0
    for u in range(n_entities):
        c = int(counts[u])
        if c == 0:
            continue
        taken = 0
        while taken < c:
            if row_fill >= T or ent_fill >= S:
                close_tile()
            take = min(c - taken, T - row_fill)
            seg_starts.append(pos)
            seg_dest.append(len(tile_first) * T + row_fill)
            seg_slot.append(ent_fill)
            if cur_first < 0:
                cur_first = u
            cur_last = u
            cur_slot_ents.append(u)
            final_tile[u] = len(tile_first)
            final_slot[u] = ent_fill
            pos += take
            taken += take
            row_fill += take
            ent_fill += 1
    if row_fill:
        close_tile()
    close_tile()  # the trailing all-pad tile, as in _pack_tiles

    n_tiles = len(tile_first)
    tf = np.asarray(tile_first, dtype=np.int64)
    tl = np.asarray(tile_last, dtype=np.int64)
    cont_in = np.zeros(n_tiles, dtype=np.int32)
    cont_out = np.zeros(n_tiles, dtype=np.int32)
    if n_tiles > 1:
        same = (tf[1:] == tl[:-1]) & (tf[1:] >= 0)
        cont_in[1:] = same.astype(np.int32)
        cont_out[:-1] = same.astype(np.int32)
    last_slot = np.asarray(tile_last_slot, dtype=np.int32)
    ent_slots = np.asarray(tile_slot_ents, dtype=np.int32).reshape(
        n_tiles, S
    )
    final_part = np.where(
        final_tile >= 0,
        final_tile * S + final_slot,
        (n_tiles - 1) * S,
    ).astype(np.int32)

    starts = np.asarray(seg_starts + [pos], dtype=np.int32)
    shift = np.asarray(
        [d - s for d, s in zip(seg_dest, seg_starts)] + [0],
        dtype=np.int32,
    )
    slots = np.asarray(seg_slot + [0], dtype=np.int32)
    meta = (n_tiles, cont_in, cont_out, last_slot, ent_slots, final_part)
    return starts, shift, slots, meta


def _derive_src_slot_device(
    ent_main: torch.Tensor,  # [n] int32, masked rows carry id n_entities
    seg_starts: torch.Tensor,  # [n_seg+1] ascending, sentinel last
    seg_shift: torch.Tensor,  # [n_seg+1] (sentinel 0)
    seg_slot: torch.Tensor,  # [n_seg+1] int32 (sentinel 0)
    nt: int,
    n_rows: int,
):
    """The src / slot tile layouts [nt] int32 derived on ent_main's
    device: a stable argsort of ent_main gives the entity-sorted row
    order (masked ids sort last, as the host's argsort over the real
    rows leaves them out), a search of each sorted position among the
    segment starts gives its packing segment, and two scatters place the
    row indices and the slots at their tile rows.  Tile rows no segment
    reaches keep (src = n_rows, slot = 0).  Positions in the sentinel
    segment are routed to index nt of buffers one longer, which is
    sliced off (the TPU package drops them with ``mode="drop"``)."""
    device = ent_main.device
    order = torch.argsort(ent_main, stable=True).to(torch.int32)
    p = torch.arange(ent_main.shape[0], dtype=torch.int64, device=device)
    starts = seg_starts.to(torch.int64)
    seg = torch.searchsorted(starts, p, right=True) - 1
    sentinel = starts.shape[0] - 1
    dest = torch.where(seg < sentinel, p + seg_shift.to(torch.int64)[seg],
                       nt)
    src = torch.full((nt + 1,), n_rows, dtype=torch.int32, device=device)
    slot = torch.zeros(nt + 1, dtype=torch.int32, device=device)
    src[dest] = order
    slot[dest] = seg_slot.to(torch.int32)[seg]
    return src[:nt], slot[:nt]


def _upload_ids(a: np.ndarray, max_id: int, device) -> torch.Tensor:
    """Ids 0..max_id uploaded in the narrowest dtype that holds them
    and widened to int32 on the device."""
    if max_id <= np.iinfo(np.uint8).max:
        a = a.astype(np.uint8)
    elif max_id <= np.iinfo(np.int16).max:
        a = a.astype(np.int16)
    else:
        a = a.astype(np.int32)
    return torch.as_tensor(np.ascontiguousarray(a), device=device).to(
        torch.int32)


def compile_categorical_table(
    ent: np.ndarray,
    n_entities: int,
    col_offset: int,
    n_rows: int,
    dtype,
    device,
    rank: int = 32,
    max_inflation: Optional[float] = None,
    fixed_ts: Optional[Tuple[int, int]] = None,
    gate_rank: Optional[int] = None,
    derive_src_on_device: Optional[bool] = None,
    rows: Optional[Tuple[int, int]] = None,
) -> Optional[CategoricalTable]:
    """Pack one table and put its layout on ``device``.

    ``fixed_ts`` pins (T, S); otherwise ``choose_tiling`` picks them.
    With ``max_inflation`` the table is accepted exactly when the TPU
    package accepts it (``reference_tiling`` at ``gate_rank``, default
    ``rank``, pads by at most ``max_inflation``), else None is returned
    and the caller falls back to another engine.  An accepted table
    keeps ``choose_tiling``'s pick when that is under the gate, else
    takes ``least_inflating_tiling``.  Rows whose ``ent`` is
    ``n_entities`` are masked: they enter no tile.

    ``derive_src_on_device`` (default: True on a CUDA device) derives
    the src / slot layouts on the device from the uploaded entity ids
    and the counts-only metadata; False packs them on the host with the
    native planner and uploads them.  The build's windows are the spans
    ``myfm.plan.counts`` (cardinalities and tiling), ``.pack``
    (``_plan_tiles`` or the host pack), ``.upload``, ``.derive`` and
    ``.finalize`` (tracing.py); while recording, each ends with a
    synchronize, so that its device work lands in it.

    ``rows = (lo, hi)`` packs rows [lo, hi) alone, a shard of a sharded
    plan: the tiling is chosen and gated from the whole table's counts,
    so every shard takes the (T, S) one process takes and accepts the
    table exactly where one process does."""
    device = torch.device(device)
    with span("myfm.plan.counts", sync=device):
        ent = np.asarray(ent, dtype=np.int64)
        real = ent < n_entities
        counts = np.bincount(ent[real], minlength=n_entities)
        if fixed_ts is not None:
            T, S = fixed_ts
        else:
            itemsize = np.dtype(dtype).itemsize
            T, S, inflation = choose_tiling(counts, rank, itemsize)
            if max_inflation is not None:
                gate = rank if gate_rank is None else gate_rank
                if reference_tiling(counts, gate)[2] > max_inflation:
                    return None
                if inflation > max_inflation:
                    T, S, _ = least_inflating_tiling(counts, rank, itemsize)
        if rows is not None:
            lo, hi = rows
            ent, n_rows = ent[lo:hi], hi - lo
            real = ent < n_entities
            counts = np.bincount(ent[real], minlength=n_entities)
    if derive_src_on_device is None:
        derive_src_on_device = device.type == "cuda"
    with span("myfm.plan.pack", sync=device):
        if derive_src_on_device:
            seg_starts, seg_shift, seg_slot, meta = _plan_tiles(counts, T, S)
            (K, cont_in, cont_out, last_slot, ent_slots, final_part) = meta
            nt = K * T
        else:
            from ._native import pack_tiles_native

            order = np.nonzero(real)[0][np.argsort(ent[real], kind="stable")]
            (src, slot, _, cont_in, cont_out, last_slot, ent_slots,
             final_part) = pack_tiles_native(order, counts, ent.shape[0], T,
                                             S)
            nt = src.shape[0]
            K = nt // T

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    with span("myfm.plan.upload", sync=device):
        ent_main = _upload_ids(ent, n_entities, device)
        if derive_src_on_device:
            seg = [up(a) for a in (seg_starts, seg_shift, seg_slot)]
        else:
            src_d = up(src)
            slot_d = _upload_ids(slot, S, device)
    with span("myfm.plan.derive", sync=device):
        if derive_src_on_device:
            src_d, slot_d = _derive_src_slot_device(ent_main, *seg, nt,
                                                    n_rows)
        ent_pad = torch.cat([ent_main, ent_main.new_full((1,), n_entities)])
        ent_tile = ent_pad[torch.clamp(src_d, max=n_rows).long()]
        slot_f = torch.where(src_d < n_rows, slot_d, S).to(torch_dtype(dtype))
    D = rank + 2
    with span("myfm.plan.finalize", sync=device):
        chunk_tiles = max(
            1,
            min(
                K,
                CHUNK_ROWS // T,
                CHUNK_FLAT_BYTES // max(S * D * D * 4, 1),
            ),
        )
        fin_win, fin_idx, fin_mask, max_fin = _finalize_windows(
            np.asarray(final_part, dtype=np.int64), counts, K, S,
            chunk_tiles,
        )
        table = CategoricalTable(
            src=src_d,
            slot=slot_d,
            slot_f=slot_f,
            ent_of_tile_row=ent_tile,
            cont_in=up(cont_in),
            cont_out=up(cont_out),
            last_slot=up(last_slot),
            ent_slots=up(ent_slots),
            final_part=up(final_part),
            fin_win=fin_win,
            fin_idx=up(fin_idx),
            fin_mask=up(fin_mask),
            cardinality=up(counts.astype(dtype)),
            ent_main=ent_main,
            noise_feat=up(col_offset + np.arange(n_entities,
                                                 dtype=np.int64)),
            col_offset=col_offset,
            n_cols=n_entities,
            n_tiles=K,
            tile_rows=T,
            tile_entities=S,
            chunk_tiles=chunk_tiles,
            max_fin=max_fin,
        )
    return table


def extract_categorical_mappings(
    X: Optional[sps.spmatrix],
    blocks: Sequence,
    grouping: Optional[np.ndarray],
    dtype,
    allow_side: bool = False,
):
    """(mappings, side_specs, n_rows, n_features, grouping) for a
    categorical / entity+attribute design, or None (the same host logic
    as the TPU package).

    A mapping is (ent [N], B, col_offset) — one one-hot table.  A side
    spec is (ent [N], block_size, Xs csr [block_size, Fs], col_ids):
    the non-one-hot column groups of one block.  A grouped flattened
    main table splits into one table per column group."""
    if X is None:
        if not blocks:
            return None
        n_rows = blocks[0].mapper_size
        X = sps.csr_matrix((n_rows, 0), dtype=dtype)
    X = sps.csr_matrix(X)
    n_rows = X.shape[0]
    n_features = X.shape[1] + sum(b.feature_size for b in blocks)

    if grouping is not None:
        grouping = np.asarray(grouping, dtype=np.int32)

    mappings: List[Tuple[np.ndarray, int, int]] = []  # (ent, B, offset)
    side_specs: List[Tuple[np.ndarray, int, sps.csr_matrix, np.ndarray]]
    side_specs = []
    if X.shape[1] > 0:
        ent = categorical_mapping(X)
        if ent is not None:
            mappings.append((ent, X.shape[1], 0))
        elif grouping is not None:
            # main-table rows have no entity compression, so non-one-
            # hot main groups stay on the colored/joint paths
            g_main = grouping[: X.shape[1]]
            if g_main.size and (np.diff(g_main) >= 0).all():
                bounds = np.searchsorted(
                    g_main, np.arange(g_main.max() + 2)
                )
                Xc = X.tocsc()
                for gi in range(g_main.max() + 1):
                    lo, hi = int(bounds[gi]), int(bounds[gi + 1])
                    if hi <= lo:
                        continue
                    sub = Xc[:, lo:hi].tocsr()
                    ent = categorical_mapping(sub)
                    if ent is None:
                        return None
                    mappings.append((ent, hi - lo, lo))
            else:
                return None
        else:
            return None
    offset = X.shape[1]
    for b in blocks:
        bx = sps.csr_matrix(b.data)
        mapper = np.asarray(b.original_to_block)
        ent = categorical_mapping(bx, mapper)
        if ent is not None:
            mappings.append((ent, b.feature_size, offset))
            offset += b.feature_size
            continue
        # split the block by column group: one-hot groups become
        # categorical tables; the remaining groups are per-entity side
        # features of the block rows (entity+attribute table)
        side_cols: List[int] = []
        if grouping is not None:
            g_blk = grouping[offset : offset + b.feature_size]
            if not (g_blk.size and (np.diff(g_blk) >= 0).all()):
                return None
            bounds = np.searchsorted(
                g_blk - g_blk[0], np.arange(g_blk[-1] - g_blk[0] + 2)
            )
            bc = bx.tocsc()
            for gi in range(g_blk[-1] - g_blk[0] + 1):
                lo, hi = int(bounds[gi]), int(bounds[gi + 1])
                if hi <= lo:
                    continue
                sub = bc[:, lo:hi].tocsr()
                ent = categorical_mapping(sub, mapper)
                if ent is not None:
                    mappings.append((ent, hi - lo, offset + lo))
                elif allow_side:
                    side_cols.extend(range(lo, hi))
                else:
                    return None
        elif allow_side:
            side_cols = list(range(b.feature_size))
        else:
            return None
        if side_cols:
            side_cols_a = np.asarray(side_cols, dtype=np.int64)
            Xs = bx.tocsc()[:, side_cols_a].tocsr()
            side_specs.append(
                (
                    mapper.astype(np.int64),
                    b.block_size,
                    Xs,
                    offset + side_cols_a,
                )
            )
        offset += b.feature_size
    if not mappings and not side_specs:
        return None
    return mappings, side_specs, n_rows, n_features, grouping


def try_compile_categorical(
    X: Optional[sps.spmatrix],
    blocks: Sequence,
    grouping: Optional[np.ndarray],
    n_groups: Optional[int],
    dtype,
    device,
    rank: int = 32,
    max_inflation: float = 4.0,
    allow_side: bool = False,
    fixed_ts: Optional[Tuple[int, int]] = None,
    gate_rank: Optional[int] = None,
    derive_src_on_device: Optional[bool] = None,
    rows: Optional[Tuple[int, int]] = None,
) -> Optional[CategoricalPlan]:
    """Compile the fast-path plan onto ``device``, or None if any table
    is neither one-hot nor (with ``allow_side``) an entity+attribute
    block within the side gates, or pads its rows by more than
    ``max_inflation`` under the TPU package's tiling.  ``rank`` is the
    width the port's tiling is chosen for (the Gram's D = rank + 2: the
    factor rank on the Gibbs path, 3R on the VI path); ``gate_rank``
    (default ``rank``) the width the TPU package gates at (4R for its
    entity+attribute VI plans).  ``fixed_ts`` pins every table's
    (T, S).  ``derive_src_on_device`` and ``rows`` (the
    shard [lo, hi) of a sharded plan, which then records ``row_lo`` and
    the whole design's ``n_total``) are passed to every
    ``compile_categorical_table``."""
    dtype = np.dtype(dtype)
    extracted = extract_categorical_mappings(
        X, blocks, grouping, dtype, allow_side=allow_side
    )
    if extracted is None:
        return None
    mappings, side_specs, n_rows, n_features, grouping = extracted

    if grouping is None:
        grouping = np.zeros(n_features, dtype=np.int32)
        n_groups = 1
    else:
        grouping = np.asarray(grouping, dtype=np.int32)
        if n_groups is None:
            n_groups = int(grouping.max()) + 1 if grouping.size else 1
    group_counts = np.bincount(grouping, minlength=n_groups).astype(dtype)
    n_total = None
    if rows is not None:
        n_total = n_rows
        n_rows = rows[1] - rows[0]

    tables = []
    side: List[Optional[SideInfo]] = []
    for ent, B, off in mappings:
        tab = compile_categorical_table(
            ent, B, off, n_total or n_rows, dtype, device, rank=rank,
            max_inflation=max_inflation, fixed_ts=fixed_ts,
            gate_rank=gate_rank, derive_src_on_device=derive_src_on_device,
            rows=rows,
        )
        if tab is None:
            return None
        tables.append(tab)
        side.append(None)
    for ent, B, Xs, col_ids in side_specs:
        info = compile_side_info(Xs, col_ids, n_features, dtype, device)
        if info is None:
            return None
        tab = compile_categorical_table(
            ent, B, int(col_ids[0]), n_total or n_rows, dtype, device,
            rank=rank,
            max_inflation=max_inflation, fixed_ts=fixed_ts,
            gate_rank=gate_rank, derive_src_on_device=derive_src_on_device,
            rows=rows,
        )
        if tab is None:
            return None
        tables.append(tab)
        side.append(info)
    tables = tuple(tables)

    # cross-table entity maps in each table's tile-row order — device
    # gathers of the already-uploaded per-table mappings
    cross_ent = []
    for t in tables:
        row = []
        src = torch.clamp(t.src, max=n_rows).long()
        for t2 in tables:
            if t2 is t:
                row.append(t.ent_of_tile_row)
                continue
            ent2_pad = torch.cat(
                [t2.ent_main, t2.ent_main.new_full((1,), t2.n_cols)]
            )
            row.append(ent2_pad[src])
        cross_ent.append(tuple(row))

    return CategoricalPlan(
        tables=tables,
        cross_ent=tuple(cross_ent),
        group_index=torch.as_tensor(
            grouping.astype(np.int64), device=device
        ),
        group_counts=torch.as_tensor(group_counts, device=device),
        n_rows=n_rows,
        n_features=n_features,
        n_groups=int(n_groups),
        side=tuple(side),
        row_lo=0 if rows is None else rows[0],
        n_total=n_total,
    )
