"""Float segment sums whose order of addition is fixed on every device.

On CUDA, ``index_add_`` adds with atomics: the order in which a
segment's entries meet differs from run to run, so float results differ
in their last bits, and a Gibbs chain that feeds them back into its
draws drifts apart from its own rerun.  Every float segment sum of the
port's ops goes through this module instead:

- on the CPU, ``index_add_``, the arithmetic the CPU parity tests were
  written against;
- on CUDA with few segments (the hyper-group sums of ``draw_lambda`` and
  ``draw_mu``: tens of thousands of features into a handful of groups),
  a masked dense sum: a [n, m, ...] ``where`` reduced over m by one
  reduction kernel, whose tree is fixed by the shape;
- on CUDA otherwise, each segment's entries summed in index order by
  ``torch.segment_reduce`` (one thread per segment and column, no
  atomics).  An ``ascending`` index (a color's slots, which the plan
  lays out in slot order) is summed where it lies, its segment offsets
  found by one ``searchsorted``; any other index is gathered in its
  stable order first.  A plan makes the order of each of its static
  unsorted indices once, when it is compiled or sharded (``index_order``:
  ``design.TablePlan.coo_order``, ``BlockPlan.coo_order`` and
  ``BlockPlan.mapper_order``), and passes it as ``order``.  An index
  given with neither is sorted on each call: only the hyper-group
  index of a design with more than ``DENSE_MAX_SEGMENTS`` groups (its
  groups need not ascend), and the plans converted from the TPU
  package's in the tests.

Either way two calls on the same inputs give the same bits.

A caller whose indices are distinct, apart from entries whose value is
zero (a color's scatter into its rows: a color is row-disjoint, and its
pad entries carry x = 0), says ``distinct=True`` and keeps
``index_add_`` on CUDA too: no element then receives two nonzero
additions, so the atomics' order cannot change a bit (adding zero is
exact).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

# the masked dense sum's limits: at most this many segments, and at
# most this many elements in its [n, m, ...] temporary
DENSE_MAX_SEGMENTS = 16
DENSE_MAX_ELEMS = 1 << 26

Order = Tuple[torch.Tensor, torch.Tensor]


def index_order(index: torch.Tensor, n: int) -> Order:
    """(stable argsort of ``index``, the [n + 1] offsets of its n
    segments in that order): the order ``segment_sum`` adds in along a
    static index on CUDA."""
    order = torch.argsort(index, stable=True)
    bounds = torch.arange(n + 1, device=index.device, dtype=index.dtype)
    return order, torch.searchsorted(index[order], bounds)


def segment_sum(x: torch.Tensor, index: torch.Tensor, n: int, *,
                order: Optional[Order] = None, ascending: bool = False,
                distinct: bool = False) -> torch.Tensor:
    """out[s] = Σ_{i: index[i] = s} x[i] over the leading axis, for s in
    [0, n); ``order``, ``ascending`` and ``distinct`` as in the module
    docstring."""
    if x.device.type != "cuda" or distinct:
        out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return out.index_add_(0, index, x)
    return _cuda_sum(x, index, n, order=order, ascending=ascending)


def add_at(out: torch.Tensor, index: torch.Tensor, x: torch.Tensor, *,
           distinct: bool = False) -> torch.Tensor:
    """``out.index_add(0, index, x)``: a new tensor, ``out`` unchanged;
    ``distinct`` as in the module docstring."""
    if out.device.type != "cuda" or distinct:
        return out.index_add(0, index, x)
    return _cuda_sum(x, index, out.shape[0], out)


def segment_sum_chunked(summands: Callable, index: torch.Tensor, n: int,
                        out: torch.Tensor, chunk: int,
                        order: Optional[Order] = None) -> torch.Tensor:
    """``out`` plus Σ over ``index``'s segments of ``summands(rows)``,
    the [len(rows), ...] terms of the given rows, made ``chunk`` rows at
    a time so that the temporary stays bounded.  On the CPU the chunks
    are row ranges added with ``index_add_``; on CUDA they are ranges of
    the index's stable ``order``, each summed segment by segment, the
    chunks' sums added in turn."""
    if out.device.type != "cuda":
        for start in range(0, index.shape[0], chunk):
            sl = slice(start, start + chunk)
            out = out.index_add(0, index[sl], summands(sl))
        return out
    return _chunks_in_order(summands, index, n, out, chunk, order)


def _chunks_in_order(summands, index, n, out, chunk, order=None):
    """``segment_sum_chunked``'s CUDA route (plain PyTorch: the CPU
    tests run it on CPU tensors)."""
    perm, offsets = order if order is not None else index_order(index, n)
    for start in range(0, index.shape[0], chunk):
        rows = perm[start : start + chunk]
        bounds = offsets.clamp(start, start + rows.shape[0]) - start
        out = out + torch.segment_reduce(summands(rows), "sum",
                                         offsets=bounds, axis=0, unsafe=True)
    return out


_SEGMENT_IDS = {}


def _segment_ids(n: int, device) -> torch.Tensor:
    """arange(n) on ``device`` as an [n, 1] column, made once (the
    colored engines call the dense sum once per color)."""
    key = (n, str(device))
    ids = _SEGMENT_IDS.get(key)
    if ids is None:
        ids = _SEGMENT_IDS[key] = torch.arange(n, device=device)[:, None]
    return ids


def _cuda_sum(x, index, n, out=None, *, order=None, ascending=False):
    if (out is None and n <= DENSE_MAX_SEGMENTS
            and n * x.numel() <= DENSE_MAX_ELEMS):
        if index.dtype != torch.long:
            index = index.long()
        mask = index[None, :] == _segment_ids(n, x.device)  # [n, m]
        mask = mask.view(mask.shape + (1,) * (x.dim() - 1))
        return torch.where(mask, x.unsqueeze(0), 0.0).sum(dim=1)
    if ascending:
        bounds = torch.arange(n + 1, device=index.device, dtype=index.dtype)
        terms, offsets = x, torch.searchsorted(index, bounds)
    else:
        perm, offsets = order if order is not None else index_order(index, n)
        terms = x[perm]
    total = torch.segment_reduce(terms, "sum", offsets=offsets, axis=0,
                                 unsafe=True)
    return total if out is None else out + total
