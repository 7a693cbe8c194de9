"""The data axis of a sharded chain: collectives over a process group.

The TPU package runs one program over a 1-D ``('data',)`` mesh under
``shard_map`` and sums statistics with ``lax.psum`` / ``psum_scatter`` /
``all_gather``.  The port runs one process per device, each on the same
straight-line sweep, and ``Axis`` maps those calls one to one onto
``torch.distributed``:

    lax.psum          Axis.psum          all_reduce
    lax.psum_scatter  Axis.psum_scatter  reduce_scatter_tensor
    lax.all_gather    Axis.all_gather    all_gather_into_tensor
    lax.axis_index    Axis.index         get_rank(group)

``axis=None`` everywhere means one process: ``psum`` returns its
argument, so the single-process chain runs exactly the arithmetic it ran
before the axis existed.

Each collective works on a contiguous copy of its operand, never on a
view into the chain's state.  On NCCL a collective runs on the current
stream, as the sweep's own kernels do.  gloo takes CUDA operands for
all three operations (torch 2.11), so both backends get the sweep's own
tensors.

``Axis.calls`` and ``Axis.bytes`` count each operation's calls and the
bytes of its operands; with ``Axis.timed`` set, ``Axis.seconds`` adds up
each one's time between two device synchronisations (a measurement
mode: the synchronisations cost time of their own).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import time
from collections import defaultdict

import torch
import torch.distributed as dist


class Axis:
    """The ranks of ``group`` (the default group when None) as one data
    axis: rank r holds rows [r·n_local, min((r+1)·n_local, n)) of an
    n-row design, n_local = ceil(n / size), as the TPU package shards."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise ValueError(
                "a sharded fit needs an initialised torch.distributed "
                "process group")
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.calls = defaultdict(int)
        self.bytes = defaultdict(int)
        self.seconds = defaultdict(float)
        self.timed = False

    @property
    def device(self) -> torch.device:
        """Where this rank's operands of host-made values go: its current
        CUDA device on NCCL (which takes CUDA tensors of the rank's own
        card only: call ``torch.cuda.set_device`` per rank, as torchrun
        scripts do), else the CPU."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def rows(self, n: int) -> Tuple[int, int]:
        """(lo, hi) of this rank's rows of an n-row design."""
        n_local = -(-n // self.size)
        lo = min(self.index * n_local, n)
        return lo, min(lo + n_local, n)

    def _run(self, name, fn, *tensors):
        """fn(*tensors) on the group, counted (and timed when ``timed``)."""
        self.calls[name] += 1
        self.bytes[name] += tensors[-1].nbytes
        if not self.timed:
            fn(*tensors)
            return
        cuda = tensors[0].device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(tensors[0].device)
        t0 = time.perf_counter()
        fn(*tensors)
        if cuda:
            torch.cuda.synchronize(tensors[0].device)
        self.seconds[name] += time.perf_counter() - t0

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ of ``x`` over the ranks (a new tensor)."""
        t = x.detach().reshape(-1).clone()
        self._run("all_reduce",
                  lambda a: dist.all_reduce(a, group=self.group), t)
        return t.reshape(x.shape)

    def psum_many(self, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``psum`` of several tensors of one dtype in one all-reduce."""
        flat = self.psum(torch.cat([x.reshape(-1) for x in xs]))
        out, off = [], 0
        for x in xs:
            out.append(flat[off : off + x.numel()].reshape(x.shape))
            off += x.numel()
        return tuple(out)

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of ``x``, this rank's 1/size slice of the
        leading axis (``psum_scatter(..., tiled=True)``)."""
        x = x.detach().contiguous()
        out = x.new_empty((x.shape[0] // self.size,) + tuple(x.shape[1:]))
        self._run("reduce_scatter_tensor",
                  lambda o, i: dist.reduce_scatter_tensor(
                      o, i, group=self.group), out, x)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along the leading axis, in rank
        order (``all_gather(..., tiled=True)``)."""
        x = x.detach().contiguous()
        out = x.new_empty((x.shape[0] * self.size,) + tuple(x.shape[1:]))
        self._run("all_gather_into_tensor",
                  lambda o, i: dist.all_gather_into_tensor(
                      o, i, group=self.group), out, x)
        return out

    def gather_rows(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """The whole [n, ...] per-row tensor from each rank's rows
        (``rows(n)``), on every rank."""
        n_local = -(-n // self.size)
        pad = x.new_zeros((n_local,) + tuple(x.shape[1:]))
        pad[: x.shape[0]] = x
        return self.all_gather(pad)[:n]


def psum(x, axis: Optional[Axis]):
    """All-reduce over the data axis; the identity for one process."""
    return x if axis is None else axis.psum(x)


def psum_many(axis: Optional[Axis], *xs):
    return xs if axis is None else axis.psum_many(*xs)


def local_rows(x: torch.Tensor, row_lo: int, n_rows: int) -> torch.Tensor:
    """This rank's rows of a vector drawn at the design's whole length
    (the single-process draw, so both chains see the same numbers)."""
    if row_lo == 0 and n_rows == x.shape[0]:
        return x
    return x[row_lo : row_lo + n_rows]


def replicas_equal(axis: Axis, tensors: Sequence[torch.Tensor]) -> bool:
    """True when every rank holds the same bits in ``tensors`` (each
    gathered whole and compared bit for bit with rank 0's)."""
    ok = True
    for t in tensors:
        flat = t.detach().reshape(-1).to(axis.device)
        bits = flat.view(torch.int64 if flat.element_size() == 8
                         else torch.int32)
        g = axis.all_gather(bits.contiguous()).view(axis.size, -1)
        ok = ok and all(torch.equal(g[0], g[r]) for r in range(axis.size))
    return ok
