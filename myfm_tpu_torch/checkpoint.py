"""Mid-chain checkpoint and resume of the Gibbs trainers.

PyTorch counterpart of ``myfm_tpu/checkpoint.py``.  A checkpoint is an
npz of the chain state's tensors in field order (nested states, such as
the fast path's ``CategoricalState``, walked depth first; a field that
is None is listed as such), the number of sweeps done, and the state of
each ``torch.Generator`` the trainer draws from.  The TPU package needs
no generator state, since it derives every sweep's key from (seed,
sweep); the port draws from one stateful generator per trainer, so its
state is part of the chain's.  Resuming restores both and reproduces the
uninterrupted chain.

A sharded chain (parallel/) holds its per-row fields (``ROW_FIELDS``)
in pieces, one per rank, and everything else replicated: its checkpoint
holds the whole design's rows, gathered from every rank, and rank 0
writes it; every rank reads it on resume and keeps its own rows.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

# the per-row fields of the Gibbs states (GibbsState.e and the fast
# path's CategoricalState.core.e / .tau), split over the ranks of a
# sharded chain
ROW_FIELDS = ("e", "core.e", "tau")


def state_fields(state, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted field name, tensor or None) of a state dataclass, in field
    order, nested dataclasses walked depth first."""
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if dataclasses.is_dataclass(value):
            yield from state_fields(value, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", value


def with_fields(like, values: Dict[str, Any], prefix: str = ""):
    """``like`` with every field replaced by ``values[dotted name]``."""
    kw = {}
    for f in dataclasses.fields(like):
        value = getattr(like, f.name)
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(value):
            kw[f.name] = with_fields(value, values, name + ".")
        else:
            kw[f.name] = values[name]
    return dataclasses.replace(like, **kw)


def save_checkpoint(path: str, state: Any, iteration: int,
                    generators: Sequence[torch.Generator] = (),
                    axis=None, n_total: int = 0) -> None:
    """Write (state, iteration, generator states) to ``path`` (.npz)
    atomically: through a temporary file in the same directory, moved
    into place once whole (a failed write leaves neither it nor a
    partial ``path``).  On a sharded chain every rank calls it with the
    data ``axis`` and the design's ``n_total`` rows: the per-row fields
    are gathered, rank 0 writes, and no rank returns before the file is
    in place."""
    payload: Dict[str, np.ndarray] = {}
    names, absent = [], []
    for name, value in state_fields(state):
        names.append(name)
        if value is None:
            absent.append(name)
            continue
        if axis is not None and name in ROW_FIELDS:
            value = axis.gather_rows(value, n_total)
        payload[f"state.{name}"] = value.detach().cpu().numpy()
    # the barrier's operand lives where the chain does (NCCL takes CUDA
    # tensors of the rank's own card only)
    device = next(v.device for _, v in state_fields(state) if v is not None)
    if axis is None or axis.index == 0:
        try:
            _write(path, payload, names, absent, iteration, generators)
        finally:
            if axis is not None:  # the others wait for the file
                axis.psum(torch.zeros(1, device=device))
    else:
        axis.psum(torch.zeros(1, device=device))


def _write(path, payload, names, absent, iteration, generators):
    payload["fields"] = np.asarray(names, dtype=str)
    payload["none_fields"] = np.asarray(absent, dtype=str)
    payload["iteration"] = np.asarray(iteration, dtype=np.int64)
    for i, g in enumerate(generators):
        payload[f"generator_{i}"] = g.get_state().numpy()
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, like: Any,
                    generators: Sequence[torch.Generator] = (),
                    rows: Tuple[int, int] = None) -> Tuple[Any, int]:
    """Read a checkpoint of ``save_checkpoint``: returns (state,
    iteration), the state with ``like``'s structure and each tensor on
    the device and in the dtype of ``like``'s; ``generators`` get their
    saved states back.  ``rows = (lo, hi)`` (a rank of a sharded chain)
    keeps rows [lo, hi) of the per-row fields."""
    with np.load(path) as data:
        names = [str(n) for n in data["fields"]]
        absent = {str(n) for n in data["none_fields"]}
        ref = dict(state_fields(like))
        if names != list(ref):
            raise ValueError(
                f"{path} holds the fields {names}, the state has "
                f"{list(ref)}")
        values = {}
        for name, r in ref.items():
            if name in absent:
                values[name] = None
            elif r is None:
                raise ValueError(
                    f"{path} holds {name}, which the state leaves None")
            else:
                a = data[f"state.{name}"]
                if rows is not None and name in ROW_FIELDS:
                    a = a[rows[0] : rows[1]]
                values[name] = torch.tensor(a, dtype=r.dtype,
                                            device=r.device)
        iteration = int(data["iteration"])
        for i, g in enumerate(generators):
            g.set_state(torch.from_numpy(data[f"generator_{i}"].copy()))
    return with_fields(like, values), iteration
