"""Content-addressed cache of compiled design plans.

PyTorch counterpart of ``myfm_tpu/design_cache.py``.  A fit compiles its
design into a plan (host packing, uploads, the layout built on the
device) before its first sweep; at the ML-10M shape that is seconds of
host time, and real workflows fit one design again and again
(hyperparameter sweeps, a regression then an ordered probit on the same
ratings, reruns).  The cache keeps the plans of the last ``_CAPACITY``
designs.

Keys are content fingerprints (blake2b over every table's
shape / indptr / indices / data, each block's mapper and the grouping,
in the TPU package's byte order, so both packages give one digest for
one design) plus the build's parameters, which always include the
device: a CPU plan never serves a CUDA fit.  In-place mutation of a
design matrix changes its fingerprint, so it cannot be served a stale
plan.  A build that declines (returns None) is not cached.

A cached plan is shared by every fit that hits it, so nothing may write
into a plan's tensors or keep per-fit state on it: trainers hold their
own buffers (``y_tiles``, workspaces, effective rows).  The tests hold a
refit on a cached plan bit-equal to a fit on a fresh one.
``clear_plan_cache()`` frees the plans; ``plan_cache_bytes()`` counts
the device memory they hold.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch
from scipy import sparse as sps

from .tracing import span

_CAPACITY = 4
_CACHE: "OrderedDict[tuple, object]" = OrderedDict()


def _h_update(h, arr: np.ndarray) -> None:
    a = np.ascontiguousarray(arr)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())


def design_fingerprint(X, blocks, grouping) -> str:
    """Content hash of (X, blocks, grouping): the TPU package's digest."""
    h = hashlib.blake2b(digest_size=16)
    if X is None:
        h.update(b"none")
    else:
        Xc = sps.csr_matrix(X)
        h.update(str(Xc.shape).encode())
        _h_update(h, Xc.indptr)
        _h_update(h, Xc.indices)
        _h_update(h, Xc.data)
    for b in blocks:
        bd = sps.csr_matrix(b.data)
        h.update(str(bd.shape).encode())
        _h_update(h, np.asarray(b.original_to_block))
        _h_update(h, bd.indptr)
        _h_update(h, bd.indices)
        _h_update(h, bd.data)
    if grouping is None:
        h.update(b"nogroup")
    else:
        _h_update(h, np.asarray(grouping))
    return h.hexdigest()


def get_or_build(
    kind: str,
    fingerprint: str,
    params: tuple,
    build: Callable[[], object],
) -> object:
    """The cached plan for (kind, fingerprint, params), or the plan
    ``build()`` returns, cached unless it is None (a declined compile is
    retried)."""
    key = (kind, fingerprint, params)
    if key in _CACHE:
        _CACHE.move_to_end(key)
        get_or_build.hits += 1
        return _CACHE[key]
    with span("myfm.plan.build"):
        plan = build()
    if plan is not None:
        _CACHE[key] = plan
        while len(_CACHE) > _CAPACITY:
            _CACHE.popitem(last=False)
    return plan


# hits since import: what a caller reads around a fit to tell whether
# its plan came from the cache
get_or_build.hits = 0


def clear_plan_cache() -> None:
    """Drop every cached plan (their device memory is freed once no fit
    holds them)."""
    _CACHE.clear()


def _tensors(obj, seen):
    if isinstance(obj, torch.Tensor):
        key = (obj.untyped_storage().data_ptr(), obj.device)
        if key not in seen:
            seen[key] = obj.untyped_storage().nbytes()
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), seen)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _tensors(x, seen)


def plan_cache_bytes(device_type: str = "cuda") -> int:
    """Bytes of the distinct tensor storages the cached plans hold on
    devices of ``device_type``."""
    seen = {}
    for plan in _CACHE.values():
        _tensors(plan, seen)
    return sum(n for (_, dev), n in seen.items()
               if dev.type == device_type)
