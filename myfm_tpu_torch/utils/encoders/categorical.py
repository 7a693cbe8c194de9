"""One-hot categorical encoder, numpy only.

Counterpart of ``myfm_tpu/utils/encoders/categorical.py``
``CategoryValueToSparseEncoder``: the vocabulary is the sorted set of
values seen at least ``min_freq`` times, and with
``handle_unknown="create"`` column 0 is ``__UNK__``.  The mapping is a
binary search over the sorted vocabulary instead of a pandas map, so
the values must be mutually orderable (numbers, or strings).
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import scipy.sparse as sps

from .base import SparseEncoderBase


class CategoryValueToSparseEncoder(SparseEncoderBase):
    """One-hot encode a list of items into a CSR matrix.

    ``handle_unknown``: "create" maps unseen values to the ``__UNK__``
    column 0; "ignore" leaves their row empty; "raise" raises KeyError.
    """

    def __init__(self, items: Iterable, min_freq: int = 1,
                 handle_unknown: str = "create"):
        if handle_unknown not in ("create", "ignore", "raise"):
            raise ValueError(
                "handle_unknown must be one of create/ignore/raise."
            )
        vals, counts = np.unique(np.asarray(list(items)),
                                 return_counts=True)
        self.vocab = vals[counts >= min_freq]
        self.handle_unknown = handle_unknown
        self._offset = 1 if handle_unknown == "create" else 0
        self.values: List = (["__UNK__"] if self._offset else []) + list(
            self.vocab.tolist()
        )

    def _lookup(self, items) -> np.ndarray:
        """Column of each item, −1 for values outside the vocabulary."""
        x = np.asarray(items)
        if self.vocab.size == 0 or x.size == 0:
            return np.full(x.shape, -1, dtype=np.int64)
        pos = np.searchsorted(self.vocab, x)
        pos_c = np.minimum(pos, self.vocab.size - 1)
        found = self.vocab[pos_c] == x
        return np.where(found, pos_c + self._offset, -1).astype(np.int64)

    def __getitem__(self, x) -> int:
        idx = int(self._lookup([x])[0])
        if idx < 0:
            if self.handle_unknown == "create":
                return 0
            raise KeyError(f"{x} not found.")
        return idx

    def names(self) -> List[str]:
        return [str(v) for v in self.values]

    def to_sparse(self, items: Iterable) -> sps.csr_matrix:
        items = np.asarray(list(items))
        cols = self._lookup(items)
        missing = cols < 0
        if missing.any():
            if self.handle_unknown == "raise":
                raise KeyError(f"{items[missing][0]} not found.")
            if self.handle_unknown == "create":
                cols = np.where(missing, 0, cols)
        rows = np.flatnonzero(cols >= 0)
        return sps.csr_matrix(
            (np.ones(rows.shape[0], dtype=np.float64), (rows, cols[rows])),
            shape=(items.shape[0], len(self)),
        )

    def __len__(self) -> int:
        return int(self.vocab.size) + self._offset
