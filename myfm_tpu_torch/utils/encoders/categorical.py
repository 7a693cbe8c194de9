"""One-hot categorical encoder, numpy only.

Counterpart of ``myfm_tpu/utils/encoders/categorical.py``
``CategoryValueToSparseEncoder``: the vocabulary is the sorted set of
values seen at least ``min_freq`` times, and with
``handle_unknown="create"`` column 0 is ``__UNK__``.  ``to_sparse`` maps
a whole column by binary search over the sorted vocabulary instead of a
pandas map, so the values must be mutually orderable (numbers, strings
or dates); ``_get_index`` maps one value through a dict, the contract
``multi_value.py`` builds on.
"""

from __future__ import annotations

from typing import Dict, Generic, Iterable, List, Optional, TypeVar, Union

import numpy as np
import scipy.sparse as sps

from .base import SparseEncoderBase

T = TypeVar("T")


class CategoryValueToSparseEncoder(Generic[T], SparseEncoderBase):
    """One-hot encode a list of items into a CSR matrix.

    Parameters
    ----------
    items:
        Training items from which the vocabulary is built.
    min_freq:
        Minimum frequency for an item to enter the vocabulary (default 1).
    handle_unknown:
        "create" → unseen values map to a dedicated ``__UNK__`` column at
        index 0; "ignore" → unseen values produce an all-zero row part;
        "raise" → a KeyError.
    """

    def __init__(
        self,
        items: Iterable[T],
        min_freq: int = 1,
        handle_unknown: str = "create",
    ):
        if handle_unknown not in ("create", "ignore", "raise"):
            raise ValueError(
                "handle_unknown must be one of create/ignore/raise."
            )
        vals, counts = np.unique(np.asarray(list(items)),
                                 return_counts=True)
        self.vocab = vals[counts >= min_freq]
        self.handle_unknown = handle_unknown
        self._item_index_offset = 1 if handle_unknown == "create" else 0
        vocab: List[T] = self.vocab.tolist()
        self._dict: Dict[T, int] = {
            item: i + self._item_index_offset for i, item in enumerate(vocab)
        }
        self.values: List[Union[str, T]] = (
            ["__UNK__"] if handle_unknown == "create" else []
        )
        self.values.extend(vocab)

    def _get_index(self, x: T) -> Optional[int]:
        idx = self._dict.get(x)
        if idx is None:
            if self.handle_unknown == "create":
                return 0
            if self.handle_unknown == "ignore":
                return None
            raise KeyError(f"{x} not found.")
        return idx

    def __getitem__(self, x: T) -> int:
        result = self._get_index(x)
        if result is None:
            raise KeyError(f"{x} not found.")
        return result

    def _lookup(self, items: np.ndarray) -> np.ndarray:
        """Column of each item, −1 for values outside the vocabulary."""
        if self.vocab.size == 0 or items.size == 0:
            return np.full(items.shape, -1, dtype=np.int64)
        pos = np.searchsorted(self.vocab, items)
        pos_c = np.minimum(pos, self.vocab.size - 1)
        found = self.vocab[pos_c] == items
        return np.where(
            found, pos_c + self._item_index_offset, -1).astype(np.int64)

    def names(self) -> List[str]:
        return [str(v) for v in self.values]

    def to_sparse(self, items: Iterable[T]) -> sps.csr_matrix:
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
        return len(self._dict) + self._item_index_offset
