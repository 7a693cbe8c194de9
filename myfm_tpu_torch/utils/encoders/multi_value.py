"""N-hot encoder for separator-joined value lists, numpy only.

Counterpart of ``myfm_tpu/utils/encoders/multi_value.py``
``MultipleValuesToSparseEncoder``.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import scipy.sparse as sps

from .categorical import CategoryValueToSparseEncoder


class MultipleValuesToSparseEncoder(CategoryValueToSparseEncoder[str]):
    """N-hot encode strings like ``"Comedy|Drama"`` into sparse rows.

    Each row's non-zero entries are ``1/sqrt(N)`` when ``normalize`` is
    on (N = row non-zero count), 1.0 otherwise.  Duplicate and empty
    tokens within a row are dropped.
    """

    def __init__(
        self,
        items: Iterable[str],
        min_freq: int = 1,
        sep: str = ",",
        normalize: bool = True,
        handle_unknown: str = "create",
    ):
        flattened = [
            token for row in items for token in set(row.split(sep)) if token
        ]
        self.sep = sep
        self.normalize = normalize
        super().__init__(
            flattened, min_freq=min_freq, handle_unknown=handle_unknown
        )

    def to_sparse(self, items: Iterable[str]) -> sps.csr_matrix:
        indptr = [0]
        indices: list = []
        data: list = []
        for row in items:
            local = {
                idx
                for idx in (
                    self._get_index(tok)
                    for tok in row.split(self.sep)
                    if tok
                )
                if idx is not None
            }
            row_idx = sorted(local)
            n = len(row_idx)
            if n:
                value = 1.0 / np.sqrt(n) if self.normalize else 1.0
                indices.extend(row_idx)
                data.extend([value] * n)
            indptr.append(indptr[-1] + n)
        return sps.csr_matrix(
            (
                np.asarray(data, dtype=np.float64),
                np.asarray(indices, dtype=np.int64),
                np.asarray(indptr, dtype=np.int64),
            ),
            shape=(len(indptr) - 1, len(self)),
        )
