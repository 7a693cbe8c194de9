"""Percentile-binning encoder for numeric features, numpy only.

Counterpart of ``myfm_tpu/utils/encoders/binning.py`` ``BinningEncoder``:
column 0 encodes NaN, columns 1..P+1 the bins.
"""

from __future__ import annotations

from typing import List

import numpy as np
from scipy import sparse as sps

from .base import SparseEncoderBase


class BinningEncoder(SparseEncoderBase):
    """One-hot encode numeric values by percentile bins.

    Bin edges are the (unique) interior percentiles of the non-NaN
    training values; NaN gets its own leading column.
    """

    def __init__(self, x, n_percentiles: int = 10) -> None:
        if n_percentiles <= 0:
            raise ValueError("n_percentiles must be greater than 0.")
        self.percentages = np.linspace(0, 100, n_percentiles + 2)[1:-1]
        x_arr = np.asarray(x, dtype=np.float64)
        self.percentiles = np.unique(
            np.percentile(x_arr[~np.isnan(x_arr)], self.percentages)
        )

    def names(self) -> List[str]:
        return (
            ["NaN"]
            + [f"<={val}" for val in self.percentiles]
            + [f">{self.percentiles[-1]}"]
        )

    def to_sparse(self, x) -> sps.csr_matrix:
        x_arr = np.asarray(x, dtype=np.float64)
        n = x_arr.shape[0]
        not_na = ~np.isnan(x_arr)
        cols = np.zeros(n, dtype=np.int64)
        # bin index = 1 + #{percentile p : x > p}; NaN stays at column 0
        cols[not_na] = 1 + np.searchsorted(
            self.percentiles, x_arr[not_na], side="left"
        )
        return sps.csr_matrix(
            (np.ones(n, dtype=np.float64), (np.arange(n), cols)),
            shape=(n, len(self)),
        )

    def __len__(self) -> int:
        return len(self.percentiles) + 2
