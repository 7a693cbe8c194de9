"""Encoder protocol: one column of values becomes a CSR block.

Counterpart of ``myfm_tpu/utils/encoders/base.py`` ``SparseEncoderBase``.
The pandas ``DataFrameEncoder`` is not ported: the port reads columns
as numpy arrays.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List

import scipy.sparse as sps


class SparseEncoderBase(ABC):
    """One column's value → sparse-block transform; ``len`` is the
    encoded width."""

    @abstractmethod
    def to_sparse(self, x: List[Any]) -> sps.csr_matrix:
        """Encode a sequence of raw values into a CSR block."""

    @abstractmethod
    def __len__(self) -> int:
        """Encoded width of this block."""

    @abstractmethod
    def names(self) -> List[str]:
        """Human-readable label per encoded column."""
