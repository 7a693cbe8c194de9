"""Encoder protocol and DataFrame composition.

Counterpart of ``myfm_tpu/utils/encoders/base.py``: an encoder turns one
column of values into a CSR block; a ``DataFrameEncoder`` owns an
ordered set of (column, encoder) pairs, hstacks their blocks, and
reports per-column widths (``encoder_shapes``) as the bridge to
``group_shapes``.  Nothing here imports pandas: ``encode_df`` reads
``df[column]``, so a pandas DataFrame and a dict of arrays both serve.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List, Tuple

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


class DataFrameEncoder:
    """Compose per-column encoders into one wide CSR design matrix.

    Columns are encoded and horizontally stacked in registration
    order.  ``encoder_shapes`` (the per-column widths, in the same
    order) is what ``fit(..., group_shapes=...)`` expects, giving each
    source column its own hyperprior group.
    """

    def __init__(self) -> None:
        self._columns: List[Tuple[str, SparseEncoderBase]] = []

    @property
    def col_encoders(self) -> Dict[str, SparseEncoderBase]:
        """Registered encoders keyed by column name (insertion order)."""
        return dict(self._columns)

    @property
    def encoder_shapes(self) -> List[int]:
        """Per-column encoded widths — feed these to ``group_shapes``."""
        return [len(encoder) for _, encoder in self._columns]

    def add_column(
        self, colname: str, encoder: SparseEncoderBase
    ) -> "DataFrameEncoder":
        """Register a column encoder (fluent; returns self)."""
        self._columns.append((colname, encoder))
        return self

    def all_names(self) -> List[str]:
        """``column__label`` name per encoded feature, in order."""
        out: List[str] = []
        for colname, encoder in self._columns:
            out.extend(f"{colname}__{label}" for label in encoder.names())
        return out

    def encode_df(self, df) -> sps.csr_matrix:
        """Encode ``df`` (a pandas DataFrame or a dict of columns) into
        one hstacked CSR matrix."""
        if not self._columns:
            raise ValueError(
                "DataFrameEncoder has no registered columns; call "
                "add_column first."
            )
        blocks = [
            encoder.to_sparse(df[colname])
            for colname, encoder in self._columns
        ]
        return sps.hstack(blocks, format="csr")
