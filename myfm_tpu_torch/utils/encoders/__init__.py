"""Sparse feature encoders, numpy only (counterpart of
``myfm_tpu/utils/encoders``)."""

from .base import DataFrameEncoder, SparseEncoderBase
from .binning import BinningEncoder
from .categorical import CategoryValueToSparseEncoder
from .multi_value import MultipleValuesToSparseEncoder

__all__ = [
    "SparseEncoderBase",
    "DataFrameEncoder",
    "CategoryValueToSparseEncoder",
    "MultipleValuesToSparseEncoder",
    "BinningEncoder",
]
