"""Sparse feature encoders (numpy only): the subset of
``myfm_tpu/utils/encoders`` that
``utils/ml_features.py`` needs."""

from .base import SparseEncoderBase
from .categorical import CategoryValueToSparseEncoder

__all__ = ["SparseEncoderBase", "CategoryValueToSparseEncoder"]
