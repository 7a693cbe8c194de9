"""Benchmark dataset managers (synthetic ratings only in this port)."""

from .loader_base import train_test_split_with_kfold
from .synthetic import SyntheticMovieLensManager

__all__ = ["SyntheticMovieLensManager", "train_test_split_with_kfold"]
