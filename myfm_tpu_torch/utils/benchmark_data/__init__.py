"""Benchmark dataset managers (counterpart of
``myfm_tpu/utils/benchmark_data``).  The MovieLens managers return
pandas DataFrames and import pandas when they read; the synthetic
manager returns dicts of numpy columns, so it runs where pandas is
absent."""

from .loader_base import (
    DataLoaderBase,
    MovieLensBase,
    train_test_split_with_kfold,
)
from .movielens100k_data import MovieLens100kDataManager
from .movielens10M_data import MovieLens10MDataManager
from .movielens1M_data import MovieLens1MDataManager
from .synthetic import SyntheticMovieLensManager

__all__ = [
    "DataLoaderBase",
    "MovieLensBase",
    "train_test_split_with_kfold",
    "MovieLens100kDataManager",
    "MovieLens1MDataManager",
    "MovieLens10MDataManager",
    "SyntheticMovieLensManager",
]
