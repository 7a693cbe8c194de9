"""MovieLens-10M data manager (counterpart of
``myfm_tpu/utils/benchmark_data/movielens10M_data.py``); the parsing
lives in the shared '::'-ratings loader (movielens1M_data.py)."""

from __future__ import annotations

from pathlib import Path

from .movielens1M_data import _DoubleColonRatingsManager


class MovieLens10MDataManager(_DoubleColonRatingsManager):
    DOWNLOAD_URL = "http://files.grouplens.org/datasets/movielens/ml-10m.zip"
    DEFAULT_PATH = Path("~/.ml-10m.zip").expanduser()
    RATINGS_MEMBER = "ml-10M100K/ratings.dat"
