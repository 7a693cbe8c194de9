"""Zip-backed benchmark-dataset plumbing and the shuffled K-fold split.

Counterpart of ``myfm_tpu/utils/benchmark_data/loader_base.py``: a
consent-gated download into a well-known cache path
(``_fetch_with_consent``, ``DataLoaderBase``, ``MovieLensBase``), and the
deterministic shuffled K-fold splitter behind the Rendle ML-10M
protocol.  The split uses the same RandomState shuffle and the same
contiguous fold windows, so a fold holds the same rows, in the same
order, as the TPU package's.  It takes a pandas DataFrame (and returns
DataFrames, as the TPU package does) or a dict of numpy columns (and
returns dicts).  pandas is imported only by the loaders' methods.
"""

from __future__ import annotations

import urllib.request
from abc import ABC, abstractmethod
from pathlib import Path
from typing import TYPE_CHECKING, Dict, Optional, Tuple, Union
from zipfile import ZipFile

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    import pandas as pd

Ratings = Dict[str, np.ndarray]


def _fold_window(n_data: int, K: int, fold: int) -> Tuple[int, int]:
    """[start, end) of fold ``fold`` in a length-``n_data`` sequence cut
    into K nearly-equal contiguous windows (earlier folds absorb the
    remainder, so sizes differ by at most one)."""
    sizes = np.full(K, n_data // K, dtype=np.int64)
    sizes[: n_data % K] += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return int(bounds[fold]), int(bounds[fold + 1])


def train_test_split_with_kfold(
    ratings: Union[Ratings, "pd.DataFrame"],
    K: int,
    fold: int,
    random_state: Optional[int] = None,
):
    """(train, test) for one fold of a deterministic shuffled K-fold;
    every column of ``ratings`` is split alike.  A DataFrame gives
    DataFrames with a fresh index, a dict of arrays gives dicts."""
    if not (0 <= fold < K):
        raise ValueError("0 <= fold < K")
    frame = hasattr(ratings, "iloc")
    n = len(ratings) if frame else len(next(iter(ratings.values())))
    order = np.arange(n)
    np.random.RandomState(random_state).shuffle(order)
    start, end = _fold_window(n, K, fold)
    in_test = np.zeros(n, dtype=bool)
    in_test[start:end] = True
    if frame:
        shuffled = ratings.iloc[order]
        return (
            shuffled.iloc[~in_test].reset_index(drop=True),
            shuffled.iloc[in_test].reset_index(drop=True),
        )
    train = {k: np.asarray(v)[order][~in_test] for k, v in ratings.items()}
    test = {k: np.asarray(v)[order][in_test] for k, v in ratings.items()}
    return train, test


def _fetch_with_consent(url: str, dest: Path) -> None:
    """Ask on stdin before touching the network; refusal aborts."""
    answer = input(
        f"Could not find {dest}.\n"
        f"Can I download and save it there?[y/N]"
    )
    if answer.lower() != "y":
        raise RuntimeError("abort.")
    print("start download...")
    urllib.request.urlretrieve(url, dest)
    print("complete")


class DataLoaderBase(ABC):
    """Opens (downloading on consent if absent) the dataset zip."""

    zf: ZipFile

    @property
    @abstractmethod
    def DOWNLOAD_URL(self) -> str:
        raise NotImplementedError  # pragma: no cover

    @property
    @abstractmethod
    def DEFAULT_PATH(self) -> Path:
        raise NotImplementedError  # pragma: no cover

    def __init__(self, zippath: Optional[Path] = None):
        zippath = Path(zippath or self.DEFAULT_PATH)
        if not zippath.exists():
            _fetch_with_consent(self.DOWNLOAD_URL, zippath)
        self.zf = ZipFile(zippath)


class MovieLensBase(DataLoaderBase, ABC):
    @abstractmethod
    def load_rating_all(self) -> "pd.DataFrame":
        raise NotImplementedError  # pragma: no cover

    def load_rating_kfold_split(
        self, K: int, fold: int, random_state: Optional[int] = 0
    ) -> Tuple["pd.DataFrame", "pd.DataFrame"]:
        """Load every rating and return fold ``fold`` of the K-fold
        split (the protocol behind the committed benchmark numbers)."""
        if not (0 <= fold < K):
            raise ValueError("0 <= fold < K")
        return train_test_split_with_kfold(
            self.load_rating_all(), K, fold, random_state
        )
