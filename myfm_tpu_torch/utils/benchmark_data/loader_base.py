"""Deterministic shuffled K-fold split on dict-of-arrays ratings.

numpy-only counterpart of ``myfm_tpu/utils/benchmark_data/loader_base.py``
``train_test_split_with_kfold`` and ``_fold_window``: the same
RandomState shuffle and the same contiguous fold windows, so a fold
holds the same rows, in the same order, as the TPU package's DataFrame
split.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

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
    ratings: Ratings,
    K: int,
    fold: int,
    random_state: Optional[int] = None,
) -> Tuple[Ratings, Ratings]:
    """(train, test) for one fold of a deterministic shuffled K-fold;
    every column of ``ratings`` is split alike."""
    if not (0 <= fold < K):
        raise ValueError("0 <= fold < K")
    n = len(next(iter(ratings.values())))
    order = np.arange(n)
    np.random.RandomState(random_state).shuffle(order)
    start, end = _fold_window(n, K, fold)
    in_test = np.zeros(n, dtype=bool)
    in_test[start:end] = True
    train = {k: np.asarray(v)[order][~in_test] for k, v in ratings.items()}
    test = {k: np.asarray(v)[order][in_test] for k, v in ratings.items()}
    return train, test
