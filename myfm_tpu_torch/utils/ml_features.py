"""MovieLens feature sets (Rendle's mf / svdpp / timesvd / timesvdpp /
timesvdpp_flipped), numpy only.

Counterpart of ``examples/ml_features.py`` on dict-of-arrays ratings
(columns ``user_id``, ``movie_id``, ``rating``, ``day``), so a machine
without pandas can build the timeSVD++-flipped design.  The date
vocabulary is the sorted set of ``day`` integers, which is the order of
the TPU package's sorted ``timestamp.dt.date`` values.

``build_feature_blocks`` returns the main (date) tables, the user/movie
RelationBlocks and the feature grouping vector, equal to the example's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy import sparse as sps

from ..relational import RelationBlock
from .encoders import CategoryValueToSparseEncoder

FEATURE_SETS = ("mf", "svdpp", "timesvd", "timesvdpp", "timesvdpp_flipped")

Ratings = Dict[str, np.ndarray]


def feature_flags(feature: str) -> Tuple[bool, bool, bool]:
    """(use_date, use_implicit_user, use_implicit_item)."""
    if feature not in FEATURE_SETS:
        raise ValueError(f"unknown feature set {feature!r}")
    return (
        feature in ("timesvd", "timesvdpp", "timesvdpp_flipped"),
        feature in ("svdpp", "timesvdpp", "timesvdpp_flipped"),
        feature == "timesvdpp_flipped",
    )


def _implicit_matrix(keys, implicit_key, implicit_value_index, n_cols):
    """N-hot matrix: row per entry of the sorted ``keys``; row k has
    1/sqrt(c) at the value columns co-occurring with keys[k] in the
    implicit source (c = their count)."""
    order = np.argsort(implicit_key, kind="stable")
    sorted_keys = implicit_key[order]
    row_of = np.searchsorted(keys, sorted_keys)
    valid = (row_of < len(keys)) & (
        keys[np.clip(row_of, 0, len(keys) - 1)] == sorted_keys
    )
    rows = row_of[valid]
    cols = implicit_value_index[order][valid]
    counts = np.bincount(rows, minlength=len(keys))
    data = 1.0 / np.sqrt(np.maximum(counts, 1))[rows]
    return sps.csr_matrix((data, (rows, cols)), shape=(len(keys), n_cols))


def _columns(enc: CategoryValueToSparseEncoder, items) -> np.ndarray:
    """The encoder's column of each item (one entry per one-hot row)."""
    return enc.to_sparse(items).indices.astype(np.int64)


def build_feature_blocks(
    train: Ratings,
    test: Ratings,
    feature: str = "timesvdpp_flipped",
    stricter_protocol: bool = True,
):
    """(X_date_train, X_date_test, train_blocks, test_blocks, grouping)
    for the Rendle evaluation protocol."""
    use_date, use_iu, use_ii = feature_flags(feature)
    if stricter_protocol:
        source = train
    else:
        source = {k: np.concatenate([train[k], test[k]]) for k in train}

    user_enc = CategoryValueToSparseEncoder(source["user_id"])
    movie_enc = CategoryValueToSparseEncoder(source["movie_id"])
    if use_date:
        date_enc = CategoryValueToSparseEncoder(source["day"])
        X_date_train = date_enc.to_sparse(train["day"])
        X_date_test = date_enc.to_sparse(test["day"])
    else:
        date_enc = None
        X_date_train = X_date_test = None

    imp_users = np.asarray(source["user_id"])
    imp_movies = np.asarray(source["movie_id"])
    imp_user_col = _columns(user_enc, imp_users)
    imp_movie_col = _columns(movie_enc, imp_movies)

    def user_table(unique_users):
        X = user_enc.to_sparse(unique_users)
        if not use_iu:
            return X
        imp = _implicit_matrix(unique_users, imp_users, imp_movie_col,
                               len(movie_enc))
        return sps.hstack([X, imp], format="csr")

    def movie_table(unique_movies):
        X = movie_enc.to_sparse(unique_movies)
        if not use_ii:
            return X
        imp = _implicit_matrix(unique_movies, imp_movies, imp_user_col,
                               len(user_enc))
        return sps.hstack([X, imp], format="csr")

    train_blocks: List[RelationBlock] = []
    test_blocks: List[RelationBlock] = []
    for part, target in [(train, train_blocks), (test, test_blocks)]:
        uu, umap = np.unique(part["user_id"], return_inverse=True)
        target.append(RelationBlock(umap, user_table(uu)))
        mu, mmap = np.unique(part["movie_id"], return_inverse=True)
        target.append(RelationBlock(mmap, movie_table(mu)))

    group_sizes: List[int] = []
    if use_date:
        group_sizes.append(len(date_enc))
    group_sizes.append(len(user_enc))
    if use_iu:
        group_sizes.append(len(movie_enc))
    group_sizes.append(len(movie_enc))
    if use_ii:
        group_sizes.append(len(user_enc))
    grouping = [g for g, size in enumerate(group_sizes) for _ in range(size)]
    return X_date_train, X_date_test, train_blocks, test_blocks, grouping


def load_synthetic_movielens(scale: str, fold: int, random_seed: int = 42,
                             K: int = 10) -> Tuple[Ratings, Ratings]:
    """K-fold (train, test) of the synthetic ratings at a MovieLens
    scale (the example's ``load_movielens(..., synthetic=True)``)."""
    from .benchmark_data import SyntheticMovieLensManager

    man = SyntheticMovieLensManager(scale, random_seed=random_seed)
    return man.load_rating_kfold_split(K, fold, random_seed)
