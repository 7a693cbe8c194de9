"""Synthetic rating-data generators.

Counterpart of ``myfm_tpu/utils/dummy_data.py``: a low-rank user × item
score model discretized through percentile cutpoints into 1..5 ratings,
plus identity-matrix RelationBlocks for testing the relational path.
The same seed gives the same frame, blocks and ratings as the TPU
package.  ``gen_dummy_rating_df`` imports pandas when called;
``gen_dummy_X`` needs numpy only.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Tuple

import numpy as np
from scipy import sparse as sps

from ..relational import RelationBlock

if TYPE_CHECKING:  # pragma: no cover
    import pandas as pd


def _dummy_ratings(random_seed: int, factor_rank: int, size: int):
    """(users, items, days, ratings): 1-based ids, day offsets from
    2000-01-01 and 1..5 ratings, drawn in the TPU package's order."""
    rng = np.random.RandomState(random_seed)
    n_users = max(size // 3, 10)
    n_items = max(size // 2, 10)
    user_factor = rng.normal(
        0, 1 / np.sqrt(factor_rank), size=(n_users, factor_rank)
    )
    item_factor = rng.normal(0, 1, size=(n_items, factor_rank))
    days = rng.randint(-365, 365, size=size)
    users = rng.choice(n_users, size=size, replace=True) + 1
    items = rng.choice(n_items, size=size, replace=True) + 1
    score = (user_factor[users - 1] * item_factor[items - 1]).sum(axis=1)
    cutpoints = np.percentile(score, [20, 40, 60, 80])
    rating = np.ones(size, dtype=np.int64)
    for cp in cutpoints:
        rating += score >= cp
    return users, items, days, rating


def gen_dummy_rating_df(
    random_seed: int = 0,
    factor_rank: int = 3,
    size: int = 100,
    user_colname: str = "userId",
    item_colname: str = "itemId",
    timestamp_colname: str = "timestamp",
    rating_colname: str = "rating",
) -> "pd.DataFrame":
    import pandas as pd

    users, items, days, rating = _dummy_ratings(
        random_seed, factor_rank, size)
    timestamps = pd.Timestamp("2000-01-01") + pd.to_timedelta(
        days, unit="day")
    df = pd.DataFrame(
        {
            user_colname: users,
            item_colname: items,
            timestamp_colname: timestamps,
        }
    )
    df[rating_colname] = rating
    return df


def gen_dummy_X(
    random_seed: int = 0,
    factor_rank: int = 3,
    size: int = 100,
) -> Tuple[List[RelationBlock], np.ndarray, List[int]]:
    """Identity-matrix user/item RelationBlocks + ratings + shapes."""
    users, items, _, rating = _dummy_ratings(random_seed, factor_rank, size)
    blocks: List[RelationBlock] = []
    shapes: List[int] = []
    for ids in (users, items):
        # the sorted distinct ids are the categories, as pd.Categorical's
        categories, codes = np.unique(ids, return_inverse=True)
        X = sps.identity(len(categories), dtype=np.float64).tocsr()
        blocks.append(RelationBlock(codes, X))
        shapes.append(X.shape[1])
    return blocks, rating, shapes


__all__ = ["gen_dummy_rating_df", "gen_dummy_X"]
