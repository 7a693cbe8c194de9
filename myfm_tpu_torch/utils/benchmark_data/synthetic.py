"""Synthetic MovieLens-shaped ratings for network-free runs.

numpy-only counterpart of ``myfm_tpu/utils/benchmark_data/synthetic.py``:
the same presets and the same random draws in the same order, so every
returned array equals the TPU package's corresponding column — Zipf-ish
item popularity, heavy-tailed user activity, a low-rank latent score
plus user/item biases discretized to 1..5 stars, and a day stamp within
three years.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .loader_base import train_test_split_with_kfold

_PRESETS = {
    # "tiny" is for smoke tests: same schema, seconds to fit
    "tiny": dict(n_rows=2_000, n_users=60, n_items=40),
    "100k": dict(n_rows=100_000, n_users=943, n_items=1682),
    "1m": dict(n_rows=1_000_209, n_users=6040, n_items=3706),
    "10m": dict(n_rows=10_000_054, n_users=69_878, n_items=10_677),
}


class SyntheticMovieLensManager:
    """Synthetic ratings at the MovieLens scales, as numpy arrays.

    Unlike the TPU package's manager, which returns pandas DataFrames
    like the MovieLens managers, this one returns dicts of numpy
    columns: the card's machine has no pandas."""

    def __init__(
        self,
        scale: str = "100k",
        rank: int = 8,
        random_seed: int = 42,
        n_rows: Optional[int] = None,
        n_users: Optional[int] = None,
        n_items: Optional[int] = None,
    ):
        preset = dict(_PRESETS.get(scale, _PRESETS["100k"]))
        if n_rows is not None:
            preset["n_rows"] = n_rows
        if n_users is not None:
            preset["n_users"] = n_users
        if n_items is not None:
            preset["n_items"] = n_items
        self.n_rows = preset["n_rows"]
        self.n_users = preset["n_users"]
        self.n_items = preset["n_items"]
        self.rank = rank
        self.random_seed = random_seed
        self._arrays: Optional[Dict[str, np.ndarray]] = None

    def _generate(self) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.random_seed)
        # heavy-tailed popularity for items, activity for users
        item_pop = rng.pareto(1.2, size=self.n_items) + 0.1
        item_pop /= item_pop.sum()
        user_act = rng.pareto(1.5, size=self.n_users) + 0.5
        user_act /= user_act.sum()
        users = rng.choice(self.n_users, size=self.n_rows, p=user_act)
        items = rng.choice(self.n_items, size=self.n_rows, p=item_pop)

        uf = rng.normal(0, 1 / np.sqrt(self.rank),
                        size=(self.n_users, self.rank))
        vf = rng.normal(0, 1 / np.sqrt(self.rank),
                        size=(self.n_items, self.rank))
        ub = 0.4 * rng.normal(size=self.n_users)
        vb = 0.4 * rng.normal(size=self.n_items)
        score = (
            (uf[users] * vf[items]).sum(axis=1)
            + ub[users] + vb[items]
            + 0.6 * rng.normal(size=self.n_rows)
        )
        cps = np.percentile(score, [12, 30, 55, 80])
        rating = np.ones(self.n_rows, dtype=np.int64)
        for cp in cps:
            rating += score >= cp
        day = rng.randint(0, 3 * 365, size=self.n_rows)
        return {
            "user_id": users + 1,
            "movie_id": items + 1,
            "rating": rating.astype(np.float64),
            # days since 2005-01-01 (the TPU package's timestamp column)
            "day": day,
        }

    def load_rating_all(self) -> Dict[str, np.ndarray]:
        """Columns ``user_id`` and ``movie_id`` (1-based), ``rating``
        (1..5, float64) and ``day`` (0-based day index)."""
        if self._arrays is None:
            self._arrays = self._generate()
        return self._arrays

    def load_rating_kfold_split(
        self, K: int, fold: int, random_state: Optional[int] = 0
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """(train, test) columns of fold ``fold`` of a shuffled K-fold."""
        return train_test_split_with_kfold(
            self.load_rating_all(), K, fold, random_state
        )
